// The paired-end pair join for Hopper (sm_90a), bound with ctypes by
// bitmapperbs_tpu_torch/ops/kernels.py (pair_join).
//
// What it replaces: no Pallas kernel.  The reference computes the proper-
// pair join in plain jnp under jax.jit (bitmapperbs_tpu/models/paired.py:
// 80-145: pair_grid, the staged lexicographic minimum per compatible frame
// pair, the running best across frame pairs and the pair second-best), and
// XLA fuses each where into the min reduction that reads it, so no
// [B, Kc, Kc] grid is ever kept in memory.  The port's plain version
// (kernels.pair_join_ref, eager torch) builds an int64 torch.where grid of
// B x Kc x Kc cells for every staged reduction: 537 MB per grid at 4,096
// pairs and Kc 128, which set the PE device call's peak memory.
//
// The function, per pair and per compatible frame pair (a mate-1 frame and
// the mate-2 frame of the same block and the opposite pattern): a cell
// (i, j) is ok when both scores are below INF, the forward mate's anchor is
// at or before the reverse mate's, and the u32 insert frev + mrev - ffwd
// lies in [min_insert, max_insert].  The frame pair's candidate is the
// lexicographic minimum of (s1 + s2, f1, f2) over its ok cells, with the
// least s1 of the cells at that minimum as its payload.  A frame pair with
// no ok cell still gives a candidate, because the plain version's staged
// minimum then runs over a grid that is 2 INF everywhere: (2 INF, the least
// mate-1 anchor of the frame, the least mate-2 anchor, the least s1 among
// the mate-1 entries at that anchor).  It beats the initial best
// (2 INF, INVALID, INVALID, 127, 127) on its bp codes at the latest, and
// reaches the output as pair_a1 / pair_a2 / pair_s1 / pair_bp* of a pair
// whose pair_valid is false.  The running best takes a candidate
// (sum, f1, f2, bp1, bp2) only when it is strictly smaller.  Then the
// second-best sum: the least s1 + s2 over the ok cells of every frame pair
// where mate 1 or mate 2 lies in another frame than the best's, or more
// than e from the best's frame anchor.
//
// Design: one block of four warps per pair, and no grid.  The warps stage
// the pair's rows side by side, one (frame pair, mate) row each in turn:
// a warp reads its row (Kc scores, Kc anchors) once, 32 entries at a time,
// and packs the valid entries (score < INF) into the block's lists in
// shared memory by ballot; the same sweep keeps the least (anchor, score)
// over all Kc entries, which is the row's side of the degenerate candidate
// in O(Kc).  Only cells of two valid entries can be ok, so the block's 128
// threads then walk the n1 x n2 cells of the lists, each keeping a register
// minimum of the key (sum, f1, f2, s1) as two 64-bit words (its cell
// (i, j) stepped with a carry, no division per cell), merged by a
// butterfly of shuffles in each warp and across the four warps through
// shared memory.  The second pass walks the same lists.  A read has one or
// a handful of verified candidates per frame, so most pairs have few
// cells; a pair inside a repeat can have up to Kc x Kc, and its block,
// alone on its SM at the end, sets the kernel's time (chip_smoke.py times
// the batch with every slot emptied and with one such pair planted;
// PERF.md has them, and a first design's time: a warp per pair).
//
// What bounds it on the H100: bytes.  Each input is read once: B x (F1 +
// F2) x Kc x 12 bytes (int32 score, int64 anchor) and the two lengths, and
// nine [B] outputs are written: at the Gbp PE cell (4,096 pairs, Kc 128,
// 2 + 2 frames) 25.2 MB, 0.0075 ms at 3.35 TB/s.  The rows are read
// coalesced (32 consecutive entries per warp load), and the rows of a pair
// by different warps at once.
//
// Domain: scores lie in [0, INF] (the candidate stages give 0..e, or INF
// where a slot holds no candidate), anchors in [0, 2^32) as int64 (u32
// values), lengths and the genome length below 2^32.
#include <cstdint>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kInf = 1 << 20;                 // constants.INF_SCORE
constexpr uint32_t kInvalid = 0xFFFFFFFFu;    // ops/u32.INVALID
constexpr int kMaxFramePairs = 4;             // PBAT: 4, directional: 2
constexpr int kMaxFrames = 4;                 // frames per mate
constexpr int kWarps = 4;                     // warps per pair (block)
constexpr unsigned kFull = 0xFFFFFFFFu;

// The compatible frame pairs, the same for every pair of a batch: the
// mate-1 and mate-2 frame, their bp codes (block * 2 + pattern) and whether
// mate 1 is the forward mate.  Passed by value; every loop over it is
// unrolled, so no index into it reaches local memory.
struct FramePairs {
  int n;
  int f1[kMaxFramePairs], f2[kMaxFramePairs];
  int bp1[kMaxFramePairs], bp2[kMaxFramePairs];
  int m1_fwd[kMaxFramePairs];
};

struct JoinArgs {
  const int32_t* s1;     // [B][F1][Kc] mate-1 scores
  const int64_t* f1;     // [B][F1][Kc] mate-1 fwd anchors (u32 values)
  const int32_t* s2;     // [B][F2][Kc]
  const int64_t* f2;
  const int64_t* m1;     // [B] mate lengths
  const int64_t* m2;
  int32_t* psum;         // outputs, [B] each
  int64_t* pf1;
  int64_t* pf2;
  int64_t* pbp1;
  int64_t* pbp2;
  int32_t* best_s1;
  int64_t* pa1;
  int64_t* pa2;
  int32_t* second;
  int64_t B;
  int F1, F2, Kc;
  uint32_t genome_len;
  int64_t e, min_insert, max_insert;
};

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }

__device__ __forceinline__ bool lex_lt(u64 ah, u64 al, u64 bh, u64 bl) {
  return ah < bh || (ah == bh && al < bl);
}

// Packs the valid entries (score < INF) of one frame row into ls / lf and
// returns their count; *least gets the least (anchor << 32 | score) over
// all Kc entries.  Every lane of the calling warp returns the same values.
__device__ int stage_row(const int32_t* s, const int64_t* f, int Kc,
                         int lane, int32_t* ls, uint32_t* lf, u64* least) {
  int n = 0;
  u64 key = ~0ull;
#pragma unroll 4
  for (int k0 = 0; k0 < Kc; k0 += 32) {
    const int k = k0 + lane;
    const bool in = k < Kc;
    const int32_t sc = in ? s[k] : kInf;
    const uint32_t an = in ? uint32_t(f[k]) : kInvalid;
    const bool valid = in && sc < kInf;
    const unsigned vote = __ballot_sync(kFull, valid);
    if (valid) {
      const int at = n + __popc(vote & ((1u << lane) - 1u));
      ls[at] = sc;
      lf[at] = an;
    }
    n += __popc(vote);
    if (in) key = umin64(key, (u64(an) << 32) | uint32_t(sc));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    key = umin64(key, __shfl_xor_sync(kFull, key, d));
  *least = key;
  return n;
}

__device__ __forceinline__ uint32_t frame_anchor(uint32_t fwd, int bp,
                                                 uint32_t m, uint32_t L) {
  return (bp >> 1) == 0 ? fwd : L - fwd - m;       // u32 wrap, as the ref
}

__device__ __forceinline__ bool cell_ok(uint32_t a1, uint32_t a2, bool fwd1,
                                        uint32_t m1, uint32_t m2,
                                        const JoinArgs& a) {
  const uint32_t ffwd = fwd1 ? a1 : a2;
  const uint32_t frev = fwd1 ? a2 : a1;
  const uint32_t insert = frev + (fwd1 ? m2 : m1) - ffwd;
  return ffwd <= frev && int64_t(insert) >= a.min_insert &&
         int64_t(insert) <= a.max_insert;
}

// Calls visit(i, j) for the cells of an n1 x n2 grid that thread tid of
// the block takes: c = tid, tid + T, ... in row-major order (T the block's
// threads), stepping (i, j) by (T / n2, T % n2) with a carry instead of a
// division per cell.
template <typename Visit>
__device__ __forceinline__ void for_cells(int n1, int n2, int tid,
                                          Visit visit) {
  constexpr int T = kWarps * 32;
  const int cells = n1 * n2;
  if (tid >= cells) return;
  const int di = T / n2, dj = T - di * n2;
  int i = tid / n2, j = tid - i * n2;
  for (int c = tid; c < cells; c += T) {
    visit(i, j);
    i += di;
    j += dj;
    if (j >= n2) {
      j -= n2;
      ++i;
    }
  }
}

// Frame pair p's lists in the block's shared memory: mate-1 scores and
// anchors, mate-2 scores and anchors, Kc words each.
struct Lists {
  const int32_t* s1;
  const uint32_t* f1;
  const int32_t* s2;
  const uint32_t* f2;
};

__device__ __forceinline__ Lists lists_of(const uint32_t* lists, int p,
                                          int Kc) {
  return {reinterpret_cast<const int32_t*>(lists + 4 * p * Kc),
          lists + (4 * p + 1) * Kc,
          reinterpret_cast<const int32_t*>(lists + (4 * p + 2) * Kc),
          lists + (4 * p + 3) * Kc};
}

// The block's shared memory past its lists: per row its valid count and
// least key, per warp its part of a reduction.
struct Scratch {
  u64 least[2 * kMaxFramePairs];
  u64 hi[kWarps], lo[kWarps];
  int count[2 * kMaxFramePairs];
  uint32_t second[kWarps];
};

// The block's lexicographic minimum of (hi, lo); every thread gets it.
__device__ void block_lex_min(u64& hi, u64& lo, Scratch& x, int lane,
                              int warp) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const u64 oh = __shfl_xor_sync(kFull, hi, d);
    const u64 ol = __shfl_xor_sync(kFull, lo, d);
    if (lex_lt(oh, ol, hi, lo)) {
      hi = oh;
      lo = ol;
    }
  }
  if (lane == 0) {
    x.hi[warp] = hi;
    x.lo[warp] = lo;
  }
  __syncthreads();
  hi = x.hi[0];
  lo = x.lo[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    if (lex_lt(x.hi[w], x.lo[w], hi, lo)) {
      hi = x.hi[w];
      lo = x.lo[w];
    }
  __syncthreads();                      // x is free again
}

// One block of kWarps warps per pair; the lists take 4 * fp.n * Kc words
// of its dynamic shared memory (per frame pair: mate-1 scores, anchors,
// mate-2 scores, anchors), the Scratch after them.
__global__ void __launch_bounds__(kWarps * 32)
    pair_join_kernel(JoinArgs a, FramePairs fp) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int Kc = a.Kc;
  uint32_t* lists = smem;
  Scratch& x = *reinterpret_cast<Scratch*>(smem + size_t(4) * fp.n * Kc);
  const uint32_t m1 = uint32_t(a.m1[b]);
  const uint32_t m2 = uint32_t(a.m2[b]);
  const uint32_t L = a.genome_len;

  // row r: frame pair r / 2, mate 1 (r even) or mate 2 (r odd)
  for (int r = warp; r < 2 * fp.n; r += kWarps) {
    const int p = r >> 1;
    int fr = 0;
#pragma unroll
    for (int q = 0; q < kMaxFramePairs; ++q)
      if (q == p) fr = (r & 1) ? fp.f2[q] : fp.f1[q];
    const int64_t row = (b * ((r & 1) ? a.F2 : a.F1) + fr) * Kc;
    u64 least;
    const int n = stage_row(
        (r & 1) ? a.s2 + row : a.s1 + row, (r & 1) ? a.f2 + row : a.f1 + row,
        Kc, lane, reinterpret_cast<int32_t*>(lists + 2 * r * Kc),
        lists + (2 * r + 1) * Kc, &least);
    if (lane == 0) {
      x.count[r] = n;
      x.least[r] = least;
    }
  }
  __syncthreads();

  uint32_t bsum = 2 * kInf, bf1 = kInvalid, bf2 = kInvalid;
  int bbp1 = 127, bbp2 = 127;
  int32_t bs1 = kInf;
#pragma unroll
  for (int p = 0; p < kMaxFramePairs; ++p) {
    if (p >= fp.n) continue;
    const Lists l = lists_of(lists, p, Kc);
    const bool fwd1 = fp.m1_fwd[p] != 0;
    // the lexicographic minimum of (sum, f1, f2, s1) over the ok cells
    u64 khi = ~0ull, klo = ~0ull;
    int found = 0;
    for_cells(x.count[2 * p], x.count[2 * p + 1], tid, [&](int i, int j) {
      const uint32_t a1 = l.f1[i], a2 = l.f2[j];
      if (!cell_ok(a1, a2, fwd1, m1, m2, a)) return;
      const uint32_t sum = uint32_t(l.s1[i]) + uint32_t(l.s2[j]);
      const u64 hi = (u64(sum) << 32) | a1;
      const u64 lo = (u64(a2) << 32) | uint32_t(l.s1[i]);
      if (lex_lt(hi, lo, khi, klo)) {
        khi = hi;
        klo = lo;
      }
      found = 1;
    });
    uint32_t csum, cf1, cf2;
    int32_t cs1;
    if (__syncthreads_or(found)) {
      block_lex_min(khi, klo, x, lane, warp);
      csum = uint32_t(khi >> 32);
      cf1 = uint32_t(khi);
      cf2 = uint32_t(klo >> 32);
      cs1 = int32_t(uint32_t(klo));
    } else {                            // every cell at 2 INF: see the note
      csum = 2 * kInf;
      cf1 = uint32_t(x.least[2 * p] >> 32);
      cf2 = uint32_t(x.least[2 * p + 1] >> 32);
      cs1 = int32_t(uint32_t(x.least[2 * p]));
    }
    const int bp1 = fp.bp1[p], bp2 = fp.bp2[p];
    const bool take =
        csum < bsum ||
        (csum == bsum &&
         (cf1 < bf1 ||
          (cf1 == bf1 &&
           (cf2 < bf2 ||
            (cf2 == bf2 && (bp1 < bbp1 || (bp1 == bbp1 && bp2 < bbp2)))))));
    if (take) {
      bsum = csum;
      bf1 = cf1;
      bf2 = cf2;
      bbp1 = bp1;
      bbp2 = bp2;
      bs1 = cs1;
    }
  }

  const uint32_t pa1 = frame_anchor(bf1, bbp1, m1, L);
  const uint32_t pa2 = frame_anchor(bf2, bbp2, m2, L);
  uint32_t second = 2 * kInf;
#pragma unroll
  for (int p = 0; p < kMaxFramePairs; ++p) {
    if (p >= fp.n) continue;
    const Lists l = lists_of(lists, p, Kc);
    const bool fwd1 = fp.m1_fwd[p] != 0;
    const int bp1 = fp.bp1[p], bp2 = fp.bp2[p];
    for_cells(x.count[2 * p], x.count[2 * p + 1], tid, [&](int i, int j) {
      const uint32_t a1 = l.f1[i], a2 = l.f2[j];
      if (!cell_ok(a1, a2, fwd1, m1, m2, a)) return;
      const uint32_t x1 = frame_anchor(a1, bp1, m1, L);
      const uint32_t x2 = frame_anchor(a2, bp2, m2, L);
      const uint32_t d1 = x1 > pa1 ? x1 - pa1 : pa1 - x1;
      const uint32_t d2 = x2 > pa2 ? x2 - pa2 : pa2 - x2;
      if (bp1 != bbp1 || int64_t(d1) > a.e || bp2 != bbp2 ||
          int64_t(d2) > a.e)
        second = min(second, uint32_t(l.s1[i]) + uint32_t(l.s2[j]));
    });
  }
  second = __reduce_min_sync(kFull, second);
  if (lane == 0) x.second[warp] = second;
  __syncthreads();

  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) second = min(second, x.second[w]);
    a.psum[b] = int32_t(bsum);
    a.pf1[b] = bf1;
    a.pf2[b] = bf2;
    a.pbp1[b] = bbp1;
    a.pbp2[b] = bbp2;
    a.best_s1[b] = bs1;
    a.pa1[b] = pa1;
    a.pa2[b] = pa2;
    a.second[b] = int32_t(second);
  }
}

}  // namespace

extern "C" {

// The pair join of B pairs (see the note above).  s1 int32 [B][F1][Kc],
// f1 int64 [B][F1][Kc], s2 / f2 likewise over F2 frames, m1 / m2 int64 [B],
// all contiguous; outputs [B] each, contiguous: psum, best_s1, second
// int32; pf1, pf2, pbp1, pbp2, pa1, pa2 int64.  pairs: 5 ints per frame
// pair (mate-1 frame, mate-2 frame, bp1, bp2, mate 1 forward), read on the
// host during the call.  Returns the cudaError_t of the launch (0 =
// launched); shapes it does not take give cudaErrorInvalidValue.
int btbs_pair_join(const void* s1, const void* f1, const void* s2,
                   const void* f2, const void* m1, const void* m2, void* psum,
                   void* pf1, void* pf2, void* pbp1, void* pbp2,
                   void* best_s1, void* pa1, void* pa2, void* second,
                   int64_t B, int F1, int F2, int Kc, int64_t genome_len,
                   int64_t e, int64_t min_insert, int64_t max_insert,
                   const int* pairs, int npairs, void* stream) {
  if (B < 1 || F1 < 1 || F1 > kMaxFrames || F2 < 1 || F2 > kMaxFrames ||
      Kc < 1 || npairs < 1 || npairs > kMaxFramePairs || genome_len < 0 ||
      genome_len > int64_t(kInvalid) || e < 0)
    return int(cudaErrorInvalidValue);
  FramePairs fp{};
  fp.n = npairs;
  for (int p = 0; p < npairs; ++p) {
    const int* q = pairs + 5 * p;
    if (q[0] < 0 || q[0] >= F1 || q[1] < 0 || q[1] >= F2 || q[2] < 0 ||
        q[2] > 3 || q[3] < 0 || q[3] > 3)
      return int(cudaErrorInvalidValue);
    fp.f1[p] = q[0];
    fp.f2[p] = q[1];
    fp.bp1[p] = q[2];
    fp.bp2[p] = q[3];
    fp.m1_fwd[p] = q[4];
  }
  const size_t smem = size_t(4) * npairs * Kc * sizeof(uint32_t) +
                      sizeof(Scratch);
  if (B > 0x7FFFFFFF) return int(cudaErrorInvalidValue);
  static size_t granted[kMaxDevices];
  cudaError_t rc = allow_shared(pair_join_kernel, smem, granted);
  if (rc != cudaSuccess) return int(rc);
  JoinArgs a;
  a.s1 = static_cast<const int32_t*>(s1);
  a.f1 = static_cast<const int64_t*>(f1);
  a.s2 = static_cast<const int32_t*>(s2);
  a.f2 = static_cast<const int64_t*>(f2);
  a.m1 = static_cast<const int64_t*>(m1);
  a.m2 = static_cast<const int64_t*>(m2);
  a.psum = static_cast<int32_t*>(psum);
  a.pf1 = static_cast<int64_t*>(pf1);
  a.pf2 = static_cast<int64_t*>(pf2);
  a.pbp1 = static_cast<int64_t*>(pbp1);
  a.pbp2 = static_cast<int64_t*>(pbp2);
  a.best_s1 = static_cast<int32_t*>(best_s1);
  a.pa1 = static_cast<int64_t*>(pa1);
  a.pa2 = static_cast<int64_t*>(pa2);
  a.second = static_cast<int32_t*>(second);
  a.B = B;
  a.F1 = F1;
  a.F2 = F2;
  a.Kc = Kc;
  a.genome_len = uint32_t(genome_len);
  a.e = e;
  a.min_insert = min_insert;
  a.max_insert = max_insert;
  pair_join_kernel<<<unsigned(B), kWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(a, fp);
  return int(cudaGetLastError());
}

}  // extern "C"
