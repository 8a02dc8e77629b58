// The compact candidate stage's flat buffer for Hopper (sm_90a), bound with
// ctypes by bitmapperbs_tpu_torch/ops/kernels.py (flat_expand, flat_dedup,
// scatter_back, select_se).
//
// What it replaces: no Pallas kernel.  The reference writes this work as
// plain jnp under jax.jit (bitmapperbs_tpu/models/aligner.py: _order_seeds
// :111-120 and the flat expansion :366-406, the unique rank and Kc cap
// :421-437, the scatter back :490-515, select_se :520-548), and XLA
// compiles it into the device program with everything around it.  Eager
// PyTorch runs the same lines as some 150 small kernels per SE candidate
// stage and selection (the port's plain versions, kernels.*_ref, which were
// bitmapperbs_tpu_torch/models/aligner.py:119-128, :285-324, :341-361,
// :395-414 and :425-452).  Four entries stand for them:
//
//   btbs_flat_expand  <- _order_seeds + the expansion: per (read, frame)
//     the kept seed counts (0 < ep - sp <= max_occ), their stable ascending
//     order, the total, frame_occ = min(total, LB), overflow = total > LB;
//     an exclusive scan of frame_occ over the batch (frame_base); gdrop per
//     read; n_used; and the packed flat lanes (SA row, seed start, read
//     length, frame, block, ok) of every slot.  Each (frame, seed) run
//     writes its own slots [gstart, min(gstart + cnt, frame_base +
//     frame_occ, CAP)) directly: no scatter, no cummax.  Slots at or past
//     n_used get zeros and ok false (the plain version zeroes them too).
//   btbs_flat_dedup   <- the unique rank after the one torch.sort of
//     key = row << 32 | anchor (the sort stays a PyTorch call, as the
//     reference's lax.sort is plain jnp): per row, the segment of the sorted
//     keys that holds it (found by binary search), each entry's rank among
//     the row's distinct anchors, keep = unique & rank < Kc, the row's
//     distinct count > Kc into overflow, and the verify lanes (anchor, row,
//     block, read length); n_valid, the count of keys of a row < R.
//   btbs_scatter_back <- the dense (B, F, Kc) grids: score (INF where no
//     kept lane lands or its score is over e), fwd-genome anchor and frame
//     anchor (INVALID there).
//   btbs_select_se    <- select_se: per read over its F x Kc slots the
//     lexicographic least (score, fwd, bp, frame anchor), which is what the
//     staged minima pick, and the least score of a slot in another frame
//     code or more than e from the best's frame anchor.
//
// n_used and n_valid stay on the card (one-element int64 tensors): the FM
// locate kernel and the gathering verify take them as lane counts
// (csrc/fm.cu, csrc/verify.cu) and skip the lanes past them, which is what
// the reference's chunk loop (_chunked_lanes, a lax.while_loop on the
// device) does.  So no host read is left in the device call, and a CUDA
// graph captures it at any flat_chunks (models/graphs.py).
//
// What bounds these on the H100: bytes.  Each is a pass over its inputs and
// outputs with a few integer operations per element: the expansion reads
// the seed intervals (R x S x 24 bytes) and writes 41 bytes per slot; the
// dedup reads 24 bytes per slot and writes 41; the scatter back reads the
// keep byte of each filled slot and 20 bytes of each kept one, and writes
// the grids (20 bytes per cell); the selection needs 4 bytes per cell (the
// score) and the anchors and code of the few cells with a finite score
// (all of a read's cells only where none has one).  At the Gbp SE cell
// that is a few MB per call, a microsecond or two at 3.35 TB/s, so what
// the design keeps down is launches and passes: 5 launches in all for what
// the plain versions run as ~150, each output written once (the grids'
// fill and their scatter by the same warp, ordered by __syncwarp), and no
// intermediate in device memory but the expansion's per-block sums.  The
// selection reads every cell's anchors all the same: a version that read
// the scores first and the anchors of the best-score cells only took the
// same 0.0074 ms at the Gbp SE shape (5.4x the bound; chip_smoke.py on an
// NVIDIA H100 80GB HBM3, 700 W): the bytes do not set its time.
//
// Layout.  The expansion is two launches: a block of kFrames = 64 frames
// sums its frame_occ (expand_totals_kernel), then each block of the second
// (expand_write_kernel, 8 warps) adds up the sums of the blocks before it
// (at most R / 64 of them, from the L2), scans its own frames in shared
// memory, and hands each frame to a warp (8 frames a warp): the warp's
// lanes hold the frame's seeds, rank them by (count, index) with shuffles,
// and write the frame's slots 32 at a time, each slot finding its run among
// at most 32 in shared memory.  (A first design gave a block 256 frames and
// a warp 32 of them: at the Gbp SE shape, 8,192 frames, that is 32 blocks
// on 132 SMs, 0.0419 ms inside, 17x the bytes bound; chip_smoke.py on an
// NVIDIA H100 80GB HBM3, 700 W.)
// The dedup and the scatter back take a warp per row (a row's segment holds
// at most LB entries); the selection a warp per read.
//
// Domain: the port's u32 lanes as int64 in [0, 2^32); scores in [0, INF]
// (INF = 1 << 20); bp codes in [0, 255]; S <= 32 seeds; F a power of two
// up to 8 frames; rows R = B x F below 2^31.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 128;                 // dedup, scatter back, select
constexpr int kFrames = 64;                   // frames per expansion block
constexpr int kExpandThreads = 256;           // threads of a write block
constexpr int kWarps = kExpandThreads / 32;   // its warps, 8 frames each
constexpr int kMaxSeeds = 32;
constexpr int kMaxFrames = 8;
constexpr int32_t kInf = 1 << 20;             // constants.INF_SCORE
constexpr int64_t kMask = 0xFFFFFFFFll;       // ops/u32.MASK
constexpr int64_t kInvalid = 0xFFFFFFFFll;    // ops/u32.INVALID
constexpr unsigned kFull = 0xFFFFFFFFu;

struct ExpandArgs {
  const int64_t* sp;        // [R][S] SA intervals (u32 values)
  const int64_t* ep;
  const int64_t* start;     // [B][F][S] at element strides s0, s1, s2
  int64_t s0, s1, s2;
  const int64_t* lengths;   // [B]
  int64_t B;
  int F, S;
  int64_t max_occ, LB, CAP;
  unsigned block_bits;      // bit f: the block of frame f
  int64_t* block_sums;      // [ceil(R / kFrames)] scratch
  int64_t* sa_row;          // [CAP] outputs
  int64_t* st;
  int64_t* len_b;
  int64_t* fidx;
  int64_t* blk;
  uint8_t* ok;
  int64_t* n_used;          // [1]
  uint8_t* overflow;        // [R]
  uint8_t* gdrop;           // [B]
};

// A seed's kept occurrence count: its interval's width if 0 < width <=
// max_occ, else 0 (u32 width, as the plain version's wrap(ep - sp)).
__device__ __forceinline__ int64_t kept(const ExpandArgs& a, int64_t i) {
  const int64_t c = (a.ep[i] - a.sp[i]) & kMask;
  return c > 0 && c <= a.max_occ ? c : 0;
}

// The frame's kept total over its S seeds.
__device__ __forceinline__ int64_t frame_total(const ExpandArgs& a,
                                               int64_t r) {
  int64_t t = 0;
  for (int s = 0; s < a.S; ++s) t += kept(a, r * a.S + s);
  return t;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum of v over the block (W warps); every thread gets it.
template <int W>
__device__ int64_t block_sum(int64_t v, int64_t* red) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();                   // red may still be read by a prior call
  if (lane == 0) red[w] = v;
  __syncthreads();
  int64_t t = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) t += red[k];
  return t;
}

__global__ void __launch_bounds__(kFrames) expand_totals_kernel(
    ExpandArgs a) {
  __shared__ int64_t red[kFrames / 32];
  const int64_t R = a.B * a.F;
  const int64_t r = int64_t(blockIdx.x) * kFrames + threadIdx.x;
  const int64_t occ = r < R ? min64(frame_total(a, r), a.LB) : 0;
  const int64_t t = block_sum<kFrames / 32>(occ, red);
  if (threadIdx.x == 0) a.block_sums[blockIdx.x] = t;
}

struct Run {
  int64_t cnt, offs, sp, start;
};

__global__ void __launch_bounds__(kExpandThreads) expand_write_kernel(
    ExpandArgs a, int64_t nblk) {
  __shared__ int64_t red[kWarps];
  __shared__ int64_t base_s[kFrames], occ_s[kFrames];
  __shared__ Run runs[kWarps][kMaxSeeds];
  const int64_t R = a.B * a.F;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t r0 = int64_t(blockIdx.x) * kFrames;

  // the slots of the blocks before this one, and of all blocks (n_used)
  int64_t before = 0, all = 0;
  for (int64_t j = threadIdx.x; j < nblk; j += kExpandThreads) {
    const int64_t v = a.block_sums[j];
    all += v;
    if (j < int64_t(blockIdx.x)) before += v;
  }
  before = block_sum<kWarps>(before, red);
  const int64_t n_used = block_sum<kWarps>(all, red);

  // the first kFrames threads' frames: total, frame_occ, overflow; the
  // block's exclusive scan of frame_occ
  const bool mine = threadIdx.x < kFrames;
  const int64_t r = r0 + threadIdx.x;
  int64_t occ = 0;
  if (mine && r < R) {
    const int64_t total = frame_total(a, r);
    occ = min64(total, a.LB);
    a.overflow[r] = total > a.LB;
  }
  int64_t incl = occ;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t x = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += x;
  }
  __syncthreads();
  if (lane == 31) red[w] = incl;
  __syncthreads();
  int64_t warp_before = 0;
  for (int k = 0; k < w; ++k) warp_before += red[k];
  if (mine) {
    base_s[threadIdx.x] = before + warp_before + incl - occ;
    occ_s[threadIdx.x] = occ;
  }
  __syncthreads();

  // gdrop: a read whose frames' slots run past the buffer (its frames lie
  // in this block: kFrames is a multiple of F)
  if (mine && r < R && r % a.F == 0) {
    bool drop = false;
    for (int f = 0; f < a.F; ++f) {
      const int t = threadIdx.x + f;
      drop |= base_s[t] + occ_s[t] > a.CAP && occ_s[t] > 0;
    }
    a.gdrop[r / a.F] = drop;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.n_used = n_used;

  // the slots of each frame, a warp per frame
  Run* run = runs[w];
  for (int i = w; i < kFrames; i += kWarps) {
    const int64_t rf = r0 + i;
    if (rf >= R) break;
    const int64_t focc = occ_s[i], fbase = base_s[i];
    if (focc == 0 || fbase >= a.CAP) continue;
    // lane s holds seed s; its place in the ascending (count, index) order
    int64_t cnt = 0, sp = 0, start = 0;
    if (lane < a.S) {
      const int64_t q = rf * a.S + lane;
      cnt = kept(a, q);
      sp = a.sp[q];
      const int64_t b = rf / a.F, f = rf - b * a.F;
      start = a.start[b * a.s0 + f * a.s1 + lane * a.s2];
    }
    int rank = 0;
    for (int s = 0; s < a.S; ++s) {
      const int64_t c = __shfl_sync(kFull, cnt, s);
      rank += c < cnt || (c == cnt && s < lane);
    }
    __syncwarp();
    if (lane < a.S) run[rank] = Run{cnt, 0, sp, start};
    __syncwarp();
    // exclusive offsets of the sorted runs
    const int64_t c = lane < a.S ? run[lane].cnt : 0;
    int64_t off = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t x = __shfl_up_sync(kFull, off, o);
      if (lane >= o) off += x;
    }
    if (lane < a.S) run[lane].offs = off - c;
    __syncwarp();
    const int64_t b = rf / a.F;
    const int64_t len = a.lengths[b];
    const int64_t bk = (a.block_bits >> (rf - b * a.F)) & 1u;
    for (int64_t j = lane; j < focc; j += 32) {
      const int64_t g = fbase + j;
      if (g >= a.CAP) break;
      int k = 0;                       // the last run starting at or before j
      for (int s = 1; s < a.S; ++s)
        if (run[s].offs <= j) k = s;
      a.sa_row[g] = (run[k].sp + (j - run[k].offs)) & kMask;
      a.st[g] = run[k].start;
      a.len_b[g] = len;
      a.fidx[g] = rf;
      a.blk[g] = bk;
      a.ok[g] = 1;
    }
    __syncwarp();
  }

  // the slots past n_used
  const int64_t stride = int64_t(gridDim.x) * kExpandThreads;
  for (int64_t g = n_used + int64_t(blockIdx.x) * kExpandThreads +
                   threadIdx.x;
       g < a.CAP; g += stride) {
    a.sa_row[g] = 0;
    a.st[g] = 0;
    a.len_b[g] = 0;
    a.fidx[g] = 0;
    a.blk[g] = 0;
    a.ok[g] = 0;
  }
}

// First index in keys[0, n) whose key is >= x (keys ascending).
__device__ __forceinline__ int64_t lower_bound(const int64_t* keys,
                                               int64_t n, int64_t x) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (keys[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The sorted keys [lo, hi) of row r, on every lane of the warp.
__device__ __forceinline__ void row_segment(const int64_t* keys, int64_t n,
                                            int64_t r, int lane, int64_t* lo,
                                            int64_t* hi) {
  int64_t v = 0;
  if (lane < 2) v = lower_bound(keys, n, (r + lane) << 32);
  *lo = __shfl_sync(kFull, v, 0);
  *hi = __shfl_sync(kFull, v, 1);
}

struct DedupArgs {
  const int64_t* keyS;      // [CAP] sorted row << 32 | anchor
  const int64_t* perm;      // [CAP] the sort's permutation
  const int64_t* len_b;     // [CAP] read length per unsorted lane
  const uint8_t* ovf_in;    // [R]
  int64_t CAP, R, Kc;
  int F;
  unsigned block_bits;
  uint8_t* keep;            // [CAP] outputs
  int64_t* rank;
  int64_t* cand;
  int64_t* rowC;
  int64_t* blkS;
  int64_t* lenS;
  uint8_t* ovf_out;         // [R]
  int64_t* n_valid;         // [1]
};

__global__ void __launch_bounds__(kThreads) dedup_kernel(DedupArgs a) {
  __shared__ int64_t valid_s;
  if (threadIdx.x == 0) valid_s = lower_bound(a.keyS, a.CAP, a.R << 32);
  __syncthreads();
  const int64_t n_valid = valid_s;
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.n_valid = n_valid;
  const int lane = threadIdx.x & 31;
  const int64_t tid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nthreads = int64_t(gridDim.x) * kThreads;
  for (int64_t r = tid >> 5; r < a.R; r += nthreads >> 5) {
    int64_t lo, hi;
    row_segment(a.keyS, n_valid, r, lane, &lo, &hi);
    const int64_t bk = (a.block_bits >> (r % a.F)) & 1u;
    int64_t before = 0;                // distinct anchors before the chunk
    for (int64_t i0 = lo; i0 < hi; i0 += 32) {
      const int64_t i = i0 + lane;
      const bool in = i < hi;
      int64_t key = 0;
      bool uniq = false;
      if (in) {
        key = a.keyS[i];
        uniq = i == lo || key != a.keyS[i - 1];
      }
      const unsigned ballot = __ballot_sync(kFull, uniq);
      if (in) {
        const int64_t rk = before + __popc(ballot & ((1u << lane) - 1u));
        const bool kp = uniq && rk < a.Kc;
        a.keep[i] = kp;
        a.rank[i] = rk;
        a.cand[i] = kp ? (key & kMask) : 0;
        a.rowC[i] = r;
        a.blkS[i] = bk;
        a.lenS[i] = a.len_b[a.perm[i]];
      }
      before += __popc(ballot);
    }
    if (lane == 0) a.ovf_out[r] = a.ovf_in[r] | (before > a.Kc);
  }
  // the keys of no row (row R: lanes without an anchor)
  const int64_t last = a.R - 1;
  const int64_t bk = (a.block_bits >> (last % a.F)) & 1u;
  for (int64_t i = n_valid + tid; i < a.CAP; i += nthreads) {
    a.keep[i] = 0;
    a.rank[i] = 0;
    a.cand[i] = 0;
    a.rowC[i] = last;
    a.blkS[i] = bk;
    a.lenS[i] = a.len_b[a.perm[i]];
  }
}

struct BackArgs {
  const int64_t* keyS;      // [CAP]
  const uint8_t* keep;
  const int64_t* rank;
  const int32_t* score;     // [CAP] verify scores of the sorted lanes
  const int64_t* lengths;   // [B]
  int64_t CAP, B, Kc;
  int F;
  unsigned block_bits;
  int64_t genome_len;
  int e;
  int32_t* score_d;         // [B][F][Kc] outputs
  int64_t* fwd;
  int64_t* frame_a;
};

__global__ void __launch_bounds__(kThreads) scatter_back_kernel(BackArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t R = a.B * a.F;
  const int64_t tid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t warps = (int64_t(gridDim.x) * kThreads) >> 5;
  for (int64_t r = tid >> 5; r < R; r += warps) {
    const int64_t base = r * a.Kc;
    for (int64_t k = lane; k < a.Kc; k += 32) {
      a.score_d[base + k] = kInf;
      a.fwd[base + k] = kInvalid;
      a.frame_a[base + k] = kInvalid;
    }
    __syncwarp();                      // the fill lands before the scatter
    int64_t lo, hi;
    row_segment(a.keyS, a.CAP, r, lane, &lo, &hi);
    const int64_t b = r / a.F;
    const bool rev = (a.block_bits >> (r - b * a.F)) & 1u;
    const int64_t len = a.lengths[b];
    for (int64_t i = lo + lane; i < hi; i += 32) {
      if (!a.keep[i]) continue;
      const int32_t s = a.score[i];
      if (s > a.e) continue;
      const int64_t slot = base + a.rank[i];
      const int64_t cand = a.keyS[i] & kMask;
      a.score_d[slot] = s;
      a.frame_a[slot] = cand;
      a.fwd[slot] = rev ? (a.genome_len - cand - len) & kMask : cand;
    }
    __syncwarp();
  }
}

struct SelectArgs {
  const int32_t* score;     // [B][F][Kc]
  const int64_t* fwd;
  const int64_t* frame_a;
  const int64_t* bp;        // [B][F][Kc] at element strides b0, b1, b2
  int64_t b0, b1, b2;
  int64_t B, Kc, e;
  int F;
  int32_t* best_score;      // [B] outputs
  int64_t* best_bp;
  int64_t* best_anchor;
  int32_t* second;
};

__device__ __forceinline__ bool lex_lt(u64 ah, u64 al, u64 bh, u64 bl) {
  return ah < bh || (ah == bh && al < bl);
}

__global__ void __launch_bounds__(kThreads) select_se_kernel(SelectArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t tid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t b = tid >> 5; b < a.B;
       b += (int64_t(gridDim.x) * kThreads) >> 5) {
    const int64_t base = b * a.F * a.Kc;
    // (score, fwd, bp) in one word above the frame anchor
    u64 hi = ~0ull, lo = ~0ull;
    for (int f = 0; f < a.F; ++f) {
      const int64_t row = base + f * a.Kc;
      for (int64_t k = lane; k < a.Kc; k += 32) {
        const u64 h = (u64(uint32_t(a.score[row + k])) << 40) |
                      (u64(uint32_t(a.fwd[row + k])) << 8) |
                      u64(a.bp[b * a.b0 + f * a.b1 + k * a.b2] & 0xFF);
        const u64 l = u64(a.frame_a[row + k]);
        if (lex_lt(h, l, hi, lo)) {
          hi = h;
          lo = l;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const u64 h = __shfl_xor_sync(kFull, hi, o);
      const u64 l = __shfl_xor_sync(kFull, lo, o);
      if (lex_lt(h, l, hi, lo)) {
        hi = h;
        lo = l;
      }
    }
    const int64_t bp_best = int64_t(hi & 0xFF);
    const int64_t fa_best = int64_t(lo);
    int32_t sec = kInf;
    for (int f = 0; f < a.F; ++f) {
      const int64_t row = base + f * a.Kc;
      for (int64_t k = lane; k < a.Kc; k += 32) {
        const int64_t fa = a.frame_a[row + k];
        const int64_t d = fa > fa_best ? fa - fa_best : fa_best - fa;
        if (a.bp[b * a.b0 + f * a.b1 + k * a.b2] != bp_best || d > a.e)
          sec = min(sec, a.score[row + k]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sec = min(sec, __shfl_xor_sync(kFull, sec, o));
    if (lane == 0) {
      a.best_score[b] = int32_t(hi >> 40);
      a.best_bp[b] = bp_best;
      a.best_anchor[b] = fa_best;
      a.second[b] = sec;
    }
  }
}

// Blocks for a warp per item over n items (at least one block, at most
// 2^20; the kernels loop past it).
unsigned warp_grid(int64_t n) {
  const int64_t blocks = (n * 32 + kThreads - 1) / kThreads;
  return unsigned(blocks < 1 ? 1 : (blocks > (1 << 20) ? (1 << 20) : blocks));
}

bool frames_ok(int F) {
  return F >= 1 && F <= kMaxFrames && (F & (F - 1)) == 0;
}

}  // namespace

extern "C" {

// Every function returns the cudaError_t of its launches (0 = launched);
// arguments it does not take give cudaErrorInvalidValue.  int64 tensors
// are contiguous unless strides are given; bool tensors are one byte.

// sp, ep int64 [B][F][S]; start int64 [B][F][S] at element strides s0, s1,
// s2; lengths int64 [B]; block_bits: bit f is frame f's block; block_sums
// int64 [ceil(B * F / 64)] scratch; outputs sa_row, st, len_b, fidx, blk
// int64 [CAP], ok bool [CAP], n_used int64 [1], overflow bool [B][F],
// gdrop bool [B].
int btbs_flat_expand(const void* sp, const void* ep, const void* start,
                     int64_t s0, int64_t s1, int64_t s2, const void* lengths,
                     int64_t B, int F, int S, int64_t max_occ, int64_t LB,
                     int64_t CAP, int block_bits, void* block_sums,
                     void* sa_row, void* st, void* len_b, void* fidx,
                     void* blk, void* ok, void* n_used, void* overflow,
                     void* gdrop, void* stream) {
  if (B < 1 || !frames_ok(F) || S < 1 || S > kMaxSeeds || max_occ < 0 ||
      LB < 0 || CAP < 1 || B * F > 0x7FFFFFFFll)
    return int(cudaErrorInvalidValue);
  ExpandArgs a;
  a.sp = static_cast<const int64_t*>(sp);
  a.ep = static_cast<const int64_t*>(ep);
  a.start = static_cast<const int64_t*>(start);
  a.s0 = s0;
  a.s1 = s1;
  a.s2 = s2;
  a.lengths = static_cast<const int64_t*>(lengths);
  a.B = B;
  a.F = F;
  a.S = S;
  a.max_occ = max_occ;
  a.LB = LB;
  a.CAP = CAP;
  a.block_bits = unsigned(block_bits);
  a.block_sums = static_cast<int64_t*>(block_sums);
  a.sa_row = static_cast<int64_t*>(sa_row);
  a.st = static_cast<int64_t*>(st);
  a.len_b = static_cast<int64_t*>(len_b);
  a.fidx = static_cast<int64_t*>(fidx);
  a.blk = static_cast<int64_t*>(blk);
  a.ok = static_cast<uint8_t*>(ok);
  a.n_used = static_cast<int64_t*>(n_used);
  a.overflow = static_cast<uint8_t*>(overflow);
  a.gdrop = static_cast<uint8_t*>(gdrop);
  const int64_t nblk = (B * F + kFrames - 1) / kFrames;
  auto st_ = static_cast<cudaStream_t>(stream);
  expand_totals_kernel<<<unsigned(nblk), kFrames, 0, st_>>>(a);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return int(rc);
  expand_write_kernel<<<unsigned(nblk), kExpandThreads, 0, st_>>>(a, nblk);
  return int(cudaGetLastError());
}

// keyS, perm, len_b int64 [CAP]; ovf_in bool [R] (R = B * F); outputs keep
// bool [CAP], rank, cand, rowC, blkS, lenS int64 [CAP], ovf_out bool [R],
// n_valid int64 [1].
int btbs_flat_dedup(const void* keyS, const void* perm, const void* len_b,
                    const void* ovf_in, int64_t CAP, int64_t R, int F,
                    int block_bits, int64_t Kc, void* keep, void* rank,
                    void* cand, void* rowC, void* blkS, void* lenS,
                    void* ovf_out, void* n_valid, void* stream) {
  if (CAP < 1 || R < 1 || R > 0x7FFFFFFFll || !frames_ok(F) || R % F ||
      Kc < 1)
    return int(cudaErrorInvalidValue);
  DedupArgs a;
  a.keyS = static_cast<const int64_t*>(keyS);
  a.perm = static_cast<const int64_t*>(perm);
  a.len_b = static_cast<const int64_t*>(len_b);
  a.ovf_in = static_cast<const uint8_t*>(ovf_in);
  a.CAP = CAP;
  a.R = R;
  a.Kc = Kc;
  a.F = F;
  a.block_bits = unsigned(block_bits);
  a.keep = static_cast<uint8_t*>(keep);
  a.rank = static_cast<int64_t*>(rank);
  a.cand = static_cast<int64_t*>(cand);
  a.rowC = static_cast<int64_t*>(rowC);
  a.blkS = static_cast<int64_t*>(blkS);
  a.lenS = static_cast<int64_t*>(lenS);
  a.ovf_out = static_cast<uint8_t*>(ovf_out);
  a.n_valid = static_cast<int64_t*>(n_valid);
  const int64_t n = R > (CAP + 31) / 32 ? R : (CAP + 31) / 32;
  dedup_kernel<<<warp_grid(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

// keyS, rank int64 [CAP], keep bool [CAP], score int32 [CAP], lengths
// int64 [B]; outputs score_d int32, fwd and frame_a int64 [B][F][Kc].
int btbs_scatter_back(const void* keyS, const void* keep, const void* rank,
                      const void* score, const void* lengths, int64_t CAP,
                      int64_t B, int F, int64_t Kc, int block_bits,
                      int64_t genome_len, int e, void* score_d, void* fwd,
                      void* frame_a, void* stream) {
  if (CAP < 1 || B < 1 || !frames_ok(F) || B * F > 0x7FFFFFFFll || Kc < 1 ||
      genome_len < 0 || genome_len > kMask || e < 0)
    return int(cudaErrorInvalidValue);
  BackArgs a;
  a.keyS = static_cast<const int64_t*>(keyS);
  a.keep = static_cast<const uint8_t*>(keep);
  a.rank = static_cast<const int64_t*>(rank);
  a.score = static_cast<const int32_t*>(score);
  a.lengths = static_cast<const int64_t*>(lengths);
  a.CAP = CAP;
  a.B = B;
  a.Kc = Kc;
  a.F = F;
  a.block_bits = unsigned(block_bits);
  a.genome_len = genome_len;
  a.e = e;
  a.score_d = static_cast<int32_t*>(score_d);
  a.fwd = static_cast<int64_t*>(fwd);
  a.frame_a = static_cast<int64_t*>(frame_a);
  scatter_back_kernel<<<warp_grid(B * F), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

// score int32, fwd and frame_a int64 [B][F][Kc]; bp int64 [B][F][Kc] at
// element strides b0, b1, b2; outputs best_score, second int32 [B],
// best_bp, best_anchor int64 [B].
int btbs_select_se(const void* score, const void* fwd, const void* frame_a,
                   const void* bp, int64_t b0, int64_t b1, int64_t b2,
                   int64_t B, int F, int64_t Kc, int64_t e, void* best_score,
                   void* best_bp, void* best_anchor, void* second,
                   void* stream) {
  if (B < 1 || F < 1 || Kc < 1 || e < 0) return int(cudaErrorInvalidValue);
  SelectArgs a;
  a.score = static_cast<const int32_t*>(score);
  a.fwd = static_cast<const int64_t*>(fwd);
  a.frame_a = static_cast<const int64_t*>(frame_a);
  a.bp = static_cast<const int64_t*>(bp);
  a.b0 = b0;
  a.b1 = b1;
  a.b2 = b2;
  a.B = B;
  a.Kc = Kc;
  a.e = e;
  a.F = F;
  a.best_score = static_cast<int32_t*>(best_score);
  a.best_bp = static_cast<int64_t*>(best_bp);
  a.best_anchor = static_cast<int64_t*>(best_anchor);
  a.second = static_cast<int32_t*>(second);
  select_se_kernel<<<warp_grid(B), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
