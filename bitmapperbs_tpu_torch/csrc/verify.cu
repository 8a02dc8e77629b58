// Candidate verification kernels for Hopper (sm_90a), bound with ctypes by
// bitmapperbs_tpu_torch/ops/kernels.py.
//
// btbs_verify_fused_gather replaces bitmapperbs_tpu/ops/pallas_kernels.py
//   _fused_verify_kernel (wrapper verify_fused_pallas) together with the
//   window gather in front of it (bitmapperbs_tpu/ops/verify.py
//   window_planes, as bitmapperbs_tpu/models/aligner.py
//   candidate_grids_compact calls it): it takes what the compact path holds
//   before any plane exists (the packed genome planes, per lane an
//   orientation, a u32 window start, a row of the read-plane table and a read
//   length) and does the window fetch, the start & 31 funnel, the
//   out-of-range -> N marking (wrapped-negative starts and windows past the
//   genome end included) and the length mask in registers.
//   It may take a lane count on the card (n_lanes: the compact path's
//   n_valid, csrc/flat.cu btbs_flat_dedup): a lane at or past it writes INF
//   and loads nothing, as the reference's chunk loop leaves the lanes past
//   the sorted buffer's valid front (bitmapperbs_tpu/models/aligner.py:
//   294-330, _chunked_lanes).
// btbs_myers replaces pallas_kernels.py _myers_kernel (wrapper myers_pallas):
//   the same Myers recurrence from a precomputed PEQ table and pad rows
//   (N columns take the pad row); out = min over the ncols end columns.
// btbs_rescue_scan replaces pallas_kernels.py _myers_scan_kernel (wrapper
//   myers_scan_pallas) together with what stands around it in paired-end
//   mate rescue (bitmapperbs_tpu/models/paired.py lines 206-238: the window
//   gather before the scan, and after it the selection of the best score,
//   its lowest frame position and the best score more than e away).  It
//   takes what the path holds before any plane exists and returns the three
//   lanes the path needs; see the note above rescue_scan_kernel.
//
// Layout of btbs_myers: one thread per lane; each lane's words are
// contiguous int32 bits (lane-major, as the port's tensors come): win
// [L][3][Ww], peq [L][4][Wd], pad [L][Wd]; out int32 [L].
//
// What bounds it on the H100: the column loop is serial per lane (ncols
// steps of ~10 * Wd integer ops) and the state (VP, VN, PEQ, pad: 7 * Wd
// words) must stay in registers.  Compute, not bytes: a lane reads
// (3 Ww + 5 Wd) words once and writes one word.  The design keeps the whole
// state in registers by instantiating the word count WD = 1..8 at compile
// time (reads up to 256 bp) so every word loop unrolls; a runtime-Wd
// instantiation with local arrays covers buckets up to 1024 bp.  btbs_myers
// reads lane-major rows, one thread per row, so its loads do not coalesce.
//
// The gathering entry is bound the same way (operations: the Myers columns
// of the lanes whose Hamming count does not decide them; it skips the loop
// for the others) and removes what stood between it and that bound on the
// compact path: ~20 MB of int64 plane intermediates per 163,840-lane batch
// written and re-read through device memory by some thirty small tensor
// ops, three concatenate /
// narrow / copy passes to build the lane-major rows, and warps that ran all
// ncols columns with most of their threads idle because the lanes with
// ham > e are scattered.  A lane needs 12 (Wd + 2) contiguous bytes of genome
// planes: each thread fetches them as whole words into registers.  After the
// Hamming pass the block compacts the lanes that need Myers (warp ballot,
// popcount prefix over the block's warps) into a shared-memory staging
// area, one padded row per lane so rows fall on different banks; the first
// `count` threads then run the column loop on full warps and the other
// warps leave.  The staging area holds 7 Wd + 3 words per thread, so it
// serves the compile-time word counts 1..8 (reads up to 256 bp).  Longer
// buckets (9..32 read words) take verify_fused_gather_wide_kernel: one
// thread would hold 7 * 32 words of state and walk a column as a serial
// chain of up to 32 add-with-carries, on a card that few such threads fill.
// There a lane runs on a group of threads of a warp, each holding a few
// words of the state; a column's carry crosses the group by two warp votes
// and one add on their bits (carry lookahead), its hp / hn top bits by one
// shuffle.  Window words are fetched from the genome planes as the
// Hamming words and the Myers columns advance (WindowReader), never held
// whole, and the compaction moves lane indices only: a compacted group
// fetches its lane's planes and read planes again (they are in the L2).
//
// On a sharded index (index/device.upload_index_sharded) the genome planes
// are split into row ranges over the cards of an index group.  The gathering
// entries (both verify kernels and the rescue scan) have a SHARD instance
// for that case (csrc/shards.cuh): the row is clamped into its orientation's
// block as before (ops/verify.window_planes), then read from the shard that
// holds it instead of the whole table, so a sharded batch launches the same
// kernels as one card.  Only the plane-row fetch differs between the
// instances: the inline fetch of verify_fused_gather_kernel and
// WindowReader::load_row.
#include <cstdint>
#include <cuda_runtime.h>

#include <type_traits>

#include "shards.cuh"
#include "smem.cuh"

namespace {

constexpr int kMaxWords = 32;   // MAX_READ_LEN 1024 / 32
constexpr int kThreads = 128;
constexpr int kInfScore = 1 << 20;           // constants.INF_SCORE

// The lanes a gathering verify runs: all L, or the first *n_lanes (an
// int64 count on the card, the flat buffer's n_valid) where one is given.
__device__ __forceinline__ int64_t lane_count(const int64_t* n_lanes,
                                              int64_t L) {
  if (!n_lanes) return L;
  const int64_t n = *n_lanes;
  return n < L ? n : L;
}

// One column of the multi-word Myers recurrence (the step every kernel
// here shares): updates VP/VN in place and returns the change of the score
// at the last row (+1, 0 or -1).  c0/c1: the column's 2-bit base code;
// isn: N column (takes the pad row).
// NW: register array capacity (== wd when WD is a compile-time constant).
template <int NW>
__device__ __forceinline__ int myers_column(
    uint32_t (&vp)[NW], uint32_t (&vn)[NW], const uint32_t (&peq)[4][NW],
    const uint32_t (&pad)[NW], int wd, bool c0, bool c1, bool isn) {
  uint32_t carry = 0u, hp_prev = 0u, hn_prev = 0u, hp_top = 0u, hn_top = 0u;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    if (k < wd) {
      // selects, not a dynamic index: keeps the PEQ table in registers
      const uint32_t sym = c1 ? (c0 ? peq[3][k] : peq[2][k])
                              : (c0 ? peq[1][k] : peq[0][k]);
      const uint32_t eq = isn ? pad[k] : sym;
      const uint32_t v = vp[k];
      // D0 = (((eq & vp) + vp) ^ vp) | eq | vn, carry across words
      const uint64_t s = uint64_t(eq & v) + v + carry;
      carry = uint32_t(s >> 32);
      const uint32_t d0 = (uint32_t(s) ^ v) | eq | vn[k];
      const uint32_t hp = vn[k] | ~(d0 | v);
      const uint32_t hn = v & d0;
      // shift-in 0 at word 0: free start (D[0][j] = 0)
      const uint32_t x = (hp << 1) | (hp_prev >> 31);
      vp[k] = ((hn << 1) | (hn_prev >> 31)) | ~(d0 | x);
      vn[k] = d0 & x;
      hp_prev = hp;
      hn_prev = hn;
      hp_top = hp;
      hn_top = hn;
    }
  }
  return int(hp_top >> 31) - int(hn_top >> 31);
}

// Semi-global Myers over ncols columns of one lane's window planes:
// emit(j, score) after column j, score starting at m.
template <int NW, typename Emit>
__device__ __forceinline__ void myers_run(
    const uint32_t* __restrict__ w0, const uint32_t* __restrict__ w1,
    const uint32_t* __restrict__ wn, const uint32_t (&peq)[4][NW],
    const uint32_t (&pad)[NW], int wd, int m, int ncols, Emit emit) {
  uint32_t vp[NW], vn[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    if (k < wd) { vp[k] = 0xFFFFFFFFu; vn[k] = 0u; }
  }
  int score = m;
  for (int j0 = 0; j0 < ncols; j0 += 32) {
    const int wi = j0 >> 5;
    const uint32_t a0 = w0[wi], a1 = w1[wi], an = wn[wi];
    const int nb = min(32, ncols - j0);
    for (int b = 0; b < nb; ++b) {
      score += myers_column<NW>(vp, vn, peq, pad, wd, (a0 >> b) & 1u,
                                (a1 >> b) & 1u, (an >> b) & 1u);
      emit(j0 + b, score);
    }
  }
}

template <int NW>
__device__ __forceinline__ int myers_min(
    const uint32_t* __restrict__ w0, const uint32_t* __restrict__ w1,
    const uint32_t* __restrict__ wn, const uint32_t (&peq)[4][NW],
    const uint32_t (&pad)[NW], int wd, int m, int ncols) {
  int best = m;
  myers_run<NW>(w0, w1, wn, peq, pad, wd, m, ncols,
                [&](int, int score) { best = min(best, score); });
  return best;
}

// A lane's precomputed PEQ [4][wd] and pad [wd] words into registers.
template <int NW>
__device__ __forceinline__ void load_peq(
    const uint32_t* __restrict__ pq, const uint32_t* __restrict__ pd, int wd,
    uint32_t (&peq)[4][NW], uint32_t (&pad)[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    if (k < wd) {
      pad[k] = pd[k];
#pragma unroll
      for (int c = 0; c < 4; ++c) peq[c][k] = pq[c * wd + k];
    }
  }
}

__device__ __forceinline__ uint32_t funnel(const uint32_t* p, int k, int e) {
  return e == 0 ? p[k] : (p[k] >> e) | (p[k + 1] << (32 - e));
}

// bits [0, nb) for nb in [0, 32]
__device__ __forceinline__ uint32_t mask_lt(uint32_t nb) {
  return nb >= 32u ? 0xFFFFFFFFu : ((1u << nb) - 1u);
}

// Bits of the window word whose first position is u32 `ws` that lie outside
// [0, genome_len): below 0 when ws has wrapped, at or past the genome end.
__device__ __forceinline__ uint32_t out_of_genome(uint32_t ws,
                                                  int64_t genome_len) {
  if (ws >= 0xFFFFF000u) {                               // wrapped below 0
    const uint32_t neg = 0u - ws;
    return mask_lt(neg < 32u ? neg : 32u);
  }
  if (int64_t(ws) >= genome_len) return 0xFFFFFFFFu;
  const int64_t left = genome_len - int64_t(ws);
  return ~mask_lt(left < 32 ? uint32_t(left) : 32u);
}

// The genome-plane row r of the orientation block that starts at row `base`
// (r clamped into the block first, as ops/verify.window_planes clamps): in
// a whole table [2 * gwords][3] clamped into it, as btbs_gather_rows clamps;
// in a shard set (the kernel's parameter, taken by reference) a zero row
// outside every shard.
__device__ __forceinline__ const uint32_t* plane_row(const uint32_t* gp,
                                                     int64_t base, int64_t r,
                                                     int64_t gwords) {
  r = base + (r >= gwords ? gwords - 1 : r);
  r = r < 0 ? 0 : (r >= 2 * gwords ? 2 * gwords - 1 : r);
  return gp + r * 3;
}

__device__ __forceinline__ const uint32_t* plane_row(const ShardSet& gp,
                                                     int64_t base, int64_t r,
                                                     int64_t gwords) {
  r = base + (r >= gwords ? gwords - 1 : r);
  return shard_row<3>(gp, r);
}

// The gathering entry: one thread per lane through the window fetch and the
// Hamming pass, then the block's ham > e lanes compacted onto its first
// threads for the Myers loop.  WD: compile-time word count; the window is
// WD + 1 words.  SHARD: the genome planes are a shard set.
template <int WD, bool SHARD>
__global__ void __launch_bounds__(kThreads) verify_fused_gather_kernel(
    typename Table<SHARD>::param gp, const int64_t* __restrict__ orient,
    const int64_t* __restrict__ start, const int64_t* __restrict__ rtab,
    const int64_t* __restrict__ rrow, const int64_t* __restrict__ rlen,
    const int64_t* __restrict__ n_lanes, int32_t* __restrict__ out,
    int64_t L, int64_t R, int64_t gwords, int64_t genome_len, int m,
    int ncols, int e) {
  constexpr int WW = WD + 1;
  constexpr int NS = (3 * WW + 4 * WD) | 1;    // odd row stride: no bank clash
  __shared__ uint32_t stage[kThreads][NS];
  __shared__ int slot_thread[kThreads];
  __shared__ int warp_count[kThreads / 32];
  const int64_t lane = int64_t(blockIdx.x) * kThreads + threadIdx.x;

  uint32_t w0[WW], w1[WW], wn[WW], d0[WD], d1[WD], dn[WD], lmask[WD];
  bool need = false;
  const int64_t n = lane_count(n_lanes, L);
  if (lane >= n && lane < L) out[lane] = kInfScore;
  if (lane < n) {
    // window planes at `start` (ops/verify.window_planes): rows
    // (start + 32) >> 5 .. + WW of the orientation's plane block, funnelled
    // by start & 31, positions outside [0, genome_len) turned into N
    const uint32_t st = uint32_t(start[lane]);
    const uint32_t sh = st & 31u;
    const int64_t wi = int64_t((st + 32u) >> 5);         // u32 add: wraps below 0
    const int64_t base = orient[lane] * gwords;
    uint32_t raw[3][WW + 1];
#pragma unroll
    for (int k = 0; k <= WW; ++k) {
      const uint32_t* q = plane_row(gp, base, wi + k, gwords);
      raw[0][k] = q[0];
      raw[1][k] = q[1];
      raw[2][k] = q[2];
    }
#pragma unroll
    for (int k = 0; k < WW; ++k) {
      uint32_t a0 = raw[0][k], a1 = raw[1][k], an = raw[2][k];
      if (sh != 0u) {
        a0 = (a0 >> sh) | (raw[0][k + 1] << (32u - sh));
        a1 = (a1 >> sh) | (raw[1][k + 1] << (32u - sh));
        an = (an >> sh) | (raw[2][k + 1] << (32u - sh));
      }
      const uint32_t oob = out_of_genome(st + 32u * uint32_t(k), genome_len);
      w0[k] = a0 & ~oob;
      w1[k] = a1 & ~oob;
      wn[k] = an | oob;
    }
    // the lane's read planes and length mask
    int64_t rr = rrow[lane];
    rr = rr < 0 ? 0 : (rr >= R ? R - 1 : rr);
    const int64_t* rp = rtab + rr * 3 * WD;
    const int64_t len = rlen[lane];
    int ham = 0;
#pragma unroll
    for (int k = 0; k < WD; ++k) {
      d0[k] = uint32_t(rp[k]);
      d1[k] = uint32_t(rp[WD + k]);
      dn[k] = uint32_t(rp[2 * WD + k]);
      const int64_t nb = len - 32 * k;
      lmask[k] = mask_lt(nb <= 0 ? 0u : (nb >= 32 ? 32u : uint32_t(nb)));
      // anchored Hamming from the e-shifted window
      const uint32_t a0 = funnel(w0, k, e), a1 = funnel(w1, k, e),
                     an = funnel(wn, k, e);
      const uint32_t eqb = ~(a0 ^ d0[k]) & ~(a1 ^ d1[k]);
      const uint32_t match =
          (eqb | ((a0 & ~a1) & (d0[k] & d1[k]))) & ~an & ~dn[k];
      ham += __popc(~match & lmask[k]);
    }
    need = ham > e;
    if (!need) out[lane] = ham;
  }

  // compact the lanes that need Myers onto the block's first threads
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, need);
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31;
  if (lid == 0) warp_count[wid] = __popc(ballot);
  __syncthreads();
  int before = 0, count = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < wid) before += warp_count[w];
    count += warp_count[w];
  }
  if (need) {
    const int slot = before + __popc(ballot & ((1u << lid) - 1u));
    uint32_t* s = stage[slot];
#pragma unroll
    for (int k = 0; k < WW; ++k) {
      s[k] = w0[k];
      s[WW + k] = w1[k];
      s[2 * WW + k] = wn[k];
    }
#pragma unroll
    for (int k = 0; k < WD; ++k) {
      s[3 * WW + k] = d0[k];
      s[3 * WW + WD + k] = d1[k];
      s[3 * WW + 2 * WD + k] = dn[k];
      s[3 * WW + 3 * WD + k] = lmask[k];
    }
    slot_thread[slot] = threadIdx.x;
  }
  __syncthreads();
  if (int(threadIdx.x) >= count) return;

  // PEQ from the staged read planes (asymmetric match; pad rows always
  // match), window words read from the staging row as the columns advance
  const uint32_t* s = stage[threadIdx.x];
  uint32_t peq[4][WD], pad[WD];
#pragma unroll
  for (int k = 0; k < WD; ++k) {
    const uint32_t r0 = s[3 * WW + k], r1 = s[3 * WW + WD + k],
                   rn = s[3 * WW + 2 * WD + k];
    const uint32_t p = ~s[3 * WW + 3 * WD + k];
    pad[k] = p;
    peq[0][k] = (~r0 & ~r1 & ~rn) | p;
    peq[1][k] = ((r0 & ~r1 & ~rn) | (r0 & r1 & ~rn)) | p;
    peq[2][k] = (~r0 & r1 & ~rn) | p;
    peq[3][k] = (r0 & r1 & ~rn) | p;
  }
  out[int64_t(blockIdx.x) * kThreads + slot_thread[threadIdx.x]] =
      myers_min<WD>(s, s + WW, s + 2 * WW, peq, pad, WD, m, ncols);
}

// Window words fetched as they are needed: word k covers the positions
// [start + 32 k, start + 32 k + 32) of one orientation, with the semantics of
// ops/verify.window_planes (rows ((start + 32) >> 5) + k and + k + 1 of the
// orientation's plane block, clamped into it; funnel by start & 31;
// positions outside [0, genome_len) and wrapped-negative starts marked N).
// Keeps the upper raw row of a word as the lower row of the next.  Every
// call takes the genome planes (G: a whole table's pointer, or the kernel's
// shard-set parameter), which the reader does not keep.
struct WindowReader {
  int64_t base, gwords, genome_len, wi;
  uint32_t st, sh;
  int k;
  uint32_t r0, r1, rn;                       // raw row wi + k

  template <typename G>
  __device__ __forceinline__ void load_row(const G& gp, int64_t r,
                                           uint32_t& x0, uint32_t& x1,
                                           uint32_t& xn) const {
    const uint32_t* q = plane_row(gp, base, r, gwords);
    x0 = q[0];
    x1 = q[1];
    xn = q[2];
  }

  // the next call of next() returns word k0
  template <typename G>
  __device__ __forceinline__ void init(const G& gp, int64_t orient,
                                       uint32_t start, int64_t gw,
                                       int64_t glen, int k0) {
    gwords = gw;
    genome_len = glen;
    base = orient * gw;
    st = start;
    sh = start & 31u;
    wi = int64_t((start + 32u) >> 5);        // u32 add: wraps below 0
    k = k0;
    load_row(gp, wi + k0, r0, r1, rn);
  }

  template <typename G>
  __device__ __forceinline__ void next(const G& gp, uint32_t& a0,
                                       uint32_t& a1, uint32_t& an) {
    uint32_t h0, h1, hn;
    load_row(gp, wi + k + 1, h0, h1, hn);
    a0 = r0;
    a1 = r1;
    an = rn;
    if (sh != 0u) {
      a0 = (a0 >> sh) | (h0 << (32u - sh));
      a1 = (a1 >> sh) | (h1 << (32u - sh));
      an = (an >> sh) | (hn << (32u - sh));
    }
    const uint32_t oob = out_of_genome(st + 32u * uint32_t(k), genome_len);
    a0 &= ~oob;
    a1 &= ~oob;
    an |= oob;
    r0 = h0;
    r1 = h1;
    rn = hn;
    ++k;
  }
};

// myers_column with the column's match row read from shared memory: eqrow
// points at word 0 of the row the column's symbol selects (PEQ rows 0..3, the
// pad row 4 for an N column) in this thread's column of a [5][NW][kThreads]
// table, so word k is eqrow[k * kThreads].
template <int NW>
__device__ __forceinline__ int myers_column_shared(
    uint32_t (&vp)[NW], uint32_t (&vn)[NW], const uint32_t* eqrow, int wd) {
  uint32_t carry = 0u, hp_prev = 0u, hn_prev = 0u, hp_top = 0u, hn_top = 0u;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    if (k < wd) {
      const uint32_t eq = eqrow[k * kThreads];
      const uint32_t v = vp[k];
      const uint64_t s = uint64_t(eq & v) + v + carry;
      carry = uint32_t(s >> 32);
      const uint32_t d0 = (uint32_t(s) ^ v) | eq | vn[k];
      const uint32_t hp = vn[k] | ~(d0 | v);
      const uint32_t hn = v & d0;
      const uint32_t x = (hp << 1) | (hp_prev >> 31);
      vp[k] = ((hn << 1) | (hn_prev >> 31)) | ~(d0 | x);
      vn[k] = d0 & x;
      hp_prev = hp;
      hn_prev = hn;
      hp_top = hp;
      hn_top = hn;
    }
  }
  return int(hp_top >> 31) - int(hn_top >> 31);
}

// This thread's column of the shared [5][NW][kThreads] match table from one
// set of read-plane words (PEQ rows 0..3) and the pad row (4).
__device__ __forceinline__ void store_eq_column(
    uint32_t* col, int nw, int k, uint32_t a, uint32_t c, uint32_t g,
    uint32_t t, uint32_t pad) {
  col[k * kThreads] = a;
  col[(nw + k) * kThreads] = c;
  col[(2 * nw + k) * kThreads] = g;
  col[(3 * nw + k) * kThreads] = t;
  col[(4 * nw + k) * kThreads] = pad;
}

// The gathering entry for 9..32 read words (see the note at the top).  A lane
// runs on a group of T = ceil(wd / K) consecutive threads of a warp; each
// thread holds K read words (K compile-time; the caller picks it per bucket,
// kernels.WIDE_WORDS) of VP and VN in registers, and of the four PEQ rows
// and the pad row in its own column of a shared table.  The words are
// aligned at the top: thread t holds words wd - T K + t K + j (j < K), so
// word wd - 1, whose top bit is the last row, is always thread T - 1's last
// word.  The words below 0 (in thread 0 only) match nothing (eq = 0) and
// start at vp = ~0, vn = 0, which a column leaves as they are with no carry
// and no hp / hn bit out: they never touch the words above.  A warp holds
// floor(32 / T) groups; its spare threads run along as a group without a
// lane.  T is not held to a power of two: at the 288 bucket (9 words) a
// group of 4 threads of 3 words would idle a quarter of its threads on every
// column.
//
// A column's add is one carry chain over the lane's words; the group cuts it
// at its threads.  Each thread adds its K words with carry in 0 and ballots
// whether its block generates a carry out (g) and whether it carries out or
// propagates one (g | p; p: the sum is all ones).  With A the g bits from
// the group's first thread up and B the g | p bits, the carry into thread
// t's first word is bit t of (A + B) ^ A ^ B (no carry can start below the
// group, where A is 0, and the groups above cannot reach down); the thread
// adds it in.  The top bits of hp / hn cross to the next thread's first
// word by one __shfl_up_sync, and the last thread keeps the score and its
// minimum.  Every vote and shuffle takes the whole warp: groups of one warp
// that each synced on their own mask would run one after another.
//
// A block takes one lane per group: the Hamming pass (each thread its own
// words, then a shuffle sum), then the lanes with ham > e compacted in
// shared memory onto the block's first groups, which run Myers; a warp runs
// while any of its groups has a lane (the others run its first lane again
// and store nothing), the warps past the last lane leave.  Every thread of
// a group streams the same window words through WindowReader (one load per
// warp and word), the Hamming pass from its own first word on.
template <int K, bool SHARD>
__global__ void __launch_bounds__(kThreads) verify_fused_gather_wide_kernel(
    typename Table<SHARD>::param gp, const int64_t* __restrict__ orient,
    const int64_t* __restrict__ start, const int64_t* __restrict__ rtab,
    const int64_t* __restrict__ rrow, const int64_t* __restrict__ rlen,
    const int64_t* __restrict__ n_lanes, int32_t* __restrict__ out,
    int64_t L, int64_t R, int64_t gwords, int64_t genome_len, int wd, int m,
    int ncols, int e) {
  static_assert(5 * K * kThreads * 4 + 4 * kThreads + 4 <= 48 * 1024,
                "the match table outgrows a block's static shared memory");
  __shared__ uint32_t eq_table[5 * K * kThreads];   // [5][K][kThreads]
  __shared__ int need_slot[kThreads];
  __shared__ int n_need;
  const int T = (wd + K - 1) / K;            // threads per lane
  const int per_warp = 32 / T;               // groups per warp
  const int G = (kThreads / 32) * per_warp;  // groups (lanes) per block
  const int lid = threadIdx.x & 31;
  const int q = lid / T, t = lid - q * T;    // group in the warp, thread in it
  const bool spare = q >= per_warp;
  const int grp = (threadIdx.x >> 5) * per_warp + q;
  const unsigned above = 0xFFFFFFFFu << (lid - t);
  const int k0 = wd - T * K + t * K;         // this thread's first word
  const int64_t first = int64_t(blockIdx.x) * G;
  if (threadIdx.x == 0) n_need = 0;
  __syncthreads();

  // anchored Hamming from the e-shifted window: each thread its words
  {
    const int64_t lane = first + grp;
    const int64_t n = lane_count(n_lanes, L);
    const bool live = !spare && lane < n;
    if (!spare && lane >= n && lane < L && t == 0) out[lane] = kInfScore;
    int ham = 0;
    if (live) {
      int64_t rr = rrow[lane];
      rr = rr < 0 ? 0 : (rr >= R ? R - 1 : rr);
      const int64_t* rp = rtab + rr * 3 * wd;
      const int64_t len = rlen[lane];
      WindowReader win;
      win.init(gp, orient[lane], uint32_t(start[lane]), gwords, genome_len,
               max(k0, 0));
      uint32_t c0, c1, cn;
      win.next(gp, c0, c1, cn);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int k = k0 + j;
        if (k >= 0) {
          uint32_t n0, n1, nn;
          win.next(gp, n0, n1, nn);
          const uint32_t a0 = e == 0 ? c0 : (c0 >> e) | (n0 << (32 - e));
          const uint32_t a1 = e == 0 ? c1 : (c1 >> e) | (n1 << (32 - e));
          const uint32_t an = e == 0 ? cn : (cn >> e) | (nn << (32 - e));
          const uint32_t d0 = uint32_t(rp[k]), d1 = uint32_t(rp[wd + k]),
                         dn = uint32_t(rp[2 * wd + k]);
          const int64_t nb = len - 32 * k;
          const uint32_t lmask =
              mask_lt(nb <= 0 ? 0u : (nb >= 32 ? 32u : uint32_t(nb)));
          const uint32_t eqb = ~(a0 ^ d0) & ~(a1 ^ d1);
          const uint32_t match = (eqb | ((a0 & ~a1) & (d0 & d1))) & ~an & ~dn;
          ham += __popc(~match & lmask);
          c0 = n0;
          c1 = n1;
          cn = nn;
        }
      }
    }
    // the group's sum on its first thread
    for (int d = 1; d < T; d <<= 1) {
      const int x = __shfl_down_sync(0xFFFFFFFFu, ham, d);
      if (t + d < T) ham += x;
    }
    if (live && t == 0) {
      if (ham <= e)
        out[lane] = ham;
      else
        need_slot[atomicAdd(&n_need, 1)] = grp;
    }
  }
  __syncthreads();
  const int count = n_need;
  const int wfirst = (threadIdx.x >> 5) * per_warp;
  if (wfirst >= count) return;               // the whole warp: no lane left

  // the lanes that need Myers, one per group
  const bool has = !spare && grp < count;
  const int64_t lane = first + need_slot[has ? grp : wfirst];
  uint32_t* eqt = eq_table + threadIdx.x;    // this thread's column
  // this thread's words of the match table: PEQ rows 0..3 from the read
  // planes (asymmetric match; pad rows always match), the pad row 4; all
  // zero below word 0
  uint32_t vp[K], vn[K];
  {
    int64_t rr = rrow[lane];
    rr = rr < 0 ? 0 : (rr >= R ? R - 1 : rr);
    const int64_t* rp = rtab + rr * 3 * wd;
    const int64_t len = rlen[lane];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = k0 + j;
      uint32_t r0 = 0u, r1 = 0u, rn = 0u, p = 0u, live = 0u;
      if (k >= 0) {
        r0 = uint32_t(rp[k]);
        r1 = uint32_t(rp[wd + k]);
        rn = uint32_t(rp[2 * wd + k]);
        const int64_t nb = len - 32 * k;
        p = ~mask_lt(nb <= 0 ? 0u : (nb >= 32 ? 32u : uint32_t(nb)));
        live = 0xFFFFFFFFu;
      }
      eqt[(0 * K + j) * kThreads] = ((~r0 & ~r1 & ~rn) | p) & live;
      eqt[(1 * K + j) * kThreads] =
          (((r0 & ~r1 & ~rn) | (r0 & r1 & ~rn)) | p) & live;
      eqt[(2 * K + j) * kThreads] = ((~r0 & r1 & ~rn) | p) & live;
      eqt[(3 * K + j) * kThreads] = ((r0 & r1 & ~rn) | p) & live;
      eqt[(4 * K + j) * kThreads] = p;
      vp[j] = 0xFFFFFFFFu;
      vn[j] = 0u;
    }
  }
  // the window's raw rows one word ahead: a row's load is in flight
  // through the 32 columns of the word before it
  const uint32_t from_below = t == 0 ? 0u : 0xFFFFFFFFu;
  WindowReader win;
  win.init(gp, orient[lane], uint32_t(start[lane]), gwords, genome_len, 0);
  int score = m, best = m;
  for (int j0 = 0; j0 < ncols; j0 += 32) {
    uint32_t a0, a1, an;
    win.next(gp, a0, a1, an);
    const int nb = min(32, ncols - j0);
#pragma unroll 2
    for (int b = 0; b < nb; ++b) {
      // the column's match row: PEQ row of its base, the pad row at N
      const uint32_t* eqrow =
          eqt + (((an >> b) & 1u) ? 4u
                 : (((a0 >> b) & 1u) | (((a1 >> b) & 1u) << 1))) *
                    (K * kThreads);
      // this thread's words of ((eq & vp) + vp) with carry in 0
      uint32_t eq[K], s[K];
      uint32_t c = 0u, ones = 0xFFFFFFFFu;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        eq[j] = eqrow[j * kThreads];
        const uint64_t x = uint64_t(eq[j] & vp[j]) + vp[j] + c;
        s[j] = uint32_t(x);
        c = uint32_t(x >> 32);
        ones &= s[j];
      }
      // the carry into this thread's first word, from the group's g / p
      const unsigned gen = __ballot_sync(0xFFFFFFFFu, c != 0u) & above;
      const unsigned prop =
          __ballot_sync(0xFFFFFFFFu, c != 0u || ones == 0xFFFFFFFFu);
      c = (((gen + prop) ^ gen ^ prop) >> lid) & 1u;
      uint32_t d0[K], hp[K], hn[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const uint64_t x = uint64_t(s[j]) + c;
        c = uint32_t(x >> 32);
        d0[j] = (uint32_t(x) ^ vp[j]) | eq[j] | vn[j];
        hp[j] = vn[j] | ~(d0[j] | vp[j]);
        hn[j] = vp[j] & d0[j];
      }
      // the top bits of hp (bit 31) and hn (bit 0) of the word below this
      // thread's first (shift-in 0 at word 0: free start, D[0][j] = 0)
      const uint32_t below =
          __shfl_up_sync(0xFFFFFFFFu,
                         (hp[K - 1] & 0x80000000u) | (hn[K - 1] >> 31), 1) &
          from_below;
      uint32_t hp_in = below >> 31, hn_in = below & 1u;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const uint32_t x = (hp[j] << 1) | hp_in;
        vp[j] = ((hn[j] << 1) | hn_in) | ~(d0[j] | x);
        vn[j] = d0[j] & x;
        hp_in = hp[j] >> 31;
        hn_in = hn[j] >> 31;
      }
      score += int(hp_in) - int(hn_in);      // word wd - 1 on thread T - 1
      best = min(best, score);
    }
  }
  if (has && t == T - 1) out[lane] = best;
}

// ---- paired-end mate rescue: window fetch + Myers scan + selection ---------
//
// Per pair the path holds: the anchored mate's block, the scan window's u32
// start (a_lo - e, wrapped below 0 by up to e), whether a rescue window
// exists (r_ok), the window's first frame anchor a_lo and its span, the
// missing mate's length and its PEQ / pad words.  Column j of the window is
// valid iff r_ok, q = j - (e + m - 1) >= 0, q <= span (read as int32) and its
// score S[j] <= e; its anchor is A = a_lo + q and its frame position P = A on
// block 0, genome_len - A - ms_len on block 1 (all u32).  Out: rs_best = min S
// over the valid columns (INF if none), rp_best = min P over the valid columns
// with S = rs_best (0xFFFFFFFF if none), rs_second = min S over the valid
// columns with |A - A_best| > e (INF if none).
//
// What bounds it on the H100: operations.  A pair reads ~19 window words and
// 15 PEQ words and writes three lanes, but runs R + m + 2e dependent Myers
// columns.  One thread per pair (the reference's kernel) is 4,096 threads
// on 132 SMs, each a serial chain of 605 columns, storing a score matrix
// that is only reduced again.  Here a pair's output columns are split over
// `chunks` neighbouring threads of a warp, and no score leaves the block.
//
// Lemma (why a chunk may start fresh).  Let D[j] be the semi-global score
// after column j of the whole window and D'[j] the score of a scan that
// starts with VP all ones and score m at column s <= j - (m + e) + 1, i.e. of
// the same pattern against the text from column s on.  D'[j] >= D[j], since
// fewer start positions compete.  If D[j] <= e, an optimal alignment ending
// at j uses m - deletions + insertions <= m + e text columns (each extra
// column costs one edit, whatever the match rule: pad rows and N columns
// change which cells match, not what a gap costs), so it starts at or after
// s and D'[j] = D[j].  Hence min(D', e + 1) = min(D, e + 1) on a chunk's
// output columns when it runs m + e - 1 warm-up columns before them (the
// kernel runs m + e, clipped at column 0), and only S <= e ever enters the
// selection.  tests/test_torch_rescue_scan.py checks the lemma on random
// texts and holds a scalar model of this kernel to the plain version.
//
// Selection without the matrix: each thread keeps (best S, its lowest P) over
// its own output columns as it goes and writes min(S, e + 1) as one byte per
// output column into shared memory; the pair's threads combine (best, P) with
// warp shuffles, every thread then knows A_best and re-reads its own bytes
// for the best score more than e away, and a second shuffle round combines
// those.  Columns past `span` and pairs without r_ok run no column at all.
//
// Two passes where the bytes do not fit.  A block of 128 / 32 pairs keeps
// 4 (R + e + 1) bytes; past ~58,000 offsets (~37,000 at 1,024 bp, where the
// PEQ table takes 80 KB) they pass the 227 KB a block may take.  There the
// wrapper launches the kernel twice with no per-column storage: MODE 1 runs
// the scan for (best, lowest P) alone and writes rs_best / rp_best; MODE 2
// reads them back, runs the same scan again and keeps the minimum S <= e over
// the columns more than e anchors from A_best.  Both passes see the same
// scores on the same columns (same split, same warm-up), and only S <= e
// enters either minimum, so the result equals the one-pass kernel's at twice
// its columns.  MODE 0 is the one-pass kernel.
struct RescueLanes {
  const int64_t *block, *win_start, *a_lo, *span, *ms_len, *peq, *pad;
  const uint8_t* r_ok;
  // element strides: of the per-pair lanes, of peq [B][4][wd], of pad [B][wd]
  int64_t s_block, s_start, s_alo, s_span, s_len, s_ok;
  int64_t pq_l, pq_c, pq_w, pd_l, pd_w;
  int32_t *rs_best, *rs_second;
  int64_t* rp_best;
  int64_t B, gwords, genome_len;
  int wd, m, e, R, chunks, qstride;
};

// SHARD: the genome planes are a shard set.
template <bool SHARD>
struct RescueArgs : RescueLanes {
  typename Table<SHARD>::type gp;
};


// NW: compile-time word count when !SHARED (PEQ in registers, wd == NW);
// register capacity of VP / VN when SHARED (PEQ in shared memory, wd <= NW).
// MODE: 0 one pass, 1 and 2 the passes of the two-pass mode (see above).
template <int NW, bool SHARED, int MODE, bool SHARD>
__global__ void __launch_bounds__(kThreads) rescue_scan_kernel(
    const RescueArgs<SHARD> a) {
  extern __shared__ uint32_t rescue_smem[];
  const int C = a.chunks;                    // a power of two <= 32
  const int pl = threadIdx.x / C, chunk = threadIdx.x % C;
  const int64_t pair = int64_t(blockIdx.x) * (kThreads / C) + pl;
  uint8_t* sc = reinterpret_cast<uint8_t*>(
                    rescue_smem + (SHARED ? 5 * NW * kThreads : 0)) +
                size_t(pl) * a.qstride;

  // this thread's output columns q in [q0, q1), q = j - (e + m - 1)
  int nout = 0;
  if (pair < a.B && a.r_ok[pair * a.s_ok]) {
    const int32_t span = int32_t(uint32_t(a.span[pair * a.s_span]));
    if (span >= 0) nout = min(span, a.R + a.e) + 1;
  }
  const int ch = (nout + C - 1) / C;
  const int q0 = min(chunk * ch, nout), q1 = min(q0 + ch, nout);
  int best = kInfScore, second = kInfScore;
  uint32_t best_p = 0xFFFFFFFFu, alo = 0u, mlen = 0u;
  const uint32_t glen = uint32_t(a.genome_len);
  bool fwd = true;
  if (MODE == 2 && q0 < q1) {                // pass 1's result for the pair
    best = a.rs_best[pair];
    best_p = uint32_t(a.rp_best[pair]);
  }
  int64_t a_best = 0;

  if (q0 < q1 && (MODE != 2 || best <= a.e)) {
    const int64_t blk = a.block[pair * a.s_block];
    fwd = blk == 0;
    alo = uint32_t(a.a_lo[pair * a.s_alo]);
    mlen = uint32_t(a.ms_len[pair * a.s_len]);
    if (MODE == 2) a_best = int64_t(fwd ? best_p : glen - best_p - mlen);
    const int64_t* pq = a.peq + pair * a.pq_l;
    const int64_t* pd = a.pad + pair * a.pd_l;
    uint32_t peq[SHARED ? 1 : 4][SHARED ? 1 : NW], pad[SHARED ? 1 : NW];
    uint32_t* col = rescue_smem + threadIdx.x;
    if constexpr (SHARED) {
      for (int k = 0; k < a.wd; ++k) {
        const int64_t* w = pq + k * a.pq_w;
        store_eq_column(col, NW, k, uint32_t(w[0]), uint32_t(w[a.pq_c]),
                        uint32_t(w[2 * a.pq_c]), uint32_t(w[3 * a.pq_c]),
                        uint32_t(pd[k * a.pd_w]));
      }
    } else {
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        pad[k] = uint32_t(pd[k * a.pd_w]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          peq[c][k] = uint32_t(pq[c * a.pq_c + k * a.pq_w]);
      }
    }
    uint32_t vp[NW], vn[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      vp[k] = 0xFFFFFFFFu;
      vn[k] = 0u;
    }
    const int jo = a.e + a.m - 1;            // column of q = 0
    const int j_first = max(0, jo + q0 - (a.m + a.e));
    const int j_last = jo + q1 - 1;
    WindowReader win;
    win.init(a.gp, blk, uint32_t(a.win_start[pair * a.s_start]), a.gwords,
             a.genome_len, j_first >> 5);
    int score = a.m;
    for (int w = j_first >> 5; w <= (j_last >> 5); ++w) {
      uint32_t a0, a1, an;
      win.next(a.gp, a0, a1, an);
      const int b_lo = max(j_first - 32 * w, 0);
      const int b_hi = min(j_last - 32 * w, 31);
#pragma unroll 1
      for (int b = b_lo; b <= b_hi; ++b) {
        const bool c0 = (a0 >> b) & 1u, c1 = (a1 >> b) & 1u,
                   isn = (an >> b) & 1u;
        if constexpr (SHARED) {
          const uint32_t sym = isn ? 4u : (uint32_t(c0) | (uint32_t(c1) << 1));
          score += myers_column_shared<NW>(vp, vn, col + sym * NW * kThreads,
                                           a.wd);
        } else {
          score += myers_column<NW>(vp, vn, peq, pad, NW, c0, c1, isn);
        }
        const int q = 32 * w + b - jo;
        if (q >= q0) {
          if (MODE == 0) sc[q] = uint8_t(min(score, a.e + 1));
          if (score <= a.e) {
            const uint32_t A = alo + uint32_t(q);
            if (MODE == 2) {
              const int64_t d = int64_t(A) - a_best;
              if ((d < 0 ? -d : d) > a.e) second = min(second, score);
            } else {
              const uint32_t P = fwd ? A : glen - A - mlen;
              if (score < best || (score == best && P < best_p)) {
                best = score;
                best_p = P;
              }
            }
          }
        }
      }
    }
  }

  // the pair's (best, lowest P): its threads are neighbours within one warp
  if (MODE != 2) {
    for (int off = C >> 1; off > 0; off >>= 1) {
      const int ob = __shfl_xor_sync(0xFFFFFFFFu, best, off);
      const uint32_t op = __shfl_xor_sync(0xFFFFFFFFu, best_p, off);
      if (ob < best || (ob == best && op < best_p)) {
        best = ob;
        best_p = op;
      }
    }
  }
  // best score more than e anchors away from the best: own bytes again
  if (MODE == 0 && q0 < q1 && best <= a.e) {
    a_best = int64_t(fwd ? best_p : glen - best_p - mlen);
    for (int q = q0; q < q1; ++q) {
      const int s = sc[q];
      if (s <= a.e) {
        const int64_t d = int64_t(alo + uint32_t(q)) - a_best;
        if ((d < 0 ? -d : d) > a.e) second = min(second, s);
      }
    }
  }
  if (MODE != 1) {
    for (int off = C >> 1; off > 0; off >>= 1)
      second = min(second, __shfl_xor_sync(0xFFFFFFFFu, second, off));
  }
  if (chunk == 0 && pair < a.B) {
    if (MODE != 2) {
      a.rs_best[pair] = best;
      a.rp_best[pair] = int64_t(best_p);
    }
    if (MODE != 1) a.rs_second[pair] = second;
  }
}

template <int WD>
__global__ void __launch_bounds__(kThreads) myers_kernel(
    const uint32_t* __restrict__ win, const uint32_t* __restrict__ peq_g,
    const uint32_t* __restrict__ pad_g, int32_t* __restrict__ out, int64_t L,
    int wd_rt, int ww, int m, int ncols) {
  constexpr int NW = WD > 0 ? WD : kMaxWords;
  const int wd = WD > 0 ? WD : wd_rt;
  const int64_t lane = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const uint32_t* w0 = win + lane * 3 * ww;
  uint32_t peq[4][NW], pad[NW];
  load_peq<NW>(peq_g + lane * 4 * wd, pad_g + lane * wd, wd, peq, pad);
  out[lane] = myers_min<NW>(w0, w0 + ww, w0 + 2 * ww, peq, pad, wd, m, ncols);
}

// The gathering verify's lanes (btbs_verify_fused_gather) past its table.
struct GatherLanes {
  const int64_t *orient, *start, *rtab, *rrow, *rlen, *n_lanes;
  int32_t* out;
  int64_t L, R, gwords, genome_len;
  int wd, m, ncols, e;
  int k;                                     // words per thread at wd > 8
};

template <int WD, bool SHARD>
void launch_fused_gather(const typename Table<SHARD>::type& gp,
                         const GatherLanes& x, cudaStream_t st) {
  const unsigned grid = unsigned((x.L + kThreads - 1) / kThreads);
  verify_fused_gather_kernel<WD, SHARD><<<grid, kThreads, 0, st>>>(
      gp, x.orient, x.start, x.rtab, x.rrow, x.rlen, x.n_lanes, x.out, x.L,
      x.R, x.gwords, x.genome_len, x.m, x.ncols, x.e);
}

template <int WD>
void launch_myers(const uint32_t* win, const uint32_t* peq,
                  const uint32_t* pad, int32_t* out, int64_t L, int wd,
                  int ww, int m, int ncols, cudaStream_t st) {
  const unsigned grid = unsigned((L + kThreads - 1) / kThreads);
  myers_kernel<WD><<<grid, kThreads, 0, st>>>(win, peq, pad, out, L, wd, ww,
                                              m, ncols);
}

// The wide kernel at K read words per thread: a block of kThreads threads
// takes one lane per group, (kThreads / 32) * floor(32 / ceil(wd / K)).
template <int K, bool SHARD>
cudaError_t launch_fused_gather_wide(const typename Table<SHARD>::type& gp,
                                     const GatherLanes& x, cudaStream_t st) {
  const int G = (kThreads / 32) * (32 / ((x.wd + K - 1) / K));
  const int64_t grid = (x.L + G - 1) / G;
  if (grid > 0x7FFFFFFF) return cudaErrorInvalidValue;
  verify_fused_gather_wide_kernel<K, SHARD>
      <<<unsigned(grid), kThreads, 0, st>>>(
          gp, x.orient, x.start, x.rtab, x.rrow, x.rlen, x.n_lanes, x.out,
          x.L, x.R, x.gwords, x.genome_len, x.wd, x.m, x.ncols, x.e);
  return cudaGetLastError();
}

// One launch of the gathering verify at x.wd read words (x.k words per
// thread over 8: the builds kernels.WIDE_WORDS picks from).
template <bool SHARD>
cudaError_t fused_gather(const typename Table<SHARD>::type& gp,
                         const GatherLanes& x, cudaStream_t st) {
  switch (x.wd) {
    case 1: launch_fused_gather<1, SHARD>(gp, x, st); break;
    case 2: launch_fused_gather<2, SHARD>(gp, x, st); break;
    case 3: launch_fused_gather<3, SHARD>(gp, x, st); break;
    case 4: launch_fused_gather<4, SHARD>(gp, x, st); break;
    case 5: launch_fused_gather<5, SHARD>(gp, x, st); break;
    case 6: launch_fused_gather<6, SHARD>(gp, x, st); break;
    case 7: launch_fused_gather<7, SHARD>(gp, x, st); break;
    case 8: launch_fused_gather<8, SHARD>(gp, x, st); break;
    default: break;
  }
  if (x.wd <= 8) return cudaGetLastError();
  switch (x.k) {
    case 4: return launch_fused_gather_wide<4, SHARD>(gp, x, st);
    case 5: return launch_fused_gather_wide<5, SHARD>(gp, x, st);
    case 6: return launch_fused_gather_wide<6, SHARD>(gp, x, st);
    case 8: return launch_fused_gather_wide<8, SHARD>(gp, x, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int NW, bool SHARED, int MODE, bool SHARD>
cudaError_t launch_rescue_scan_mode(const RescueArgs<SHARD>& a,
                                    cudaStream_t st) {
  const int pairs = kThreads / a.chunks;     // per block
  const size_t smem =
      (SHARED ? size_t(5) * NW * kThreads * sizeof(uint32_t) : 0) +
      (MODE == 0 ? size_t(pairs) * a.qstride : 0);
  static size_t granted[kMaxDevices];
  const cudaError_t rc = allow_shared(
      rescue_scan_kernel<NW, SHARED, MODE, SHARD>, smem, granted);
  if (rc != cudaSuccess) return rc;
  const unsigned grid = unsigned((a.B + pairs - 1) / pairs);
  rescue_scan_kernel<NW, SHARED, MODE, SHARD><<<grid, kThreads, smem, st>>>(
      a);
  return cudaGetLastError();
}

template <int NW, bool SHARED, bool SHARD>
cudaError_t launch_rescue_scan(const RescueArgs<SHARD>& a, int mode,
                               cudaStream_t st) {
  if (mode == 1) return launch_rescue_scan_mode<NW, SHARED, 1>(a, st);
  if (mode == 2) return launch_rescue_scan_mode<NW, SHARED, 2>(a, st);
  return launch_rescue_scan_mode<NW, SHARED, 0>(a, st);
}

// One launch of the rescue scan (mode as btbs_rescue_scan) at a.wd words.
template <bool SHARD>
cudaError_t rescue_scan(const RescueArgs<SHARD>& a, int mode,
                        cudaStream_t st) {
  switch (a.wd) {
    case 1: return launch_rescue_scan<1, false>(a, mode, st);
    case 2: return launch_rescue_scan<2, false>(a, mode, st);
    case 3: return launch_rescue_scan<3, false>(a, mode, st);
    case 4: return launch_rescue_scan<4, false>(a, mode, st);
    case 5: return launch_rescue_scan<5, false>(a, mode, st);
    case 6: return launch_rescue_scan<6, false>(a, mode, st);
    case 7: return launch_rescue_scan<7, false>(a, mode, st);
    case 8: return launch_rescue_scan<8, false>(a, mode, st);
    default: break;
  }
  if (a.wd <= 12) return launch_rescue_scan<12, true>(a, mode, st);
  if (a.wd <= 16) return launch_rescue_scan<16, true>(a, mode, st);
  if (a.wd <= 24) return launch_rescue_scan<24, true>(a, mode, st);
  return launch_rescue_scan<32, true>(a, mode, st);
}

bool shapes_ok(int64_t L, int wd, int ww, int ncols) {
  return L > 0 && L <= int64_t(kThreads) * 0x7FFFFFFF && wd >= 1 &&
         wd <= kMaxWords && ww >= 1 && ncols >= 1 && ncols <= 32 * ww;
}

// The genome planes of the gathering entries below: nparts 0: gp uint32
// [2 * gwords][3], a whole table (gp_parts and gp_rows unused); nparts
// 1..kMaxShards: gp_parts[s] is shard s, gp_rows rows of 3 words each, of
// the planes split into row ranges (index/device.Shards).  Calls
// launch(table) with the pointer or the shard set.
template <typename Launch>
cudaError_t with_planes(const void* gp, const void* const* gp_parts,
                        int nparts, int64_t gp_rows, Launch launch) {
  if (nparts == 0) return launch(static_cast<const uint32_t*>(gp));
  ShardSet gs;
  if (!make_shard_set(gp_parts, nparts, gp_rows, &gs))
    return cudaErrorInvalidValue;
  return launch(gs);
}

}  // namespace

extern "C" {

// The genome planes as with_planes above; orient, start (u32 value), rrow,
// rlen int64 [L]; rtab int64 [R][3 * wd] read planes (u32 values); out int32
// [L].  wd in 1..32 and a window of exactly wd + 1 words; k: the wide
// kernel's read words per thread at wd > 8 (4, 5, 6 or 8), unused below;
// n_lanes: null, or an int64 [1] on the card: lanes at or past it write
// INF and load nothing.
int btbs_verify_fused_gather(const void* gp, const void* const* gp_parts,
                             int nparts, int64_t gp_rows, const void* orient,
                             const void* start, const void* rtab,
                             const void* rrow, const void* rlen,
                             const void* n_lanes, void* out,
                             int64_t L, int64_t R, int64_t gwords,
                             int64_t genome_len, int wd, int m, int ncols,
                             int e, int k, void* stream) {
  if (!shapes_ok(L, wd, wd + 1, ncols) || ncols <= 32 * wd ||
      e < 0 || e > 31 || R < 1 || gwords < 1 || genome_len < 0)
    return int(cudaErrorInvalidValue);
  const GatherLanes x{static_cast<const int64_t*>(orient),
                      static_cast<const int64_t*>(start),
                      static_cast<const int64_t*>(rtab),
                      static_cast<const int64_t*>(rrow),
                      static_cast<const int64_t*>(rlen),
                      static_cast<const int64_t*>(n_lanes),
                      static_cast<int32_t*>(out),
                      L, R, gwords, genome_len, wd, m, ncols, e, k};
  auto st = static_cast<cudaStream_t>(stream);
  return int(with_planes(gp, gp_parts, nparts, gp_rows, [&](const auto& g) {
    constexpr bool kShard =
        !std::is_pointer<std::decay_t<decltype(g)>>::value;
    return fused_gather<kShard>(g, x, st);
  }));
}

// Mate rescue for B pairs (see the note above rescue_scan_kernel).  The
// genome planes as with_planes above; block, win_start (u32 value), a_lo
// (u32), span (u32), ms_len int64
// and r_ok bool (one byte) lanes, peq int64 [B][4][wd] and pad int64 [B][wd]
// (u32 values), each with its element strides; rs_best, rs_second int32 [B],
// rp_best int64 [B], contiguous.  chunks: threads per pair, a power of two up
// to 32; in mode 0 a block of 128 / chunks pairs keeps R + e + 1 bytes per
// pair (and above 8 read words its PEQ table) in shared memory, so the caller
// raises chunks where the insert range is wide, and past what 32 threads per
// pair fit it runs mode 1 and then mode 2, which keep no bytes
// (ops/kernels.rescue_scan_chunks); mode 1 writes rs_best and rp_best only,
// mode 2 reads them and writes rs_second only.  A block that does not fit is
// refused with cudaErrorInvalidValue.
int btbs_rescue_scan(const void* gp, const void* const* gp_parts, int nparts,
                     int64_t gp_rows, const void* block, int64_t s_block,
                     const void* win_start, int64_t s_start, const void* r_ok,
                     int64_t s_ok, const void* a_lo, int64_t s_alo,
                     const void* span, int64_t s_span, const void* ms_len,
                     int64_t s_len, const void* peq, int64_t pq_l,
                     int64_t pq_c, int64_t pq_w, const void* pad, int64_t pd_l,
                     int64_t pd_w, void* rs_best, void* rp_best,
                     void* rs_second, int64_t B, int64_t gwords,
                     int64_t genome_len, int wd, int m, int e, int R,
                     int chunks, int mode, void* stream) {
  if (B < 1 || wd < 1 || wd > kMaxWords || m != 32 * wd || e < 0 || e > 31 ||
      R < 1 || R > (1 << 24) || chunks < 1 || chunks > 32 ||
      (chunks & (chunks - 1)) != 0 || gwords < 1 || genome_len < 0 ||
      mode < 0 || mode > 2)
    return int(cudaErrorInvalidValue);
  RescueLanes a;
  a.block = static_cast<const int64_t*>(block);
  a.win_start = static_cast<const int64_t*>(win_start);
  a.a_lo = static_cast<const int64_t*>(a_lo);
  a.span = static_cast<const int64_t*>(span);
  a.ms_len = static_cast<const int64_t*>(ms_len);
  a.peq = static_cast<const int64_t*>(peq);
  a.pad = static_cast<const int64_t*>(pad);
  a.r_ok = static_cast<const uint8_t*>(r_ok);
  a.s_block = s_block;
  a.s_start = s_start;
  a.s_alo = s_alo;
  a.s_span = s_span;
  a.s_len = s_len;
  a.s_ok = s_ok;
  a.pq_l = pq_l;
  a.pq_c = pq_c;
  a.pq_w = pq_w;
  a.pd_l = pd_l;
  a.pd_w = pd_w;
  a.rs_best = static_cast<int32_t*>(rs_best);
  a.rs_second = static_cast<int32_t*>(rs_second);
  a.rp_best = static_cast<int64_t*>(rp_best);
  a.B = B;
  a.gwords = gwords;
  a.genome_len = genome_len;
  a.wd = wd;
  a.m = m;
  a.e = e;
  a.R = R;
  a.chunks = chunks;
  a.qstride = (R + e + 1 + 3) & ~3;          // one byte per output column
  auto st = static_cast<cudaStream_t>(stream);
  return int(with_planes(gp, gp_parts, nparts, gp_rows, [&](const auto& g) {
    constexpr bool kShard =
        !std::is_pointer<std::decay_t<decltype(g)>>::value;
    RescueArgs<kShard> args;
    static_cast<RescueLanes&>(args) = a;
    args.gp = g;
    return rescue_scan<kShard>(args, mode, st);
  }));
}

int btbs_myers(const void* win, const void* peq, const void* pad, void* out,
               int64_t L, int wd, int ww, int m, int ncols, void* stream) {
  if (!shapes_ok(L, wd, ww, ncols)) return int(cudaErrorInvalidValue);
  auto w = static_cast<const uint32_t*>(win);
  auto q = static_cast<const uint32_t*>(peq);
  auto p = static_cast<const uint32_t*>(pad);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (wd) {
    case 1: launch_myers<1>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 2: launch_myers<2>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 3: launch_myers<3>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 4: launch_myers<4>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 5: launch_myers<5>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 6: launch_myers<6>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 7: launch_myers<7>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 8: launch_myers<8>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    default: launch_myers<0>(w, q, p, o, L, wd, ww, m, ncols, st); break;
  }
  return int(cudaGetLastError());
}

}  // extern "C"
