// FM-index step kernels for Hopper (sm_90a), bound with ctypes by
// bitmapperbs_tpu_torch/ops/kernels.py.
//
// These are the second half of what scripts/pallas_gather_proto.py
// (make_pallas_gather.gather, kernel body `kernel`) was written as the first
// half of: the checkpoint-row fetch fused with the step that consumes the
// row, and the whole step loop inside one launch.  Each entry point replaces
// a lockstep loop of bitmapperbs_tpu/ops/fm.py (one row gather between some
// thirty small tensor ops per step, every lane masked through every step):
//
//   btbs_fm_search  <- fm.search_patterns: backward search of seed slices
//     from the k-mer table's interval (or from (0, n) for slices shorter than
//     the table's k), one occ pair per character.
//   btbs_fm_extend  <- fm.extend_seeds: adaptive leftward seed extension.
//   btbs_fm_locate  <- fm.locate: bounded LF walk to the next sampled suffix
//     plus the SA-sample lookup.
//
// Lanes never exchange data across steps, so the lockstep shape was the
// TPU's (one vector program over all lanes), not the algorithm's.  Here each
// lane runs its own loop and leaves it when it is done:
//   search: a lane whose interval is empty (ep <= sp) is frozen for good in
//     the lockstep version, so leaving the loop gives the same (sp, ep).
//   extend: the lockstep version takes step t iff the lane is not dead, its
//     interval holds more than ext_occ rows and starts > 0.  A lane that does
//     not take a step changes nothing, so it can never take a later one, and
//     a dead lane stays dead: the loop ends at the first step not taken.  The
//     lockstep version reads its characters as
//     patterns[clamp(starts0 - 1 - t)]; on every taken step starts has fallen
//     by exactly t, so that is patterns[starts - 1].
//   locate: a lane is done at its first marked position; the lockstep
//     version's later steps leave rank, cur and steps unchanged.
//     Locate also takes the flat buffer's fill, n_lanes, a count on the card
//     (csrc/flat.cu btbs_flat_expand): a lane at or past it writes 0 and
//     loads nothing, as the reference's chunk loop leaves the lanes past the
//     fill (bitmapperbs_tpu/models/aligner.py:294-330, _chunked_lanes).
// Invalid lanes reach the output in the mapping pipeline (they are masked
// later), so every clamp of the lockstep version is reproduced: rows and
// sample indices clamped into their tables as btbs_gather_rows clamps,
// cur = min(valid ? i : 0, n - 1), min(.., n - 1) after every LF step.
// Positions are native uint32_t, so every wrap is the hardware's; lanes
// cross the interface as the port's int64-held u32, narrowed on load and
// widened on store.
//
// What bounds it on the H100.  For one lane it is the chain of dependent
// loads: its next row address comes out of the row it just fetched, so a
// lane costs (steps taken) x (device-memory latency, ~0.3 us on tables far
// larger than the 50 MB L2), while its bytes (68 per row) and ~60 integer
// operations per row are small.  For the launch it is bytes, once enough
// lanes are in flight to hide that latency: measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3 (700 W) on a 106 MB checkpoint table, search and
// locate spend 1.1-1.6x their bytes bound inside the kernel (a 68-byte row
// at a 68-byte stride spans three or four 32-byte sectors, so the card
// moves more than the bound counts), and extend, where most lanes stop at
// once and a few take all 20 steps, sits at the latency chain of its
// longest lane.  The design therefore spends threads to keep loads in
// flight: the two rows of a backward step (sp and ep) belong to
// neighbouring thread groups so both fetches are in flight together, and a
// row is read by kTpr = 2 cooperating threads: each loads every second word
// of each plane (thread 0 the count word too, and in locate each its mark
// words), so a row is two short runs of loads side by side instead of 9-17
// serial 4-byte loads of one thread, and the popcounts meet with
// __shfl_xor_sync.  (1, 2 and 4 threads per row were measured on that card:
// within a third of one another inside the kernel, 2 ahead in extend and
// locate, 4 last at the larger lane counts.)  Every lane is resident at
// once at the mapping path's lane counts (<= 2,048 threads per SM x 132
// SMs), which is what covers the latency.  Row offsets are
// 64-bit (the checkpoint rows of a 3 Gbp genome pass 2^31 bytes).  cp.async
// prefetch of the next step's rows is not used: the next index is not known
// before the current row has been counted, and its 16-byte copies would need
// a padded row stride (20 words: 3.84 GB of rows at 3.08 Gbp against 3.26).
//
// btbs_dependent_load_chain is a measuring probe, not part of the mapping
// path: one thread walks a chain of loads whose addresses depend on the
// previous load, which gives the card's dependent-load latency on a table.
//
// On a sharded index (index/device.upload_index_sharded) the checkpoint rows
// and SA samples are split into row ranges over the cards of an index group.
// Each kernel has a SHARD instance for that case (csrc/shards.cuh): the row
// fetch picks the shard that holds the row (a zero row outside every shard,
// the reference's sharded fetch) and the step is the same, so a sharded
// batch launches each FM kernel once, as one card does.  Only cp_row and the
// SA-sample load differ between the instances.
#include <cstdint>
#include <cuda_runtime.h>

#include "shards.cuh"

namespace {

constexpr int kAlpha = 4;                        // count words per row
constexpr int kWords = 4;                        // words per 128-bit plane
constexpr int kP0 = kAlpha;                      // BWT bit-0 plane
constexpr int kP1 = kAlpha + kWords;             // BWT bit-1 plane
constexpr int kMarkBase = kAlpha + 2 * kWords;   // SA-mark rank before the row
constexpr int kMark = kMarkBase + 1;             // SA-mark plane
constexpr int kRowWords = kMark + kWords;        // 17
constexpr uint32_t kCpBlock = 32 * kWords;       // BWT positions per row
constexpr int kThreads = 128;
constexpr int kTpr = 2;                          // threads that share a row
static_assert(kAlpha == kWords, "count word w and plane word w share a loop");
static_assert(kWords % kTpr == 0 && 32 % (2 * kTpr) == 0, "whole groups");

// The index as the step kernels read it.  SHARD false: cp holds the
// checkpoint rows of both blocks, [R][kRowWords]; SHARD true: their shard
// set (R unused).
template <bool SHARD>
struct Fm {
  typename Table<SHARD>::type cp;
  const int64_t* cbase;    // [2][kAlpha]
  const int64_t* n;        // [2] text lengths
  int64_t R, rows_max;
};

// The (possibly broadcast) pattern tensor uint8 [d0, d1, d2, m]: element
// strides of its three lane dimensions; the last dimension is contiguous.
struct Pat {
  const uint8_t* base;
  int64_t d1, d2, s0, s1, s2;
  int m;
};

__device__ __forceinline__ const uint8_t* pat_row(const Pat& p, int64_t lane) {
  const int64_t r = lane / p.d2, i2 = lane - r * p.d2;
  const int64_t i0 = r / p.d1, i1 = r - i0 * p.d1;
  return p.base + i0 * p.s0 + i1 * p.s1 + i2 * p.s2;
}

__device__ __forceinline__ uint32_t pat_char(const Pat& p, const uint8_t* row,
                                             int64_t q) {
  q = q < 0 ? 0 : (q >= p.m ? p.m - 1 : q);
  return row[q] & 3u;
}

// The checkpoint row of position i: clamped into a whole table (as
// btbs_gather_rows clamps), a zero row past a shard set (as the reference's
// sharded fetch gives).
template <bool SHARD>
__device__ __forceinline__ const uint32_t* cp_row(const Fm<SHARD>& fm,
                                                  int64_t blk, uint32_t i) {
  int64_t r = int64_t(i / kCpBlock) + blk * fm.rows_max;
  if constexpr (SHARD) {
    return shard_row<kRowWords>(fm.cp, r);
  } else {
    r = r < 0 ? 0 : (r >= fm.R ? fm.R - 1 : r);
    return fm.cp + r * kRowWords;
  }
}

// SA sample si: clamped into a whole table of n_samples; in a shard set
// clamped below 2 * samples_max first, as ops/fm.fetch_sa_samples does,
// then a zero row past the shards.
__device__ __forceinline__ uint32_t sa_sample(const uint32_t* sa,
                                              int64_t n_samples,
                                              int64_t samples_max,
                                              int64_t si) {
  si = si < 0 ? 0 : (si >= n_samples ? n_samples - 1 : si);
  return sa[si];
}

__device__ __forceinline__ uint32_t sa_sample(const ShardSet& sa, int64_t,
                                              int64_t samples_max,
                                              int64_t si) {
  const int64_t top = 2 * samples_max - 1;
  return *shard_row<1>(sa, si < top ? si : top);
}

// bits of plane word w that lie below position `within` of the row
__device__ __forceinline__ uint32_t lower_mask(uint32_t within, int w) {
  const int nb = int(within) - 32 * w;
  return nb <= 0 ? 0u : (nb >= 32 ? 0xFFFFFFFFu : ((1u << nb) - 1u));
}

// The G (power of two <= 32) consecutive threads of this thread's group.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G >= 32) {
    return 0xFFFFFFFFu;
  } else {
    const unsigned lane = threadIdx.x & 31u;
    return ((1u << G) - 1u) << (lane / G * G);
  }
}

// Sum over the kTpr threads that share a row.
__device__ __forceinline__ uint32_t row_sum(unsigned gmask, uint32_t v) {
#pragma unroll
  for (int o = 1; o < kTpr; o <<= 1) v += __shfl_xor_sync(gmask, v, o);
  return v;
}

// Thread j's share of occ(c, i) from the row of i: the count word (thread 0)
// plus the popcounts of its plane words j, j + kTpr, ... below `within`.
__device__ __forceinline__ uint32_t occ_share(const uint32_t* __restrict__ row,
                                              uint32_t c, uint32_t within,
                                              int j) {
  const uint32_t b0 = 0u - (c & 1u), b1 = 0u - ((c >> 1) & 1u);
  uint32_t acc = j == 0 ? row[c] : 0u;
#pragma unroll
  for (int k = 0; k < kWords / kTpr; ++k) {
    const int w = j + k * kTpr;
    const uint32_t ind = ~(row[kP0 + w] ^ b0) & ~(row[kP1 + w] ^ b1);
    acc += __popc(ind & lower_mask(within, w));
  }
  return acc;
}

// One backward-search step of a lane held by 2 x kTpr threads: side 0 counts
// the row of sp, side 1 the row of ep, and the halves swap results.
template <bool SHARD>
__device__ __forceinline__ void backward_step(
    const Fm<SHARD>& fm, int64_t blk, uint32_t c, int side, int j, unsigned gmask,
    uint32_t sp, uint32_t ep, uint32_t& nsp, uint32_t& nep) {
  const uint32_t i = side ? ep : sp;
  const uint32_t* row = cp_row(fm, blk, i);
  uint32_t v = row_sum(gmask, occ_share(row, c, i % kCpBlock, j));
  v += uint32_t(fm.cbase[blk * kAlpha + c]);
  const uint32_t o = __shfl_xor_sync(gmask, v, kTpr);
  nsp = side ? o : v;
  nep = side ? v : o;
}

template <bool SHARD>
__global__ void __launch_bounds__(kThreads) fm_search_kernel(
    Fm<SHARD> fm, Pat pat, const int64_t* __restrict__ block,
    const int64_t* __restrict__ starts, const int64_t* __restrict__ ends,
    const int64_t* __restrict__ sp0, const int64_t* __restrict__ ep0, int k,
    int max_len, int64_t* __restrict__ out_sp, int64_t* __restrict__ out_ep,
    int32_t* __restrict__ rows_out, int64_t L) {
  constexpr int G = 2 * kTpr;
  const int64_t lane = (int64_t(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (lane >= L) return;                       // whole groups leave together
  const int sub = threadIdx.x % G, side = sub / kTpr, j = sub % kTpr;
  const unsigned gmask = group_mask<G>();
  const int64_t blk = block[lane] & 1;
  const int64_t end = ends[lane];
  const int64_t len = end - starts[lane];
  uint32_t sp, ep;
  int64_t t;
  if (k == 0 || len < k) {                     // no table start: walk from (0, n)
    sp = 0u;
    ep = uint32_t(fm.n[blk]);
    t = 0;
  } else {
    sp = uint32_t(sp0[lane]);
    ep = uint32_t(ep0[lane]);
    t = k;
  }
  const int64_t stop = len < max_len ? len : int64_t(max_len);
  const uint8_t* prow = pat_row(pat, lane);
  int rows = 0;
  for (; t < stop && ep > sp; ++t) {
    const uint32_t c = pat_char(pat, prow, end - 1 - t);
    uint32_t nsp, nep;
    backward_step(fm, blk, c, side, j, gmask, sp, ep, nsp, nep);
    sp = nsp;
    ep = nep;
    rows += 2;
  }
  if (sub == 0) {
    out_sp[lane] = int64_t(sp);
    out_ep[lane] = int64_t(ep);
    if (rows_out) rows_out[lane] = rows;
  }
}

template <bool SHARD>
__global__ void __launch_bounds__(kThreads) fm_extend_kernel(
    Fm<SHARD> fm, Pat pat, const int64_t* __restrict__ block,
    const int64_t* __restrict__ starts, const int64_t* __restrict__ sp_in,
    const int64_t* __restrict__ ep_in, int ext_max, uint32_t ext_occ,
    int64_t* __restrict__ out_sp, int64_t* __restrict__ out_ep,
    int64_t* __restrict__ out_st, int32_t* __restrict__ rows_out, int64_t L) {
  constexpr int G = 2 * kTpr;
  const int64_t lane = (int64_t(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (lane >= L) return;
  const int sub = threadIdx.x % G, side = sub / kTpr, j = sub % kTpr;
  const unsigned gmask = group_mask<G>();
  const int64_t blk = block[lane] & 1;
  uint32_t sp = uint32_t(sp_in[lane]), ep = uint32_t(ep_in[lane]);
  int64_t st = starts[lane];
  const uint8_t* prow = pat_row(pat, lane);
  int rows = 0;
  for (int t = 0; t < ext_max; ++t) {
    if (!(uint32_t(ep - sp) > ext_occ && st > 0)) break;    // not active
    const uint32_t c = pat_char(pat, prow, st - 1);
    uint32_t nsp, nep;
    backward_step(fm, blk, c, side, j, gmask, sp, ep, nsp, nep);
    rows += 2;
    if (nep <= nsp) break;                                   // would empty: dead
    sp = nsp;
    ep = nep;
    --st;
  }
  if (sub == 0) {
    out_sp[lane] = int64_t(sp);
    out_ep[lane] = int64_t(ep);
    out_st[lane] = st;
    if (rows_out) rows_out[lane] = rows;
  }
}

template <bool SHARD>
__global__ void __launch_bounds__(kThreads) fm_locate_kernel(
    Fm<SHARD> fm, typename Table<SHARD>::param sa, int64_t n_samples,
    int64_t samples_max, int sa_rate, const int64_t* __restrict__ block,
    const int64_t* __restrict__ pos, const uint8_t* __restrict__ valid,
    const int64_t* __restrict__ n_lanes, int64_t* __restrict__ out,
    int32_t* __restrict__ rows_out, int64_t L) {
  constexpr int NW = kWords / kTpr;             // plane words per thread
  const int64_t lane = (int64_t(blockIdx.x) * kThreads + threadIdx.x) / kTpr;
  if (lane >= L) return;
  const int j = threadIdx.x % kTpr;
  if (n_lanes && lane >= *n_lanes) {            // past the flat buffer's fill
    if (j == 0) {
      out[lane] = 0;
      if (rows_out) rows_out[lane] = 0;
    }
    return;
  }
  const unsigned gmask = group_mask<kTpr>();
  const int64_t blk = block[lane] & 1;
  const uint32_t last = uint32_t(fm.n[blk]) - 1u;
  uint32_t cur = valid[lane] ? uint32_t(pos[lane]) : 0u;
  cur = cur < last ? cur : last;
  uint32_t steps = 0u, rank = 0u;
  int rows = 0;
  for (int s = 0; s < sa_rate; ++s) {
    ++rows;
    const uint32_t* __restrict__ row = cp_row(fm, blk, cur);
    const uint32_t within = cur % kCpBlock;
    const int wsel = int(within >> 5);
    const uint32_t b = within & 31u;
    // mark test + mark rank + BWT symbol, all from this one row
    uint32_t cnt[NW], p0[NW], p1[NW];
    uint32_t mrank = j == 0 ? row[kMarkBase] : 0u;
    uint32_t flags = 0u;                       // mark bit | c0 << 1 | c1 << 2
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int w = j + k * kTpr;
      const uint32_t mk = row[kMark + w];
      cnt[k] = row[w];
      p0[k] = row[kP0 + w];
      p1[k] = row[kP1 + w];
      mrank += __popc(mk & lower_mask(within, w));
      if (w == wsel)
        flags = ((mk >> b) & 1u) | (((p0[k] >> b) & 1u) << 1) |
                (((p1[k] >> b) & 1u) << 2);
    }
    flags = row_sum(gmask, flags);        // one thread's is non-zero
    mrank = row_sum(gmask, mrank);
    if (flags & 1u) {                          // a sampled suffix: done
      rank = mrank;
      break;
    }
    const uint32_t c0 = (flags >> 1) & 1u, c1 = (flags >> 2) & 1u;
    const uint32_t c = c0 | (c1 << 1);
    const uint32_t b0 = 0u - c0, b1 = 0u - c1;
    uint32_t occ = 0u;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int w = j + k * kTpr;
      occ += (uint32_t(w) == c ? cnt[k] : 0u) +
             __popc(~(p0[k] ^ b0) & ~(p1[k] ^ b1) & lower_mask(within, w));
    }
    occ = row_sum(gmask, occ);
    const uint32_t nxt = uint32_t(fm.cbase[blk * kAlpha + c]) + occ;
    cur = nxt < last ? nxt : last;
    ++steps;
  }
  if (j == 0) {
    const int64_t si = blk * samples_max + int64_t(rank);
    out[lane] = int64_t(uint32_t(sa_sample(sa, n_samples, samples_max, si) +
                                 steps));
    if (rows_out) rows_out[lane] = rows;
  }
}

// x -> table[x scaled into the table] mixed with the step: every address
// depends on the word loaded before it.
__global__ void dependent_load_kernel(const uint32_t* __restrict__ table,
                                      uint32_t nwords, int steps, uint32_t x,
                                      uint32_t* __restrict__ out) {
  for (int s = 0; s < steps; ++s)
    x = (table[__umulhi(x, nwords)] ^ x) * 2654435761u + uint32_t(s);
  out[0] = x;
}

bool grid_for(int64_t threads, unsigned* grid) {
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (threads < 1 || blocks > 0x7FFFFFFF) return false;
  *grid = unsigned(blocks);
  return true;
}

// The index arguments of the three FM entries below (search and extend do
// not read sa): cbase int64 [2][4] and n int64 [2]; nparts 0: cp uint32
// [R][17] and sa uint32 [n_samples] are whole tables; nparts 1..kMaxShards:
// cp_parts[s] and sa_parts[s] are shard s of each, R rows of 17 words and
// n_samples words per shard.  rows_max / samples_max: the per-block strides.
struct IndexArgs {
  const void *cp, *sa;
  const void* const* cp_parts;
  const void* const* sa_parts;
  int nparts;
  int64_t R, n_samples, rows_max, samples_max;
  const void *cbase, *n;
};

// Calls launch(fm, sa) with the whole-table or the shard-set Fm and SA
// samples the arguments describe; returns the cudaError_t of the launch.
template <typename Launch>
int with_index(const IndexArgs& x, bool need_sa, int64_t L, Launch launch) {
  if (x.R < 1 || x.rows_max < 0 || x.samples_max < 0 || L < 1 ||
      (need_sa && x.n_samples < 1))
    return int(cudaErrorInvalidValue);
  auto cbase = static_cast<const int64_t*>(x.cbase);
  auto n = static_cast<const int64_t*>(x.n);
  if (x.nparts == 0) {
    const Fm<false> fm{static_cast<const uint32_t*>(x.cp), cbase, n, x.R,
                       x.rows_max};
    launch(fm, static_cast<const uint32_t*>(x.sa));
  } else {
    Fm<true> fm{};
    ShardSet sa{};
    if (!make_shard_set(x.cp_parts, x.nparts, x.R, &fm.cp) ||
        (need_sa && !make_shard_set(x.sa_parts, x.nparts, x.n_samples, &sa)))
      return int(cudaErrorInvalidValue);
    fm.cbase = cbase;
    fm.n = n;
    fm.rows_max = x.rows_max;
    launch(fm, sa);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every function returns the cudaError_t of its launch (0 = launched).
// The index as IndexArgs above; pat uint8 with lane dimensions [d0][d1][d2]
// (d0 * d1 * d2 == L) at element strides s0, s1, s2 and m contiguous
// characters per lane; lane tensors int64 [L]; rows_out: null, or int32 [L]
// that receives the number of checkpoint rows each lane fetched (for
// measuring).
#define BTBS_INDEX_PARAMS                                                   \
  const void *cp, const void *sa, const void *const *cp_parts,              \
      const void *const *sa_parts, int nparts, int64_t R, int64_t n_samples, \
      int64_t rows_max, int64_t samples_max, const void *cbase, const void *n
#define BTBS_INDEX_ARGS                                                     \
  IndexArgs{cp,       sa,        cp_parts,    sa_parts, nparts, R,          \
            n_samples, rows_max, samples_max, cbase,    n}

int btbs_fm_search(BTBS_INDEX_PARAMS, const void* pat, int64_t d1, int64_t d2,
                   int64_t s0, int64_t s1, int64_t s2, int m,
                   const void* block, const void* starts, const void* ends,
                   const void* sp0, const void* ep0, int k, int max_len,
                   void* out_sp, void* out_ep, void* rows_out, int64_t L,
                   void* stream) {
  unsigned grid;
  if (m < 1 || d1 < 1 || d2 < 1 || k < 0 || (k > 0 && (!sp0 || !ep0)) ||
      !grid_for(L * 2 * kTpr, &grid))
    return int(cudaErrorInvalidValue);
  const Pat p{static_cast<const uint8_t*>(pat), d1, d2, s0, s1, s2, m};
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const int64_t*>(block);
  auto s = static_cast<const int64_t*>(starts);
  auto e = static_cast<const int64_t*>(ends);
  auto a0 = static_cast<const int64_t*>(sp0);
  auto a1 = static_cast<const int64_t*>(ep0);
  auto o0 = static_cast<int64_t*>(out_sp);
  auto o1 = static_cast<int64_t*>(out_ep);
  auto ro = static_cast<int32_t*>(rows_out);
  return with_index(BTBS_INDEX_ARGS, false, L, [&](const auto& fm, auto) {
    fm_search_kernel<<<grid, kThreads, 0, st>>>(fm, p, b, s, e, a0, a1, k,
                                               max_len, o0, o1, ro, L);
  });
}

int btbs_fm_extend(BTBS_INDEX_PARAMS, const void* pat, int64_t d1, int64_t d2,
                   int64_t s0, int64_t s1, int64_t s2, int m,
                   const void* block, const void* starts, const void* sp_in,
                   const void* ep_in, int ext_max, int64_t ext_occ,
                   void* out_sp, void* out_ep, void* out_st, void* rows_out,
                   int64_t L, void* stream) {
  unsigned grid;
  if (m < 1 || d1 < 1 || d2 < 1 || ext_max < 0 || ext_occ < 0 ||
      ext_occ > 0xFFFFFFFFll || !grid_for(L * 2 * kTpr, &grid))
    return int(cudaErrorInvalidValue);
  const Pat p{static_cast<const uint8_t*>(pat), d1, d2, s0, s1, s2, m};
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const int64_t*>(block);
  auto s = static_cast<const int64_t*>(starts);
  auto a0 = static_cast<const int64_t*>(sp_in);
  auto a1 = static_cast<const int64_t*>(ep_in);
  auto o0 = static_cast<int64_t*>(out_sp);
  auto o1 = static_cast<int64_t*>(out_ep);
  auto o2 = static_cast<int64_t*>(out_st);
  auto ro = static_cast<int32_t*>(rows_out);
  const uint32_t occ = uint32_t(ext_occ);
  return with_index(BTBS_INDEX_ARGS, false, L, [&](const auto& fm, auto) {
    fm_extend_kernel<<<grid, kThreads, 0, st>>>(fm, p, b, s, a0, a1, ext_max,
                                               occ, o0, o1, o2, ro, L);
  });
}

// sa: both blocks, samples_max each; valid uint8 [L]; n_lanes: null, or an
// int64 [1] on the card: lanes at or past it write 0 and load nothing.
int btbs_fm_locate(BTBS_INDEX_PARAMS, int sa_rate, const void* block,
                   const void* pos, const void* valid, const void* n_lanes,
                   void* out, void* rows_out, int64_t L, void* stream) {
  unsigned grid;
  if (sa_rate < 0 || !grid_for(L * kTpr, &grid))
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const int64_t*>(block);
  auto i = static_cast<const int64_t*>(pos);
  auto v = static_cast<const uint8_t*>(valid);
  auto nl = static_cast<const int64_t*>(n_lanes);
  auto o = static_cast<int64_t*>(out);
  auto ro = static_cast<int32_t*>(rows_out);
  return with_index(BTBS_INDEX_ARGS, true, L,
                    [&](const auto& fm, const auto& sa_t) {
    fm_locate_kernel<<<grid, kThreads, 0, st>>>(
        fm, sa_t, n_samples, samples_max, sa_rate, b, i, v, nl, o, ro, L);
  });
}

#undef BTBS_INDEX_PARAMS
#undef BTBS_INDEX_ARGS

// table uint32 [nwords]; out uint32 [1]: `steps` dependent loads, one thread,
// the chain's first address taken from `seed`.
int btbs_dependent_load_chain(const void* table, int64_t nwords, int steps,
                              uint32_t seed, void* out, void* stream) {
  if (nwords < 1 || nwords > 0xFFFFFFFFll || steps < 1)
    return int(cudaErrorInvalidValue);
  dependent_load_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), uint32_t(nwords), steps, seed,
      static_cast<uint32_t*>(out));
  return int(cudaGetLastError());
}

}  // extern "C"
