// Candidate verification kernels for Hopper (sm_90a), bound with ctypes by
// bitmapperbs_tpu_torch/ops/kernels.py.
//
// btbs_verify_fused replaces bitmapperbs_tpu/ops/pallas_kernels.py
//   _fused_verify_kernel (wrapper verify_fused_pallas): per candidate lane,
//   the e-bit funnel shift of the wide window, the anchored asymmetric
//   bisulfite Hamming count (ref C matches read T, N never matches, masked
//   to the read length) and, when ham > e, semi-global multi-word Myers with
//   the PEQ table built from the read planes in registers.
//   out = ham if ham <= e else min over the ncols end columns.
// btbs_verify_fused_gather replaces the same TPU kernel together with the
//   window gather in front of it (bitmapperbs_tpu/ops/verify.py
//   window_planes, as bitmapperbs_tpu/models/aligner.py
//   candidate_grids_compact calls it): it takes what the compact path holds
//   before any plane exists (the packed genome planes, per lane an
//   orientation, a u32 window start, a row of the read-plane table and a read
//   length) and does the window fetch, the start & 31 funnel, the
//   out-of-range -> N marking (wrapped-negative starts and windows past the
//   genome end included) and the length mask in registers.
// btbs_myers replaces pallas_kernels.py _myers_kernel (wrapper myers_pallas):
//   the same Myers recurrence from a precomputed PEQ table and pad rows
//   (N columns take the pad row); out = min over the ncols end columns.
// btbs_myers_scan replaces pallas_kernels.py _myers_scan_kernel (wrapper
//   myers_scan_pallas): the recurrence of btbs_myers, with the running
//   score written after EVERY column (paired-end mate rescue scans the
//   whole insert window of a pair in one lane: ncols = R + m + 2e).
//
// Layout: one thread per lane; each lane's words are contiguous int32 bits
// (lane-major, as the port's tensors come): win [L][3][Ww], read planes
// [L][3][Wd], lenmask / pad [L][Wd], peq [L][4][Wd]; out int32 [L], and for
// the scan int32 [ncols][L] (column-major).  A scan lane reads ~3 Ww + 5 Wd
// words but writes ncols (605 at insert 0-500, m = 96, e = 4), so the store
// is what its layout is chosen for: column j of a warp's 32 lanes is one
// 128-byte line.  The wrapper returns the [L, ncols] transpose as a view.
//
// What bounds it on the H100: the column loop is serial per lane (ncols
// steps of ~10 * Wd integer ops) and the state (VP, VN, PEQ, pad: 7 * Wd
// words) must stay in registers.  Compute, not bytes: a lane reads
// (3 Ww + 4 Wd) words once and writes one word (the scan: one per column,
// ~4 bytes per ~30 integer ops).  The design keeps the whole state in registers
// by instantiating the word count WD = 1..8 at compile time (reads up to
// 256 bp) so every word loop unrolls; a runtime-Wd instantiation with local
// arrays covers buckets up to 1024 bp.  The fused kernel skips the Myers
// loop for lanes whose Hamming count already decides the result.  The three
// entries that take planes read lane-major rows, one thread per row, so
// their loads do not coalesce.
//
// The gathering entry is bound the same way (operations: the Myers columns
// of the lanes whose Hamming count does not decide them) and removes what
// stood between it and that bound on the compact path: ~20 MB of int64
// plane intermediates per 163,840-lane batch written and re-read through
// device memory by some thirty small tensor ops, three concatenate /
// narrow / copy passes to build the lane-major rows, and warps that ran all
// ncols columns with most of their threads idle because the lanes with
// ham > e are scattered.  A lane needs 12 (Wd + 2) contiguous bytes of genome
// planes: each thread fetches them as whole words into registers.  After the
// Hamming pass the block compacts the lanes that need Myers (warp ballot,
// popcount prefix over the block's warps) into a shared-memory staging
// area, one padded row per lane so rows fall on different banks; the first
// `count` threads then run the column loop on full warps and the other
// warps leave.  The staging area holds 7 Wd + 3 words per thread, which is
// why this entry exists for the compile-time word counts (reads up to 256
// bp) only; longer buckets gather with ops/verify.window_planes and take
// btbs_verify_fused.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 32;   // MAX_READ_LEN 1024 / 32
constexpr int kThreads = 128;

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

// WD > 0: compile-time word count; WD == 0: runtime wd (<= kMaxWords).
template <int WD>
__global__ void __launch_bounds__(kThreads) verify_fused_kernel(
    const uint32_t* __restrict__ win, const uint32_t* __restrict__ rd,
    const uint32_t* __restrict__ lm, int32_t* __restrict__ out, int64_t L,
    int wd_rt, int ww, int m, int ncols, int e) {
  constexpr int NW = WD > 0 ? WD : kMaxWords;
  const int wd = WD > 0 ? WD : wd_rt;
  const int64_t lane = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const uint32_t* w0 = win + lane * 3 * ww;
  const uint32_t* w1 = w0 + ww;
  const uint32_t* wn = w1 + ww;
  const uint32_t* d0 = rd + lane * 3 * wd;
  const uint32_t* d1 = d0 + wd;
  const uint32_t* dn = d1 + wd;
  const uint32_t* lmask = lm + lane * wd;

  // anchored Hamming from the e-shifted wide window
  int ham = 0;
  for (int k = 0; k < wd; ++k) {
    const uint32_t a0 = funnel(w0, k, e), a1 = funnel(w1, k, e),
                   an = funnel(wn, k, e);
    const uint32_t r0 = d0[k], r1 = d1[k], rn = dn[k];
    const uint32_t eqb = ~(a0 ^ r0) & ~(a1 ^ r1);
    const uint32_t match = (eqb | ((a0 & ~a1) & (r0 & r1))) & ~an & ~rn;
    ham += __popc(~match & lmask[k]);
  }
  if (ham <= e) {
    out[lane] = ham;
    return;
  }

  // PEQ from the read planes (asymmetric match; pad rows always match)
  uint32_t peq[4][NW], pad[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    if (k < wd) {
      const uint32_t r0 = d0[k], r1 = d1[k], rn = dn[k];
      const uint32_t p = ~lmask[k];
      pad[k] = p;
      peq[0][k] = (~r0 & ~r1 & ~rn) | p;
      peq[1][k] = ((r0 & ~r1 & ~rn) | (r0 & r1 & ~rn)) | p;
      peq[2][k] = (~r0 & r1 & ~rn) | p;
      peq[3][k] = (r0 & r1 & ~rn) | p;
    }
  }
  out[lane] = myers_min<NW>(w0, w1, wn, peq, pad, wd, m, ncols);
}

// bits [0, nb) for nb in [0, 32]
__device__ __forceinline__ uint32_t mask_lt(uint32_t nb) {
  return nb >= 32u ? 0xFFFFFFFFu : ((1u << nb) - 1u);
}

// The gathering entry: one thread per lane through the window fetch and the
// Hamming pass, then the block's ham > e lanes compacted onto its first
// threads for the Myers loop.  WD: compile-time word count; the window is
// WD + 1 words.
template <int WD>
__global__ void __launch_bounds__(kThreads) verify_fused_gather_kernel(
    const uint32_t* __restrict__ gp, const int64_t* __restrict__ orient,
    const int64_t* __restrict__ start, const int64_t* __restrict__ rtab,
    const int64_t* __restrict__ rrow, const int64_t* __restrict__ rlen,
    int32_t* __restrict__ out, int64_t L, int64_t R, int64_t gwords,
    int64_t genome_len, int m, int ncols, int e) {
  constexpr int WW = WD + 1;
  constexpr int NS = (3 * WW + 4 * WD) | 1;    // odd row stride: no bank clash
  __shared__ uint32_t stage[kThreads][NS];
  __shared__ int slot_thread[kThreads];
  __shared__ int warp_count[kThreads / 32];
  const int64_t lane = int64_t(blockIdx.x) * kThreads + threadIdx.x;

  uint32_t w0[WW], w1[WW], wn[WW], d0[WD], d1[WD], dn[WD], lmask[WD];
  bool need = false;
  if (lane < L) {
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
      int64_t r = wi + k;
      r = base + (r >= gwords ? gwords - 1 : r);
      r = r < 0 ? 0 : (r >= 2 * gwords ? 2 * gwords - 1 : r);
      const uint32_t* q = gp + r * 3;
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
      const uint32_t ws = st + 32u * uint32_t(k);          // word's first position
      uint32_t oob;
      if (ws >= 0xFFFFF000u) {                             // wrapped below 0
        const uint32_t neg = 0u - ws;
        oob = mask_lt(neg < 32u ? neg : 32u);
      } else if (int64_t(ws) >= genome_len) {
        oob = 0xFFFFFFFFu;
      } else {
        const int64_t left = genome_len - int64_t(ws);
        oob = ~mask_lt(left < 32 ? uint32_t(left) : 32u);
      }
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

// out[j * L + lane]: the score after window column j (column-major store).
template <int WD>
__global__ void __launch_bounds__(kThreads) myers_scan_kernel(
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
  int32_t* col = out + lane;
  myers_run<NW>(w0, w0 + ww, w0 + 2 * ww, peq, pad, wd, m, ncols,
                [&](int j, int score) { col[int64_t(j) * L] = score; });
}

template <int WD>
void launch_fused(const uint32_t* win, const uint32_t* rd, const uint32_t* lm,
                  int32_t* out, int64_t L, int wd, int ww, int m, int ncols,
                  int e, cudaStream_t st) {
  const unsigned grid = unsigned((L + kThreads - 1) / kThreads);
  verify_fused_kernel<WD><<<grid, kThreads, 0, st>>>(win, rd, lm, out, L, wd,
                                                     ww, m, ncols, e);
}

template <int WD>
void launch_fused_gather(const uint32_t* gp, const int64_t* orient,
                         const int64_t* start, const int64_t* rtab,
                         const int64_t* rrow, const int64_t* rlen, int32_t* out,
                         int64_t L, int64_t R, int64_t gwords,
                         int64_t genome_len, int m, int ncols, int e,
                         cudaStream_t st) {
  const unsigned grid = unsigned((L + kThreads - 1) / kThreads);
  verify_fused_gather_kernel<WD><<<grid, kThreads, 0, st>>>(
      gp, orient, start, rtab, rrow, rlen, out, L, R, gwords, genome_len, m,
      ncols, e);
}

template <int WD>
void launch_myers(const uint32_t* win, const uint32_t* peq,
                  const uint32_t* pad, int32_t* out, int64_t L, int wd,
                  int ww, int m, int ncols, cudaStream_t st) {
  const unsigned grid = unsigned((L + kThreads - 1) / kThreads);
  myers_kernel<WD><<<grid, kThreads, 0, st>>>(win, peq, pad, out, L, wd, ww,
                                              m, ncols);
}

template <int WD>
void launch_myers_scan(const uint32_t* win, const uint32_t* peq,
                       const uint32_t* pad, int32_t* out, int64_t L, int wd,
                       int ww, int m, int ncols, cudaStream_t st) {
  const unsigned grid = unsigned((L + kThreads - 1) / kThreads);
  myers_scan_kernel<WD><<<grid, kThreads, 0, st>>>(win, peq, pad, out, L, wd,
                                                   ww, m, ncols);
}

bool shapes_ok(int64_t L, int wd, int ww, int ncols) {
  return L > 0 && L <= int64_t(kThreads) * 0x7FFFFFFF && wd >= 1 &&
         wd <= kMaxWords && ww >= 1 && ncols >= 1 && ncols <= 32 * ww;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).
int btbs_verify_fused(const void* win, const void* rd, const void* lm,
                      void* out, int64_t L, int wd, int ww, int m, int ncols,
                      int e, void* stream) {
  if (!shapes_ok(L, wd, ww, ncols) || e < 0 || e > 31 ||
      (e > 0 && ww < wd + 1))
    return int(cudaErrorInvalidValue);
  auto w = static_cast<const uint32_t*>(win);
  auto r = static_cast<const uint32_t*>(rd);
  auto l = static_cast<const uint32_t*>(lm);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (wd) {
    case 1: launch_fused<1>(w, r, l, o, L, wd, ww, m, ncols, e, st); break;
    case 2: launch_fused<2>(w, r, l, o, L, wd, ww, m, ncols, e, st); break;
    case 3: launch_fused<3>(w, r, l, o, L, wd, ww, m, ncols, e, st); break;
    case 4: launch_fused<4>(w, r, l, o, L, wd, ww, m, ncols, e, st); break;
    case 5: launch_fused<5>(w, r, l, o, L, wd, ww, m, ncols, e, st); break;
    case 6: launch_fused<6>(w, r, l, o, L, wd, ww, m, ncols, e, st); break;
    case 7: launch_fused<7>(w, r, l, o, L, wd, ww, m, ncols, e, st); break;
    case 8: launch_fused<8>(w, r, l, o, L, wd, ww, m, ncols, e, st); break;
    default: launch_fused<0>(w, r, l, o, L, wd, ww, m, ncols, e, st); break;
  }
  return int(cudaGetLastError());
}

// gp uint32 [2 * gwords][3] genome planes; orient, start (u32 value), rrow,
// rlen int64 [L]; rtab int64 [R][3 * wd] read planes (u32 values); out int32
// [L].  wd in 1..8 and a window of exactly wd + 1 words.
int btbs_verify_fused_gather(const void* gp, const void* orient,
                             const void* start, const void* rtab,
                             const void* rrow, const void* rlen, void* out,
                             int64_t L, int64_t R, int64_t gwords,
                             int64_t genome_len, int wd, int m, int ncols,
                             int e, void* stream) {
  if (!shapes_ok(L, wd, wd + 1, ncols) || wd > 8 || ncols <= 32 * wd ||
      e < 0 || e > 31 || R < 1 || gwords < 1 || genome_len < 0)
    return int(cudaErrorInvalidValue);
  auto g = static_cast<const uint32_t*>(gp);
  auto a = static_cast<const int64_t*>(orient);
  auto s = static_cast<const int64_t*>(start);
  auto t = static_cast<const int64_t*>(rtab);
  auto r = static_cast<const int64_t*>(rrow);
  auto n = static_cast<const int64_t*>(rlen);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define BTBS_FUSED_GATHER(WD)                                             \
  case WD:                                                                \
    launch_fused_gather<WD>(g, a, s, t, r, n, o, L, R, gwords, genome_len, \
                            m, ncols, e, st);                             \
    break;
  switch (wd) {
    BTBS_FUSED_GATHER(1)
    BTBS_FUSED_GATHER(2)
    BTBS_FUSED_GATHER(3)
    BTBS_FUSED_GATHER(4)
    BTBS_FUSED_GATHER(5)
    BTBS_FUSED_GATHER(6)
    BTBS_FUSED_GATHER(7)
    BTBS_FUSED_GATHER(8)
  }
#undef BTBS_FUSED_GATHER
  return int(cudaGetLastError());
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

int btbs_myers_scan(const void* win, const void* peq, const void* pad,
                    void* out, int64_t L, int wd, int ww, int m, int ncols,
                    void* stream) {
  if (!shapes_ok(L, wd, ww, ncols)) return int(cudaErrorInvalidValue);
  auto w = static_cast<const uint32_t*>(win);
  auto q = static_cast<const uint32_t*>(peq);
  auto p = static_cast<const uint32_t*>(pad);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (wd) {
    case 1: launch_myers_scan<1>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 2: launch_myers_scan<2>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 3: launch_myers_scan<3>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 4: launch_myers_scan<4>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 5: launch_myers_scan<5>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 6: launch_myers_scan<6>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 7: launch_myers_scan<7>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    case 8: launch_myers_scan<8>(w, q, p, o, L, wd, ww, m, ncols, st); break;
    default: launch_myers_scan<0>(w, q, p, o, L, wd, ww, m, ncols, st); break;
  }
  return int(cudaGetLastError());
}

}  // extern "C"
