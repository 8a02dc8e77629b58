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
// loop for lanes whose Hamming count already decides the result.  Loads are
// uncoalesced (lane-major rows); feature-major layouts, fusing the window
// gather, and cp.async staging are later work.
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
