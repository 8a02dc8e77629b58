// Table row gather for Hopper (sm_90a), bound with ctypes by
// bitmapperbs_tpu_torch/ops/kernels.py.
//
// btbs_gather_rows replaces scripts/pallas_gather_proto.py
//   make_pallas_gather.gather (kernel body `kernel`): out[i, :] =
//   table[idx[i], :], the per-lane row fetch behind every FM-index step
//   (checkpoint rows, W = 17), the SA-sample lookup (W = 1), the k-mer table
//   lookup (W = 2) and the genome-plane window gather (W = 3).  The index
//   is clamped into [0, R - 1] here, as the reference's gathers clamp, so
//   callers need no separate clamp pass.
//
// The TPU prototype issued one async row copy per lane with a window of
// copies in flight, because its vector unit has no per-lane addressing.
// A GPU thread addresses memory itself, so that loop is not carried over:
// this computes the same function with one thread per OUTPUT WORD,
// t -> (lane = t / W, word = t % W).  The threads of a warp then read the
// consecutive words of a row (one or two 32-byte sectors per 68-byte
// checkpoint row, 128 bytes of sectors at worst) and write consecutive
// words of the output, so both sides coalesce.
//
// What bounds it on the H100: bytes.  Per lane it moves 8 bytes of index,
// the row's sectors in and 4 W bytes out, with no arithmetic beyond the
// address; rows land at unpredictable addresses of tables larger than the
// 50 MB L2, so the floor is device-memory sector traffic and the latency of
// dependent loads (index, then row).  The design keeps every access
// coalesced and leaves enough warps resident to cover that latency; W is a
// template parameter for the widths the mapping path uses so t / W and
// t % W compile to multiplies, with a runtime-W variant for any other
// width.  Offsets are 64-bit throughout: checkpoint rows of a 3 Gbp genome
// are past 2^31 bytes.  cp.async / TMA bulk row copies, a deeper in-flight
// window and fusing the occ / LF step onto the fetched row are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 0x7FFFFFFF;

// W > 0: compile-time row width; W == 0: runtime width w_rt.
template <int W>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const int32_t* __restrict__ table, const int64_t* __restrict__ idx,
    int32_t* __restrict__ out, int64_t R, int64_t L, int w_rt) {
  const int64_t w = W > 0 ? W : w_rt;
  const int64_t total = L * w;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t lane = t / w;
    const int64_t word = t - lane * w;
    int64_t row = idx[lane];
    row = row < 0 ? 0 : (row >= R ? R - 1 : row);
    out[t] = table[row * w + word];
  }
}

template <int W>
void launch(const int32_t* table, const int64_t* idx, int32_t* out, int64_t R,
            int64_t L, int w, cudaStream_t st) {
  const int64_t total = L * int64_t(w);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;   // grid-stride covers the rest
  gather_rows_kernel<W><<<unsigned(blocks), kThreads, 0, st>>>(table, idx, out,
                                                              R, L, w);
}

}  // namespace

extern "C" {

// table int32 [R][W], idx int64 [L], out int32 [L][W]; returns the
// cudaError_t of the launch (0 = launched).
int btbs_gather_rows(const void* table, const void* idx, void* out, int64_t R,
                     int64_t L, int W, void* stream) {
  if (R < 1 || L < 1 || W < 1) return int(cudaErrorInvalidValue);
  auto t = static_cast<const int32_t*>(table);
  auto i = static_cast<const int64_t*>(idx);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: launch<1>(t, i, o, R, L, W, st); break;
    case 2: launch<2>(t, i, o, R, L, W, st); break;
    case 3: launch<3>(t, i, o, R, L, W, st); break;
    case 17: launch<17>(t, i, o, R, L, W, st); break;
    default: launch<0>(t, i, o, R, L, W, st); break;
  }
  return int(cudaGetLastError());
}

}  // extern "C"
