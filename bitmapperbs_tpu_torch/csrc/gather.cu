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
// this computes the same function with threads that own OUTPUT WORDS,
// t -> (lane = t / W, word = t % W).  The threads of a warp then read the
// consecutive words of a row (one or two 32-byte sectors per 68-byte
// checkpoint row, 128 bytes of sectors at worst) and write consecutive
// words of the output, so both sides coalesce.
//
// What bounds it on the H100: bytes.  Per lane it moves 8 bytes of index,
// the row's sectors in and 4 W bytes out, with no arithmetic beyond the
// address; rows land at unpredictable addresses of tables larger than the
// 50 MB L2, so the floor is device-memory sector traffic and the latency of
// dependent loads (index, then row).  The card needs ~18 KB per SM in flight
// to cover device-memory latency at its memory rate, and one word per thread
// keeps about half of that.  So a thread takes kIlp output words a whole
// grid apart: it loads all kIlp indices first, then all kIlp table words,
// then stores, which keeps kIlp independent row requests in flight instead
// of one, while neighbouring threads still take neighbouring words.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W) against one
// word per thread, inside the kernel: 0.029 against 0.039 ms at 327,680
// lanes of 17-word rows, the same within 3 % at 1- and 3-word rows, and
// 0.0034 against 0.0024 ms on the 40,960-lane k-mer table lookup, whose 80
// blocks no longer fill the 132 SMs.  W is a template parameter for the
// widths the mapping path uses so t / W and t % W compile to multiplies,
// with a runtime-W instantiation for any other width.  Offsets are 64-bit
// throughout: checkpoint rows of a 3 Gbp genome are past 2^31 bytes.
//
// btbs_gather_rows_shard is the same gather over one shard of a table whose
// rows are split into equal ranges, one per card (the sharded index,
// index/device.upload_index_sharded): the table holds global rows
// [base, base + R), and a lane whose index falls outside that range gets a
// zero row without touching the table.  It stands for the reference's
// sharded fetch, clip + where(ok, row, 0) before the psum
// (bitmapperbs_tpu/ops/fm.py:46-69, ops/verify.py:105-112); the caller sums
// the shards' partial rows, and every row lives on exactly one shard.  One
// kernel template serves both (SHARD): the same threads-own-output-words
// layout and kIlp loads in flight, with the range test in place of the clamp.
//
// The FM-index step loops do not come through here on the card: csrc/fm.cu
// fuses their row fetches with the occ / LF step that consumes the row and
// keeps the loop inside one launch, and csrc/verify.cu's gathering entries
// fetch their own genome-plane windows, on a whole table and on a shard set
// alike.  This kernel serves every other table fetch: the k-mer table
// lookup, and the window gather of the dense re-run and the mismatch-only
// paths (on a sharded index one btbs_gather_rows_shard per shard).
//
// btbs_enable_peer_access lets the kernels launched on one card read a
// shard that sits on another (the fused kernels' SHARD instances pick the
// shard of each row themselves); index/device.upload_index_sharded and
// parallel/shard._place call it for every card of an index group.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 4;
constexpr int64_t kMaxBlocks = 0x7FFFFFFF;

// W > 0: compile-time row width; W == 0: runtime width w_rt.
// kIlp output words per thread and trip, a whole grid apart.
// SHARD: the table is global rows [base, base + R); rows outside give 0.
// Otherwise indices are clamped into [0, R - 1] (base unused).
template <int W, bool SHARD>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const int32_t* __restrict__ table, const int64_t* __restrict__ idx,
    int32_t* __restrict__ out, int64_t R, int64_t L, int w_rt, int64_t base) {
  const int64_t w = W > 0 ? W : w_rt;
  const int64_t total = L * w;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t0 = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; t0 < total;
       t0 += kIlp * stride) {
    int64_t src[kIlp];
    int32_t v[kIlp];
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      const int64_t t = t0 + k * stride;
      // -1: past the lanes (no store); -2: a row of another shard (store 0)
      src[k] = -1;
      if (t < total) {
        const int64_t lane = t / w;
        int64_t row = idx[lane];
        if (SHARD) {
          row -= base;
          src[k] = row >= 0 && row < R ? row * w + (t - lane * w) : -2;
        } else {
          row = row < 0 ? 0 : (row >= R ? R - 1 : row);
          src[k] = row * w + (t - lane * w);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kIlp; ++k) v[k] = src[k] >= 0 ? table[src[k]] : 0;
#pragma unroll
    for (int k = 0; k < kIlp; ++k)
      if (src[k] != -1) out[t0 + k * stride] = v[k];
  }
}

template <int W, bool SHARD>
void launch(const int32_t* table, const int64_t* idx, int32_t* out, int64_t R,
            int64_t L, int w, int64_t base, cudaStream_t st) {
  const int64_t total = L * int64_t(w);
  const int64_t per_block = int64_t(kThreads) * kIlp;
  int64_t blocks = (total + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;   // grid-stride covers the rest
  gather_rows_kernel<W, SHARD><<<unsigned(blocks), kThreads, 0, st>>>(
      table, idx, out, R, L, w, base);
}

template <bool SHARD>
int gather(const void* table, const void* idx, void* out, int64_t R,
           int64_t L, int W, int64_t base, void* stream) {
  if (R < 1 || L < 1 || W < 1) return int(cudaErrorInvalidValue);
  auto t = static_cast<const int32_t*>(table);
  auto i = static_cast<const int64_t*>(idx);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: launch<1, SHARD>(t, i, o, R, L, W, base, st); break;
    case 2: launch<2, SHARD>(t, i, o, R, L, W, base, st); break;
    case 3: launch<3, SHARD>(t, i, o, R, L, W, base, st); break;
    case 17: launch<17, SHARD>(t, i, o, R, L, W, base, st); break;
    default: launch<0, SHARD>(t, i, o, R, L, W, base, st); break;
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// table int32 [R][W], idx int64 [L], out int32 [L][W]; returns the
// cudaError_t of the launch (0 = launched).
int btbs_gather_rows(const void* table, const void* idx, void* out, int64_t R,
                     int64_t L, int W, void* stream) {
  return gather<false>(table, idx, out, R, L, W, 0, stream);
}

// The shard's rows int32 [R][W] are global rows [base, base + R); a lane
// outside them gets a zero row.
int btbs_gather_rows_shard(const void* table, const void* idx, void* out,
                           int64_t R, int64_t L, int W, int64_t base,
                           void* stream) {
  return gather<true>(table, idx, out, R, L, W, base, stream);
}

// Lets kernels launched on card `dev` read memory of card `peer` (device
// ordinals); returns the cudaError_t.  Idempotent: a pair already enabled
// returns 0.  The caller has checked cudaDeviceCanAccessPeer; the calling
// thread's current card is restored.
int btbs_enable_peer_access(int dev, int peer) {
  int was;
  cudaError_t rc = cudaGetDevice(&was);
  if (rc != cudaSuccess) return int(rc);
  rc = cudaSetDevice(dev);
  if (rc != cudaSuccess) return int(rc);
  rc = cudaDeviceEnablePeerAccess(peer, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();                    // clear it: not a fault here
    rc = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(was);
  return int(rc != cudaSuccess ? rc : back);
}

}  // extern "C"
