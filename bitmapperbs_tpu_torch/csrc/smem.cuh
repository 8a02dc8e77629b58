// Dynamic shared memory above 48 KB on sm_90, for the kernels of
// csrc/verify.cu and csrc/pair.cu.
#pragma once

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr size_t kStaticSharedLimit = 48 * 1024;
constexpr size_t kSharedLimit = 227 * 1024;   // a block's most on sm_90
constexpr int kMaxDevices = 64;

// Dynamic shared memory above 48 KB is an opt-in per kernel instance and
// card.  `granted` (one array per kernel instance) keeps what each card was
// granted, so the opt-in is made once per size at the first launch that
// needs it: a CUDA graph captures a launch after a warm-up of the same
// shape (models/graphs.py), and the captured launch makes no attribute call.
// More than kSharedLimit bytes give cudaErrorInvalidValue.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes, size_t* granted) {
  if (bytes > kSharedLimit) return cudaErrorInvalidValue;
  if (bytes <= kStaticSharedLimit) return cudaSuccess;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < kMaxDevices && granted[dev] >= bytes) return cudaSuccess;
  rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (rc == cudaSuccess && dev < kMaxDevices) granted[dev] = bytes;
  return rc;
}

}  // namespace
