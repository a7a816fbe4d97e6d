// Shared helpers for the attention kernels: dtype conversion and the
// rounding the Pallas kernels apply when they cast to the input dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace kaito {

// Masked score.  Finite, like the Pallas kernels' NEG_INF: a row whose
// every key so far is masked keeps m = NEG_INF and its garbage partials
// are zeroed by alpha = exp(NEG_INF - m_new) once a valid key arrives.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA do
}

// x rounded to T and widened back: `.astype(dtype)` in the Pallas kernels.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Raise the dynamic shared-memory cap of a kernel when it needs more
// than the default 48 KB; the H100 allows 227 KB per block.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// allow_smem once per device (not on every call: a call may be captured
// into a CUDA graph, and the host sets the pace of decode); `done` holds
// the devices already raised, one per kernel instance.
template <typename K>
cudaError_t allow_smem_once(K kernel, size_t bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = allow_smem(kernel, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace kaito
