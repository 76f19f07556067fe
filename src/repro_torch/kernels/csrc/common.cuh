// Shared helpers for the port's hand-written Hopper kernels.
//
// Each kernel is exposed through a plain C entry point (extern "C"),
// loaded with ctypes by repro_torch/kernels/_build.py.  An entry point
// launches on the caller's stream, never synchronises, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch (too much shared memory, a bad grid) — such a
// launch never runs and a later synchronise would not report it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// The TPU kernels mask with a large finite negative, not -inf: a row whose
// first processed block is fully masked takes exp(0) = 1 on those slots,
// and the first real score wipes that out through exp(-1e30 - m) = 0.
// With -inf the same row would produce NaN.
#define REPRO_NEG_INF (-1e30f)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte global -> shared copy that bypasses L1 (cp.async.cg; both
// addresses 16-byte aligned).  With ``valid`` false nothing is read and
// the 16 bytes are zero-filled (``gmem`` must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte global -> shared copy (cp.async.ca: the .cg form takes 16 bytes
// only); zero-filled when ``valid`` is false, as cp_async16.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory
// (Hopper allows up to 227 KB per block), then launch-check.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
