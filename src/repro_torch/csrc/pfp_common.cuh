// Shared by the port's CUDA sources: the C interface they export, the fp32
// constants of the moment formulas (repro_torch/core/pfp_math.py) and the
// cp.async copies of the kernels' rings.
#pragma once

#include <cuda_runtime.h>

#define PFP_EXPORT extern "C" __attribute__((visibility("default")))

namespace pfp {

constexpr float kVarEps = 1e-12f;                  // core/gaussian.py VAR_EPS
constexpr float kSqrt2 = 1.41421356237309504880f;
constexpr float kSqrt2Pi = 2.50662827463100050242f;
constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

// Every launcher returns the launch's own error (0 on success); the Python
// wrapper raises on anything else. A refused launch never runs, so this is
// the only place its error shows.
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared-memory limit on the current device the
// first time it is launched there; `raised` is the instantiation's record.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       bool (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  return err;
}

// cp.async: a 16-byte (or 4-byte) copy from global to shared memory that
// zero-fills the destination when !ok; commit closes a group of copies and
// wait<N> waits until at most N groups are in flight.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace pfp
