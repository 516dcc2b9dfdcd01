// Shared pieces of the two time-recurrence kernels, wkv6.cu and
// ssd_scan.cu (sm_90a).
//
// Both scans keep one head's state on the chip for the whole sequence and
// split it the same way. A CTA owns SCAN_COLS = 32 state columns (RWKV-6:
// value columns j of S[i, j]; Mamba-2: rows d of h[d, m]), one a lane, and
// each column's N state elements are cut into P parts of Q, one a warp:
// warp p holds elements p·Q … p·Q + Q − 1 of all 32 columns in registers.
// So every lane of a warp reads the same staged elements of a step's
// vectors (a shared-memory broadcast), and a step's readout, a sum over
// the column's N elements, is P partial sums that each warp stores in
// shared memory; the parts are added once the chunk's steps are done, so
// nothing in the serial loop waits on another warp or lane. The time loop
// runs in chunks of SCAN_T steps: the chunk's per-step vectors are copied
// into shared memory with 16-byte asynchronous copies (cp.async), widened
// to float32 by all threads, element by element along a row, and the
// serial loop then reads only shared memory and registers while the next
// chunk's copies are in flight.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SCAN_COLS 32
#define SCAN_T 32

// The split of a column's N state elements: Q a lane (a multiple of 4, so
// a part loads as float4), P parts, a warp each.
template <int N>
struct ScanShape {
  static constexpr int Q = N >= 32 ? N / 8 : 4;
  static constexpr int P = N / Q;
  static constexpr int THREADS = 32 * P;
  static_assert(N % 16 == 0 && Q % 4 == 0 && P * Q == N, "state length");
};

__device__ __forceinline__ void scan_cp_async16(void* smem,
                                                const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void scan_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void scan_cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies ``steps`` rows of VEC 16-byte words, row s at src + s · stride
// bytes, into dst (rows back to back), the CTA's threads in turn.
template <int VEC>
__device__ __forceinline__ void scan_copy_rows(unsigned char* dst,
                                               const unsigned char* src,
                                               int64_t stride, int steps,
                                               int tid, int threads) {
  for (int c = tid; c < steps * VEC; c += threads) {
    scan_cp_async16(dst + c * 16, src + (c / VEC) * stride + (c % VEC) * 16);
  }
}

__device__ __forceinline__ float scan_to_float(float x) { return x; }
__device__ __forceinline__ float scan_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Widens ``count`` staged elements to float32, consecutive threads on
// consecutive elements.
template <typename T>
__device__ __forceinline__ void scan_widen(float* dst, const T* src,
                                           int count, int tid, int threads) {
  for (int c = tid; c < count; c += threads) dst[c] = scan_to_float(src[c]);
}

template <typename T>
__device__ __forceinline__ T scan_from_float(float x);
template <>
__device__ __forceinline__ float scan_from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 scan_from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// steps of the chunk at t0 in a sequence of S
__device__ __forceinline__ int scan_steps(int64_t S, int64_t t0) {
  return S - t0 < SCAN_T ? (int)(S - t0) : SCAN_T;
}

// the sum of y over a warp's 32 lanes, in every lane
__device__ __forceinline__ float scan_warp_sum(float y) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) y += __shfl_xor_sync(0xffffffffu, y, o);
  return y;
}

// Raises a kernel's dynamic shared memory limit to ``bytes`` on its first
// launch (``*done`` remembers it); returns the CUDA error.
template <typename Kernel>
static cudaError_t scan_smem_limit(Kernel kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}
