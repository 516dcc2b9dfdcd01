// Shared pieces of the two time-recurrence kernels, wkv6.cu and
// ssd_scan.cu (sm_90a).
//
// Both scans keep one head's state on the chip for the whole sequence and
// give a CTA SCAN_COLS = 32 of its state columns (RWKV-6: value columns j
// of S[i, j]; Mamba-2: rows d of h[d, m]). Each has two kernels, and a call
// launches one of them:
//
// * the serial kernel, for a call shorter than one chunk of SCAN_T steps
//   (a decode step): a lane a column, the column's N state elements cut
//   into P parts of Q, one a warp (ScanShape); the chunk's per-step
//   vectors are copied into shared memory with 16-byte asynchronous copies
//   (cp.async), widened to float32 by all threads, and the serial loop
//   reads only shared memory and registers; the warps' readout parts are
//   summed after the chunk.
// * the pipelined kernel, for a call of one chunk or more: one producer
//   warp copies each chunk as it arrives into one of three stages, two
//   chunks ahead, while the consumer warps compute the current one (the
//   inputs widened in registers), and the two sides hand stages over with
//   named barriers (bar.sync / bar.arrive with an id and a thread count:
//   scan_bar_sync, scan_bar_arrive); no CTA-wide __syncthreads runs inside
//   the time loop. wkv6.cu's consumers run the serial step on 4 × 4 tiles
//   of the state; ssd_scan.cu's run Mamba-2's chunked form on the tensor
//   cores.
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

// a 4-byte asynchronous copy (one float)
__device__ __forceinline__ void scan_cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void scan_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void scan_cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// waits for all but the most recent group (or for all of them when
// ``all``)
__device__ __forceinline__ void scan_cp_async_wait_prior(bool all) {
  if (all) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
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

// Named barrier ``id`` (1-15; 0 is __syncthreads'): bar.sync waits until
// ``count`` threads (a multiple of 32) have arrived, bar.arrive arrives
// without waiting. Both order the calling thread's earlier shared-memory
// writes before the barrier for the threads that wait on it; a warp meets
// them converged (the instructions are .aligned).
__device__ __forceinline__ void scan_bar_sync(int id, int count) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void scan_bar_arrive(int id, int count) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// One warp's copy of ``steps`` rows of VEC 16-byte words (VEC ≤ 32; row s
// at src + s · stride bytes) into dst, rows back to back: lane l takes
// word l % VEC of rows l / VEC, l / VEC + 32 / VEC, …, its pointers
// advanced by a pass's rows, so that a copy costs a few instructions.
template <int VEC>
__device__ __forceinline__ void scan_copy_rows_warp(unsigned char* dst,
                                                    const unsigned char* src,
                                                    int64_t stride, int steps,
                                                    int lane) {
  static_assert(VEC >= 1 && VEC <= 32 && 32 % VEC == 0, "row words");
  constexpr int PASS = 32 / VEC;   // rows a pass
  const int row = lane / VEC, col = (lane % VEC) * 16;
  const unsigned char* s = src + row * stride + col;
  unsigned char* d = dst + row * VEC * 16 + col;
  const int64_t s_pass = PASS * stride;
  for (int r = row; r < steps; r += PASS) {
    scan_cp_async16(d, s);
    s += s_pass;
    d += PASS * VEC * 16;
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
