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

// The backward kernels' pieces (wkv6_bwd.cu, ssd_scan_bwd.cu).
//
// A transposing butterfly over the low ROUNDS bits of a lane's ``sel``
// (the lanes that hold one row's or column's parts): NV parts a lane in,
// each summed over the 2^ROUNDS lanes. Round b while parts remain to
// split: a lane keeps the half that its bit b picks, adds the partner's
// copy of it (the lane whose bit b differs) and leaves it in the first
// half; once one part is left, a round adds the partner's. Afterwards a
// lane holds parts scan_bfly_mine(sel) … + scan_bfly_keep() − 1 in its
// first entries, and lanes that differ only in the bits past the
// splitting rounds hold the same sums (every lane adds in one fixed
// order, so the bytes repeat run to run).
__host__ __device__ constexpr int scan_log2(int x) {
  return x <= 1 ? 0 : 1 + scan_log2(x / 2);
}

template <int NV, int ROUNDS>
struct ScanBfly {
  static constexpr int SPLITS =
      ROUNDS < scan_log2(NV) ? ROUNDS : scan_log2(NV);
  static constexpr int KEEP = NV >> SPLITS;
};

template <int NV, int ROUNDS>
__device__ __forceinline__ void scan_butterfly(float (&part)[NV], int sel) {
#pragma unroll
  for (int bit = 0; bit < ROUNDS; ++bit) {
    if (bit < ScanBfly<NV, ROUNDS>::SPLITS) {
      const int h = NV >> (bit + 1);
      const bool hi = (sel >> bit) & 1;
#pragma unroll
      for (int i = 0; i < NV / 2; ++i) {
        if (i < h) {
          const float send = hi ? part[i] : part[i + h];
          const float keep = hi ? part[i + h] : part[i];
          part[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << bit);
        }
      }
    } else {
      part[0] += __shfl_xor_sync(0xffffffffu, part[0], 1 << bit);
    }
  }
}

template <int NV, int ROUNDS>
__device__ __forceinline__ int scan_bfly_mine(int sel) {
  int mine = 0;
#pragma unroll
  for (int bit = 0; bit < ScanBfly<NV, ROUNDS>::SPLITS; ++bit) {
    mine += ((sel >> bit) & 1) * (NV >> (bit + 1));
  }
  return mine;
}

// The second pass of a backward kernel: out[e] = sum over p = 0 … P − 1
// of part[p · stride + e], in that order (the per-CTA partials of a sum
// across CTAs, added without atomics, so the bytes repeat run to run),
// rounded once to T.
template <typename T>
static __global__ void scan_sum_kernel(const float* __restrict__ part, int P,
                                       int64_t stride, int64_t n,
                                       T* __restrict__ out) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc += part[p * stride + e];
    out[e] = scan_from_float<T>(acc);
  }
}

template <typename T>
static cudaError_t scan_sum(const float* part, int P, int64_t stride,
                            int64_t n, T* out, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t blocks = (n + 255) / 256;
  scan_sum_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                       stream>>>(part, P, stride, n, out);
  return cudaGetLastError();
}

// 4 consecutive elements (8- or 16-byte aligned), widened to float32
__device__ __forceinline__ void scan_load4(const __nv_bfloat16* p,
                                           float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void scan_load4(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
}

// A thread's 4 × 4 tile of a row-major float32 matrix (row stride ld
// floats) into and out of registers
__device__ __forceinline__ void scan_tile_load(float (&t)[4][4],
                                               const float* p, int64_t ld) {
#pragma unroll
  for (int i = 0; i < 4; ++i) scan_load4(p + i * ld, t[i]);
}

__device__ __forceinline__ void scan_tile_store(float* p, int64_t ld,
                                                const float (&t)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(p + i * ld) =
        make_float4(t[i][0], t[i][1], t[i][2], t[i][3]);
  }
}

// Stores ``bytes`` (a multiple of 16) of zeros at p, the CTA's threads in
// turn (the rows of a last chunk past the sequence's end)
__device__ __forceinline__ void scan_zero(unsigned char* p, int bytes,
                                          int tid, int threads) {
  for (int c = tid * 16; c < bytes; c += threads * 16) {
    *reinterpret_cast<uint4*>(p + c) = make_uint4(0, 0, 0, 0);
  }
}

// The tensor-core pieces of the chunked kernels (ssd_scan.cu,
// ssd_scan_bwd.cu, wkv6_bwd.cu).
//
// 3xTF32 on the tensor cores: x = big + small, big x rounded to TF32 (a
// 10-bit mantissa) with two integer operations, small = x − big exactly;
// the tensor core reads the top 19 bits of each operand, so small is
// passed as it is (truncated there: ~2^-21 of x). A product a·b is taken
// as a_small·b_big + a_big·b_small + a_big·b_big (a_small·b_small, ~2^-22
// of it, dropped) with float32 sums: float32 accuracy, where one TF32
// product keeps about 3 digits. An operand exact in TF32 (a bf16 input)
// has no small part, and its cross term is skipped. (cvt.rna.tf32.f32
// costs four integer and compare instructions on sm_90a; this split costs
// three in all.)
__device__ __forceinline__ void ssd_split(float x, uint32_t& big,
                                          uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ float ssd_ld(const float* p) { return *p; }
__device__ __forceinline__ float ssd_ld(const __nv_bfloat16* p) {
  return __uint_as_float((uint32_t)*reinterpret_cast<const uint16_t*>(p)
                         << 16);
}

__device__ __forceinline__ void ssd_mma(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An m16n8k8 fragment, split: A holds (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4) of a 16 × 8 tile, B (k t, n g) and (k t + 4, n g) of an
// 8 × 8 one; ``at(row, col)`` gives the element, ``exact`` leaves small
// unset.
template <int K>
struct SsdFrag {
  uint32_t big[K], small[K];
};

template <bool EXACT, typename At>
__device__ __forceinline__ SsdFrag<4> ssd_frag_a(At at, int g, int t) {
  SsdFrag<4> f;
  const float v[4] = {at(g, t), at(g + 8, t), at(g, t + 4), at(g + 8, t + 4)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (EXACT) {
      f.big[i] = __float_as_uint(v[i]);
    } else {
      ssd_split(v[i], f.big[i], f.small[i]);
    }
  }
  return f;
}

template <bool EXACT, typename At>
__device__ __forceinline__ SsdFrag<2> ssd_frag_b(At at, int g, int t) {
  SsdFrag<2> f;
  const float v[2] = {at(t, g), at(t + 4, g)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (EXACT) {
      f.big[i] = __float_as_uint(v[i]);
    } else {
      ssd_split(v[i], f.big[i], f.small[i]);
    }
  }
  return f;
}

// A product into three accumulators (big·big and the two cross terms), so
// that a tile's tensor-core products do not wait on each other; the caller
// adds them once the tile's sum is done.
struct SsdAcc {
  float bb[4], bs[4], sb[4];
};

__device__ __forceinline__ void ssd_acc_zero(SsdAcc& d) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d.bb[e] = d.bs[e] = d.sb[e] = 0.f;
}

__device__ __forceinline__ float ssd_acc_sum(const SsdAcc& d, int e) {
  return d.bb[e] + (d.bs[e] + d.sb[e]);
}

template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void ssd_mma3(SsdAcc& d, const SsdFrag<4>& a,
                                         const SsdFrag<2>& b) {
  if (!A_EXACT) ssd_mma(d.sb, a.small, b.big);
  if (!B_EXACT) ssd_mma(d.bs, a.big, b.small);
  ssd_mma(d.bb, a.big, b.big);
}

// The backward kernels' (ssd_scan_bwd.cu, wkv6_bwd.cu): an m16n8k8 product
// into one accumulator, the small parts first (a tile whose chains
// interleave with other tiles' needs no accumulator of each), and a pair
// of neighbouring outputs stored at once.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void ssd_mma3_into(float (&d)[4],
                                              const SsdFrag<4>& a,
                                              const SsdFrag<2>& b) {
  if (!A_EXACT) ssd_mma(d, a.small, b.big);
  if (!B_EXACT) ssd_mma(d, a.big, b.small);
  ssd_mma(d, a.big, b.big);
}

__device__ __forceinline__ void ssd_store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
__device__ __forceinline__ void ssd_store2(__nv_bfloat16* p, float lo,
                                           float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}
