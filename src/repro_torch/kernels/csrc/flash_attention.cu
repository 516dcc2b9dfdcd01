// flash_attention: GQA attention with an online softmax (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:110
// ``flash_attention`` (pallas_call at :138, body ``_flash_kernel`` at :37).
//
//   out[b, h, i] = softmax_j(s_ij) . v[b, h / G, j]
//   s_ij = cap * tanh(scale * (q_i . k_j) / cap)      (cap optional)
//
// over the keys j < Skv with j <= q_offset + i (causal) and
// j > q_offset + i - window (sliding window); G = Hq / Hkv, so query head h
// reads KV head h / G by index and K and V are never repeated in memory.
// A fully-masked row gives 0. Running max, denominator and accumulator are
// float32; q, k and v are float32 or bfloat16 and the output takes their
// type. Its answer is ``ref.attention_ref``'s (kernels/ref.py), within
// float tolerance. Inputs are read through their batch, head and sequence
// strides (the last dimension contiguous), so the projections' transposed
// views need no copy; the output is contiguous [B, Hq, Sq, D].
//
// Bound (operations): 4 * B * Hq * (live pairs) * D flops, the two
// products. For llama3.2-1b's 32k prefill (B 1, Hq 32, Hkv 8, D 64, bf16,
// causal): 4.40 TFLOP, 4.45 ms at 989 TFLOP/s bf16; the 335 MB of q, k, v
// and o take 0.10 ms at 3.35 TB/s.
//
// Two kernels, one per input type (a rule by type, not a fallback: a bf16
// call that cannot launch its kernel returns the CUDA error).
//
// bfloat16: fa_hopper.cuh, on the tensor cores. One CTA per (b, h, query
// tile), heaviest (diagonal) tiles first, the Hq / Hkv query heads of one
// KV head side by side in the grid so their K and V tiles meet in L2.
// Producer and consumers: one thread of a producer warpgroup issues TMA
// loads (128-byte swizzle, 64 columns a box) of the q tile once and of the
// K and V tiles through a ring of stages, completion on mbarriers;
// setmaxnreg moves the producer's registers to the consumer warpgroups,
// which own 64 query rows each. S = q . k^T is wgmma with both operands in
// shared memory and a float32 sum; the scale multiplies S after the
// product (pre-scaling q in bf16 would round it at D 120 or 128), log2(e)
// folded in for ex2. Soft cap, causal and window masks and Skv act on S
// in registers, and only on the tiles that cross the diagonal, the
// window's edge or Skv; a warpgroup skips the tiles wholly outside its
// rows' reach. P . V is wgmma with P from registers (the S accumulator's
// fragment is the A operand's, pair by pair) and V from shared memory,
// MN-major (the transpose bit), 64 columns of V at a time into a fresh
// float32 sum that is added to O in registers: the tensor cores' own
// float32 sum, carried over the 2,000 key steps of a 32k row, drifted to
// 6.0e-4 over the last eighth of the rows against 1.5e-4 this way. O is
// divided by the denominator at the end. head_dim pads to D_PAD in {64,
// 128, 256} (TMA fills columns past D and rows past Sq or Skv with zeros;
// stores are masked). Tiles, chosen on the card (PERF.md): at D_PAD 64,
// three consumer warpgroups (192 query rows, 160 registers a thread), 128
// keys a tile, 4 stages; at 128 and 256, two warpgroups (128 rows, 240
// registers), 64 keys, 3 and 2 stages.
//
// Split P. P rounded once to bf16 (the textbook tensor-core kernel) puts
// a relative Frobenius error of 2.15e-3 (2.46e-3 over the last eighth of
// the rows) on llama's head shape at S = 2,048 against the float32
// softmax, over the 1e-3 gate. So P enters the second product as two bf16
// parts: P_hi, P with its low 16 bits cleared (one byte permute a pair),
// and P_lo = bf16(P - P_hi) (rounded), both multiplied by V. At S = 1,024
// on llama's, gemma3-4b's and danube's heads the split reads 1.2e-4 and
// one rounding 2.1e-3 (tests/test_torch_attention.py replays both). The
// second product costs 1.5x the algorithm's tensor-core operations: the
// kernel's own floor is 6.7 ms at the 32k shape.
//
// float32: the SIMT kernel below (float32 FMA, no tensor cores: they
// would take float32 as TF32, about three decimal digits, and float32 is
// the gates' type, held at 1e-5). One CTA of 256 threads per (b, h,
// 64-query tile); the q tile (pre-scaled in float32) and each 64-key K and
// V tile are staged in shared memory, rows padded by 4 floats. Thread
// (ty, tx) of the 16 x 16 grid computes the scores of rows ty + 16i and
// keys tx + 16j (i, j < 4) as a 4 x 4 register tile, reduces each row's
// max and sum over its 16 lanes with shuffles, stages the probabilities
// in shared memory, and accumulates the same four rows of the output, so
// the rescale stays in registers. Only live key tiles are visited (from
// the window's first visible key to the causal limit), heaviest query
// tiles first.
//
// Left on the table (bf16): overlap of a warpgroup's softmax with its
// own next S product (registers: the split P doubles P's, and D_PAD 64
// and 256 still spill a few), explicit ping-pong of the warpgroups'
// products, TMA stores of O, a persistent grid, and wider key tiles at
// D_PAD 128 and 256.
#include <cuda_bf16.h>

#include "common.cuh"
#include "fa_hopper.cuh"

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_PS (FA_BK + 4)          // row stride of the probability tile
#define FA_NEG_INF (-1e30f)

__device__ __forceinline__ float fa_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ void fa_store(float* p, float x) { *p = x; }

// Stages rows [r0, r0 + 64) of one head's [S, D] slice (row stride ss) as
// float32 times mul in a [64][DS] shared tile, zeros past S and D.
template <typename T, int D_PAD>
__device__ __forceinline__ void fa_stage(float* dst, const T* src,
                                         int64_t ss, int32_t r0, int32_t S,
                                         int32_t D, float mul) {
  constexpr int DS = D_PAD + 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < 64 * D_PAD; idx += FA_THREADS) {
    const int r = idx / D_PAD, c = idx % D_PAD;
    float x = 0.0f;
    if (r0 + r < S && c < D) x = fa_load(src + (int64_t)(r0 + r) * ss + c) * mul;
    dst[r * DS + c] = x;
  }
}

template <typename T, int D_PAD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int64_t q_sb, int64_t q_sh, int64_t q_ss,
                       int64_t k_sb, int64_t k_sh, int64_t k_ss,
                       int64_t v_sb, int64_t v_sh, int64_t v_ss,
                       int32_t Hq, int32_t Hkv, int32_t Sq, int32_t Skv,
                       int32_t D, int32_t causal, int32_t has_window,
                       int32_t window, int32_t q_offset, float scale,
                       int32_t has_cap, float cap) {
  constexpr int DS = D_PAD + 4;
  constexpr int TD = D_PAD / 16;   // output columns per thread
  extern __shared__ float4 fa_smem4[];
  float* sQ = reinterpret_cast<float*>(fa_smem4);
  float* sK = sQ + FA_BQ * DS;
  float* sV = sK + FA_BK * DS;
  float* sP = sV + FA_BK * DS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int32_t q0 = (int32_t)(gridDim.x - 1 - blockIdx.x) * FA_BQ;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  fa_stage<T, D_PAD>(sQ, qb, q_ss, q0, Sq, D, scale);

  float acc[4][TD];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = FA_NEG_INF;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.0f;
  }

  // the live key tiles: from the window's first visible key of the tile's
  // first row to the causal limit of its last row
  int32_t k_lo = 0, k_hi = Skv;
  if (has_window) {
    const int32_t first = q_offset + q0 - window + 1;
    k_lo = first > 0 ? (first / FA_BK) * FA_BK : 0;
  }
  if (causal) {
    const int32_t last = q_offset + q0 + FA_BQ;   // exclusive
    k_hi = last < Skv ? last : Skv;
  }

  for (int32_t k0 = k_lo; k0 < k_hi; k0 += FA_BK) {
    fa_stage<T, D_PAD>(sK, kb, k_ss, k0, Skv, D, 1.0f);
    fa_stage<T, D_PAD>(sV, vb, v_ss, k0, Skv, D, 1.0f);
    __syncthreads();

    // scores of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D_PAD; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * DS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * DS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }

    // cap, mask, online softmax over the tile; the row's 16 lanes share
    // its max and sum through shuffles (xor offsets < 16 stay in the half
    // warp that holds the row)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int32_t qpos = q_offset + q0 + ty + 16 * i;
      bool live[4];
      float mx = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int32_t kpos = k0 + tx + 16 * j;
        live[j] = kpos < Skv && (!causal || kpos <= qpos) &&
                  (!has_window || kpos > qpos - window);
        float x = s[i][j];
        if (has_cap) x = cap * tanhf(x / cap);
        s[i][j] = live[j] ? x : FA_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.0f;
        sP[(ty + 16 * i) * FA_PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc[i][4m + e] += sum_j p[ty + 16i][j] * v[j][64m + 4tx + e]
#pragma unroll 2
    for (int j = 0; j < FA_BK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * FA_PS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int m = 0; m < TD / 4; ++m) {
          const float4 vv = *reinterpret_cast<const float4*>(
              sV + (j + jj) * DS + 64 * m + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? p4[i].x : jj == 1 ? p4[i].y
                          : jj == 2 ? p4[i].z : p4[i].w;
            acc[i][4 * m + 0] = fmaf(p, vv.x, acc[i][4 * m + 0]);
            acc[i][4 * m + 1] = fmaf(p, vv.y, acc[i][4 * m + 1]);
            acc[i][4 * m + 2] = fmaf(p, vv.z, acc[i][4 * m + 2]);
            acc[i][4 * m + 3] = fmaf(p, vv.w, acc[i][4 * m + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int32_t row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
    T* orow = o + (((int64_t)b * Hq + h) * Sq + row) * D;
#pragma unroll
    for (int m = 0; m < TD / 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * m + 4 * tx + e;
        if (c < D) fa_store(orow + c, acc[i][4 * m + e] / denom);
      }
  }
}

template <typename T, int D_PAD>
static int fa_launch(const void* q, const void* k, const void* v, void* o,
                     const int64_t* st, int32_t B, int32_t Hq, int32_t Hkv,
                     int32_t Sq, int32_t Skv, int32_t D, int32_t causal,
                     int32_t has_window, int32_t window, int32_t q_offset,
                     float scale, int32_t has_cap, float cap,
                     cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(FA_BQ + 2 * FA_BK) * (D_PAD + 4) +
                       (size_t)FA_BQ * FA_PS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D_PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((Sq + FA_BQ - 1) / FA_BQ),
                  (unsigned int)Hq, (unsigned int)B);
  flash_attention_kernel<T, D_PAD><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], Hq, Hkv, Sq, Skv, D, causal,
      has_window, window, q_offset, scale, has_cap, cap);
  return (int)cudaGetLastError();
}

template <typename T>
static int fa_dispatch(const void* q, const void* k, const void* v, void* o,
                       const int64_t* st, int32_t B, int32_t Hq, int32_t Hkv,
                       int32_t Sq, int32_t Skv, int32_t D, int32_t causal,
                       int32_t has_window, int32_t window, int32_t q_offset,
                       float scale, int32_t has_cap, float cap,
                       cudaStream_t stream) {
  if (D <= 64)
    return fa_launch<T, 64>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, D, causal,
                            has_window, window, q_offset, scale, has_cap,
                            cap, stream);
  if (D <= 128)
    return fa_launch<T, 128>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, D, causal,
                             has_window, window, q_offset, scale, has_cap,
                             cap, stream);
  return fa_launch<T, 256>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, D, causal,
                           has_window, window, q_offset, scale, has_cap, cap,
                           stream);
}

// Strides are in elements: q's, k's and v's (batch, head, sequence), the
// last dimension contiguous; for bfloat16 each a multiple of 8 and each
// base 16-byte aligned (TMA's rule). is_bf16 picks bfloat16 (the tensor-core
// kernel) or float32 (the SIMT kernel). Returns a CUDA error, or
// fa_hopper::kEncodeError + the CUresult where cuTensorMapEncodeTiled
// refuses a tensor map.
extern "C" int fw_flash_attention(
    const void* q, const void* k, const void* v, void* o, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int32_t B, int32_t Hq,
    int32_t Hkv, int32_t Sq, int32_t Skv, int32_t D, int32_t causal,
    int32_t has_window, int32_t window, int32_t q_offset, float scale,
    int32_t has_cap, float cap, int32_t is_bf16, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaGetLastError();
  const int64_t st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                         v_sb, v_sh, v_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return fa_hopper::launch(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, D, causal,
                             has_window, window, q_offset, scale, has_cap,
                             cap, s);
  return fa_dispatch<float>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, D, causal,
                            has_window, window, q_offset, scale, has_cap, cap,
                            s);
}
