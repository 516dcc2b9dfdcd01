// flash_attention_bwd: the gradients of GQA flash attention (sm_90a).
//
// The backward of src/repro/kernels/flash_attention.py:110
// ``flash_attention`` (pallas_call at :138). The TPU kernel has no backward
// of its own: the reference trains through its chunked jnp attention, which
// XLA differentiates (``jax.value_and_grad``). The port's forward on the
// card is the hand-written ``flash_attention`` kernel, so its gradient is a
// kernel of the port's own. Its plain version is ``ref.attention_bwd_ref``
// (kernels/ref.py); its answer is that function's within float tolerance.
//
// FlashAttention-2's algorithm. With s the scaled score raw · scale (under
// the cap s = cap · tanh(raw · scale / cap)), the forward's log-sum-exp lse
// of each row (natural log, +inf for a row with no live key) and P =
// exp(s − lse) on the live pairs (0 elsewhere):
//
//   Δ   = rowsum(dO ∘ O)                         (float32, one pass)
//   dS  = P ∘ (dO · Vᵀ − Δ)   (· (1 − tanh²) under the cap)
//   dV  = Pᵀ · dO,   dK = scale · dSᵀ · Q,   dQ = scale · dS · K
//
// The live pairs are the forward's: keys below Skv, at or before the query
// under causal (query i at q_offset + i), within the window; rows past Sq
// take no part. One C entry point launches three kernels on one stream: a
// Δ pass, a key-tile pass that owns dK and dV, and a query-tile pass that
// owns dQ. Each CTA's sums stay inside it: the GQA sum over a group's query
// heads runs inside the key-tile CTA, nothing is added with atomics, and
// dq, dk and dv are the same bytes run to run.
//
// Bound (operations): the algorithm's five products, 10 · B · Hq · (live
// pairs) · D flops; at llama3.2-1b's 32k shape (B 1, Hq 32, D 64, causal)
// 11.0 TFLOP, 11.1 ms at 989 TFLOP/s bf16. Both designs below recompute S
// and dP in the query pass, seven products: their own floor is 15.6 ms.
//
// Two routes by input type and head_dim (a rule, not a fallback: a call
// that cannot launch its kernel returns the CUDA error, and the wrapper
// names the route it asks for).
//
// bfloat16 at head_dim <= 128: fa_bwd_hopper.cuh, on the tensor cores.
// Every product is wgmma in bf16 with a float32 sum. A producer warpgroup
// (one thread issuing TMA loads, 128-byte swizzle, completion on mbarriers;
// setmaxnreg moves its registers to the consumers) feeds consumer
// warpgroups of 64 rows each. q, k, v and dO are read through their
// strides, so the model's transposed views need no copy.
// - Δ pass: one warp a row writes Δ and lse · log2(e) into buffers padded
//   to 64-row tiles, whose pad rows read Δ = 0 and lse = +inf (so P = 0
//   there, with no mask).
// - Key-tile pass, one CTA per (b, KV head, 64 · KNWG keys), key tile 0
//   (the heaviest) first: K and V loaded once; the producer streams the
//   group's (Q, dO, lse, Δ) query tiles, 64 rows each, through a ring of
//   stages, only the live ones (causal: none before the keys; window:
//   none past their reach). Each warpgroup takes Sᵀ = K · Qᵀ and dPᵀ =
//   V · dOᵀ (both operands in shared memory), forms Pᵀ and dSᵀ in
//   registers (the scale after the product, in log2 units; the mask only
//   on tiles that cross the diagonal, the window's edge or Skv), then
//   dV += Pᵀ · dO and dK += dSᵀ · Q with Pᵀ and dSᵀ as the register A
//   operand and dO and Q read MN-major (the transpose bit, as the
//   forward's P · V reads V), issued together. A warpgroup skips the
//   tiles wholly outside its keys' reach.
// - Query-tile pass, one CTA per (b, q head, 64 · QNWG rows), the last
//   (heaviest) tiles first: Q and dO loaded once, the forward's live
//   (K, V) tiles streamed; S = Q · Kᵀ, dP = dO · Vᵀ, dS in registers,
//   dQ += dS · K. Each row's lse and Δ stay in registers.
// P and dS are rounded once to bf16 before their products (FlashAttention
// 2's choice; tests/test_torch_attention_bwd_tc.py replays the schedule
// on the CPU within the 1e-2 gate); dq, dk and dv are rounded once at the
// store. Columns past D and rows past Sq or Skv read as zeros (TMA); keys
// at or past Skv are masked. Registers decide the tiles: ptxas holds
// every thread to the launch's budget, 65,536 over the CTA's threads
// (setmaxnreg moves registers at run time but does not raise it), so
// a key-pass warpgroup, which keeps dK and dV, Sᵀ and dPᵀ and both bf16
// operands, forms both operands before issuing either product. Tiles,
// chosen on the card (scripts/torch_attention_bwd_probe.py, PERF.md): at
// head_dim 64 the key pass runs two consumer warpgroups (128 keys, 168
// registers, no spill) and 4 stages, the query pass three (192 rows, 128
// registers) and 4 stages; at 128 the key pass one warpgroup (64 keys:
// its 192 accumulator registers spill at two warpgroups' 168, and run at
// half the rate) and 4 stages, the query pass two and 3 stages.
//
// float32, and bfloat16 at head_dim 256 (gemma3-4b's local layers, which
// no card path trains; its accumulators would not fit in registers): the
// SIMT kernels below. float32 stays off the tensor cores because its gate
// is 1e-5 (they would take float32 as TF32). 256 threads, a 16 x 16 grid:
// thread (ty, tx) owns the scores of rows ty + 16i and keys tx + 16j of a
// tile, and rows ty + 16i and columns 64m + 4tx + {0..3} of an
// accumulator. Tiles are BT x BT (64 at head_dim <= 128, 32 at 256),
// staged as float32 with rows padded by 4 floats; every product a float32
// FMA; the inputs contiguous. The key-tile pass stages K and V once and
// loops over the group's heads and the query tiles that reach it; the
// query-tile pass recomputes S and dP over the forward's live key tiles.
//
// Left on the table (bf16): overlapping one tile's S and dP with the last
// tile's dK / dQ products, ping-pong of the warpgroups, a persistent grid,
// TMA stores, and dQ in one pass (atomics would break the byte-equal
// repeats; a fixed order behind per-tile counters would keep them).
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "fa_bwd_hopper.cuh"

namespace fa_bwd {

constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  int32_t B, Hq, Hkv, Sq, Skv, D, causal, has_window, window, q_offset;
  int32_t has_cap;
  float scale, cap;
};

// Tile shapes: BT rows (queries or keys) a tile, DS floats a staged row, PS
// a row of the score tiles (odd, so a column read spreads over banks).
template <int D_PAD>
struct Tile {
  static constexpr int BT = D_PAD > 128 ? 32 : 64;
  static constexpr int TI = BT / 16;          // rows (and keys) a thread
  static constexpr int TC = D_PAD / 16;       // accumulator columns a thread
  static constexpr int DS = D_PAD + 4;
  static constexpr int PS = BT + 1;
  static constexpr int SMEM =
      (int)sizeof(float) * (4 * BT * DS + 2 * BT * PS + 2 * BT);
};

// Stages rows [r0, r0 + BT) of a contiguous [S, D] slice as float32 into
// a [BT][DS] tile, zeros past S and D.
template <typename T, int D_PAD>
__device__ __forceinline__ void stage(float* dst, const T* src, int32_t r0,
                                      int32_t S, int32_t D) {
  using C = Tile<D_PAD>;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < C::BT * D_PAD; idx += THREADS) {
    const int r = idx / D_PAD, c = idx % D_PAD;
    float x = 0.0f;
    if (r0 + r < S && c < D) x = ld(src + (int64_t)(r0 + r) * D + c);
    dst[r * C::DS + c] = x;
  }
}

// The rows' lse and Δ of a query tile; a row past Sq gets lse = +inf (so
// P = 0) and Δ = 0.
__device__ __forceinline__ void stage_rows(float* sL, float* sD,
                                           const float* lse,
                                           const float* delta, int32_t q0,
                                           int32_t Sq, int BT) {
  for (int r = threadIdx.x; r < BT; r += THREADS) {
    const bool in = q0 + r < Sq;
    sL[r] = in ? lse[q0 + r] : INFINITY;
    sD[r] = in ? delta[q0 + r] : 0.0f;
  }
}

// out[i][j] = a_row(ty + 16i) · b_row(tx + 16j) over D_PAD columns
template <int D_PAD>
__device__ __forceinline__ void dot_tile(
    const float* a, const float* b, int ty, int tx,
    float (&out)[Tile<D_PAD>::TI][Tile<D_PAD>::TI]) {
  using C = Tile<D_PAD>;
#pragma unroll
  for (int i = 0; i < C::TI; ++i)
#pragma unroll
    for (int j = 0; j < C::TI; ++j) out[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D_PAD; d += 4) {
    float4 x[C::TI], y[C::TI];
#pragma unroll
    for (int i = 0; i < C::TI; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * C::DS + d);
#pragma unroll
    for (int j = 0; j < C::TI; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * C::DS + d);
#pragma unroll
    for (int i = 0; i < C::TI; ++i)
#pragma unroll
      for (int j = 0; j < C::TI; ++j) {
        out[i][j] = fmaf(x[i].x, y[j].x, out[i][j]);
        out[i][j] = fmaf(x[i].y, y[j].y, out[i][j]);
        out[i][j] = fmaf(x[i].z, y[j].z, out[i][j]);
        out[i][j] = fmaf(x[i].w, y[j].w, out[i][j]);
      }
  }
}

// P and dS of the pair of tiles (queries q0 + ty + 16i, keys k0 + tx + 16j)
// from the staged Q, dO, K, V, lse and Δ; written to sP (when not null) and
// sdS as [query][key].
template <int D_PAD>
__device__ __forceinline__ void scores(const float* sQ, const float* sdO,
                                       const float* sK, const float* sV,
                                       const float* sL, const float* sD,
                                       float* sP, float* sdS, int32_t q0,
                                       int32_t k0, const Args& a, int ty,
                                       int tx) {
  using C = Tile<D_PAD>;
  float s[C::TI][C::TI], dp[C::TI][C::TI];
  dot_tile<D_PAD>(sQ, sK, ty, tx, s);
  dot_tile<D_PAD>(sdO, sV, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < C::TI; ++i) {
    const int r = ty + 16 * i;
    const int32_t qi = q0 + r;
    const int32_t qpos = a.q_offset + qi;
#pragma unroll
    for (int j = 0; j < C::TI; ++j) {
      const int c = tx + 16 * j;
      const int32_t kj = k0 + c;
      const bool live = qi < a.Sq && kj < a.Skv &&
                        (!a.causal || kj <= qpos) &&
                        (!a.has_window || kj > qpos - a.window);
      float x = s[i][j] * a.scale, dt = 1.0f;
      if (a.has_cap) {
        const float t = tanhf(x / a.cap);
        x = a.cap * t;
        dt = 1.0f - t * t;
      }
      const float p = live ? expf(x - sL[r]) : 0.0f;
      if (sP != nullptr) sP[r * C::PS + c] = p;
      sdS[r * C::PS + c] = p * (dp[i][j] - sD[r]) * dt;
    }
  }
}

// acc[i][4m + e] += sum_r w[r][row(i)] * x[r][64m + 4tx + e] over the
// tile's BT rows r, where row(i) = ty + 16i: dV and dK of the key tile
template <int D_PAD>
__device__ __forceinline__ void acc_transposed(
    const float* w, const float* x, int ty, int tx,
    float (&acc)[Tile<D_PAD>::TI][Tile<D_PAD>::TC]) {
  using C = Tile<D_PAD>;
#pragma unroll 4
  for (int r = 0; r < C::BT; ++r) {
    float wr[C::TI];
#pragma unroll
    for (int i = 0; i < C::TI; ++i) wr[i] = w[r * C::PS + ty + 16 * i];
#pragma unroll
    for (int m = 0; m < C::TC / 4; ++m) {
      const float4 v =
          *reinterpret_cast<const float4*>(x + r * C::DS + 64 * m + 4 * tx);
#pragma unroll
      for (int i = 0; i < C::TI; ++i) {
        acc[i][4 * m + 0] = fmaf(wr[i], v.x, acc[i][4 * m + 0]);
        acc[i][4 * m + 1] = fmaf(wr[i], v.y, acc[i][4 * m + 1]);
        acc[i][4 * m + 2] = fmaf(wr[i], v.z, acc[i][4 * m + 2]);
        acc[i][4 * m + 3] = fmaf(wr[i], v.w, acc[i][4 * m + 3]);
      }
    }
  }
}

// acc[i][4m + e] += sum_c w[row(i)][c] * x[c][64m + 4tx + e] over the
// tile's BT keys c: dQ of the query tile
template <int D_PAD>
__device__ __forceinline__ void acc_rows(
    const float* w, const float* x, int ty, int tx,
    float (&acc)[Tile<D_PAD>::TI][Tile<D_PAD>::TC]) {
  using C = Tile<D_PAD>;
#pragma unroll 4
  for (int c = 0; c < C::BT; ++c) {
    float wr[C::TI];
#pragma unroll
    for (int i = 0; i < C::TI; ++i) wr[i] = w[(ty + 16 * i) * C::PS + c];
#pragma unroll
    for (int m = 0; m < C::TC / 4; ++m) {
      const float4 v =
          *reinterpret_cast<const float4*>(x + c * C::DS + 64 * m + 4 * tx);
#pragma unroll
      for (int i = 0; i < C::TI; ++i) {
        acc[i][4 * m + 0] = fmaf(wr[i], v.x, acc[i][4 * m + 0]);
        acc[i][4 * m + 1] = fmaf(wr[i], v.y, acc[i][4 * m + 1]);
        acc[i][4 * m + 2] = fmaf(wr[i], v.z, acc[i][4 * m + 2]);
        acc[i][4 * m + 3] = fmaf(wr[i], v.w, acc[i][4 * m + 3]);
      }
    }
  }
}

// rows r0 + ty + 16i (< S) and columns < D of a contiguous [S, D] slice
// from an accumulator, times mul
template <typename T, int D_PAD>
__device__ __forceinline__ void store_acc(
    T* dst, const float (&acc)[Tile<D_PAD>::TI][Tile<D_PAD>::TC], int32_t r0,
    int32_t S, int32_t D, float mul, int ty, int tx) {
  using C = Tile<D_PAD>;
#pragma unroll
  for (int i = 0; i < C::TI; ++i) {
    const int32_t row = r0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int m = 0; m < C::TC / 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * m + 4 * tx + e;
        if (col < D) st(dst + (int64_t)row * D + col, acc[i][4 * m + e] * mul);
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int64_t rows, int32_t D) {
  const int64_t row =
      (int64_t)blockIdx.x * (THREADS / 32) + (int)threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;   // a whole warp leaves together
  const T* a = o + row * D;
  const T* b = dout + row * D;
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) s = fmaf(ld(a + c), ld(b + c), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <typename T, int D_PAD>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, const Args a) {
  using C = Tile<D_PAD>;
  extern __shared__ float4 fb_smem4[];
  float* sK = reinterpret_cast<float*>(fb_smem4);
  float* sV = sK + C::BT * C::DS;
  float* sQ = sV + C::BT * C::DS;
  float* sdO = sQ + C::BT * C::DS;
  float* sP = sdO + C::BT * C::DS;
  float* sdS = sP + C::BT * C::PS;
  float* sL = sdS + C::BT * C::PS;
  float* sD = sL + C::BT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int32_t k0 = (int32_t)blockIdx.x * C::BT;   // key tile 0 first
  const int G = a.Hq / a.Hkv;
  const int64_t kv_off = ((int64_t)b * a.Hkv + kvh) * a.Skv * a.D;
  stage<T, D_PAD>(sK, k + kv_off, k0, a.Skv, a.D);
  stage<T, D_PAD>(sV, v + kv_off, k0, a.Skv, a.D);

  float acc_k[C::TI][C::TC], acc_v[C::TI][C::TC];
#pragma unroll
  for (int i = 0; i < C::TI; ++i)
#pragma unroll
    for (int c = 0; c < C::TC; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;

  // the query rows that reach the tile: at or after its first key under
  // causal, before its last key + window under a window
  int64_t q_lo = 0, q_hi = a.Sq;
  if (a.causal && k0 > a.q_offset) q_lo = (int64_t)k0 - a.q_offset;
  if (a.has_window) {
    const int64_t k_last = (k0 + C::BT < a.Skv ? k0 + C::BT : a.Skv) - 1;
    const int64_t reach = k_last + a.window - a.q_offset;
    if (reach < q_hi) q_hi = reach;
  }
  const int32_t qt_lo = (int32_t)(q_lo / C::BT);
  const int32_t qt_hi =
      q_hi > q_lo ? (int32_t)((q_hi + C::BT - 1) / C::BT) : qt_lo;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t row_off = (int64_t)b * a.Hq + h;
    const T* qh = q + row_off * a.Sq * a.D;
    const T* dh = dout + row_off * a.Sq * a.D;
    for (int32_t qt = qt_lo; qt < qt_hi; ++qt) {
      const int32_t q0 = qt * C::BT;
      __syncthreads();   // the last tile's reads are done
      stage<T, D_PAD>(sQ, qh, q0, a.Sq, a.D);
      stage<T, D_PAD>(sdO, dh, q0, a.Sq, a.D);
      stage_rows(sL, sD, lse + row_off * a.Sq, delta + row_off * a.Sq, q0,
                 a.Sq, C::BT);
      __syncthreads();
      scores<D_PAD>(sQ, sdO, sK, sV, sL, sD, sP, sdS, q0, k0, a, ty, tx);
      __syncthreads();
      acc_transposed<D_PAD>(sP, sdO, ty, tx, acc_v);
      acc_transposed<D_PAD>(sdS, sQ, ty, tx, acc_k);
    }
  }
  store_acc<T, D_PAD>(dk + kv_off, acc_k, k0, a.Skv, a.D, a.scale, ty, tx);
  store_acc<T, D_PAD>(dv + kv_off, acc_v, k0, a.Skv, a.D, 1.0f, ty, tx);
}

template <typename T, int D_PAD>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, const Args a) {
  using C = Tile<D_PAD>;
  extern __shared__ float4 fb_smem4[];
  float* sK = reinterpret_cast<float*>(fb_smem4);
  float* sV = sK + C::BT * C::DS;
  float* sQ = sV + C::BT * C::DS;
  float* sdO = sQ + C::BT * C::DS;
  float* sdS = sdO + C::BT * C::DS + C::BT * C::PS;
  float* sL = sdS + C::BT * C::PS;
  float* sD = sL + C::BT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  // the heaviest (last) query tiles first
  const int32_t q0 = (int32_t)(gridDim.x - 1 - blockIdx.x) * C::BT;
  const int64_t row_off = (int64_t)b * a.Hq + h;
  const int64_t kv_off = ((int64_t)b * a.Hkv + kvh) * a.Skv * a.D;
  stage<T, D_PAD>(sQ, q + row_off * a.Sq * a.D, q0, a.Sq, a.D);
  stage<T, D_PAD>(sdO, dout + row_off * a.Sq * a.D, q0, a.Sq, a.D);
  stage_rows(sL, sD, lse + row_off * a.Sq, delta + row_off * a.Sq, q0, a.Sq,
             C::BT);

  float acc[C::TI][C::TC];
#pragma unroll
  for (int i = 0; i < C::TI; ++i)
#pragma unroll
    for (int c = 0; c < C::TC; ++c) acc[i][c] = 0.0f;

  // the live key tiles, the forward's range: from the window's first key
  // of the tile's first row to the causal limit of its last row
  int32_t k_lo = 0, k_hi = a.Skv;
  if (a.has_window) {
    const int64_t first = (int64_t)a.q_offset + q0 - a.window + 1;
    k_lo = first > 0 ? (int32_t)(first / C::BT) * C::BT : 0;
  }
  if (a.causal) {
    const int64_t last = (int64_t)a.q_offset + q0 + C::BT;   // exclusive
    k_hi = last < a.Skv ? (int32_t)last : a.Skv;
  }
  for (int32_t k0 = k_lo; k0 < k_hi; k0 += C::BT) {
    __syncthreads();   // the last tile's reads are done
    stage<T, D_PAD>(sK, k + kv_off, k0, a.Skv, a.D);
    stage<T, D_PAD>(sV, v + kv_off, k0, a.Skv, a.D);
    __syncthreads();
    scores<D_PAD>(sQ, sdO, sK, sV, sL, sD, nullptr, sdS, q0, k0, a, ty, tx);
    __syncthreads();
    acc_rows<D_PAD>(sdS, sK, ty, tx, acc);
  }
  store_acc<T, D_PAD>(dq + row_off * a.Sq * a.D, acc, q0, a.Sq, a.D, a.scale,
                      ty, tx);
}

template <typename T, int D_PAD>
static int launch(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq,
                  void* dk, void* dv, const Args& a, cudaStream_t stream) {
  using C = Tile<D_PAD>;
  const int64_t rows = (int64_t)a.B * a.Hq * a.Sq;
  const int64_t dblocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (dblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  delta_kernel<T><<<(unsigned int)dblocks, THREADS, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, rows, a.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_kernel<T, D_PAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<T, D_PAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 gkv((unsigned int)((a.Skv + C::BT - 1) / C::BT),
                 (unsigned int)a.Hkv, (unsigned int)a.B);
  dkdv_kernel<T, D_PAD><<<gkv, THREADS, C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 gq((unsigned int)((a.Sq + C::BT - 1) / C::BT),
                (unsigned int)a.Hq, (unsigned int)a.B);
  dq_kernel<T, D_PAD><<<gq, THREADS, C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, a);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv,
                    const Args& a, cudaStream_t stream) {
  if (a.D <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, a, stream);
  if (a.D <= 128)
    return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, a,
                          stream);
  return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, a, stream);
}

}  // namespace fa_bwd

// The route, chosen by the wrapper (ops.attention_bwd_route): the SIMT
// kernels or the bf16 tensor-core kernels.
constexpr int kRouteSimt = 0, kRouteWgmma = 1;

// Whether a [B, H, S, D] tensor's (batch, head, row) element strides are
// those of contiguous storage (a dimension of size 1 is never stepped).
static bool packed(const int64_t* st, int32_t B, int32_t H, int32_t S,
                   int32_t D) {
  return (S < 2 || st[2] == D) && (H < 2 || st[1] == (int64_t)S * D) &&
         (B < 2 || st[0] == (int64_t)H * S * D);
}

// q, o and dout [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], all of one type
// (float32, or bfloat16 when is_bf16), read through their element strides
// st (q's, k's, v's, o's, dout's batch, head and row; the last dimension
// contiguous); dq [B, Hq, Sq, D] and dk, dv [B, Hkv, Skv, D] contiguous,
// written; lse the forward's float32 [B, Hq, Sq], contiguous. Sq and Skv >
// 0. route kRouteWgmma (bf16 at head_dim <= 128): delta and lse2 float32
// [B, Hq, Sq_pad] scratch, Sq_pad = Sq rounded up to 64, and q, k, v and
// dout as TMA reads them (fa_bwd_tc::launch). kRouteSimt: every input
// contiguous, delta float32 [B, Hq, Sq] scratch, lse2 unused. Returns a
// CUDA error, or fa_hopper::kEncodeError + the CUresult where
// cuTensorMapEncodeTiled refuses a tensor map.
extern "C" int fw_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* lse2, void* dq,
    void* dk, void* dv, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, int64_t d_sb,
    int64_t d_sh, int64_t d_ss, int32_t B, int32_t Hq, int32_t Hkv,
    int32_t Sq, int32_t Skv, int32_t D, int32_t causal, int32_t has_window,
    int32_t window, int32_t q_offset, float scale, int32_t has_cap,
    float cap, int32_t is_bf16, int32_t route, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535 || Sq < 1 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t st[15] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                          v_ss, o_sb, o_sh, o_ss, d_sb, d_sh, d_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kRouteWgmma) {
    if (!is_bf16 || D > 128 || lse2 == nullptr)
      return (int)cudaErrorInvalidValue;
    return fa_bwd_tc::launch(q, k, v, o, dout, lse, delta, lse2, dq, dk, dv,
                             st, B, Hq, Hkv, Sq, Skv, D, causal, has_window,
                             window, q_offset, scale, has_cap, cap, s);
  }
  if (route != kRouteSimt || !packed(st, B, Hq, Sq, D) ||
      !packed(st + 3, B, Hkv, Skv, D) || !packed(st + 6, B, Hkv, Skv, D) ||
      !packed(st + 9, B, Hq, Sq, D) || !packed(st + 12, B, Hq, Sq, D))
    return (int)cudaErrorInvalidValue;
  const fa_bwd::Args a{B,      Hq,         Hkv,    Sq,       Skv,
                       D,      causal,     has_window, window, q_offset,
                       has_cap, scale,     cap};
  if (is_bf16)
    return fa_bwd::dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq,
                                           dk, dv, a, s);
  return fa_bwd::dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, a,
                                 s);
}
