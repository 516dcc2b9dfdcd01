// fa_bwd_hopper.cuh: the bfloat16 attention backward on Hopper's tensor
// cores (wgmma with TMA); csrc/flash_attention_bwd.cu's header note says
// what it computes and why it is built so. Included by that file alone.
#pragma once

#include "hopper.cuh"

namespace fa_bwd_tc {

using namespace fa_hopper;

constexpr int BT = 64;   // rows a warpgroup owns; rows of a streamed tile

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct Params {
  __nv_bfloat16 *dq, *dk, *dv;
  // [B, Hq, Sq_pad]: the forward's lse times log2(e) (+inf past Sq and on
  // rows with no live key) and Δ = rowsum(dO ∘ O) (0 past Sq)
  const float* lse2;
  const float* delta;
  int32_t B, Hq, Hkv, Sq, Skv, D, Sq_pad;
  int32_t causal, has_window, window, q_offset, has_cap;
  float scale, scale_log2, cap;
};

// The key-tile pass: 64 keys a consumer warpgroup, K and V of the CTA's
// BKEY keys staged once, then a ring of NST stages, each one query tile's
// Q and dO (64 rows) and its rows' lse2 and Δ.
template <int D_PAD, int NWG, int NST>
struct KvCfg : RegSplit<NWG> {
  static constexpr int BKEY = BT * NWG;
  static constexpr int NCH = D_PAD / 64;            // 128-byte column chunks
  static constexpr int KV_BYTES = BKEY * D_PAD * 2;  // the CTA's K (or V)
  static constexpr int TILE_BYTES = BT * D_PAD * 2;  // one Q or dO tile
  static constexpr int ROW_BYTES = 2 * BT * 4;       // a tile's lse2 and Δ
  // 1024 for aligning the swizzled tiles; full and empty barriers of each
  // stage and K/V's
  static constexpr int SMEM = 1024 + 2 * KV_BYTES +
                              NST * (2 * TILE_BYTES + ROW_BYTES) +
                              8 * (2 * NST + 1);
};

// The query-tile pass: 64 query rows a consumer warpgroup, Q and dO of the
// CTA's BQ rows staged once, then a ring of NST (K, V) tiles of 64 keys.
template <int D_PAD, int NWG, int NST>
struct QCfg : RegSplit<NWG> {
  static constexpr int BQ = BT * NWG;
  static constexpr int NCH = D_PAD / 64;
  static constexpr int Q_BYTES = BQ * D_PAD * 2;    // the CTA's Q (or dO)
  static constexpr int KV_BYTES = BT * D_PAD * 2;   // one K or V tile
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + NST * 2 * KV_BYTES + 8 * (2 * NST + 1);
};

// acc[c] += A · X[:, 64c : 64c + 64] for each 64-column chunk c, issued,
// not awaited: A (64 × 64) from registers as bf16 fragments, X a 64-row
// tile read MN-major (the transpose bit), 16 of its rows a step.
template <int NCH>
__device__ __forceinline__ void issue_acc(float (&acc)[NCH][32],
                                          const uint32_t (&a)[4][4],
                                          uint32_t sX) {
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64(acc[c], a[kk],
                   desc_sw128(sX + c * BT * 128 + kk * 16 * 128));
}

// A 64 × 64 accumulator tile as bf16 A fragments, each value rounded to
// nearest: the accumulator's pairs (8kk + 2i, 8kk + 2i + 1) are register i
// of the operand's step kk (16 columns a step).
__device__ __forceinline__ void pack_bf16(const float (&x)[32],
                                          uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = bf16x2_bits(
          __floats2bfloat162_rn(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]));
}

// This thread's elements of one 64 × 64 tile of S and dP (rows row0 and
// row0 + 8, columns col0 + 8j + cq + {0, 1}) → P = exp(s − lse) in s and
// (dP − Δ) · dt in dp, where s is the raw score scaled after the product
// (capped under the cap, dt = 1 − tanh², else dt = 1), in log2 units. The
// mask only where the tile crosses an edge (a dead pair gets P = 0).
// KEY_ROWS: the key pass's transposed tile (rows keys, columns queries),
// each column's lse2 and Δ read from the stage (sl, sd); else rows are
// queries, whose lse2 and Δ this thread holds (lr, dr).
template <bool KEY_ROWS, bool MASKED, bool CAP>
__device__ __forceinline__ void grad_tile(float (&s)[32], float (&dp)[32],
                                          const Params& p, int row0, int col0,
                                          int cq, const float* sl,
                                          const float* sd,
                                          const float (&lr)[2],
                                          const float (&dr)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int ro = (i & 2) ? 8 : 0, co = 8 * (i / 4) + cq + (i & 1);
    float l, d;
    if constexpr (KEY_ROWS) {
      l = sl[co];
      d = sd[co];
    } else {
      l = lr[(i >> 1) & 1];
      d = dr[(i >> 1) & 1];
    }
    float x = s[i], dt = 1.0f;
    if constexpr (CAP) {
      const float t = tanhf(x * p.scale / p.cap);
      x = t * p.cap * kLog2e;
      dt = 1.0f - t * t;
    } else {
      x *= p.scale_log2;
    }
    if constexpr (MASKED) {
      const int kpos = KEY_ROWS ? row0 + ro : col0 + co;
      const int qpos = p.q_offset + (KEY_ROWS ? col0 + co : row0 + ro);
      const bool live = kpos < p.Skv && (!p.causal || kpos <= qpos) &&
                        (!p.has_window || kpos > qpos - p.window);
      if (!live) x = -INFINITY;
    }
    // a row with lse2 = +inf (no live key, or past Sq) gets P = 0
    s[i] = ex2(x - l);
    dp[i] = (dp[i] - d) * dt;
  }
}

// grad_tile with its mask and cap chosen once a tile (branches outside
// the element loop)
template <bool KEY_ROWS>
__device__ __forceinline__ void grad_any(float (&s)[32], float (&dp)[32],
                                         const Params& p, bool masked,
                                         int row0, int col0, int cq,
                                         const float* sl, const float* sd,
                                         const float (&lr)[2],
                                         const float (&dr)[2]) {
  if (masked) {
    if (p.has_cap)
      grad_tile<KEY_ROWS, true, true>(s, dp, p, row0, col0, cq, sl, sd, lr,
                                      dr);
    else
      grad_tile<KEY_ROWS, true, false>(s, dp, p, row0, col0, cq, sl, sd, lr,
                                       dr);
  } else {
    if (p.has_cap)
      grad_tile<KEY_ROWS, false, true>(s, dp, p, row0, col0, cq, sl, sd, lr,
                                       dr);
    else
      grad_tile<KEY_ROWS, false, false>(s, dp, p, row0, col0, cq, sl, sd,
                                        lr, dr);
  }
}

// Rows row0 and row0 + 8 (below S) and columns below D of a [.., S, D]
// bf16 slice starting at row `off`, from an accumulator times mul.
template <int NCH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[NCH][32],
                                           int64_t off, int row0, int S,
                                           int D, float mul, int cq) {
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = 64 * c + 8 * (i / 4) + cq;
      const int row = row0 + ((i & 2) ? 8 : 0);
      if (row >= S || col >= D) continue;
      const float v0 = acc[c][i] * mul, v1 = acc[c][i + 1] * mul;
      __nv_bfloat16* dst = out + (off + row) * D + col;
      if ((D & 1) == 0) {   // col is even, so col + 1 < D
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16_rn(v0);
        if (col + 1 < D) dst[1] = __float2bfloat16_rn(v1);
      }
    }
}

__device__ __forceinline__ void release(uint32_t empty_bar, int lane) {
  __syncwarp();   // this warp is done with the stage
  if (lane == 0) mbar_arrive(empty_bar);
}

// Δ = rowsum(dO ∘ O) in float32 and lse · log2(e) of each row, into
// [B, Hq, Sq_pad] (one warp a row; rows past Sq get Δ = 0 and +inf, so
// the passes read whole 64-row tiles and P is 0 there). O and dO are read
// through their (batch, head, row) strides.
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse2,
                float* __restrict__ delta, int64_t o_sb, int64_t o_sh,
                int64_t o_ss, int64_t d_sb, int64_t d_sh, int64_t d_ss,
                int32_t Hq, int32_t Sq, int32_t Sq_pad, int32_t D,
                int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * 8 + (int)threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;   // a whole warp leaves together
  const int64_t bh = row / Sq_pad;
  const int32_t i = (int32_t)(row % Sq_pad);
  if (i >= Sq) {
    if (lane == 0) {
      lse2[row] = INFINITY;
      delta[row] = 0.0f;
    }
    return;
  }
  const int64_t b = bh / Hq, h = bh % Hq;
  const __nv_bfloat16* a = o + b * o_sb + h * o_sh + i * o_ss;
  const __nv_bfloat16* g = dout + b * d_sb + h * d_sh + i * d_ss;
  float s = 0.0f;
  for (int c = lane; c < D; c += 32)
    s = fmaf(__bfloat162float(a[c]), __bfloat162float(g[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    delta[row] = s;
    lse2[row] = lse[bh * Sq + i] * kLog2e;   // +inf stays +inf
  }
}

// The key-tile pass: dK and dV of BKEY keys of one (b, KV head), summed
// over the group's G query heads inside the CTA (no atomics).
template <int D_PAD, int NWG, int NST>
__global__ void __launch_bounds__(KvCfg<D_PAD, NWG, NST>::THREADS, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using C = KvCfg<D_PAD, NWG, NST>;
  extern __shared__ __align__(1024) uint8_t bwd_smem[];
  const uint32_t base = smem_u32(bwd_smem);
  const uint32_t sK = (base + 1023u) & ~1023u;
  const uint32_t sV = sK + C::KV_BYTES;
  const uint32_t sT = sV + C::KV_BYTES;   // stage s: Q, then dO
  const uint32_t sR = sT + NST * 2 * C::TILE_BYTES;   // stage s: lse2, Δ
  const uint32_t bars = sR + NST * C::ROW_BYTES;
  const uint32_t bar_kv = bars + 8 * 2 * NST;
  // full[s] at bars + 8s, empty[s] at bars + 8 (NST + s)
  const float* rows = reinterpret_cast<const float*>(bwd_smem + (sR - base));

  // key tile 0 (the heaviest under causal) first
  const int bkv = p.B * p.Hkv;
  const int k0 = ((int)blockIdx.x / bkv) * C::BKEY;
  const int b = ((int)blockIdx.x % bkv) / p.Hkv;
  const int kvh = (int)blockIdx.x % p.Hkv;
  const int G = p.Hq / p.Hkv;

  // the query rows that reach the CTA's keys: at or after its first key
  // under causal, before its last key + window under a window
  int64_t q_lo = 0, q_hi = p.Sq;
  if (p.causal && k0 > p.q_offset) q_lo = (int64_t)k0 - p.q_offset;
  if (p.has_window) {
    const int64_t k_last = min64((int64_t)k0 + C::BKEY, p.Skv) - 1;
    q_hi = min64(q_hi, k_last + p.window - p.q_offset);
  }
  const int qt_lo = (int)(q_lo / BT);
  const int n_qt = q_hi > q_lo ? (int)((q_hi + BT - 1) / BT) - qt_lo : 0;
  const int n_tiles = G * n_qt;   // head-major: the group's heads in turn

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (NST + s), 4 * NWG);
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // producer: K and V once, then the (Q, dO, lse2, Δ) tiles through the
    // ring, issued by one thread
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 4 * NWG && lane == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          const uint32_t off = c * C::BKEY * 128 + w * BT * 128;
          tma_load_4d(sK + off, &tm_k, bar_kv, 64 * c, k0 + BT * w, kvh, b);
          tma_load_4d(sV + off, &tm_v, bar_kv, 64 * c, k0 + BT * w, kvh, b);
        }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NST;
        if (it >= NST) mbar_wait(bars + 8 * (NST + s), (it / NST - 1) & 1);
        const int h = kvh * G + it / n_qt, q0 = (qt_lo + it % n_qt) * BT;
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, 2 * C::TILE_BYTES + C::ROW_BYTES);
        const uint32_t dst = sT + s * 2 * C::TILE_BYTES;
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(dst + c * BT * 128, &tm_q, full, 64 * c, q0, h, b);
          tma_load_4d(dst + C::TILE_BYTES + c * BT * 128, &tm_do, full,
                      64 * c, q0, h, b);
        }
        const int64_t r = ((int64_t)b * p.Hq + h) * p.Sq_pad + q0;
        bulk_load(sR + s * C::ROW_BYTES, p.lse2 + r, BT * 4, full);
        bulk_load(sR + s * C::ROW_BYTES + BT * 4, p.delta + r, BT * 4, full);
      }
    }
  } else {
    // consumer warpgroup wg: keys [k0 + 64 wg, k0 + 64 wg + 64). Thread
    // (wi, lane) holds accumulator rows r0 and r0 + 8, columns 8j + cq +
    // {0, 1}. wg comes through a shuffle so the descriptors built from it
    // stay in uniform registers (as the forward's).
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int wg = __shfl_sync(0xffffffffu, warp / 4, 0), wi = warp % 4;
    const int r0 = 16 * wi + lane / 4, cq = 2 * (lane % 4);
    const int kw0 = k0 + BT * wg;
    // this warpgroup's live queries [wq_lo, wq_hi), none when its keys
    // start at or past Skv; it still waits for and releases every tile
    int64_t wq_lo = 0, wq_hi = kw0 < p.Skv ? p.Sq : 0;
    if (p.causal && kw0 > p.q_offset) wq_lo = (int64_t)kw0 - p.q_offset;
    if (p.has_window) {
      const int64_t kw_last = min64((int64_t)kw0 + BT, p.Skv) - 1;
      wq_hi = min64(wq_hi, kw_last + p.window - p.q_offset);
    }
    float dk[C::NCH][32], dv[C::NCH][32];
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.0f;
    const uint32_t sKw = sK + BT * wg * 128, sVw = sV + BT * wg * 128;
    const float none[2] = {0.0f, 0.0f};
    bool kv_in = false;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % NST;
      const int q0 = (qt_lo + it % n_qt) * BT;
      mbar_wait(bars + 8 * s, (it / NST) & 1);
      if (q0 + BT > wq_lo && q0 < wq_hi) {
        if (!kv_in) {
          mbar_wait(bar_kv, 0);
          kv_in = true;
        }
        const uint32_t sQ = sT + s * 2 * C::TILE_BYTES;
        const uint32_t sdO = sQ + C::TILE_BYTES;
        // Sᵀ = K · Qᵀ and dPᵀ = V · dOᵀ, both operands in shared memory
        float st[32], dpt[32];
        wgmma_fence();
        issue_nt<D_PAD, C::BKEY>(st, sKw, sQ);
        issue_nt<D_PAD, C::BKEY>(dpt, sVw, sdO);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        const bool masked =
            (p.causal && kw0 + BT - 1 > p.q_offset + q0) ||
            (p.has_window &&
             (int64_t)kw0 <= (int64_t)p.q_offset + q0 + BT - 1 - p.window) ||
            kw0 + BT > p.Skv;
        const float* sl = rows + s * 2 * BT;
        grad_any<true>(st, dpt, p, masked, kw0 + r0, q0, cq, sl, sl + BT,
                       none, none);
        // Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ − Δ) · dt rounded to bf16 in registers,
        // then dV += Pᵀ · dO and dK += dSᵀ · Q (both formed before either
        // product is issued, which keeps the warpgroup's registers within
        // the launch's budget)
        uint32_t pa[4][4], da[4][4];
        pack_bf16(st, pa);
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] *= dpt[i];
        pack_bf16(st, da);
        wgmma_fence();
        issue_acc<C::NCH>(dv, pa, sdO);
        issue_acc<C::NCH>(dk, da, sQ);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          fence_regs(dv[c]);
          fence_regs(dk[c]);
        }
        fence_regs(pa);
        fence_regs(da);
      }
      release(bars + 8 * (NST + s), lane);
    }
    const int64_t off = ((int64_t)b * p.Hkv + kvh) * p.Skv;
    store_rows<C::NCH>(p.dk, dk, off, kw0 + r0, p.Skv, p.D, p.scale, cq);
    store_rows<C::NCH>(p.dv, dv, off, kw0 + r0, p.Skv, p.D, 1.0f, cq);
  }
}

// The query-tile pass: dQ of BQ query rows of one (b, head), the
// forward's live key tiles streamed through the ring.
template <int D_PAD, int NWG, int NST>
__global__ void __launch_bounds__(QCfg<D_PAD, NWG, NST>::THREADS, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using C = QCfg<D_PAD, NWG, NST>;
  extern __shared__ __align__(1024) uint8_t bwd_smem[];
  const uint32_t sQ = (smem_u32(bwd_smem) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + C::Q_BYTES;
  const uint32_t sKV = sdO + C::Q_BYTES;   // stage s: K, then V
  const uint32_t bars = sKV + NST * 2 * C::KV_BYTES;
  const uint32_t bar_q = bars + 8 * 2 * NST;

  // the heaviest (last) query tiles first; the group's heads side by side,
  // so their K and V tiles meet in L2
  const int bh = p.B * p.Hq;
  const int n_qt = (p.Sq + C::BQ - 1) / C::BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x / bh;
  const int b = ((int)blockIdx.x % bh) / p.Hq;
  const int head = (int)blockIdx.x % p.Hq;
  const int kvh = head / (p.Hq / p.Hkv);
  const int q0 = qt * C::BQ;

  // the live key tiles, the forward's range: from the window's first
  // visible key of the tile's first row to the causal limit of its last
  int k_lo = 0, k_hi = p.Skv;
  if (p.has_window) {
    const int64_t first = (int64_t)p.q_offset + q0 - p.window + 1;
    k_lo = first > 0 ? (int)(first / BT * BT) : 0;
  }
  if (p.causal)
    k_hi = (int)min64((int64_t)p.q_offset + q0 + C::BQ, p.Skv);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BT - 1) / BT : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (NST + s), 4 * NWG);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // producer: Q and dO once, then K and V tiles through the ring
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 4 * NWG && lane == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, 2 * C::Q_BYTES);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          const uint32_t off = c * C::BQ * 128 + w * BT * 128;
          tma_load_4d(sQ + off, &tm_q, bar_q, 64 * c, q0 + BT * w, head, b);
          tma_load_4d(sdO + off, &tm_do, bar_q, 64 * c, q0 + BT * w, head,
                      b);
        }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NST;
        if (it >= NST) mbar_wait(bars + 8 * (NST + s), (it / NST - 1) & 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, 2 * C::KV_BYTES);
        const int kt0 = k_lo + it * BT;
        const uint32_t dst = sKV + s * 2 * C::KV_BYTES;
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(dst + c * BT * 128, &tm_k, full, 64 * c, kt0, kvh, b);
          tma_load_4d(dst + C::KV_BYTES + c * BT * 128, &tm_v, full, 64 * c,
                      kt0, kvh, b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64)
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int wg = __shfl_sync(0xffffffffu, warp / 4, 0), wi = warp % 4;
    const int r0 = 16 * wi + lane / 4, cq = 2 * (lane % 4);
    const int row_first = p.q_offset + q0 + BT * wg;   // absolute positions
    const int row_last = row_first + BT - 1;
    const int grow = q0 + BT * wg + r0;                // this thread's row
    // the rows' lse2 and Δ, held for the whole loop
    float lr[2], dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = grow + 8 * r;
      const int64_t at = ((int64_t)b * p.Hq + head) * p.Sq_pad + row;
      lr[r] = row < p.Sq ? p.lse2[at] : INFINITY;
      dr[r] = row < p.Sq ? p.delta[at] : 0.0f;
    }
    float dq[C::NCH][32];
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[c][i] = 0.0f;
    const uint32_t sQw = sQ + BT * wg * 128, sdOw = sdO + BT * wg * 128;

    // this warpgroup's live tiles [it_lo, it_hi): the CTA's range less the
    // tiles wholly before its first row's window or past its last row's
    // diagonal
    int it_lo = 0, it_hi = n_tiles;
    if (p.has_window) {
      const int t = row_first - p.window + 1 - k_lo;
      if (t > 0) it_lo = min(n_tiles, t / BT);
    }
    if (p.causal)
      it_hi = row_last >= k_lo ? min(n_tiles, (row_last - k_lo) / BT + 1) : 0;
    if (it_hi < it_lo) it_hi = it_lo;
    auto wait_full = [&](int it) {
      mbar_wait(bars + 8 * (it % NST), (it / NST) & 1);
    };
    auto empty = [&](int it) { return bars + 8 * (NST + it % NST); };

    for (int it = 0; it < it_lo; ++it) {
      wait_full(it);
      release(empty(it), lane);
    }
    if (it_lo < it_hi) mbar_wait(bar_q, 0);
    for (int it = it_lo; it < it_hi; ++it) {
      wait_full(it);
      const uint32_t sK = sKV + (it % NST) * 2 * C::KV_BYTES;
      const uint32_t sV = sK + C::KV_BYTES;
      const int kt0 = k_lo + it * BT;
      // S = Q · Kᵀ and dP = dO · Vᵀ, both operands in shared memory
      float sc[32], dp[32];
      wgmma_fence();
      issue_nt<D_PAD, C::BQ>(sc, sQw, sK);
      issue_nt<D_PAD, C::BQ>(dp, sdOw, sV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool masked = (p.causal && kt0 + BT - 1 > row_first) ||
                          (p.has_window && kt0 <= row_last - p.window) ||
                          kt0 + BT > p.Skv;
      grad_any<false>(sc, dp, p, masked, grow, kt0, cq, nullptr, nullptr,
                      lr, dr);
      // dS = P ∘ (dP − Δ) · dt rounded to bf16, then dQ += dS · K (K read
      // MN-major)
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= dp[i];
      uint32_t da[4][4];
      pack_bf16(sc, da);
      wgmma_fence();
      issue_acc<C::NCH>(dq, da, sK);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) fence_regs(dq[c]);
      fence_regs(da);
      release(empty(it), lane);
    }
    for (int it = max(it_hi, it_lo); it < n_tiles; ++it) {
      wait_full(it);
      release(empty(it), lane);
    }
    const int64_t off = ((int64_t)b * p.Hq + head) * p.Sq;
    store_rows<C::NCH>(p.dq, dq, off, grow, p.Sq, p.D, p.scale, cq);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------

// KNWG / KNST: the key pass's consumer warpgroups and stages; QNWG / QNST
// the query pass's. st: q's, k's, v's and dO's element strides (batch,
// head, row).
template <int D_PAD, int KNWG, int KNST, int QNWG, int QNST>
static int launch_cfg(const void* q, const void* k, const void* v,
                      const void* dout, const int64_t* st, const Params& p,
                      cudaStream_t stream) {
  using KC = KvCfg<D_PAD, KNWG, KNST>;
  using QC = QCfg<D_PAD, QNWG, QNST>;
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map(&tq, q, st[0], st[1], st[2], p.B, p.Hq, p.Sq, p.D, BT);
  if (rc == 0)
    rc = make_map(&tk, k, st[3], st[4], st[5], p.B, p.Hkv, p.Skv, p.D, BT);
  if (rc == 0)
    rc = make_map(&tv, v, st[6], st[7], st[8], p.B, p.Hkv, p.Skv, p.D, BT);
  if (rc == 0)
    rc = make_map(&tdo, dout, st[9], st[10], st[11], p.B, p.Hq, p.Sq, p.D,
                  BT);
  if (rc != 0) return rc;
  auto kkern = dkdv_wgmma_kernel<D_PAD, KNWG, KNST>;
  auto qkern = dq_wgmma_kernel<D_PAD, QNWG, QNST>;
  rc = prepare<KC>(kkern);
  if (rc == 0) rc = prepare<QC>(qkern);
  if (rc != 0) return rc;
  const long long gk = (long long)((p.Skv + KC::BKEY - 1) / KC::BKEY) * p.B *
                       p.Hkv;
  const long long gq = (long long)((p.Sq + QC::BQ - 1) / QC::BQ) * p.B * p.Hq;
  if (gk > 0x7fffffffLL || gq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kkern<<<(unsigned int)gk, KC::THREADS, KC::SMEM, stream>>>(tq, tk, tv, tdo,
                                                             p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qkern<<<(unsigned int)gq, QC::THREADS, QC::SMEM, stream>>>(tq, tk, tv, tdo,
                                                             p);
  return (int)cudaGetLastError();
}

// The bf16 entry at head_dim <= 128. st: q's, k's, v's, o's and dO's
// element strides (batch, head, row), the last dimension contiguous; q, k,
// v and dO as TMA reads them (strides multiples of 8, bases 16-byte
// aligned: the wrapper copies an operand that is not). lse2 and delta are
// [B, Hq, Sq_pad] float32 scratch (Sq_pad a multiple of 64); dq, dk and dv
// contiguous.
static int launch(const void* q, const void* k, const void* v,
                  const void* o, const void* dout, const float* lse,
                  float* delta, float* lse2, void* dq, void* dk, void* dv,
                  const int64_t* st, int32_t B, int32_t Hq, int32_t Hkv,
                  int32_t Sq, int32_t Skv, int32_t D, int32_t causal,
                  int32_t has_window, int32_t window, int32_t q_offset,
                  float scale, int32_t has_cap, float cap,
                  cudaStream_t stream) {
  Params p{};
  p.dq = (__nv_bfloat16*)dq;
  p.dk = (__nv_bfloat16*)dk;
  p.dv = (__nv_bfloat16*)dv;
  p.lse2 = lse2;
  p.delta = delta;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.Sq_pad = (Sq + BT - 1) / BT * BT;
  p.causal = causal; p.has_window = has_window; p.window = window;
  p.q_offset = q_offset; p.has_cap = has_cap; p.scale = scale;
  p.scale_log2 = scale * kLog2e; p.cap = cap;
  const int64_t rows = (int64_t)B * Hq * p.Sq_pad;
  const int64_t blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_prep_kernel<<<(unsigned int)blocks, 256, 0, stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, lse, lse2, delta,
      st[9], st[10], st[11], st[12], st[13], st[14], Hq, Sq, p.Sq_pad, D,
      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t tst[12] = {st[0], st[1], st[2], st[3],  st[4],  st[5],
                           st[6], st[7], st[8], st[12], st[13], st[14]};
  // tiles chosen on the card (flash_attention_bwd.cu's note)
  if (D <= 64)
    return launch_cfg<64, 2, 4, 3, 4>(q, k, v, dout, tst, p, stream);
  return launch_cfg<128, 1, 4, 2, 3>(q, k, v, dout, tst, p, stream);
}

}  // namespace fa_bwd_tc
