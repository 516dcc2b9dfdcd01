// fa_hopper.cuh: the bfloat16 flash_attention kernel on Hopper's tensor
// cores (wgmma with TMA); csrc/flash_attention.cu's header note says what
// it computes and why it is built so. Included by that file alone.
#pragma once

#include "hopper.cuh"

namespace fa_hopper {

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

constexpr int BK = 64;   // keys a tile

struct Params {
  __nv_bfloat16* o;
  float* lse;   // the rows' natural log-sum-exp [B, Hq, Sq], or null
  int32_t B, Hq, Hkv, Sq, Skv, D, n_qt;
  int32_t causal, has_window, window, q_offset, has_cap;
  float scale, scale_log2, cap;
};

// D_PAD: head_dim padded (64, 128, 256); NWG consumer warpgroups of 64
// query rows each; a ring of NST K and V stages.
template <int D_PAD, int NWG, int NST>
struct Cfg : RegSplit<NWG> {
  static constexpr int BQ = 64 * NWG;
  static constexpr int NCH = D_PAD / 64;          // 128-byte column chunks
  static constexpr int Q_BYTES = BQ * D_PAD * 2;
  static constexpr int KV_BYTES = BK * D_PAD * 2;  // one K or V tile
  static constexpr int STAGES = NST;
  // 1024 for aligning the swizzled tiles; the full and empty barrier of
  // each stage and q's
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (2 * STAGES + 1);
};

constexpr float kLn2 = 0.6931471805599453f;

// ot = P_hi · V[:, chunk] + P_lo · V[:, chunk] for one 64-column chunk of
// V, into a fresh accumulator (the first step overwrites it), issued (not
// awaited): V MN-major, keys its rows, 16 keys a step.
__device__ __forceinline__ void issue_pv(float (&ot)[32],
                                         const uint32_t (&ph)[BK / 16][4],
                                         const uint32_t (&pl)[BK / 16][4],
                                         uint32_t sVc) {
  wgmma_rs_n64_first(ot, ph[0], desc_sw128(sVc));
#pragma unroll
  for (int kk = 1; kk < BK / 16; ++kk)
    wgmma_rs_n64(ot, ph[kk], desc_sw128(sVc + kk * 16 * 128));
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs_n64(ot, pl[kk], desc_sw128(sVc + kk * 16 * 128));
}

// The online softmax of one tile of S (this thread's rows qpos0 and
// qpos0 + 8, columns k0 + 8j + cq + {0, 1}): scale (and cap) after the
// product, in log2 units; the mask only where the tile crosses an edge;
// the running max and this thread's share of the denominator; alpha, the
// rescale of O; and P = P_hi + P_lo, both bf16, in wgmma's A-fragment
// layout: the accumulator's pairs (8kk + 2i, 8kk + 2i + 1) are register
// i of the A operand of key step kk.
template <bool MASKED, bool CAP>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], const Params& p, int k0, int qpos0, int cq,
    float (&m_run)[2], float (&l_run)[2], float (&alpha)[2],
    uint32_t (&ph)[BK / 16][4], uint32_t (&pl)[BK / 16][4]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = sc[i];
    if constexpr (CAP) x = tanhf(x * p.scale / p.cap) * p.cap * kLog2e;
    if constexpr (MASKED) {
      const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
      const int qpos = qpos0 + ((i & 2) ? 8 : 0);
      const bool live = kpos < p.Skv && (!p.causal || kpos <= qpos) &&
                        (!p.has_window || kpos > qpos - p.window);
      if (!live) x = -INFINITY;
    }
    sc[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  // raw scores times mult are log2 units (a capped score already is)
  const float mult = CAP ? 1.0f : p.scale_log2;
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * mult);
    mu[r] = m_new == -INFINITY ? 0.0f : m_new;
    alpha[r] = ex2(m_run[r] - mu[r]);
    m_run[r] = m_new;
  }
  float rsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = ex2(fmaf(sc[8 * kk + 2 * i], mult, -mu[i & 1]));
      const float c = ex2(fmaf(sc[8 * kk + 2 * i + 1], mult, -mu[i & 1]));
      rsum[i & 1] += a + c;
      const uint32_t ua = __float_as_uint(a), uc = __float_as_uint(c);
      ph[kk][i] = __byte_perm(ua, uc, 0x7632);   // the upper halves
      pl[kk][i] = bf16x2_bits(
          __floats2bfloat162_rn(a - __uint_as_float(ua & 0xffff0000u),
                                c - __uint_as_float(uc & 0xffff0000u)));
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
}

// softmax_tile with its mask and cap chosen once per tile (branches
// outside the element loop)
__device__ __forceinline__ void softmax_any(
    float (&sc)[BK / 2], const Params& p, int k0, int qpos0, int cq,
    bool masked, float (&m_run)[2], float (&l_run)[2], float (&alpha)[2],
    uint32_t (&ph)[BK / 16][4], uint32_t (&pl)[BK / 16][4]) {
  if (masked) {
    if (p.has_cap)
      softmax_tile<true, true>(sc, p, k0, qpos0, cq, m_run, l_run, alpha, ph,
                               pl);
    else
      softmax_tile<true, false>(sc, p, k0, qpos0, cq, m_run, l_run, alpha, ph,
                                pl);
  } else {
    if (p.has_cap)
      softmax_tile<false, true>(sc, p, k0, qpos0, cq, m_run, l_run, alpha, ph,
                                pl);
    else
      softmax_tile<false, false>(sc, p, k0, qpos0, cq, m_run, l_run, alpha,
                                 ph, pl);
  }
}

// LSE: also store the rows' log-sum-exp to p.lse (a separate build, so
// the forward without it is the kernel it was)
template <int D_PAD, int NWG, int NST, bool LSE>
__global__ void __launch_bounds__(Cfg<D_PAD, NWG, NST>::THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using C = Cfg<D_PAD, NWG, NST>;
  extern __shared__ __align__(1024) uint8_t fa_smem[];
  const uint32_t sQ = (smem_u32(fa_smem) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::Q_BYTES;  // stage s: K, then V
  const uint32_t bars = sKV + C::STAGES * 2 * C::KV_BYTES;
  const uint32_t bar_q = bars + 8 * 2 * C::STAGES;
  // full[s] at bars + 8s, empty[s] at bars + 8 (STAGES + s)

  // heaviest query tiles first; the Hq / Hkv heads of one KV head side by
  // side, so their K and V tiles meet in L2
  const int bh = p.B * p.Hq;
  const int qt = p.n_qt - 1 - (int)blockIdx.x / bh;
  const int b = ((int)blockIdx.x % bh) / p.Hq;
  const int head = (int)blockIdx.x % p.Hq;
  const int kvh = head / (p.Hq / p.Hkv);
  const int q0 = qt * C::BQ;

  // the live key tiles: from the window's first visible key of the tile's
  // first row to the causal limit of its last row
  int k_lo = 0, k_hi = p.Skv;
  if (p.has_window) {
    const int first = p.q_offset + q0 - p.window + 1;
    k_lo = first > 0 ? first / BK * BK : 0;
  }
  if (p.causal) k_hi = min(p.q_offset + q0 + C::BQ, p.Skv);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (C::STAGES + s), 4 * NWG);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // producer: the q tile once, then K and V tiles through the ring,
    // issued by one thread
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 4 * NWG && lane == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
        tma_load_4d(sQ + c * C::BQ * 128, &tm_q, bar_q, 64 * c, q0, head, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::STAGES;
        if (it >= C::STAGES)
          mbar_wait(bars + 8 * (C::STAGES + s), (it / C::STAGES - 1) & 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, 2 * C::KV_BYTES);
        const int k0 = k_lo + it * BK;
        const uint32_t dk = sKV + s * 2 * C::KV_BYTES;
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(dk + c * BK * 128, &tm_k, full, 64 * c, k0, kvh, b);
          tma_load_4d(dk + C::KV_BYTES + c * BK * 128, &tm_v, full, 64 * c,
                      k0, kvh, b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows [64 wg, 64 wg + 64) of the tile.
    // Thread (wi, lane) holds rows r0 and r0 + 8 of the accumulators, at
    // columns 8j + cq + {0, 1} (wgmma's fragment layout). wg comes through
    // a shuffle from lane 0, so the compiler knows it is the same across
    // the warp and keeps the descriptors built from it in uniform registers
    // (a per-thread value there serializes the wgmmas).
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int wg = __shfl_sync(0xffffffffu, warp / 4, 0), wi = warp % 4;
    const int r0 = 16 * wi + lane / 4, cq = 2 * (lane % 4);
    const int row_first = p.q_offset + q0 + 64 * wg;  // absolute positions
    const int row_last = row_first + 63;
    float o[D_PAD / 2];
#pragma unroll
    for (int i = 0; i < D_PAD / 2; ++i) o[i] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
    const uint32_t sQw = sQ + 64 * wg * 128;

    // this warpgroup's live tiles [it_lo, it_hi): the CTA's range less the
    // tiles wholly before its first row's window or past its last row's
    // diagonal. It still waits for and releases the others.
    int it_lo = 0, it_hi = n_tiles;
    if (p.has_window) {
      const int t = row_first - p.window + 1 - k_lo;
      if (t > 0) it_lo = min(n_tiles, t / BK);
    }
    if (p.causal)
      it_hi = row_last >= k_lo ? min(n_tiles, (row_last - k_lo) / BK + 1) : 0;
    if (it_hi < it_lo) it_hi = it_lo;
    auto wait_full = [&](int it) {
      mbar_wait(bars + 8 * (it % C::STAGES), (it / C::STAGES) & 1);
    };
    auto release = [&](int it) {   // this warp is done with tile it
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (C::STAGES + it % C::STAGES));
    };
    auto k_tile = [&](int it) {
      return sKV + (it % C::STAGES) * 2 * C::KV_BYTES;
    };
    auto masked = [&](int k0) {    // a tile that crosses a mask edge
      return (p.causal && k0 + BK - 1 > row_first) ||
             (p.has_window && k0 <= row_last - p.window) || k0 + BK > p.Skv;
    };

    for (int it = 0; it < it_lo; ++it) { wait_full(it); release(it); }
    if (it_lo < it_hi) {
      mbar_wait(bar_q, 0);
      const int qpos0 = row_first + r0;
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
      float alpha[2];
      // S, its softmax, then P . V, each product awaited before the next
      // step: while one warpgroup runs its softmax, the others' products
      // hold the tensor cores (and no product in flight shares a register
      // with the softmax)
      for (int it = it_lo; it < it_hi; ++it) {
        wait_full(it);
        float sc[BK / 2];   // written afresh by the first step
        wgmma_fence();
        // S = q · kᵀ for the key tile into a fresh sum: the first step only
        // writes sc, so sc holds no registers between tiles
        issue_nt<D_PAD, C::BQ>(sc, sQw, k_tile(it));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        const int k0 = k_lo + it * BK;
        softmax_any(sc, p, k0, qpos0, cq, masked(k0), m_run, l_run, alpha,
                        ph, pl);
        // P . V a 64-column chunk at a time into a fresh accumulator, added
        // to O in float32 (rounded to nearest): the tensor cores' own sum
        // over thousands of keys would drift (PERF.md)
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          float ot[32];
          fence_regs(ph);
          fence_regs(pl);
          wgmma_fence();
          issue_pv(ot, ph, pl, k_tile(it) + C::KV_BYTES + c * BK * 128);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(ot);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            o[32 * c + i] = fmaf(o[32 * c + i], alpha[(i >> 1) & 1], ot[i]);
        }
        fence_regs(ph);
        fence_regs(pl);
        release(it);
      }
    }
    for (int it = it_hi; it < n_tiles; ++it) { wait_full(it); release(it); }

    // the row sums are split over the 4 lanes that share a row
    float inv[2], lsum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      lsum[r] = l;
      inv[r] = l > 0.0f ? 1.0f / l : 0.0f;   // a fully masked row gives 0
    }
    __nv_bfloat16* ob = p.o + ((int64_t)b * p.Hq + head) * p.Sq * p.D;
    const int grow = q0 + 64 * wg + r0;
    // the LSE for the backward: m_run and the sum are in log2 units, so
    // ln(sum e^s) = (m + log2 l) · ln 2; a fully masked row stores +inf,
    // for which exp(s − lse) is 0
    if (LSE && (lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = grow + 8 * r;
        if (row < p.Sq)
          p.lse[((int64_t)b * p.Hq + head) * p.Sq + row] =
              lsum[r] > 0.0f ? (m_run[r] + log2f(lsum[r])) * kLn2 : INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < D_PAD / 2; i += 2) {
      const int col = 8 * (i / 4) + cq;
      const int row = grow + ((i & 2) ? 8 : 0);
      if (row >= p.Sq || col >= p.D) continue;
      const float v0 = o[i] * inv[(i >> 1) & 1];
      const float v1 = o[i + 1] * inv[(i >> 1) & 1];
      __nv_bfloat16* dst = ob + (int64_t)row * p.D + col;
      if ((p.D & 1) == 0) {   // col is even, so col + 1 < D
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16_rn(v0);
        if (col + 1 < p.D) dst[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host: launch
// ---------------------------------------------------------------------------

__global__ void fill_inf_kernel(float* x, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = INFINITY;
}

// x[0:n] = +inf (the LSE of rows with no key)
static int fill_inf(float* x, int64_t n, cudaStream_t stream) {
  if (n == 0) return 0;
  fill_inf_kernel<<<(unsigned int)((n + 255) / 256), 256, 0, stream>>>(x, n);
  return (int)cudaGetLastError();
}

template <int D_PAD, int NWG, int NST>
static int launch_cfg(const void* q, const void* k, const void* v, void* o,
                      float* lse, const int64_t* st, Params p,
                      cudaStream_t stream) {
  using C = Cfg<D_PAD, NWG, NST>;
  void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                 const Params) =
      lse != nullptr ? fa_wgmma_kernel<D_PAD, NWG, NST, true>
                     : fa_wgmma_kernel<D_PAD, NWG, NST, false>;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, st[0], st[1], st[2], p.B, p.Hq, p.Sq, p.D, C::BQ);
  if (rc == 0)
    rc = make_map(&tk, k, st[3], st[4], st[5], p.B, p.Hkv, p.Skv, p.D, BK);
  if (rc == 0)
    rc = make_map(&tv, v, st[6], st[7], st[8], p.B, p.Hkv, p.Skv, p.D, BK);
  if (rc == 0) rc = prepare<C>(kernel);
  if (rc != 0) return rc;
  p.o = (__nv_bfloat16*)o;
  p.lse = lse;
  p.n_qt = (p.Sq + C::BQ - 1) / C::BQ;
  const long long grid = (long long)p.n_qt * p.B * p.Hq;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned int)grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// The bf16 entry: strides in elements (q's, k's, v's batch, head,
// sequence), each a multiple of 8 and each base 16-byte aligned (the
// wrapper copies an operand that is not).
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* lse, const int64_t* st, int32_t B, int32_t Hq,
                  int32_t Hkv, int32_t Sq, int32_t Skv, int32_t D,
                  int32_t causal, int32_t has_window, int32_t window,
                  int32_t q_offset, float scale, int32_t has_cap, float cap,
                  cudaStream_t stream) {
  if (Skv == 0) {  // no keys: every row is fully masked (lse +inf)
    if (lse != nullptr) {
      const int rc = fill_inf(lse, (int64_t)B * Hq * Sq, stream);
      if (rc != 0) return rc;
    }
    return (int)cudaMemsetAsync(o, 0, (size_t)B * Hq * Sq * D * 2, stream);
  }
  Params p{};
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.causal = causal; p.has_window = has_window; p.window = window;
  p.q_offset = q_offset; p.has_cap = has_cap; p.scale = scale;
  p.scale_log2 = scale * kLog2e; p.cap = cap;
  // tiles chosen on the card (PERF.md), 64 keys each: at head_dim 64,
  // three consumer warpgroups (192 query rows) and 6 stages; at 128 and
  // 256, two warpgroups (128 rows) and 3 and 2 stages
  if (D <= 64) return launch_cfg<64, 3, 6>(q, k, v, o, lse, st, p, stream);
  if (D <= 128)
    return launch_cfg<128, 2, 3>(q, k, v, o, lse, st, p, stream);
  return launch_cfg<256, 2, 2>(q, k, v, o, lse, st, p, stream);
}

}  // namespace fa_hopper
