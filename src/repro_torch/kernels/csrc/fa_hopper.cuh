// fa_hopper.cuh: the bfloat16 flash_attention kernel on Hopper's tensor
// cores (wgmma with TMA); csrc/flash_attention.cu's header note says what
// it computes and why it is built so. Included by that file alone.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa_hopper {

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of the given parity has completed. A
// wait that never ends (a schedule fault) traps after 2^30 polls, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++polls == (1u << 30)) __trap();
  } while (!done);
}

// One TMA box of a 4-d tensor map into shared memory; completion (its
// bytes) goes to the barrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Moves registers between warpgroups (the producer gives, the consumers
// take); every warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile (layout
// type 1): groups of 8 rows 1024 bytes apart. The step between 64-column
// chunks of an MN-major operand (the leading byte offset, here 16) is
// unused: every product reads one chunk.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d[0:32] += A·B, m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[0:32] += A·B, m64n64k16, A from registers (a, bf16 pairs), B
// MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:32] = A·B (the sum starts afresh; d is only written), m64n64k16,
// A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d[0:32] = A·B (the sum starts afresh; d is only written), m64n64k16,
// A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64_first(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

// 2^x (MUFU.EX2; results below 2^-126 flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

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
struct Cfg {
  static constexpr int BQ = 64 * NWG;
  static constexpr int NCH = D_PAD / 64;          // 128-byte column chunks
  static constexpr int Q_BYTES = BQ * D_PAD * 2;
  static constexpr int KV_BYTES = BK * D_PAD * 2;  // one K or V tile
  static constexpr int STAGES = NST;
  // + the producer warpgroup, whose registers setmaxnreg moves to the
  // consumers
  static constexpr int THREADS = (NWG + 1) * 128;
  // the CTA's register pool at one CTA an SM, split by setmaxnreg
  static constexpr int POOL = 65536 / THREADS / 8 * 8 * THREADS;
  static constexpr int PRODUCER_REGS = NWG > 2 ? 32 : 24;
  static constexpr int CONSUMER_REGS_FIT =
      (POOL - 128 * PRODUCER_REGS) / (NWG * 128) / 8 * 8;
  static constexpr int CONSUMER_REGS =
      CONSUMER_REGS_FIT < 240 ? CONSUMER_REGS_FIT : 240;
  // 1024 for aligning the swizzled tiles; the full and empty barrier of
  // each stage and q's
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (2 * STAGES + 1);
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// S = q · kᵀ for one key tile into a fresh sum, issued (not awaited): the
// first step only writes sc, so sc holds no registers between tiles.
// D_PAD / 16 steps of 16 columns, both operands K-major in
// 128-byte-swizzled chunks of 64 columns (a step advances 32 bytes inside
// its chunk).
template <int D_PAD, int BQ>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint32_t sQw,
                                        uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < D_PAD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = desc_sw128(sQw + (kk / 4) * BQ * 128 + off);
    const uint64_t db = desc_sw128(sK + (kk / 4) * BK * 128 + off);
    if (kk == 0) wgmma_ss_n64_first(sc, da, db);
    else wgmma_ss_n64(sc, da, db);
  }
}

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
        issue_s<D_PAD, C::BQ>(sc, sQw, k_tile(it));
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
// host: tensor maps and launch
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

// Returned when cuTensorMapEncodeTiled refuses a map: kEncodeError + its
// CUresult.
constexpr int kEncodeError = 10000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; it is fetched through the
// runtime's entry-point query, so the library links no libcuda.
static EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiledFn)ptr;
  }
  return fn;
}

// A [B, H, S, D] bf16 tensor read through its element strides (batch,
// head, sequence; the last dimension contiguous), in boxes of 64 columns
// by `rows` rows, 128-byte swizzled. Columns past D and rows past S read
// as zeros. A dimension of size 1 is never stepped, so its stride is
// replaced by 16 bytes.
static int make_map(CUtensorMap* map, const void* ptr, int64_t sb, int64_t sh,
                    int64_t ss, int B, int H, int S, int D, int rows) {
  EncodeTiledFn enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {S > 1 ? (cuuint64_t)ss * 2 : 16,
                                 H > 1 ? (cuuint64_t)sh * 2 : 16,
                                 B > 1 ? (cuuint64_t)sb * 2 : 16};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
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
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  {
    // setmaxnreg.inc waits for registers that only the CTA's own pool can
    // give: refuse a build whose pool is short rather than hang
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return (int)err;
    if (fa.numRegs * C::THREADS <
        128 * C::PRODUCER_REGS + NWG * 128 * C::CONSUMER_REGS)
      return (int)cudaErrorInvalidConfiguration;
  }
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
