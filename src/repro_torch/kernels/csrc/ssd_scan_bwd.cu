// ssd_scan_bwd: the gradient of ssd_scan, Mamba-2's selective scan, in
// Mamba-2's chunked form on the tensor cores (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel for the
// scan; XLA differentiates its lax.scan (src/repro/models/mamba2.py:
// 110-122, under chunked_scan). The port adds it for the reason
// wkv6_bwd.cu gives.
//
// Per (batch, head), h [D rows d, n state columns m] in float32, the
// forward h_t = exp(ℓ_t) h_{t-1} + dt_t x_t ⊗ B_t, y_t = h_t C_t with
// ℓ_t = dt_t a. The decay is one scalar a head and step, so the backward
// has the forward's state-space-dual chunked form (ssd_scan.cu, chunks of
// L = 32 steps). Within a chunk, with seg[i][j] the sum of ℓ over steps
// j + 1 … i, pre_i over 0 … i, suf_j over j + 1 … L − 1 and total over
// all, E = exp(seg) (causal), G = C·Bᵀ, A = dY·Xᵀ (a head) and W2 =
// A ∘ E ∘ dt_j:
//
//   dh_start = exp(total) dh_end + dYᵀ·diag(exp pre)·C
//   dx  = dt ∘ gB,   gB = (G ∘ E)ᵀ·dY + diag(exp suf)·B·dh_endᵀ
//   dB  = Σ_h W2ᵀ·C + diag(dt exp suf)·X·dh_end
//   dC  = Σ_h W2·B + diag(exp pre)·dY·h_start
//
// and the gradient of each step's log-decay, dℓ_k, is the sum of the
// chunk's terms whose segment holds step k: G ∘ W2 [i][j] (j < k ≤ i),
// exp(pre_i) dy_i·(h_start C_i) (k ≤ i), exp(suf_j) dt_j x_j·(dh_end B_j)
// (j < k) and exp(total) Σ dh_end ∘ h_start; ddt_k = a dℓ_k + x_k·gB_k and
// da = Σ dt_k dℓ_k. h_start is the forward's checkpoint (ssd_scan.cu writes
// the state before every chunk when asked, [B, H, ceil(S/32), D, n]
// float32); no state is recomputed.
//
// Two kernels and two short passes, one call:
//
// 1. ssd_bwd_dh_kernel walks the chunks from the last, a CTA (4 warps) a
//    16-row block of one head's state and all n columns: it stores the
//    gradient of the state after each chunk (dh_end, [B, H, ceil(S/32),
//    D, n] float32 scratch, the checkpoints' size) and steps dh_end(c − 1)
//    = exp(total) dh_end(c) + P_c, P_c = dYᵀ·diag(exp pre)·C on mma; its
//    last value is dh0. Grid (D / 16, H, B): 512 CTAs at zamba2-1.2b's
//    training shape (B 2, S 4,096, H 64, D 64, n 64), 256 at 1 × 32,768.
//    Its time is mostly dh_end's writes (the chunk's serial part is one
//    FMA; deeper copy rings, column blocks and four chunks a step measured
//    no faster).
// 2. ssd_bwd_chunk_kernel runs every chunk at once, a CTA (8 warps) one
//    (chunk, batch row) and a group of heads, walked in order: C·Bᵀ once,
//    then for each head and each 32-row slice of its state, copied with
//    cp.async into one of two stages while the last one runs, the products
//    dY·Xᵀ, dY·h_start, X·dh_end, (G ∘ E)ᵀ·dY and B·dh_endᵀ; after a head's
//    slices W2 ·C and ·B into dB and dC (summed over the CTA's heads in
//    registers, in head order), and one warp forms dℓ from the terms
//    above: each row's running sum over its columns, then each column's
//    sum over its rows, in order (a scan across the lanes a row measured
//    slower). Grid (ceil(S/32), B, groups), the groups of heads as many
//    as put two CTAs on each of 132 SMs (the caller picks them: ops.py's
//    ssd_bwd_groups; 2 at the training shape, 1 at
//    1 × 32,768: 512 and 1,024 CTAs), two CTAs an SM (128 registers a
//    thread; one CTA an SM measured 1.46 times the time).
// 3. scan_sum adds the groups' dB and dC partials (only with more than one
//    group) and da over the batch rows and chunks, in a fixed order.
//
// Every product is 3xTF32 mma.sync m16n8k8 (scan.cuh's ssd_* pieces, shared
// with the forward; an operand read from bf16 is exact in TF32 and has no
// small part), every decay exp of a sum over its own segment (E's in
// order, Mamba-2's segsum as the forward forms it), never a difference of
// two cumulative sums, which cancels once a chunk's sum passes −87. No float
// atomics anywhere, so the bytes repeat run to run. Rows past S are
// zeros (dt = 0: a decay of 1 and no input), as in the forward.
//
// Bound at zamba2-1.2b's training shape (x, B, C, dx, dB, dC bf16; dt,
// dy, ddt float32): 549 MB moved by the function (inputs, checkpoints and
// gradients once each), 0.16 ms at 3.35 TB/s; the chunked products 21.6
// GFLOP, 0.04 ms at 495 TFLOP/s (TF32); chip_smoke.py states both. The
// design moves about 0.7 GB more (dh_end written and read, dy read twice)
// and spends most of its time in the chunk pass's products and their
// fragment loads; PERF.md has the split by stage.
#include "scan.cuh"

// ---------------------------------------------------------------------------
// 1. the chunk-end gradients
// ---------------------------------------------------------------------------

// A stage (bytes): dy [L][YS] float32 (this CTA's 16 rows), C [L][CR] (T),
// dt [L] float32; row paddings put the fragments' loads in distinct banks.
template <int N, typename T>
struct SsdBwdDh {
  static constexpr int L = SCAN_T, ROWS = 16, THREADS = 128;
  static constexpr int YS = ROWS + 8;
  static constexpr int CR = N + 16 / (int)sizeof(T);
  static constexpr int C_AT = 4 * L * YS;
  static constexpr int DT_AT = C_AT + L * CR * (int)sizeof(T);
  static constexpr int STAGE = DT_AT + 4 * L;
  static constexpr int SMEM_BYTES = 2 * STAGE;
  static constexpr int NT = N / 8, TPW = NT >= 4 ? NT / 4 : 1;
  static constexpr bool EXACT = sizeof(T) == 2;
  static_assert(STAGE % 16 == 0 && C_AT % 16 == 0, "layout");
};

template <int N, typename T>
__global__ void __launch_bounds__(SsdBwdDh<N, T>::THREADS)
    ssd_bwd_dh_kernel(const T* __restrict__ Cv, const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ dy,
                      const float* __restrict__ dh_last,
                      float* __restrict__ dhe, float* __restrict__ dh0,
                      int64_t S, int H, int D) {
  using K = SsdBwdDh<N, T>;
  constexpr int L = K::L, YS = K::YS, CR = K::CR, TPW = K::TPW;
  constexpr int THREADS = K::THREADS;
  constexpr bool EXACT = K::EXACT;
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned all = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int d0 = blockIdx.x * K::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int64_t x_step = (int64_t)H * D;
  const int nch = (int)((S + L - 1) / L);
  const float a_h = a[h];
  auto stage = [&](int c) { return smem + (c & 1) * K::STAGE; };

  // chunk c's rows into its stage; rows past the sequence's end are zeros
  auto issue = [&](int c) {
    const int64_t t0 = (int64_t)c * L;
    const int steps = scan_steps(S, t0);
    unsigned char* sg = stage(c);
    const float* ysrc = dy + ((int64_t)b * S + t0) * x_step +
                        (int64_t)h * D + d0;
    for (int q = tid; q < steps * 4; q += THREADS) {   // 64 bytes a row
      scan_cp_async16(sg + (q >> 2) * YS * 4 + (q & 3) * 16,
                      ysrc + (q >> 2) * x_step + (q & 3) * 4);
    }
    constexpr int CV = N * (int)sizeof(T) / 16;
    const unsigned char* csrc = reinterpret_cast<const unsigned char*>(
        Cv + ((int64_t)b * S + t0) * N);
    for (int q = tid; q < steps * CV; q += THREADS) {
      const int row = q / CV, col = (q % CV) * 16;
      scan_cp_async16(sg + K::C_AT + row * CR * (int)sizeof(T) + col,
                      csrc + (int64_t)row * N * sizeof(T) + col);
    }
    if (tid < steps) {
      scan_cp_async4(sg + K::DT_AT + 4 * tid,
                     dt + ((int64_t)b * S + t0 + tid) * H + h);
    }
    scan_cp_async_commit();
    if (steps < L) {
      scan_zero(sg + steps * YS * 4, (L - steps) * YS * 4, tid, THREADS);
      scan_zero(sg + K::C_AT + steps * CR * (int)sizeof(T),
                (L - steps) * CR * (int)sizeof(T), tid, THREADS);
      if (tid >= steps && tid < L) {
        reinterpret_cast<float*>(sg + K::DT_AT)[tid] = 0.f;
      }
    }
  };

  // warp wp's n-tiles: wp, wp + 4, … (n = 16: warps 0 and 1)
  const bool has = wp < K::NT;
  const int64_t state = (((int64_t)b * H + h) * D + d0) * N;
  float acc[TPW][4];
#pragma unroll
  for (int q = 0; q < TPW; ++q) {
    const int m = (wp + 4 * q) * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[q][e] = has && dh_last
                      ? dh_last[state + (int64_t)(g + 8 * (e >> 1)) * N + m +
                                (e & 1)]
                      : 0.f;
    }
  }

  issue(nch - 1);
  for (int c = nch - 1; c >= 0; --c) {
    scan_cp_async_wait_all();
    __syncthreads();
    if (c > 0) issue(c - 1);
    const unsigned char* sg = stage(c);
    const float* ys = reinterpret_cast<const float*>(sg);
    const T* cs = reinterpret_cast<const T*>(sg + K::C_AT);
    // the chunk's prefix decays, lane s: exp of the sum of ℓ over 0 … s
    float pre = reinterpret_cast<const float*>(sg + K::DT_AT)[lane] * a_h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(all, pre, o);
      if (lane >= o) pre += v;
    }
    const float ep = expf(pre);
    const float et = expf(__shfl_sync(all, pre, 31));
    if (!has) continue;
    // dh_end(c), for the chunk pass
    float* out = dhe + (((int64_t)b * H + h) * nch + c) * D * N +
                 (int64_t)d0 * N;
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
      const int m = (wp + 4 * q) * 8 + 2 * t;
      ssd_store2(out + (int64_t)g * N + m, acc[q][0], acc[q][1]);
      ssd_store2(out + (int64_t)(g + 8) * N + m, acc[q][2], acc[q][3]);
    }
    // dh_end(c − 1) = exp(total)·dh_end(c) + dYᵀ·diag(exp pre)·C
    float p[TPW][4];
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[q][e] = 0.f;
    }
#pragma unroll
    for (int k0 = 0; k0 < L; k0 += 8) {
      const float e0 = __shfl_sync(all, ep, k0 + t);
      const float e1 = __shfl_sync(all, ep, k0 + t + 4);
      const SsdFrag<4> fa = ssd_frag_a<false>(
          [&](int r, int k) {
            return ys[(k0 + k) * YS + r] * (k < 4 ? e0 : e1);
          },
          g, t);
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
        const T* ccol = cs + k0 * CR + (wp + 4 * q) * 8;
        const SsdFrag<2> fb = ssd_frag_b<EXACT>(
            [&](int kk, int n) { return ssd_ld(ccol + kk * CR + n); }, g, t);
        ssd_mma3_into<false, EXACT>(p[q], fa, fb);
      }
    }
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = fmaf(et, acc[q][e], p[q][e]);
    }
  }
  if (has) {
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
      const int m = (wp + 4 * q) * 8 + 2 * t;
      ssd_store2(dh0 + state + (int64_t)g * N + m, acc[q][0], acc[q][1]);
      ssd_store2(dh0 + state + (int64_t)(g + 8) * N + m, acc[q][2],
                 acc[q][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. each chunk's gradients
// ---------------------------------------------------------------------------

// A stage (bytes), one head's 32-row slice: dy [L][FS] float32, x [L][XR]
// (T), h_start and dh_end [DS][HR] float32, dt [L] float32. The CTA's own:
// B, C [L][BR] (T); G = C·Bᵀ, the head's E, M = G ∘ E and W2 [L][FS]
// float32; the dℓ terms [L + 1][TS]; vectors (dt, exp pre, exp suf, exp
// total, the warps' row parts of x·gB, x·exp(suf)·B·dh_endᵀ and Z·C, and of
// Σ dh_end ∘ h_start).
template <int N, typename T>
struct SsdBwdChunk {
  static constexpr int L = SCAN_T, DS = 32, THREADS = 256;
  static constexpr int FS = L + 4;
  static constexpr int XR = DS + 16 / (int)sizeof(T);
  static constexpr int HR = N + 4;
  static constexpr int BR = N + 16 / (int)sizeof(T);
  static constexpr int TS = L + 2;
  static constexpr int X_AT = 4 * L * FS;
  static constexpr int HS_AT = X_AT + L * XR * (int)sizeof(T);
  static constexpr int HE_AT = HS_AT + 4 * DS * HR;
  static constexpr int DT_AT = HE_AT + 4 * DS * HR;
  static constexpr int STAGE = DT_AT + 4 * L;
  static constexpr int B_AT = 2 * STAGE;
  static constexpr int C_AT = B_AT + L * BR * (int)sizeof(T);
  static constexpr int G_AT = C_AT + L * BR * (int)sizeof(T);
  static constexpr int E_AT = G_AT + 4 * L * FS;
  static constexpr int M_AT = E_AT + 4 * L * FS;
  static constexpr int W_AT = M_AT + 4 * L * FS;
  static constexpr int T_AT = W_AT + 4 * L * FS;
  static constexpr int V_AT = T_AT + 4 * (L + 1) * TS;
  static constexpr int VEC = 3 * L + 4 + 3 * 4 * L + 8;
  static constexpr int SMEM_BYTES = V_AT + 4 * VEC;
  static constexpr int NT = N / 8, TPW = NT >= 4 ? NT / 4 : 1;
  static constexpr bool EXACT = sizeof(T) == 2;
  // two CTAs an SM where their shared memory fits (registers capped at
  // 128 a thread), one otherwise
  static constexpr int MIN_BLOCKS = 2 * SMEM_BYTES <= 232448 ? 2 : 1;
  static_assert(STAGE % 16 == 0 && X_AT % 16 == 0 && HS_AT % 16 == 0 &&
                    B_AT % 16 == 0 && C_AT % 16 == 0 &&
                    SMEM_BYTES <= 232448,
                "layout");
};

template <int N, typename T>
__global__ void __launch_bounds__(SsdBwdChunk<N, T>::THREADS,
                                  SsdBwdChunk<N, T>::MIN_BLOCKS)
    ssd_bwd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ Bv,
                         const T* __restrict__ Cv,
                         const float* __restrict__ dt,
                         const float* __restrict__ a,
                         const float* __restrict__ ckpt,
                         const float* __restrict__ dy,
                         const float* __restrict__ dhe, T* __restrict__ dx,
                         T* __restrict__ dB, T* __restrict__ dC,
                         float* __restrict__ dbc_part,
                         float* __restrict__ ddt,
                         float* __restrict__ da_part, int64_t S, int H,
                         int D, int hpc) {
  using K = SsdBwdChunk<N, T>;
  constexpr int L = K::L, DS = K::DS, FS = K::FS, XR = K::XR, HR = K::HR;
  constexpr int BR = K::BR, TS = K::TS, TPW = K::TPW, THREADS = K::THREADS;
  constexpr bool EXACT = K::EXACT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bsm = reinterpret_cast<T*>(smem + K::B_AT);
  T* csm = reinterpret_cast<T*>(smem + K::C_AT);
  float* gs = reinterpret_cast<float*>(smem + K::G_AT);
  float* es = reinterpret_cast<float*>(smem + K::E_AT);
  float* ms = reinterpret_cast<float*>(smem + K::M_AT);
  float* ws = reinterpret_cast<float*>(smem + K::W_AT);
  float* ts = reinterpret_cast<float*>(smem + K::T_AT);
  float* dtv = reinterpret_cast<float*>(smem + K::V_AT);
  float* epv = dtv + L;
  float* esv = epv + L;
  float* etv = esv + L;
  float* rin = etv + 4;       // [4][L]: Σ x·gB over the warps' d columns
  float* rsuf = rin + 4 * L;  // [4][L]: Σ x·exp(suf)·B·dh_endᵀ
  float* rpre = rsuf + 4 * L; // [4][L]: Σ Z·C over the warps' m columns
  float* rtot = rpre + 4 * L; // [8]: Σ dh_end ∘ h_start

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, mt = wp & 1, wn = wp >> 1;
  const int c = blockIdx.x, b = blockIdx.y, grp = blockIdx.z;
  const int Bn = gridDim.y;
  const int h_begin = grp * hpc;
  const int nh = H - h_begin < hpc ? H - h_begin : hpc;
  const int nch = (int)((S + L - 1) / L);
  const int64_t t0 = (int64_t)c * L;
  const int steps = scan_steps(S, t0);
  const int NSL = D / DS, units = nh * NSL;
  const int64_t x_step = (int64_t)H * D;
  const int64_t row0 = (int64_t)b * S + t0;   // the chunk's first (b, t)
  auto stage = [&](int u) { return smem + (u & 1) * K::STAGE; };

  // unit u = (head h_begin + u / NSL, slice u % NSL) into its stage
  auto issue = [&](int u) {
    const int hh = h_begin + u / NSL, s = u % NSL;
    unsigned char* sg = stage(u);
    const int64_t col0 = (int64_t)hh * D + s * DS;
    for (int q = tid; q < steps * 8; q += THREADS) {   // 128 bytes a row
      scan_cp_async16(sg + (q >> 3) * FS * 4 + (q & 7) * 16,
                      dy + (row0 + (q >> 3)) * x_step + col0 + (q & 7) * 4);
    }
    constexpr int XV = DS * (int)sizeof(T) / 16;
    for (int q = tid; q < steps * XV; q += THREADS) {
      const int row = q / XV, col = (q % XV) * 16;
      scan_cp_async16(sg + K::X_AT + row * XR * (int)sizeof(T) + col,
                      reinterpret_cast<const unsigned char*>(
                          x + (row0 + row) * x_step + col0) + col);
    }
    constexpr int HV = N / 4;
    const int64_t st = ((((int64_t)b * H + hh) * nch + c) * D + s * DS) * N;
    for (int q = tid; q < DS * HV; q += THREADS) {
      const int row = q / HV, col = (q % HV) * 4;
      scan_cp_async16(sg + K::HS_AT + (row * HR + col) * 4,
                      ckpt + st + (int64_t)row * N + col);
      scan_cp_async16(sg + K::HE_AT + (row * HR + col) * 4,
                      dhe + st + (int64_t)row * N + col);
    }
    if (tid < steps) {
      scan_cp_async4(sg + K::DT_AT + 4 * tid, dt + (row0 + tid) * H + hh);
    }
    scan_cp_async_commit();
    if (steps < L) {
      scan_zero(sg + steps * FS * 4, (L - steps) * FS * 4, tid, THREADS);
      scan_zero(sg + K::X_AT + steps * XR * (int)sizeof(T),
                (L - steps) * XR * (int)sizeof(T), tid, THREADS);
      if (tid >= steps && tid < L) {
        reinterpret_cast<float*>(sg + K::DT_AT)[tid] = 0.f;
      }
    }
  };

  // the chunk's B and C rows, with the first unit
  {
    constexpr int BV = N * (int)sizeof(T) / 16;
    for (int q = tid; q < steps * BV; q += THREADS) {
      const int row = q / BV, col = (q % BV) * 16;
      const int64_t src = (row0 + row) * N * (int64_t)sizeof(T) + col;
      scan_cp_async16(reinterpret_cast<unsigned char*>(bsm) +
                          row * BR * (int)sizeof(T) + col,
                      reinterpret_cast<const unsigned char*>(Bv) + src);
      scan_cp_async16(reinterpret_cast<unsigned char*>(csm) +
                          row * BR * (int)sizeof(T) + col,
                      reinterpret_cast<const unsigned char*>(Cv) + src);
    }
    if (steps < L) {
      const int rb = BR * (int)sizeof(T);
      scan_zero(reinterpret_cast<unsigned char*>(bsm) + steps * rb,
                (L - steps) * rb, tid, THREADS);
      scan_zero(reinterpret_cast<unsigned char*>(csm) + steps * rb,
                (L - steps) * rb, tid, THREADS);
    }
  }
  issue(0);
  scan_cp_async_wait_all();
  __syncthreads();
  // G = C·Bᵀ: warp (mt, wn) the rows i = 16·mt …, the columns j = 8·wn …
  {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 8) {
      const SsdFrag<4> fa = ssd_frag_a<EXACT>(
          [&](int r, int k) { return ssd_ld(csm + (16 * mt + r) * BR + k0 + k); },
          g, t);
      const SsdFrag<2> fb = ssd_frag_b<EXACT>(
          [&](int kk, int n) { return ssd_ld(bsm + (8 * wn + n) * BR + k0 + kk); },
          g, t);
      ssd_mma3_into<EXACT, EXACT>(acc, fa, fb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      gs[(16 * mt + g + 8 * (e >> 1)) * FS + 8 * wn + 2 * t + (e & 1)] =
          acc[e];
    }
  }

  // warp (mt, wn): A's tile (i rows 16·mt …, j columns 8·wn …; none above
  // the diagonal), gB's (j rows 16·mt …, d columns 8·wn … of a slice), and
  // n-tiles wn, wn + 4, … of the 32 × n products (rows 16·mt …)
  const bool has_a = !(mt == 0 && wn >= 2);
  const bool has_n = wn < K::NT;
  float dBacc[TPW][4], dCacc[TPW][4];
#pragma unroll
  for (int q = 0; q < TPW; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dBacc[q][e] = dCacc[q][e] = 0.f;
  }

  for (int hl = 0; hl < nh; ++hl) {
    const int hh = h_begin + hl;
    const float a_h = a[hh];
    float Aacc[4] = {0.f, 0.f, 0.f, 0.f};
    float U[TPW][4], Z[TPW][4];
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) U[q][e] = Z[q][e] = 0.f;
    }
    float rin_acc[2] = {0.f, 0.f}, rsuf_acc[2] = {0.f, 0.f}, ttot = 0.f;
    for (int s = 0; s < NSL; ++s) {
      const int u = hl * NSL + s;
      scan_cp_async_wait_all();
      __syncthreads();
      if (u + 1 < units) issue(u + 1);
      const unsigned char* sg = stage(u);
      const float* ys = reinterpret_cast<const float*>(sg);
      const T* xs = reinterpret_cast<const T*>(sg + K::X_AT);
      const float* hsv = reinterpret_cast<const float*>(sg + K::HS_AT);
      const float* hev = reinterpret_cast<const float*>(sg + K::HE_AT);
      const float* dts = reinterpret_cast<const float*>(sg + K::DT_AT);
      if (s == 0) {
        // the head's decays, every sum over its own segment added in
        // order: E[i][j] = exp(ℓ_{j+1} + … + ℓ_i) (lane j; the forward's
        // segsum) and M = G ∘ E, warps 0-3 a quarter of the rows i each
        // (the sum up to the quarter's first row first, without exps);
        // exp(pre_i), exp(suf_j) and exp(total), warps 4-6
        const float ell = dts[lane] * a_h;
        float run = 0.f;
        if (wp < 4) {
          const int i0 = 8 * wp;
          for (int k = 0; k < i0; ++k) {
            const float dk = __shfl_sync(0xffffffffu, ell, k);
            if (k > lane) run += dk;
          }
#pragma unroll
          for (int i = i0; i < i0 + 8; ++i) {
            const float di = __shfl_sync(0xffffffffu, ell, i);
            if (i > lane) run += di;
            const float v = i >= lane ? expf(run) : 0.f;
            es[i * FS + lane] = v;
            ms[i * FS + lane] = gs[i * FS + lane] * v;
          }
        } else if (wp == 4) {   // steps 0 … i (lane i)
#pragma unroll 8
          for (int k = 0; k < L; ++k) {
            const float dk = __shfl_sync(0xffffffffu, ell, k);
            if (k <= lane) run += dk;
          }
          epv[lane] = expf(run);
          dtv[lane] = dts[lane];
        } else if (wp == 5) {   // steps j + 1 … L − 1 (lane j)
#pragma unroll 8
          for (int k = 0; k < L; ++k) {
            const float dk = __shfl_sync(0xffffffffu, ell, k);
            if (k > lane) run += dk;
          }
          esv[lane] = expf(run);
        } else if (wp == 6) {   // all steps
#pragma unroll 8
          for (int k = 0; k < L; ++k) run += __shfl_sync(0xffffffffu, ell, k);
          if (lane == 0) etv[0] = expf(run);
        }
        __syncthreads();
      }
      // A += dY·Xᵀ, Z += dY·h_start, U += X·dh_end over the slice's rows d
#pragma unroll
      for (int k0 = 0; k0 < DS; k0 += 8) {
        const SsdFrag<4> fy = ssd_frag_a<false>(
            [&](int r, int k) { return ys[(16 * mt + r) * FS + k0 + k]; }, g,
            t);
        if (has_a) {
          const SsdFrag<2> fx = ssd_frag_b<EXACT>(
              [&](int kk, int n) {
                return ssd_ld(xs + (8 * wn + n) * XR + k0 + kk);
              },
              g, t);
          ssd_mma3_into<false, EXACT>(Aacc, fy, fx);
        }
        if (has_n) {
          const SsdFrag<4> fxa = ssd_frag_a<EXACT>(
              [&](int r, int k) {
                return ssd_ld(xs + (16 * mt + r) * XR + k0 + k);
              },
              g, t);
#pragma unroll
          for (int q = 0; q < TPW; ++q) {
            const int m0 = (wn + 4 * q) * 8;
            const SsdFrag<2> fh = ssd_frag_b<false>(
                [&](int kk, int n) { return hsv[(k0 + kk) * HR + m0 + n]; },
                g, t);
            ssd_mma3_into<false, false>(Z[q], fy, fh);
            const SsdFrag<2> fe = ssd_frag_b<false>(
                [&](int kk, int n) { return hev[(k0 + kk) * HR + m0 + n]; },
                g, t);
            ssd_mma3_into<EXACT, false>(U[q], fxa, fe);
          }
        }
      }
      for (int e = tid; e < DS * N; e += THREADS) {
        const int r = e / N, m = e % N;
        ttot = fmaf(hev[r * HR + m], hsv[r * HR + m], ttot);
      }
      // gB = (G ∘ E)ᵀ·dY + diag(exp suf)·B·dh_endᵀ (j rows, d columns)
      {
        float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 16 * mt; k0 < L; k0 += 8) {   // M[i][j] = 0 for i < j
          const SsdFrag<4> fm = ssd_frag_a<false>(
              [&](int r, int k) { return ms[(k0 + k) * FS + 16 * mt + r]; },
              g, t);
          const SsdFrag<2> fy = ssd_frag_b<false>(
              [&](int kk, int n) { return ys[(k0 + kk) * FS + 8 * wn + n]; },
              g, t);
          ssd_mma3_into<false, false>(p1, fm, fy);
        }
#pragma unroll
        for (int k0 = 0; k0 < N; k0 += 8) {
          const SsdFrag<4> fb = ssd_frag_a<EXACT>(
              [&](int r, int k) {
                return ssd_ld(bsm + (16 * mt + r) * BR + k0 + k);
              },
              g, t);
          const SsdFrag<2> fe = ssd_frag_b<false>(
              [&](int kk, int n) { return hev[(8 * wn + n) * HR + k0 + kk]; },
              g, t);
          ssd_mma3_into<EXACT, false>(p2, fb, fe);
        }
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 16 * mt + g + 8 * (e >> 1);
          const int d = 8 * wn + 2 * t + (e & 1);
          const float sj = esv[j];
          const float v = fmaf(sj, p2[e], p1[e]);
          const float xv = ssd_ld(xs + j * XR + d);
          rin_acc[e >> 1] = fmaf(xv, v, rin_acc[e >> 1]);
          rsuf_acc[e >> 1] = fmaf(xv, sj * p2[e], rsuf_acc[e >> 1]);
          out[e] = dtv[j] * v;
        }
        const int64_t col = (int64_t)hh * D + s * DS + 8 * wn + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int j = 16 * mt + g + 8 * (e >> 1);
          if (j < steps) {
            ssd_store2(dx + (row0 + j) * x_step + col, out[e], out[e + 1]);
          }
        }
      }
    }
    // the head's end: W2 = A ∘ E ∘ dt_j, the dℓ terms G ∘ W2 (j < i) and
    // the warps' row parts
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * mt + g + 8 * (e >> 1);
      const int j = 8 * wn + 2 * t + (e & 1);
      const float w2 = has_a ? Aacc[e] * es[i * FS + j] * dtv[j] : 0.f;
      ws[i * FS + j] = w2;
      if (j < i) ts[i * TS + j + 1] = gs[i * FS + j] * w2;
    }
    float zc[2] = {0.f, 0.f};
    if (has_n) {
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * mt + g + 8 * (e >> 1);
          const int m = (wn + 4 * q) * 8 + 2 * t + (e & 1);
          zc[e >> 1] = fmaf(Z[q][e], ssd_ld(csm + i * BR + m), zc[e >> 1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        rin_acc[r] += __shfl_xor_sync(0xffffffffu, rin_acc[r], o);
        rsuf_acc[r] += __shfl_xor_sync(0xffffffffu, rsuf_acc[r], o);
        zc[r] += __shfl_xor_sync(0xffffffffu, zc[r], o);
      }
      if (t == 0) {
        const int row = 16 * mt + g + 8 * r;
        rin[wn * L + row] = rin_acc[r];
        rsuf[wn * L + row] = rsuf_acc[r];
        rpre[wn * L + row] = zc[r];
      }
    }
    ttot = scan_warp_sum(ttot);
    if (lane == 0) rtot[wp] = ttot;
    __syncthreads();
    // dB += W2ᵀ·C + dt·exp(suf)·U, dC += W2·B + exp(pre)·Z
    if (has_n) {
      float pb[TPW][4], pc[TPW][4];
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pb[q][e] = pc[q][e] = 0.f;
      }
      for (int k0 = 16 * mt; k0 < L; k0 += 8) {   // W2[i][j] = 0 for i < j
        const SsdFrag<4> fw = ssd_frag_a<false>(
            [&](int r, int k) { return ws[(k0 + k) * FS + 16 * mt + r]; }, g,
            t);
#pragma unroll
        for (int q = 0; q < TPW; ++q) {
          const T* ccol = csm + k0 * BR + (wn + 4 * q) * 8;
          const SsdFrag<2> fc = ssd_frag_b<EXACT>(
              [&](int kk, int n) { return ssd_ld(ccol + kk * BR + n); }, g, t);
          ssd_mma3_into<false, EXACT>(pb[q], fw, fc);
        }
      }
      for (int k0 = 0; k0 < 16 * mt + 16; k0 += 8) {   // j ≤ i
        const SsdFrag<4> fw = ssd_frag_a<false>(
            [&](int r, int k) { return ws[(16 * mt + r) * FS + k0 + k]; }, g,
            t);
#pragma unroll
        for (int q = 0; q < TPW; ++q) {
          const T* bcol = bsm + k0 * BR + (wn + 4 * q) * 8;
          const SsdFrag<2> fb = ssd_frag_b<EXACT>(
              [&](int kk, int n) { return ssd_ld(bcol + kk * BR + n); }, g, t);
          ssd_mma3_into<false, EXACT>(pc[q], fw, fb);
        }
      }
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * mt + g + 8 * (e >> 1);
          dBacc[q][e] += fmaf(dtv[r] * esv[r], U[q][e], pb[q][e]);
          dCacc[q][e] += fmaf(epv[r], Z[q][e], pc[q][e]);
        }
      }
    }
    // dℓ, ddt and the chunk's part of da: one warp
    if (wp == 0) {
      const int nw = K::NT < 4 ? K::NT : 4;   // warps a row part has
      float tp = 0.f, sf = 0.f, gin = 0.f;
      for (int w = 0; w < nw; ++w) tp += rpre[w * L + lane];
      for (int w = 0; w < 4; ++w) {
        sf += rsuf[w * L + lane];
        gin += rin[w * L + lane];
      }
      ts[lane * TS] = epv[lane] * tp;
      ts[L * TS + lane + 1] = dtv[lane] * sf;
      if (lane == 0) {
        float tt = 0.f;
        for (int w = 0; w < 8; ++w) tt += rtot[w];
        ts[L * TS] = etv[0] * tt;
      }
      __syncwarp();
      // each row's running sum over its columns 0 … i (lane 0 also the
      // end row's 0 … L)
      {
        float run = 0.f;
        for (int j = 0; j <= lane; ++j) {
          run += ts[lane * TS + j];
          ts[lane * TS + j] = run;
        }
      }
      if (lane == 0) {
        float run = 0.f;
        for (int j = 0; j <= L; ++j) {
          run += ts[L * TS + j];
          ts[L * TS + j] = run;
        }
      }
      __syncwarp();
      // dℓ_k: column k's running sums over the rows k … L
      float dl = 0.f;
      for (int i = lane; i <= L; ++i) dl += ts[i * TS + lane];
      if (lane < steps) ddt[(row0 + lane) * H + hh] = fmaf(a_h, dl, gin);
      const float dap = scan_warp_sum(lane < steps ? dtv[lane] * dl : 0.f);
      if (lane == 0) da_part[((int64_t)b * nch + c) * H + hh] = dap;
    }
  }
  // the CTA's dB and dC, its heads' sums
  if (has_n) {
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
      const int m = (wn + 4 * q) * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = 16 * mt + g + 8 * (e >> 1);
        if (r >= steps) continue;
        const int64_t at = (row0 + r) * N + m;
        if (dbc_part) {
          const int64_t bsn = (int64_t)Bn * S * N;
          ssd_store2(dbc_part + grp * bsn + at, dBacc[q][e], dBacc[q][e + 1]);
          ssd_store2(dbc_part + ((int64_t)gridDim.z + grp) * bsn + at,
                     dCacc[q][e], dCacc[q][e + 1]);
        } else {
          ssd_store2(dB + at, dBacc[q][e], dBacc[q][e + 1]);
          ssd_store2(dC + at, dCacc[q][e], dCacc[q][e + 1]);
        }
      }
    }
  }
}

template <int N, typename T>
static int launch_ssd_bwd(const void* x, const void* Bv, const void* Cv,
                          const void* dt, const void* a, const void* ckpt,
                          const void* dy, const void* dh_last, void* dx,
                          void* dB, void* dC, void* ddt, void* da, void* dh0,
                          void* part, int B, int64_t S, int H, int D,
                          int groups, cudaStream_t stream) {
  using K1 = SsdBwdDh<N, T>;
  using K2 = SsdBwdChunk<N, T>;
  static bool dh_set = false, chunk_set = false;
  cudaError_t e = scan_smem_limit(ssd_bwd_dh_kernel<N, T>, K1::SMEM_BYTES,
                                  &dh_set);
  if (e == cudaSuccess) {
    e = scan_smem_limit(ssd_bwd_chunk_kernel<N, T>, K2::SMEM_BYTES,
                        &chunk_set);
  }
  if (e != cudaSuccess) return (int)e;
  const int nch = (int)((S + SCAN_T - 1) / SCAN_T);
  const int hpc = (H + groups - 1) / groups;
  float* dhe = (float*)part;
  float* da_part = dhe + (int64_t)B * H * nch * D * N;
  float* dbc_part = groups > 1 ? da_part + (int64_t)B * nch * H : nullptr;
  ssd_bwd_dh_kernel<N, T>
      <<<dim3(D / K1::ROWS, H, B), K1::THREADS, K1::SMEM_BYTES, stream>>>(
          (const T*)Cv, (const float*)dt, (const float*)a, (const float*)dy,
          (const float*)dh_last, dhe, (float*)dh0, S, H, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk_kernel<N, T>
      <<<dim3(nch, B, groups), K2::THREADS, K2::SMEM_BYTES, stream>>>(
          (const T*)x, (const T*)Bv, (const T*)Cv, (const float*)dt,
          (const float*)a, (const float*)ckpt, (const float*)dy, dhe,
          (T*)dx, (T*)dB, (T*)dC, dbc_part, (float*)ddt, da_part, S, H, D,
          hpc);
  e = cudaGetLastError();
  const int64_t bsn = (int64_t)B * S * N;
  if (e == cudaSuccess && dbc_part) {
    e = scan_sum<T>(dbc_part, groups, bsn, bsn, (T*)dB, stream);
    if (e == cudaSuccess) {
      e = scan_sum<T>(dbc_part + groups * bsn, groups, bsn, bsn, (T*)dC,
                      stream);
    }
  }
  // da over the batch rows and chunks
  if (e == cudaSuccess) e = scan_sum<float>(da_part, B * nch, H, H,
                                            (float*)da, stream);
  return (int)e;
}

template <typename T>
static int dispatch_ssd_bwd(const void* x, const void* Bv, const void* Cv,
                            const void* dt, const void* a, const void* ckpt,
                            const void* dy, const void* dh_last, void* dx,
                            void* dB, void* dC, void* ddt, void* da,
                            void* dh0, void* part, int B, int64_t S, int H,
                            int D, int n, int groups, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch_ssd_bwd<16, T>(x, Bv, Cv, dt, a, ckpt, dy, dh_last, dx,
                                   dB, dC, ddt, da, dh0, part, B, S, H, D,
                                   groups, stream);
    case 32:
      return launch_ssd_bwd<32, T>(x, Bv, Cv, dt, a, ckpt, dy, dh_last, dx,
                                   dB, dC, ddt, da, dh0, part, B, S, H, D,
                                   groups, stream);
    case 64:
      return launch_ssd_bwd<64, T>(x, Bv, Cv, dt, a, ckpt, dy, dh_last, dx,
                                   dB, dC, ddt, da, dh0, part, B, S, H, D,
                                   groups, stream);
    case 128:
      return launch_ssd_bwd<128, T>(x, Bv, Cv, dt, a, ckpt, dy, dh_last, dx,
                                    dB, dC, ddt, da, dh0, part, B, S, H, D,
                                    groups, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x [B, S, H, D], Bv, Cv [B, S, n] (T), dt [B, S, H] and a [H] float32,
// ckpt [B, H, ceil(S / 32), D, n] float32 (ssd_scan's), dy [B, S, H, D]
// float32, dh_last [B, H, D, n] float32 or null for zeros → dx (T), dB,
// dC (T), ddt float32, da [H] and dh0 [B, H, D, n] float32. groups: the
// chunk pass's head groups, ceil(H / ceil(H / groups)) == groups (ops.py's
// ssd_bwd_groups picks them). Scratch: part, float32, B·H·nch·D·n (dh_end)
// + B·nch·H (da's parts) + 2·groups·B·S·n (dB's and dC's parts, only where
// groups > 1) elements, nch = ceil(S / 32).
extern "C" int fw_ssd_scan_bwd(const void* x, const void* Bv, const void* Cv,
                               const void* dt, const void* a,
                               const void* ckpt, const void* dy,
                               const void* dh_last, void* dx, void* dB,
                               void* dC, void* ddt, void* da, void* dh0,
                               void* part, int32_t B, int64_t S, int32_t H,
                               int32_t D, int32_t n, int32_t bf16,
                               int32_t groups, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (D <= 0 || D % SCAN_COLS) return (int)cudaErrorInvalidValue;
  // every group holds a head, as the scratch's layout assumes
  if (groups < 1 || groups > H) return (int)cudaErrorInvalidValue;
  const int hpc = (H + groups - 1) / groups;
  if ((H + hpc - 1) / hpc != groups) return (int)cudaErrorInvalidValue;
  return bf16 ? dispatch_ssd_bwd<__nv_bfloat16>(
                    x, Bv, Cv, dt, a, ckpt, dy, dh_last, dx, dB, dC, ddt, da,
                    dh0, part, B, S, H, D, n, groups, (cudaStream_t)stream)
              : dispatch_ssd_bwd<float>(
                    x, Bv, Cv, dt, a, ckpt, dy, dh_last, dx, dB, dC, ddt, da,
                    dh0, part, B, S, H, D, n, groups, (cudaStream_t)stream);
}
