// wkv6_scan_bwd: the gradient of wkv6_scan, RWKV-6's time recurrence, in
// chunked form on the tensor cores (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel for the
// recurrence; XLA differentiates its lax.scan (src/repro/models/rwkv6.py:
// 121-134, under chunked_scan). The port adds it because autograd through
// the plain per-step loop costs seconds a layer at the training shape and
// keeps every step's state.
//
// Per (batch, head), S [D key rows i, D value columns j] in float32, the
// forward S_t = diag(w_t) S_{t-1} + k_t v_t^T, o_t = r_t^T (S_{t-1} +
// diag(u) k_t v_t^T), and G_t the gradient of S_t:
//
//   dr_t = S_{t-1} dO_t + u o k_t (dO_t . v_t)
//   dk_t = G_t v_t + u o r_t (dO_t . v_t)
//   dv_t = G_t^T k_t + dO_t (sum_i r_t u k_t)
//   dlw_t = w_t o rowsum(G_t o S_{t-1}),  du = sum_{b,t} r_t o k_t (dO_t . v_t)
//
// dlw is the gradient of log w, the decay's only consumer being its raw
// input (w = exp(-exp(raw)), models/rwkv6.py's _decay); the caller passes
// log w and takes d raw = dlw . log w. Nothing divides by w, which
// underflows to 0.
//
// The chunked form, chunks of L = 32 steps (the forward's checkpoint
// chunk; wkv6.cu writes the state before every chunk when asked, ckpt [B,
// H, ceil(S/32), D, D] float32). With a = log w, pre_t = exp(sum of a over
// the chunk's steps before t), suf_s = exp(sum over the steps after s),
// tot = exp(sum over the chunk), S_c the chunk's starting state and G_e
// the gradient of the state after its last step, each chunk's terms are
// products of decayed operands:
//
//   G_start = diag(tot) G_e + (R o pre)^T dO                (step 1)
//   dr = pre o (dO S_c^T) + intra,   dk = suf o (V G_e^T) + intra,
//   dv = (K o suf) G_e + Q^T dO,     M = dO V^T             (step 2)
//
// with Q[t][s] = sum_i r_t k_s W[t][s] and W[t][s] the decay of channel i
// over the steps between s and t (s < t). The decay is per key channel,
// so a pair of steps is not a product of chunk-wide operands: the chunk
// runs as two sub-chunks of 16. A pair across the sub-chunk boundary b =
// 16 factors through it, W = exp(sum over b … t-1) . exp(sum over s+1 …
// b-1), both factors ≤ 1, so R^ = R o pb and K^ = K o sb make Q's block
// R^ K^T and the intra parts of dr and dk pb o (M K^) and sb o (M^T R^),
// all on the tensor cores; a pair inside a sub-chunk is formed term by
// term on the SIMT units, W the running product of the w's between the
// two steps. Every exponent is a running sum from its own boundary (pre
// from the chunk's start, suf from its end, pb from b, sb back to b),
// never a difference of two cumulative sums, which loses about 3e-5 of
// every later decay once a channel's sum passes -400 (one step at raw = 6).
// dlw_m sums the terms whose decay spans step m (a pair s < m < t, the
// chunk's start or end standing in for s or t):
//
//   dlw_m = tot o rowsum(S_c o G_e) + sum_{s<m} k_s o suf_s o (V G_e^T)_s
//         + sum_{t>m} r_t o pre_t o (dO S_c^T)_t + the cross pairs' prefix
//           (m < 16) or suffix (m ≥ 16) sums + the sub-chunk's own pairs,
//
// every term a product through w_m: where w_m underflows, dlw_m is 0
// exactly. (The identity dlw_m = sum_{t>m} r o dr_t - sum_{s≥m} k o dk_s +
// rowsum(S_e o G_e) gives the same in exact arithmetic but leaves a
// float32 residue there that d raw multiplies by exp(raw).)
//
// Two kernels and a short pass, one call:
//
// 1. wkv6_bwd_dh_kernel walks the chunks from the last, a CTA (4 warps) a
//    16-row block of one head's state and all D columns: it stores G_e of
//    every chunk ([B, H, ceil(S/32), D, D] float32 scratch, the
//    checkpoints' size) and steps G_e(c - 1) = tot G_e(c) + (R o pre)^T dO
//    on mma; its last value is dS0. Grid (D / 16, H, B).
// 2. wkv6_bwd_chunk_kernel runs every chunk at once, a CTA (8 warps) one
//    (chunk, head, batch row): M and the decays; the sub-chunks' pairs, a
//    thread a (sub-chunk, key channel) with Q's sums over the channels by
//    a transposing butterfly, while two warps form Q's cross block; the
//    products dO S_c^T, V G_e^T, (K o suf) G_e, the cross parts and Q^T dO
//    (S_c and G_e in 32-row slices at D = 128); the gradients; dlw and du's
//    part by a thread a channel, in order. Grid (ceil(S/32), H, B).
// 3. scan_sum adds du over the batch rows and chunks in a fixed order.
//
// Every product is 3xTF32 mma.sync m16n8k8 (scan.cuh's ssd_* pieces; an
// operand read from bf16 is exact in TF32 and has no small part). No float
// atomics, so the bytes repeat run to run. Rows past S are w = 1 (log w 0)
// and zeros. Inputs are r, k, v and dO in float32 or bfloat16 (widened in
// registers), log w and u float32; each gradient is rounded once to its
// input's type (dlw, du and dS0 float32).
//
// Bound at rwkv6-3b's training shape (B 2, S 4,096, H 40, D 64; r, k, v,
// dO and dr, dk, dv bf16, log w and dlw float32): 632 MB moved by the
// function (inputs, checkpoints and gradients once each), 0.19 ms at 3.35
// TB/s; the chunked products 13 GFLOP, 0.03 ms at 495 TFLOP/s (TF32), and
// the sub-chunks' pairs 0.9 GFLOP of float32: bytes-bound; chip_smoke.py
// states both. The design moves about 0.34 GB more (G_e written and read);
// PERF.md has its times.
#include "scan.cuh"

// ---------------------------------------------------------------------------
// 1. the chunk-end gradients
// ---------------------------------------------------------------------------

// A stage (bytes): dO [L][OR] (T), r [L][RR] (T, this CTA's 16 key rows),
// log w [L][16] float32, a ring of NST (three chunks in flight ahead of
// the one computed); then the chunk's operand R ∘ pre split for 3xTF32,
// its big and small parts [L][RR] (uint32), and tot [16] (float32). Row
// paddings put the fragments' loads in distinct banks.
template <int N, typename T>
struct Wkv6BwdDh {
  static constexpr int L = SCAN_T, ROWS = 16, THREADS = 128, NST = 4;
  static constexpr int OR = N + 32 / (int)sizeof(T);
  static constexpr int RR = ROWS + 8;
  static constexpr int R_AT = L * OR * (int)sizeof(T);
  static constexpr int LW_AT = R_AT + L * RR * (int)sizeof(T);
  static constexpr int STAGE = LW_AT + 4 * L * ROWS;
  static constexpr int RPB_AT = NST * STAGE;
  static constexpr int RPS_AT = RPB_AT + 4 * L * RR;
  static constexpr int TOT_AT = RPS_AT + 4 * L * RR;
  static constexpr int SMEM_BYTES = TOT_AT + 4 * ROWS;
  static constexpr int TPW = N / 32;   // n-tiles a warp
  static constexpr bool EXACT = sizeof(T) == 2;
  static_assert(R_AT % 16 == 0 && LW_AT % 16 == 0 && STAGE % 16 == 0,
                "layout");
};

template <int N, typename T>
__global__ void __launch_bounds__(Wkv6BwdDh<N, T>::THREADS)
    wkv6_bwd_dh_kernel(const T* __restrict__ r, const float* __restrict__ lw,
                       const T* __restrict__ dout,
                       const float* __restrict__ ds_last,
                       float* __restrict__ dhe, float* __restrict__ ds0,
                       int64_t S, int H) {
  using K = Wkv6BwdDh<N, T>;
  constexpr int L = K::L, OR = K::OR, RR = K::RR, TPW = K::TPW;
  constexpr int THREADS = K::THREADS, ROWS = K::ROWS, NST = K::NST;
  constexpr bool EXACT = K::EXACT;
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned all = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int64_t step = (int64_t)H * N;
  const int nch = (int)((S + L - 1) / L);
  uint32_t* rpb = reinterpret_cast<uint32_t*>(smem + K::RPB_AT);
  uint32_t* rps = reinterpret_cast<uint32_t*>(smem + K::RPS_AT);
  float* tot = reinterpret_cast<float*>(smem + K::TOT_AT);
  auto stage = [&](int c) { return smem + (c % NST) * K::STAGE; };

  // chunk c's rows into its stage (a commit group, empty for c < 0); rows
  // past the sequence's end are zeros (log w 0: w = 1)
  auto issue = [&](int c) {
    if (c < 0) {
      scan_cp_async_commit();
      return;
    }
    const int64_t t0 = (int64_t)c * L;
    const int steps = scan_steps(S, t0);
    unsigned char* sg = stage(c);
    const int64_t at = ((int64_t)b * S + t0) * step + (int64_t)h * N;
    constexpr int OV = N * (int)sizeof(T) / 16;
    const unsigned char* osrc =
        reinterpret_cast<const unsigned char*>(dout + at);
    for (int q = tid; q < steps * OV; q += THREADS) {
      const int row = q / OV, col = (q % OV) * 16;
      scan_cp_async16(sg + row * OR * (int)sizeof(T) + col,
                      osrc + row * step * (int64_t)sizeof(T) + col);
    }
    constexpr int RV = ROWS * (int)sizeof(T) / 16;
    const unsigned char* rsrc =
        reinterpret_cast<const unsigned char*>(r + at + i0);
    for (int q = tid; q < steps * RV; q += THREADS) {
      const int row = q / RV, col = (q % RV) * 16;
      scan_cp_async16(sg + K::R_AT + row * RR * (int)sizeof(T) + col,
                      rsrc + row * step * (int64_t)sizeof(T) + col);
    }
    for (int q = tid; q < steps * 4; q += THREADS) {   // 64 bytes a row
      scan_cp_async16(sg + K::LW_AT + (q >> 2) * 64 + (q & 3) * 16,
                      lw + at + i0 + (q >> 2) * step + (q & 3) * 4);
    }
    scan_cp_async_commit();
    if (steps < L) {
      scan_zero(sg + steps * OR * (int)sizeof(T),
                (L - steps) * OR * (int)sizeof(T), tid, THREADS);
      scan_zero(sg + K::R_AT + steps * RR * (int)sizeof(T),
                (L - steps) * RR * (int)sizeof(T), tid, THREADS);
      scan_zero(sg + K::LW_AT + steps * 64, (L - steps) * 64, tid, THREADS);
    }
  };

  const int64_t state = (((int64_t)b * H + h) * N + i0) * N;
  float acc[TPW][4];
#pragma unroll
  for (int q = 0; q < TPW; ++q) {
    const int m = (wp + 4 * q) * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[q][e] = ds_last ? ds_last[state + (int64_t)(g + 8 * (e >> 1)) * N +
                                    m + (e & 1)]
                          : 0.f;
    }
  }

  for (int x = 1; x < NST; ++x) issue(nch - x);
  for (int c = nch - 1; c >= 0; --c) {
    // chunk c's group is done when at most NST − 2 newer ones are pending
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 2) : "memory");
    __syncthreads();
    issue(c - (NST - 1));   // into the stage chunk c + 1 used
    const unsigned char* sg = stage(c);
    const T* os = reinterpret_cast<const T*>(sg);
    const T* rs = reinterpret_cast<const T*>(sg + K::R_AT);
    const float* lws = reinterpret_cast<const float*>(sg + K::LW_AT);
    // the decays, a warp 4 key rows, lane t: pre = exp of the sum of log w
    // over the steps before t (a scan over the lanes: each prefix a sum
    // over its own steps) and tot over the whole chunk; the operand r ∘ pre
    // split once here for every warp's fragments
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int ch = 4 * wp + x;
      float run = lws[lane * ROWS + ch];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(all, run, o);
        if (lane >= o) run += y;
      }
      const float before = __shfl_up_sync(all, run, 1);
      ssd_split(ssd_ld(rs + lane * RR + ch) * expf(lane ? before : 0.f),
                rpb[lane * RR + ch], rps[lane * RR + ch]);
      if (lane == 31) tot[ch] = expf(run);
    }
    __syncthreads();
    // G_e(c), for the chunk pass
    float* out = dhe + (((int64_t)b * H + h) * nch + c) * N * N +
                 (int64_t)i0 * N;
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
      const int m = (wp + 4 * q) * 8 + 2 * t;
      ssd_store2(out + (int64_t)g * N + m, acc[q][0], acc[q][1]);
      ssd_store2(out + (int64_t)(g + 8) * N + m, acc[q][2], acc[q][3]);
    }
    // G_e(c − 1) = diag(tot)·G_e(c) + (R ∘ pre)ᵀ·dO
    float p[TPW][4];
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[q][e] = 0.f;
    }
#pragma unroll
    for (int k0 = 0; k0 < L; k0 += 8) {
      SsdFrag<4> fa;   // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (k0 + t + 4 * (e >> 1)) * RR + g + 8 * (e & 1);
        fa.big[e] = rpb[at];
        fa.small[e] = rps[at];
      }
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
        const T* ocol = os + k0 * OR + (wp + 4 * q) * 8;
        const SsdFrag<2> fb = ssd_frag_b<EXACT>(
            [&](int kk, int n) { return ssd_ld(ocol + kk * OR + n); }, g, t);
        ssd_mma3_into<false, EXACT>(p[q], fa, fb);
      }
    }
    const float e_lo = tot[g], e_hi = tot[g + 8];
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[q][e] = fmaf(e >> 1 ? e_hi : e_lo, acc[q][e], p[q][e]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < TPW; ++q) {
    const int m = (wp + 4 * q) * 8 + 2 * t;
    ssd_store2(ds0 + state + (int64_t)g * N + m, acc[q][0], acc[q][1]);
    ssd_store2(ds0 + state + (int64_t)(g + 8) * N + m, acc[q][2], acc[q][3]);
  }
}

// ---------------------------------------------------------------------------
// 2. each chunk's gradients
// ---------------------------------------------------------------------------

// The shared memory (bytes): r, k, v, dO [L][IR] (T); the slice region,
// S_c and G_e [DS][HR] float32 (after the products, the cross terms of
// dlw [L][TR]; at D = 128, where it is filled only for the products, it
// first holds the channel blocks' Q sums [2][CB][128]); the decays pre,
// suf [L][TR], pb, sb [SUB][TR]; the sums dri, dki (later r ∘ pre ∘ X1,
// k ∘ suf ∘ Y1) and span [L][TR], span first holding log w; M and Q
// [L][MS] (at D ≤ 64 Q's upper triangle takes the second channel block's
// sums); u, e0, tot [N] and the bonus sums [L], all float32. At D = 64 in
// bf16 two CTAs fit an SM.
template <int N, typename T>
struct Wkv6BwdChunk {
  static constexpr int L = SCAN_T, SUB = 16, THREADS = 256, WARPS = 8;
  static constexpr int DS = N < 128 ? N : 32;   // S_c / G_e rows a slice
  static constexpr int NSL = N / DS;
  static constexpr int TPW = N / 32;        // a warp's n-tiles of [L x N]
  static constexpr int QPS = TPW / NSL;     // … whose key rows lie in a slice
  static constexpr int CB = N / 32;         // channel blocks (warps) a sub-chunk
  static constexpr int NSW = 2 * CB;        // warps of the pair pass
  static constexpr bool ALIAS = CB > 2;     // the Q sums in the slice region
  static constexpr int PAIRS = SUB * (SUB - 1) / 2, QPN = 128;
  static constexpr int IR = N + 16 / (int)sizeof(T);
  static constexpr int HR = N + 4, TR = N + 4, MS = L + 4;
  static constexpr int IN = L * IR * (int)sizeof(T);
  static constexpr int SL_AT = 4 * IN;
  static constexpr int SL_BYTES = 2 * 4 * DS * HR;
  static constexpr int QP_AT = SL_AT, QP_BYTES = 4 * 2 * CB * QPN;
  static constexpr int PRE_AT = SL_AT + SL_BYTES;
  static constexpr int SUF_AT = PRE_AT + 4 * L * TR;
  static constexpr int PB_AT = SUF_AT + 4 * L * TR;
  static constexpr int SB_AT = PB_AT + 4 * SUB * TR;
  static constexpr int DRI_AT = SB_AT + 4 * SUB * TR;
  static constexpr int DKI_AT = DRI_AT + 4 * L * TR;
  static constexpr int SPAN_AT = DKI_AT + 4 * L * TR;
  static constexpr int M_AT = SPAN_AT + 4 * L * TR;
  static constexpr int Q_AT = M_AT + 4 * L * MS;
  static constexpr int U_AT = Q_AT + 4 * L * MS;
  static constexpr int E0_AT = U_AT + 4 * N;
  static constexpr int TOT_AT = E0_AT + 4 * N;
  static constexpr int BO_AT = TOT_AT + 4 * N;
  static constexpr int SMEM_BYTES = BO_AT + 4 * L;
  // two CTAs an SM where their shared memory fits (1 KB a CTA reserved;
  // registers capped at 128 a thread), one otherwise
  static constexpr int MIN_BLOCKS =
      2 * (SMEM_BYTES + 1024) <= 233472 ? 2 : 1;
  static constexpr bool EXACT = sizeof(T) == 2;
  static_assert(IN % 16 == 0 && SL_BYTES % 16 == 0 && PRE_AT % 16 == 0 &&
                    SPAN_AT % 16 == 0 && U_AT % 16 == 0 &&
                    SMEM_BYTES <= 232448,
                "layout");
  static_assert(!ALIAS || QP_BYTES <= SL_BYTES, "alias");
  static_assert(4 * L * TR <= SL_BYTES && 4 * DS <= THREADS, "slices");
};

// Where the pair pass leaves a channel block's sum of Q's term for pair
// slot p (the pairs in column order) of the sub-chunk at t0: Q[t][s]
// itself for the first block, Q[s][t] (above the diagonal, zero until the
// blocks are added) for the second, qp (the Q sums' buffer) at D = 128.
template <int N, typename T>
__device__ __forceinline__ float* wkv6_bwd_qslot(float* qs, float* qp,
                                                 int t0, int cb, int p) {
  using K = Wkv6BwdChunk<N, T>;
  if (K::ALIAS) return qp + cb * K::QPN + p;
  int s = 0, off = 0;
  while (p >= off + K::SUB - 1 - s) {
    off += K::SUB - 1 - s;
    ++s;
  }
  const int t = s + 1 + p - off;
  return cb ? qs + (t0 + s) * K::MS + t0 + t : qs + (t0 + t) * K::MS + t0 + s;
}

// One (sub-chunk, key channel) of the pair pass: the sub-chunk's pairs s <
// t, column s at a time (W the running product of w over s + 1 … t − 1,
// w = exp(log w) read from span before span is written): the intra sums
// of dr (row t) and dk (column s), span[m] (the pairs s < m < t: after
// column s, sum_{t > s+1} r_t · dri_t so far), and Q's terms r_t k_s W,
// summed over the warp's 32 channels by a transposing butterfly 32 pairs
// at a time (wkv6_bwd_qslot).
template <int N, typename T>
__device__ __forceinline__ void wkv6_bwd_pairs(
    const T* __restrict__ rs, const T* __restrict__ ks,
    const float* __restrict__ ms, float* __restrict__ dri,
    float* __restrict__ dki, float* spn, float* qs, float* qp, int t0,
    int cb, int i, int lane) {
  using K = Wkv6BwdChunk<N, T>;
  constexpr int SUB = K::SUB, IR = K::IR, TR = K::TR, MS = K::MS;
  float rr[SUB], kk[SUB], ww[SUB], acc[SUB], q[32];
#pragma unroll
  for (int x = 0; x < SUB; ++x) {
    rr[x] = ssd_ld(rs + (t0 + x) * IR + i);
    kk[x] = ssd_ld(ks + (t0 + x) * IR + i);
    ww[x] = expf(spn[(t0 + x) * TR + i]);
    acc[x] = 0.f;
  }
  spn[t0 * TR + i] = 0.f;
#pragma unroll
  for (int s = 0; s < SUB - 1; ++s) {
    float W = 1.f, dks = 0.f;
#pragma unroll
    for (int t = s + 1; t < SUB; ++t) {
      const int slot = (SUB - 1) * s - s * (s - 1) / 2 + (t - s - 1);
      const float mw = ms[(t0 + t) * MS + t0 + s] * W;
      acc[t] = fmaf(mw, kk[s], acc[t]);
      dks = fmaf(mw, rr[t], dks);
      q[slot & 31] = rr[t] * kk[s] * W;
      if ((slot & 31) == 31) {
        scan_butterfly<32, 5>(q, lane);
        *wkv6_bwd_qslot<N, T>(qs, qp, t0, cb,
                              (slot & ~31) + scan_bfly_mine<32, 5>(lane)) =
            q[0];
      }
      W *= ww[t];
    }
    dki[(t0 + s) * TR + i] = dks;
    float d = 0.f;
#pragma unroll
    for (int t = s + 2; t < SUB; ++t) d = fmaf(rr[t], acc[t], d);
    spn[(t0 + s + 1) * TR + i] = d;
  }
  dki[(t0 + SUB - 1) * TR + i] = 0.f;
  constexpr int LAST = K::PAIRS & ~31;   // the last batch's first slot
#pragma unroll
  for (int e = K::PAIRS - LAST; e < 32; ++e) q[e] = 0.f;
  scan_butterfly<32, 5>(q, lane);
  const int p = LAST + scan_bfly_mine<32, 5>(lane);
  if (p < K::PAIRS) *wkv6_bwd_qslot<N, T>(qs, qp, t0, cb, p) = q[0];
#pragma unroll
  for (int t = 0; t < SUB; ++t) dri[(t0 + t) * TR + i] = acc[t];
}

template <int N, typename T>
__global__ void __launch_bounds__(Wkv6BwdChunk<N, T>::THREADS,
                                  Wkv6BwdChunk<N, T>::MIN_BLOCKS)
    wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ lw,
                          const float* __restrict__ u,
                          const float* __restrict__ ckpt,
                          const T* __restrict__ dout,
                          const float* __restrict__ dhe, T* __restrict__ dr,
                          T* __restrict__ dk, T* __restrict__ dv,
                          float* __restrict__ dlw,
                          float* __restrict__ du_part, int64_t S, int H) {
  using K = Wkv6BwdChunk<N, T>;
  constexpr int L = K::L, SUB = K::SUB, THREADS = K::THREADS;
  constexpr int DS = K::DS, NSL = K::NSL, TPW = K::TPW, QPS = K::QPS;
  constexpr int IR = K::IR, HR = K::HR, TR = K::TR, MS = K::MS;
  constexpr int CB = K::CB, NSW = K::NSW, QPN = K::QPN;
  constexpr bool EXACT = K::EXACT, ALIAS = K::ALIAS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* rs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + K::IN);
  T* vs = reinterpret_cast<T*>(smem + 2 * K::IN);
  T* os = reinterpret_cast<T*>(smem + 3 * K::IN);
  float* scs = reinterpret_cast<float*>(smem + K::SL_AT);
  float* ges = scs + DS * HR;
  float* xs = scs;   // after the products: the cross terms of dlw
  float* qp = reinterpret_cast<float*>(smem + K::QP_AT);   // D = 128
  float* pre = reinterpret_cast<float*>(smem + K::PRE_AT);
  float* suf = reinterpret_cast<float*>(smem + K::SUF_AT);
  float* pb = reinterpret_cast<float*>(smem + K::PB_AT);
  float* sb = reinterpret_cast<float*>(smem + K::SB_AT);
  float* dri = reinterpret_cast<float*>(smem + K::DRI_AT);
  float* dki = reinterpret_cast<float*>(smem + K::DKI_AT);
  float* spn = reinterpret_cast<float*>(smem + K::SPAN_AT);
  float* ms = reinterpret_cast<float*>(smem + K::M_AT);
  float* qs = reinterpret_cast<float*>(smem + K::Q_AT);
  float* us = reinterpret_cast<float*>(smem + K::U_AT);
  float* e0s = reinterpret_cast<float*>(smem + K::E0_AT);
  float* tots = reinterpret_cast<float*>(smem + K::TOT_AT);
  float* bos = reinterpret_cast<float*>(smem + K::BO_AT);

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, mt = wp & 1, wn = wp >> 1;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nch = (int)((S + L - 1) / L);
  const int64_t t0 = (int64_t)c * L;
  const int steps = scan_steps(S, t0);
  const int64_t step = (int64_t)H * N;
  const int64_t row0 = ((int64_t)b * S + t0) * step + (int64_t)h * N;
  const int64_t st = (((int64_t)b * H + h) * nch + c) * N * N;

  // the chunk's rows, log w into span (a commit group), then S_c and G_e
  // (another, read only by the products; at D = 128 loaded slice by slice
  // for them); rows past the sequence's end are zeros, log w 0 (w = 1)
  {
    constexpr int IV = N * (int)sizeof(T) / 16;
    const T* src[4] = {r, k, v, dout};
    T* dst[4] = {rs, ks, vs, os};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const unsigned char* s8 =
          reinterpret_cast<const unsigned char*>(src[x] + row0);
      unsigned char* d8 = reinterpret_cast<unsigned char*>(dst[x]);
      for (int q = tid; q < steps * IV; q += THREADS) {
        const int row = q / IV, col = (q % IV) * 16;
        scan_cp_async16(d8 + row * IR * (int)sizeof(T) + col,
                        s8 + row * step * (int64_t)sizeof(T) + col);
      }
      if (steps < L) {
        scan_zero(d8 + steps * IR * (int)sizeof(T),
                  (L - steps) * IR * (int)sizeof(T), tid, THREADS);
      }
    }
    constexpr int LV = N / 4;
    for (int q = tid; q < steps * LV; q += THREADS) {
      const int row = q / LV, col = (q % LV) * 4;
      scan_cp_async16(spn + row * TR + col, lw + row0 + row * step + col);
    }
    if (steps < L) {
      scan_zero(reinterpret_cast<unsigned char*>(spn + steps * TR),
                4 * (L - steps) * TR, tid, THREADS);
    }
    for (int q = tid; q < N / 4; q += THREADS) {
      scan_cp_async16(us + 4 * q, u + (int64_t)h * N + 4 * q);
    }
    scan_cp_async_commit();
  }
  auto slice = [&](int sl) {
    constexpr int HV = N / 4;
    for (int q = tid; q < DS * HV; q += THREADS) {
      const int row = q / HV, col = (q % HV) * 4;
      const int64_t at = st + (int64_t)(sl * DS + row) * N + col;
      scan_cp_async16(scs + row * HR + col, ckpt + at);
      scan_cp_async16(ges + row * HR + col, dhe + at);
    }
    scan_cp_async_commit();
  };
  if (NSL == 1) slice(0);
  for (int e = tid; e < L * MS; e += THREADS) qs[e] = 0.f;
  scan_cp_async_wait_prior(NSL > 1);
  __syncthreads();
  const float* lws = spn;   // log w, until the pair pass

  // M = dO·Vᵀ (warp (mt, wn): rows t 16·mt …, columns s 8·wn …); the
  // decays, a thread a (kind, channel), each a running sum from its own
  // boundary; the bonus sums Σ_i r u k, a warp a step
  {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 8) {
      const SsdFrag<4> fa = ssd_frag_a<EXACT>(
          [&](int row, int kk) {
            return ssd_ld(os + (16 * mt + row) * IR + k0 + kk);
          },
          g, t4);
      const SsdFrag<2> fb = ssd_frag_b<EXACT>(
          [&](int kk, int n) {
            return ssd_ld(vs + (8 * wn + n) * IR + k0 + kk);
          },
          g, t4);
      ssd_mma3_into<EXACT, EXACT>(acc, fa, fb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ms[(16 * mt + g + 8 * (e >> 1)) * MS + 8 * wn + 2 * t4 + (e & 1)] =
          acc[e];
    }
  }
  for (int e = tid; e < 4 * N; e += THREADS) {
    const int kind = e / N, i = e % N;
    float run = 0.f;
    if (kind == 0) {          // pre[t]: steps 0 … t − 1; tot: all
      for (int t = 0; t < L; ++t) {
        pre[t * TR + i] = expf(run);
        run += lws[t * TR + i];
      }
      tots[i] = expf(run);
    } else if (kind == 1) {   // suf[s]: steps s + 1 … L − 1
      for (int t = L - 1; t >= 0; --t) {
        suf[t * TR + i] = expf(run);
        run += lws[t * TR + i];
      }
    } else if (kind == 2) {   // pb[t − 16]: steps 16 … t − 1
      for (int t = SUB; t < L; ++t) {
        pb[(t - SUB) * TR + i] = expf(run);
        run += lws[t * TR + i];
      }
    } else {                  // sb[s]: steps s + 1 … 15
      for (int t = SUB - 1; t >= 0; --t) {
        sb[t * TR + i] = expf(run);
        run += lws[t * TR + i];
      }
    }
  }
  for (int s = wp; s < L; s += K::WARPS) {
    float bo = 0.f;
    for (int i = lane; i < N; i += 32) {
      bo = fmaf(ssd_ld(rs + s * IR + i) * us[i], ssd_ld(ks + s * IR + i), bo);
    }
    bo = scan_warp_sum(bo);
    if (lane == 0) bos[s] = bo;
  }
  __syncthreads();

  // the sub-chunks' pairs (warps 0 … NSW − 1), Q's cross block R̂·K̂ᵀ (two
  // warps, after their pairs where every warp has some)
  if (wp < NSW) {
    const int sub = wp / CB, cb = wp % CB;
    wkv6_bwd_pairs<N, T>(rs, ks, ms, dri, dki, spn, qs,
                         qp + sub * CB * QPN, SUB * sub, cb, 32 * cb + lane,
                         lane);
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (wp != (NSW + x) % K::WARPS) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 8) {
      const SsdFrag<4> fa = ssd_frag_a<false>(
          [&](int row, int kk) {
            return ssd_ld(rs + (SUB + row) * IR + k0 + kk) *
                   pb[row * TR + k0 + kk];
          },
          g, t4);
      const SsdFrag<2> fb = ssd_frag_b<false>(
          [&](int kk, int n) {
            return ssd_ld(ks + (8 * x + n) * IR + k0 + kk) *
                   sb[(8 * x + n) * TR + k0 + kk];
          },
          g, t4);
      ssd_mma3_into<false, false>(acc, fa, fb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qs[(SUB + g + 8 * (e >> 1)) * MS + 8 * x + 2 * t4 + (e & 1)] = acc[e];
    }
  }
  __syncthreads();
  // Q inside the sub-chunks: the channel blocks' sums in order
  if (CB > 1) {
    for (int e = tid; e < 2 * K::PAIRS; e += THREADS) {
      const int sub = e / K::PAIRS, p = e % K::PAIRS;
      int s = 0, off = 0;
      while (p >= off + SUB - 1 - s) {
        off += SUB - 1 - s;
        ++s;
      }
      const int t0 = SUB * sub, t = s + 1 + p - off;
      float* lo = qs + (t0 + t) * MS + t0 + s;
      if (ALIAS) {
        float sum = 0.f;
        for (int cb = 0; cb < CB; ++cb) sum += qp[(sub * CB + cb) * QPN + p];
        *lo = sum;
      } else {   // the second block's sums above the diagonal
        float* hi = qs + (t0 + s) * MS + t0 + t;
        *lo += *hi;
        *hi = 0.f;
      }
    }
  }
  if (NSL == 1) scan_cp_async_wait_all();
  __syncthreads();

  // the products, warp (mt, wn) the tiles rows 16·mt …, n-tiles wn + 4q:
  // X1 = dO·S_cᵀ, Y1 = V·G_eᵀ (key rows i), Z1 = (K ∘ suf)·G_e (value
  // columns j), over the slices of S_c and G_e
  float X1[TPW][4], Y1[TPW][4], Z1[TPW][4], XY[TPW][4], Z2[TPW][4];
#pragma unroll
  for (int q = 0; q < TPW; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      X1[q][e] = Y1[q][e] = Z1[q][e] = XY[q][e] = Z2[q][e] = 0.f;
    }
  }
#pragma unroll
  for (int sl = 0; sl < NSL; ++sl) {
    if (NSL > 1) {
      if (sl > 0) __syncthreads();
      slice(sl);
      scan_cp_async_wait_all();
      __syncthreads();
    }
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 8) {
      const SsdFrag<4> fo = ssd_frag_a<EXACT>(
          [&](int row, int kk) {
            return ssd_ld(os + (16 * mt + row) * IR + k0 + kk);
          },
          g, t4);
      const SsdFrag<4> fv = ssd_frag_a<EXACT>(
          [&](int row, int kk) {
            return ssd_ld(vs + (16 * mt + row) * IR + k0 + kk);
          },
          g, t4);
#pragma unroll
      for (int qq = 0; qq < QPS; ++qq) {
        const int q = sl * QPS + qq;
        const int il = 8 * (wn + 4 * q) - sl * DS;   // the slice's row
        const SsdFrag<2> fs = ssd_frag_b<false>(
            [&](int kk, int n) { return scs[(il + n) * HR + k0 + kk]; }, g,
            t4);
        ssd_mma3_into<EXACT, false>(X1[q], fo, fs);
        const SsdFrag<2> fg = ssd_frag_b<false>(
            [&](int kk, int n) { return ges[(il + n) * HR + k0 + kk]; }, g,
            t4);
        ssd_mma3_into<EXACT, false>(Y1[q], fv, fg);
      }
    }
#pragma unroll
    for (int k0 = 0; k0 < DS; k0 += 8) {
      const int i0 = sl * DS + k0;
      const SsdFrag<4> fk = ssd_frag_a<false>(
          [&](int row, int kk) {
            const int s = 16 * mt + row;
            return ssd_ld(ks + s * IR + i0 + kk) * suf[s * TR + i0 + kk];
          },
          g, t4);
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
        const int n0 = 8 * (wn + 4 * q);
        const SsdFrag<2> fg = ssd_frag_b<false>(
            [&](int kk, int n) { return ges[(k0 + kk) * HR + n0 + n]; }, g,
            t4);
        ssd_mma3_into<false, false>(Z1[q], fk, fg);
      }
    }
    // e0 = tot ∘ rowsum(S_c ∘ G_e) over the slice's rows, 4 lanes a row
    if (tid < 4 * DS) {
      const int row = tid >> 2, part = tid & 3;
      float sum = 0.f;
      for (int j = part; j < N; j += 4) {
        sum = fmaf(scs[row * HR + j], ges[row * HR + j], sum);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) e0s[sl * DS + row] = tots[sl * DS + row] * sum;
    }
  }
  // the cross parts: X2 = M[16:, :16]·K̂ (rows t ≥ 16, mt = 1), Y2 =
  // M[16:, :16]ᵀ·R̂ (rows s < 16, mt = 0)
#pragma unroll
  for (int k0 = 0; k0 < SUB; k0 += 8) {
    if (mt) {
      const SsdFrag<4> fm = ssd_frag_a<false>(
          [&](int row, int kk) { return ms[(SUB + row) * MS + k0 + kk]; }, g,
          t4);
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
        const int n0 = 8 * (wn + 4 * q);
        const SsdFrag<2> fb = ssd_frag_b<false>(
            [&](int kk, int n) {
              const int s = k0 + kk, i = n0 + n;
              return ssd_ld(ks + s * IR + i) * sb[s * TR + i];
            },
            g, t4);
        ssd_mma3_into<false, false>(XY[q], fm, fb);
      }
    } else {
      const SsdFrag<4> fm = ssd_frag_a<false>(
          [&](int row, int kk) { return ms[(SUB + k0 + kk) * MS + row]; }, g,
          t4);
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
        const int n0 = 8 * (wn + 4 * q);
        const SsdFrag<2> fb = ssd_frag_b<false>(
            [&](int kk, int n) {
              const int tp = k0 + kk, i = n0 + n;
              return ssd_ld(rs + (SUB + tp) * IR + i) * pb[tp * TR + i];
            },
            g, t4);
        ssd_mma3_into<false, false>(XY[q], fm, fb);
      }
    }
  }
  // Z2 = Qᵀ·dO (rows s; Q[t][s] = 0 for t ≤ s)
  for (int k0 = 16 * mt; k0 < L; k0 += 8) {
    const SsdFrag<4> fq = ssd_frag_a<false>(
        [&](int row, int kk) { return qs[(k0 + kk) * MS + 16 * mt + row]; },
        g, t4);
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
      const T* ocol = os + k0 * IR + 8 * (wn + 4 * q);
      const SsdFrag<2> fo = ssd_frag_b<EXACT>(
          [&](int kk, int n) { return ssd_ld(ocol + kk * IR + n); }, g, t4);
      ssd_mma3_into<false, EXACT>(Z2[q], fq, fo);
    }
  }
  __syncthreads();   // S_c and G_e read: their region takes the cross terms

  // the gradients; dlw's terms in place: dri ← r ∘ pre ∘ X1, dki ← k ∘ suf
  // ∘ Y1, xs ← r ∘ pb ∘ X2 (t ≥ 16) or k ∘ sb ∘ Y2 (s < 16)
#pragma unroll
  for (int q = 0; q < TPW; ++q) {
    const int col = 8 * (wn + 4 * q) + 2 * t4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * mt + g + 8 * hh;
      const float dov = ms[row * MS + row], bo = bos[row];
      float odr[2], odk[2], odv[2];
#pragma unroll
      for (int ee = 0; ee < 2; ++ee) {
        const int e = 2 * hh + ee, i = col + ee, at = row * TR + i;
        const float rv = ssd_ld(rs + row * IR + i);
        const float kv = ssd_ld(ks + row * IR + i);
        const float x1 = pre[at] * X1[q][e], y1 = suf[at] * Y1[q][e];
        const float cr = mt ? pb[(row - SUB) * TR + i] * XY[q][e] : 0.f;
        const float ck = mt ? 0.f : sb[at] * XY[q][e];
        odr[ee] = fmaf(us[i] * kv, dov, x1 + cr + dri[at]);
        odk[ee] = fmaf(us[i] * rv, dov, y1 + ck + dki[at]);
        odv[ee] = fmaf(ssd_ld(os + row * IR + i), bo, Z1[q][e] + Z2[q][e]);
        dri[at] = rv * x1;
        dki[at] = kv * y1;
        xs[at] = mt ? rv * cr : kv * ck;
      }
      if (row < steps) {
        const int64_t at = row0 + row * step + col;
        ssd_store2(dr + at, odr[0], odr[1]);
        ssd_store2(dk + at, odk[0], odk[1]);
        ssd_store2(dv + at, odv[0], odv[1]);
      }
    }
  }
  __syncthreads();

  // dlw and du's part: dlw_m = e0 + Σ_{s<m} k∘suf∘Y1 + Σ_{t>m} r∘pre∘X1 +
  // the cross terms (Σ_{s<m} for m < 16, Σ_{t>m} for m ≥ 16) + the
  // sub-chunk's pairs. A thread a channel takes the prefix sums into span,
  // another the suffix sums into dri (in place, from the last step) and
  // du's part; then every thread adds the two for its elements.
  if (tid < 2 * N) {
    const int i = tid % N;
    if (tid < N) {
      const float e0 = e0s[i];
      float pk = 0.f, px = 0.f;
      for (int m = 0; m < L; ++m) {
        float a = e0 + pk;
        if (m < SUB) a += px;
        spn[m * TR + i] += a;
        pk += dki[m * TR + i];
        if (m < SUB) px += xs[m * TR + i];
      }
    } else {
      float sr = 0.f, sx = 0.f, dua = 0.f;
      for (int m = L - 1; m >= 0; --m) {
        const float rin = dri[m * TR + i];
        dri[m * TR + i] = m >= SUB ? sr + sx : sr;
        sr += rin;
        if (m >= SUB) sx += xs[m * TR + i];
        dua = fmaf(ssd_ld(rs + m * IR + i) * ssd_ld(ks + m * IR + i),
                   ms[m * MS + m], dua);
      }
      du_part[(((int64_t)b * nch + c) * H + h) * N + i] = dua;
    }
  }
  __syncthreads();
  for (int e = tid; e < steps * N; e += THREADS) {
    const int m = e / N, i = e % N;
    dlw[row0 + m * step + i] = spn[m * TR + i] + dri[m * TR + i];
  }
}

template <int N, typename T>
static int launch_wkv6_bwd(const void* r, const void* k, const void* v,
                           const void* lw, const void* u, const void* ckpt,
                           const void* dout, const void* ds_last, void* dr,
                           void* dk, void* dv, void* dlw, void* du,
                           void* ds0, void* part, int B, int64_t S, int H,
                           cudaStream_t stream) {
  using K1 = Wkv6BwdDh<N, T>;
  using K2 = Wkv6BwdChunk<N, T>;
  static bool dh_set = false, chunk_set = false;
  cudaError_t e = scan_smem_limit(wkv6_bwd_dh_kernel<N, T>, K1::SMEM_BYTES,
                                  &dh_set);
  if (e == cudaSuccess) {
    e = scan_smem_limit(wkv6_bwd_chunk_kernel<N, T>, K2::SMEM_BYTES,
                        &chunk_set);
  }
  if (e != cudaSuccess) return (int)e;
  const int nch = (int)((S + SCAN_T - 1) / SCAN_T);
  float* dhe = (float*)part;
  float* du_part = dhe + (int64_t)B * H * nch * N * N;
  wkv6_bwd_dh_kernel<N, T>
      <<<dim3(N / K1::ROWS, H, B), K1::THREADS, K1::SMEM_BYTES, stream>>>(
          (const T*)r, (const float*)lw, (const T*)dout,
          (const float*)ds_last, dhe, (float*)ds0, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_chunk_kernel<N, T>
      <<<dim3(nch, H, B), K2::THREADS, K2::SMEM_BYTES, stream>>>(
          (const T*)r, (const T*)k, (const T*)v, (const float*)lw,
          (const float*)u, (const float*)ckpt, (const T*)dout, dhe, (T*)dr,
          (T*)dk, (T*)dv, (float*)dlw, du_part, S, H);
  e = cudaGetLastError();
  // du over the batch rows and chunks
  const int64_t hn = (int64_t)H * N;
  if (e == cudaSuccess) e = scan_sum<float>(du_part, B * nch, hn, hn,
                                            (float*)du, stream);
  return (int)e;
}

template <typename T>
static int dispatch_wkv6_bwd(const void* r, const void* k, const void* v,
                             const void* lw, const void* u, const void* ckpt,
                             const void* dout, const void* ds_last, void* dr,
                             void* dk, void* dv, void* dlw, void* du,
                             void* ds0, void* part, int B, int64_t S, int H,
                             int D, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_wkv6_bwd<32, T>(r, k, v, lw, u, ckpt, dout, ds_last, dr,
                                    dk, dv, dlw, du, ds0, part, B, S, H,
                                    stream);
    case 64:
      return launch_wkv6_bwd<64, T>(r, k, v, lw, u, ckpt, dout, ds_last, dr,
                                    dk, dv, dlw, du, ds0, part, B, S, H,
                                    stream);
    case 128:
      return launch_wkv6_bwd<128, T>(r, k, v, lw, u, ckpt, dout, ds_last, dr,
                                     dk, dv, dlw, du, ds0, part, B, S, H,
                                     stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// r, k, v, dout [B, S, H, D] (T), lw (log w) [B, S, H, D] and u [H, D]
// float32, ckpt [B, H, ceil(S / 32), D, D] float32 (wkv6_scan's), ds_last
// [B, H, D, D] float32 or null for zeros → dr, dk, dv (T), dlw float32
// [B, S, H, D], du [H, D] and ds0 [B, H, D, D] float32. Scratch: part,
// float32, B·H·nch·D·D (the chunk-end gradients) + B·nch·H·D (du's parts)
// elements, nch = ceil(S / 32).
extern "C" int fw_wkv6_scan_bwd(const void* r, const void* k, const void* v,
                                const void* lw, const void* u,
                                const void* ckpt, const void* dout,
                                const void* ds_last, void* dr, void* dk,
                                void* dv, void* dlw, void* du, void* ds0,
                                void* part, int32_t B, int64_t S, int32_t H,
                                int32_t D, int32_t bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  return bf16 ? dispatch_wkv6_bwd<__nv_bfloat16>(
                    r, k, v, lw, u, ckpt, dout, ds_last, dr, dk, dv, dlw, du,
                    ds0, part, B, S, H, D, (cudaStream_t)stream)
              : dispatch_wkv6_bwd<float>(
                    r, k, v, lw, u, ckpt, dout, ds_last, dr, dk, dv, dlw, du,
                    ds0, part, B, S, H, D, (cudaStream_t)stream);
}
