// wkv6_scan: RWKV-6's time recurrence over a whole sequence (sm_90a).
//
// Replaces no TPU kernel: the reference runs this recurrence as lax.scan
// (src/repro/models/rwkv6.py:121-134, its step under chunked_scan with a
// chunk of 256). The port adds it because the literal translation, a
// Python loop over time, is about 8 small launches a step: some 8.4 M
// launches for one rwkv6-3b prefill of 32,768 tokens.
//
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// per (batch, head), S [D key rows i, D value columns j] in float32. r, k
// and v are [B, S, H, D] in float32 or bfloat16 (widened in registers,
// the values of the reference's cast), w [B, S, H, D] float32, u [H, D]
// float32, S0 [B, H, D, D] or null for zeros; o is [B, S, H, D] in r's
// type (rounded to nearest even, the reference's cast of its float32
// readout) and S_last [B, H, D, D] float32. Prefill and a decode step
// (S = 1) are the same call.
//
// Two kernels (scan.cuh), one launch a call. A call shorter than one
// chunk (a decode step) runs the serial kernel, faster there than the
// pipelined one (PERF.md: 4.5 against 7.1 µs a launch at rwkv6-3b's
// decode, B = 4): value column j evolves alone (S_t[:, j] reads only
// v_t[j]), so a CTA owns 32 columns of one head, a lane each, its D key
// rows split over 8 warps; the warps' parts of a step's readout are
// summed after the 32-step chunk, and the readout is
// r_t^T S_{t-1} + v_t[j] (sum_i r_i u_i k_i), the bonus one number a
// step.
//
// A call of a chunk or more runs the pipelined kernel, grid (D / 32, H, B),
// 4 consumer warps and 1 producer warp a CTA (rwkv6-3b at B = 1: 80 CTAs).
// The producer only copies: each 32-step chunk as it arrives (r, k, v in
// their type, w float32) into one of three stages, two chunks ahead, with
// cp.async; the two sides hand stages over with named barriers. A
// consumer thread holds a 4 × 4 tile of the state (4 key rows, 4 value
// columns), a warp whole columns (its lanes are the 16 row groups × 2
// column groups at D = 64), so a step's shared loads are r, k, w for the
// thread's rows and v for its columns, widened in registers: 10
// wavefronts a warp where a lane a column reads 24 values all lanes share
// (a uniform 16-byte load costs 4 wavefronts, as one of 32 distinct words
// does). A thread's readout part is r·S + v·(r·u·k) over its rows (the
// bonus folded in, 8 FMAs); a group of 4 steps' 16 parts is summed over
// the warp's row groups by a transposing shuffle butterfly whose rounds
// run between the next group's steps, so no part crosses a warp and the
// shuffles' latency hides behind FMAs. A whole chunk runs without a
// branch. Each state element keeps the serial step's operation order,
// S = fma(w, S, k·v); the readout's sums run in another order than XLA's
// einsums: the kernel agrees with ref.wkv6_scan_ref within 1e-5 relative
// Frobenius error (float32). Inputs are read in their batch-major layout
// (the reference's time-major transposes are an artifact of scan).
//
// Bound at rwkv6-3b's prefill (B 1, S 32,768, H 40, D 64; r, k, v and o
// bf16, w float32): 1.01 GB moved, 0.30 ms at 3.35 TB/s; 5 float32
// operations a state element and step and 5 a key row (the bonus and the
// readout), 27.3 GFLOP, 0.41 ms at 67 TFLOP/s. The consumer warps are
// issue-bound (about 100 instructions a step and warp, one warp a
// scheduler) and B = 1 leaves 52 SMs idle; PERF.md records the times, the
// stages' shares from scripts/torch_scan_probe.py and the layouts measured
// slower than this one (16 columns a CTA, 160 CTAs; 4 × 2 tiles, 8
// consumer warps).
//
// Left on the table: a chunked (matrix) form of the recurrence, which
// RWKV-6's per-channel decay makes hard (log-space sub-chunks), and the
// idle SMs at B = 1.
#include <type_traits>

#include "scan.cuh"

template <int N, typename T>
struct Wkv6Layout {
  using Shape = ScanShape<N>;
  static constexpr int RK_VEC = N * (int)sizeof(T) / 16;   // r or k row
  static constexpr int W_VEC = N * 4 / 16;
  static constexpr int V_VEC = SCAN_COLS * (int)sizeof(T) / 16;
  // the raw chunk: SCAN_T rows of r, then of k, w and this CTA's v
  static constexpr int K_OFF = SCAN_T * RK_VEC * 16;
  static constexpr int W_OFF = 2 * K_OFF;
  static constexpr int V_OFF = W_OFF + SCAN_T * W_VEC * 16;
  static constexpr int RAW_BYTES = V_OFF + SCAN_T * V_VEC * 16;
  // then in float32: r, k, w rows, v, the warps' readout parts, the bonus
  static constexpr int SMEM_BYTES =
      RAW_BYTES + 4 * (3 * SCAN_T * N + SCAN_T * SCAN_COLS +
                       SCAN_T * Shape::THREADS + SCAN_T);
};

template <int N, typename T>
__global__ void __launch_bounds__(ScanShape<N>::THREADS)
    wkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ s0, T* __restrict__ o,
                     float* __restrict__ s_out, int64_t S, int H) {
  using L = Wkv6Layout<N, T>;
  constexpr int Q = L::Shape::Q, P = L::Shape::P;
  constexpr int THREADS = L::Shape::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw = smem;
  float* r_s = reinterpret_cast<float*>(smem + L::RAW_BYTES);
  float* k_s = r_s + SCAN_T * N;
  float* w_s = k_s + SCAN_T * N;
  float* v_s = w_s + SCAN_T * N;
  float* part_s = v_s + SCAN_T * SCAN_COLS;
  float* bonus_s = part_s + SCAN_T * THREADS;

  const int tid = threadIdx.x;
  const int lane = tid % 32, wp = tid / 32;   // column, part of the state
  const int j0 = blockIdx.x * SCAN_COLS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t step = (int64_t)H * N;                   // one time step
  const int64_t base = ((int64_t)b * S * H + h) * N;     // (b, 0, h, 0)
  const int64_t state = ((int64_t)b * H + h) * N * N;    // S[b, h]

  float u_reg[N / 32];   // u at key rows lane, lane + 32, … (the bonus)
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    u_reg[i] = u[(int64_t)h * N + lane + 32 * i];
  }

  auto issue = [&](int64_t t0) {   // the chunk at t0 into raw
    const int steps = scan_steps(S, t0);
    const int64_t at = base + t0 * step;
    scan_copy_rows<L::RK_VEC>(raw, reinterpret_cast<const unsigned char*>(
        r + at), step * sizeof(T), steps, tid, THREADS);
    scan_copy_rows<L::RK_VEC>(raw + L::K_OFF,
        reinterpret_cast<const unsigned char*>(k + at), step * sizeof(T),
        steps, tid, THREADS);
    scan_copy_rows<L::W_VEC>(raw + L::W_OFF,
        reinterpret_cast<const unsigned char*>(w + at), step * 4, steps, tid,
        THREADS);
    scan_copy_rows<L::V_VEC>(raw + L::V_OFF,
        reinterpret_cast<const unsigned char*>(v + at + j0), step * sizeof(T),
        steps, tid, THREADS);
    scan_cp_async_commit();
  };

  float st[Q];   // S[wp·Q + m, j0 + lane]
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    st[m] = s0 ? s0[state + (int64_t)(wp * Q + m) * N + j0 + lane] : 0.f;
  }

  issue(0);
  for (int64_t t0 = 0; t0 < S; t0 += SCAN_T) {
    const int steps = scan_steps(S, t0);
    scan_cp_async_wait_all();
    __syncthreads();
    scan_widen(r_s, reinterpret_cast<const T*>(raw), steps * N, tid, THREADS);
    scan_widen(k_s, reinterpret_cast<const T*>(raw + L::K_OFF), steps * N,
               tid, THREADS);
    scan_widen(w_s, reinterpret_cast<const float*>(raw + L::W_OFF),
               steps * N, tid, THREADS);
    scan_widen(v_s, reinterpret_cast<const T*>(raw + L::V_OFF),
               steps * SCAN_COLS, tid, THREADS);
    __syncthreads();
    if (t0 + SCAN_T < S) issue(t0 + SCAN_T);
    for (int s = wp; s < steps; s += P) {   // the bonus sums, a warp a step
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < N / 32; ++i) {
        const int row = lane + 32 * i;
        acc = fmaf(r_s[s * N + row] * u_reg[i], k_s[s * N + row], acc);
      }
      acc = scan_warp_sum(acc);
      if (lane == 0) bonus_s[s] = acc;
    }
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float* rr = r_s + s * N + wp * Q;
      const float* kk = k_s + s * N + wp * Q;
      const float* ww = w_s + s * N + wp * Q;
      const float vj = v_s[s * SCAN_COLS + lane];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < Q; q += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rr + q);
        const float4 k4 = *reinterpret_cast<const float4*>(kk + q);
        const float4 w4 = *reinterpret_cast<const float4*>(ww + q);
        a0 = fmaf(r4.x, st[q], a0);
        a1 = fmaf(r4.y, st[q + 1], a1);
        a2 = fmaf(r4.z, st[q + 2], a2);
        a3 = fmaf(r4.w, st[q + 3], a3);
        st[q] = fmaf(w4.x, st[q], k4.x * vj);
        st[q + 1] = fmaf(w4.y, st[q + 1], k4.y * vj);
        st[q + 2] = fmaf(w4.z, st[q + 2], k4.z * vj);
        st[q + 3] = fmaf(w4.w, st[q + 3], k4.w * vj);
      }
      part_s[s * THREADS + tid] = (a0 + a1) + (a2 + a3);
    }
    __syncthreads();
    for (int s = wp; s < steps; s += P) {   // o = the parts' sum + v·bonus
      float y = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) y += part_s[s * THREADS + p * 32 + lane];
      o[base + (t0 + s) * step + j0 + lane] = scan_from_float<T>(
          fmaf(v_s[s * SCAN_COLS + lane], bonus_s[s], y));
    }
  }
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    s_out[state + (int64_t)(wp * Q + m) * N + j0 + lane] = st[m];
  }
}

// The pipelined kernel. A consumer thread holds a 4 × CQ tile of the state
// (4 key rows, CQ = 4 value columns), so that a step's shared loads are r,
// k, w for its rows and v for its columns (10 wavefronts a warp for bf16
// inputs), where a lane a column reads 3·Q values that all lanes share (a
// uniform 16-byte load costs 4 wavefronts, as one of 32 distinct words
// does). A warp's lanes are the LR = N / 4 row groups of all N key rows ×
// LC = 128 / N column groups, so a warp holds whole columns: the readout
// o_t = r_tᵀ(S_{t−1} + diag(u) k_t v_tᵀ) is a thread's sum over its rows,
// the bonus term folded in (sum_i r_i u_i k_i), then over the warp's row
// groups with shuffles; no part crosses a warp. The producer warp only
// copies: each chunk as it arrives (r, k, v in T, w in float32) into one
// of three stages, two chunks ahead of the consumers, who widen in
// registers.
#define WKV6_STAGES 3

template <int N, typename T>
struct Wkv6Pipe {
  static constexpr int COLS = SCAN_COLS, CQ = 4;
  static constexpr int LR = N / 4, LC = 32 / LR;      // lanes: rows × cols
  static constexpr int W = COLS / (CQ * LC);          // consumer warps
  static constexpr int CONS = 32 * W, THREADS = CONS + 32;
  static constexpr int RK_VEC = N * (int)sizeof(T) / 16;
  static constexpr int W_VEC = N * 4 / 16;
  static constexpr int V_VEC = COLS * (int)sizeof(T) / 16;
  // a stage (bytes): w rows (float32), r, k, v rows (T)
  static constexpr int R_AT = SCAN_T * N * 4;
  static constexpr int K_AT = R_AT + SCAN_T * N * (int)sizeof(T);
  static constexpr int V_AT = K_AT + SCAN_T * N * (int)sizeof(T);
  static constexpr int STAGE = V_AT + SCAN_T * COLS * (int)sizeof(T);
  static constexpr int SMEM_BYTES = WKV6_STAGES * STAGE;
  // the readout: a group of 4 steps is NV parts a thread; ROUNDS
  // transposing shuffle rounds (one a row-group bit, at most 4) leave KEEP
  // of them a lane
  static constexpr int NV = 4 * CQ;
  static constexpr int ROUNDS = LR < NV ? 3 : 4;
  static constexpr int KEEP = NV >> ROUNDS;
  static_assert((N == 32 || N == 64 || N == 128) && STAGE % 16 == 0,
                "layout");
};

// named barriers of the pipelined kernel: a stage filled, a stage's chunk
// done, one each for odd and even chunks
#define WKV6_FULL 1
#define WKV6_EMPTY 3

// 4 consecutive staged elements, widened to float32
__device__ __forceinline__ void wkv6_load(const __nv_bfloat16* p,
                                          float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void wkv6_load(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
}

// Round B of the readout's transposing butterfly (nothing past the last):
// of the first NV >> B parts this lane keeps the half that its row group's
// bit B picks, adds the copy of that half from the lane whose bit differs
// (LC << B lanes away), and leaves it in the first NV >> (B + 1) parts.
template <int NV, int ROUNDS, int B>
__device__ __forceinline__ void wkv6_round(float (&part)[NV], int rg,
                                           int lc) {
  if constexpr (B < ROUNDS) {
    constexpr int H = NV >> (B + 1);
    const bool hi = (rg >> B) & 1;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = hi ? part[i] : part[i + H];
      const float keep = hi ? part[i + H] : part[i];
      part[i] = keep + __shfl_xor_sync(0xffffffffu, send, lc << B);
    }
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(Wkv6Pipe<N, T>::THREADS, 1)
    wkv6_scan_kernel_pipe(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ w,
                          const float* __restrict__ u,
                          const float* __restrict__ s0, T* __restrict__ o,
                          float* __restrict__ s_out, int64_t S, int H) {
  using L = Wkv6Pipe<N, T>;
  constexpr int COLS = L::COLS, CQ = L::CQ;
  constexpr int LC = L::LC, NV = L::NV, ROUNDS = L::ROUNDS, KEEP = L::KEEP;
  constexpr int CONS = L::CONS, THREADS = L::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * COLS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t step = (int64_t)H * N;                   // one time step
  const int64_t base = ((int64_t)b * S * H + h) * N;     // (b, 0, h, 0)
  const int64_t state = ((int64_t)b * H + h) * N * N;    // S[b, h]
  const int nch = (int)((S + SCAN_T - 1) / SCAN_T);
  auto stage = [&](int c) { return smem + (c % WKV6_STAGES) * L::STAGE; };

  if (tid >= CONS) {   // the producer warp
    const int lane = tid - CONS;
    // chunk c's rows, as they are, into its stage
    auto issue = [&](int c) {
      const int64_t t0 = (int64_t)c * SCAN_T, at = base + t0 * step;
      const int steps = scan_steps(S, t0);
      unsigned char* sg = stage(c);
      scan_copy_rows_warp<L::W_VEC>(
          sg, reinterpret_cast<const unsigned char*>(w + at), step * 4, steps,
          lane);
      scan_copy_rows_warp<L::RK_VEC>(
          sg + L::R_AT, reinterpret_cast<const unsigned char*>(r + at),
          step * sizeof(T), steps, lane);
      scan_copy_rows_warp<L::RK_VEC>(
          sg + L::K_AT, reinterpret_cast<const unsigned char*>(k + at),
          step * sizeof(T), steps, lane);
      scan_copy_rows_warp<L::V_VEC>(
          sg + L::V_AT, reinterpret_cast<const unsigned char*>(v + at + j0),
          step * sizeof(T), steps, lane);
      scan_cp_async_commit();
    };
    // chunk c + 2's copies are in flight while chunk c runs, into the
    // stage of chunk c − 1 once it is done; chunk c + 1's are waited for
    // and handed over
    issue(0);
    if (nch > 1) issue(1);
    scan_cp_async_wait_prior(nch == 1);
    scan_bar_arrive(WKV6_FULL, THREADS);
    for (int c = 0; c < nch; ++c) {   // the consumers run chunk c
      if (c >= 1) scan_bar_sync(WKV6_EMPTY + ((c - 1) & 1), THREADS);
      if (c + 2 < nch) issue(c + 2);
      if (c + 1 < nch) {
        scan_cp_async_wait_prior(c + 2 >= nch);
        scan_bar_arrive(WKV6_FULL + ((c + 1) & 1), THREADS);
      }
    }
    scan_bar_sync(WKV6_EMPTY + ((nch - 1) & 1), THREADS);
    return;
  }

  // the consumers: thread (row group rg, column group cq) of warp wp holds
  // S[i0 + ii, jc + jj], ii < 4, jj < CQ
  const int lane = tid & 31, wp = tid >> 5;
  const int rg = lane / LC, cq = lane % LC;
  const int i0 = 4 * rg, jc = CQ * (LC * wp + cq);
  float st[4][CQ], u4[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    u4[ii] = u[(int64_t)h * N + i0 + ii];
#pragma unroll
    for (int jj = 0; jj < CQ; ++jj) {
      st[ii][jj] =
          s0 ? s0[state + (int64_t)(i0 + ii) * N + j0 + jc + jj] : 0.f;
    }
  }
  // The readout runs on groups of 4 steps: a thread's NV parts (4 steps ×
  // CQ columns) are summed over the warp's row groups by the transposing
  // butterfly, which leaves this lane parts mine … mine + KEEP − 1 (part
  // p: step p / CQ, column p % CQ); the rounds past it add the row groups
  // that hold the same parts. A group's rounds run between the next
  // group's steps, so that their shuffles' latency hides behind the steps'
  // FMAs.
  int mine = 0;
#pragma unroll
  for (int bit = 0; bit < ROUNDS; ++bit) {
    mine += ((rg >> bit) & 1) * ((NV / 2) >> bit);
  }
  // this lane's output of the last group (its part mine: step mine / CQ,
  // column mine % CQ), none before the first group
  T* const out0 = o + base + j0 + jc + (mine / CQ) * step + mine % CQ;
  T* out_prev = nullptr;
  int64_t t_prev = 0;            // the last group's first step
  // this group's parts, the last group's (zeros before the first: their
  // rounds run and nothing is stored)
  float part[NV], prev[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) prev[i] = 0.f;
  const bool writer = rg < (1 << ROUNDS);   // holds parts no other lane does
  // the last group's closing rounds, stored (``CHECK``: steps past the
  // sequence's end are skipped; only the last chunk's groups have any)
  auto finish = [&](auto check) {
    wkv6_round<NV, ROUNDS, 3>(prev, rg, LC);
#pragma unroll
    for (int m = LC << ROUNDS; m < 32; m <<= 1) {
#pragma unroll
      for (int e = 0; e < KEEP; ++e) {
        prev[e] += __shfl_xor_sync(0xffffffffu, prev[e], m);
      }
    }
    if (writer && out_prev) {
#pragma unroll
      for (int e = 0; e < KEEP; ++e) {   // KEEP = 2: parts mine, mine + 1
        const int q = (mine + e) / CQ - mine / CQ;
        if (!decltype(check)::value || t_prev + (mine + e) / CQ < S) {
          out_prev[q * step + e - q * CQ] = scan_from_float<T>(prev[e]);
        }
      }
    }
  };
  for (int c = 0; c < nch; ++c) {
    const int64_t t0 = (int64_t)c * SCAN_T;
    const int steps = scan_steps(S, t0);
    const unsigned char* sg = stage(c);
    const float* ww = reinterpret_cast<const float*>(sg) + i0;
    const T* rr = reinterpret_cast<const T*>(sg + L::R_AT) + i0;
    const T* kk = reinterpret_cast<const T*>(sg + L::K_AT) + i0;
    const T* vv = reinterpret_cast<const T*>(sg + L::V_AT) + jc;
    scan_bar_sync(WKV6_FULL + (c & 1), THREADS);
    // step s's operands in registers; step s + 1's are loaded before step
    // s's FMAs
    float r4[4], k4[4], w4[4], vq[CQ];
    wkv6_load(rr, r4);
    wkv6_load(kk, k4);
    wkv6_load(ww, w4);
    wkv6_load(vv, vq);
    // the chunk's groups; a whole chunk (the hot path) runs without a
    // branch, a short last one skips the steps past its end
    auto run_chunk = [&](auto whole) {
      constexpr bool WHOLE = decltype(whole)::value;
      auto run = [&](int s0, int q) {   // step s0 + q: parts, S updated
        const int s = s0 + q;
        if (!WHOLE && s >= steps) {
#pragma unroll
          for (int jj = 0; jj < CQ; ++jj) part[CQ * q + jj] = 0.f;
          return;
        }
        const int last = WHOLE ? SCAN_T - 1 : steps - 1;
        const int sn = s < last ? s + 1 : s;
        float rn[4], kn[4], wn[4], vn[CQ];
        wkv6_load(rr + sn * N, rn);
        wkv6_load(kk + sn * N, kn);
        wkv6_load(ww + sn * N, wn);
        wkv6_load(vv + sn * COLS, vn);
        // the readout's part over this thread's rows: r·S + v·(r·u·k)
        float bonus = (r4[0] * u4[0]) * k4[0];
#pragma unroll
        for (int ii = 1; ii < 4; ++ii) {
          bonus = fmaf(r4[ii] * u4[ii], k4[ii], bonus);
        }
#pragma unroll
        for (int jj = 0; jj < CQ; ++jj) {
          float acc = r4[0] * st[0][jj];
#pragma unroll
          for (int ii = 1; ii < 4; ++ii) acc = fmaf(r4[ii], st[ii][jj], acc);
          part[CQ * q + jj] = fmaf(vq[jj], bonus, acc);
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int jj = 0; jj < CQ; ++jj) {
            st[ii][jj] = fmaf(w4[ii], st[ii][jj], k4[ii] * vq[jj]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) r4[i] = rn[i], k4[i] = kn[i], w4[i] = wn[i];
#pragma unroll
        for (int jj = 0; jj < CQ; ++jj) vq[jj] = vn[jj];
      };
      const int end = WHOLE ? SCAN_T : steps;
#pragma unroll 2
      for (int s0 = 0; s0 < end; s0 += 4) {
        run(s0, 0);
        wkv6_round<NV, ROUNDS, 0>(prev, rg, LC);
        run(s0, 1);
        wkv6_round<NV, ROUNDS, 1>(prev, rg, LC);
        run(s0, 2);
        wkv6_round<NV, ROUNDS, 2>(prev, rg, LC);
        run(s0, 3);
        finish(std::integral_constant<bool, !WHOLE>());
#pragma unroll
        for (int i = 0; i < NV; ++i) prev[i] = part[i];
        t_prev = t0 + s0;
        out_prev = out0 + t_prev * step;
      }
    };
    if (steps == SCAN_T) {
      run_chunk(std::true_type());
    } else {
      run_chunk(std::false_type());
    }
    scan_bar_arrive(WKV6_EMPTY + (c & 1), THREADS);
  }
  wkv6_round<NV, ROUNDS, 0>(prev, rg, LC);
  wkv6_round<NV, ROUNDS, 1>(prev, rg, LC);
  wkv6_round<NV, ROUNDS, 2>(prev, rg, LC);
  finish(std::true_type());
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int jj = 0; jj < CQ; ++jj) {
      s_out[state + (int64_t)(i0 + ii) * N + j0 + jc + jj] = st[ii][jj];
    }
  }
}

template <int N, typename T>
static int launch_wkv6(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0,
                       void* o, void* s_out, int B, int64_t S, int H,
                       cudaStream_t stream) {
  cudaError_t e;
  if (S < SCAN_T) {   // shorter than one chunk: the serial kernel
    static bool smem_set = false;
    const int smem = Wkv6Layout<N, T>::SMEM_BYTES;
    e = scan_smem_limit(wkv6_scan_kernel<N, T>, smem, &smem_set);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(N / SCAN_COLS, H, B);
    wkv6_scan_kernel<N, T><<<grid, ScanShape<N>::THREADS, smem, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)w,
        (const float*)u, (const float*)s0, (T*)o, (float*)s_out, S, H);
    return (int)cudaGetLastError();
  }
  using L = Wkv6Pipe<N, T>;
  static bool pipe_set = false;
  e = scan_smem_limit(wkv6_scan_kernel_pipe<N, T>, L::SMEM_BYTES, &pipe_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / L::COLS, H, B);
  wkv6_scan_kernel_pipe<N, T><<<grid, L::THREADS, L::SMEM_BYTES, stream>>>(
          (const T*)r, (const T*)k, (const T*)v, (const float*)w,
          (const float*)u, (const float*)s0, (T*)o, (float*)s_out, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_wkv6(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         void* o, void* s_out, int B, int64_t S, int H,
                         int D, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_wkv6<32, T>(r, k, v, w, u, s0, o, s_out, B, S, H,
                                stream);
    case 64:
      return launch_wkv6<64, T>(r, k, v, w, u, s0, o, s_out, B, S, H,
                                stream);
    case 128:
      return launch_wkv6<128, T>(r, k, v, w, u, s0, o, s_out, B, S, H,
                                 stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fw_wkv6_scan(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* o, void* s_out, int32_t B, int64_t S,
                            int32_t H, int32_t D, int32_t bf16,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  return bf16 ? dispatch_wkv6<__nv_bfloat16>(r, k, v, w, u, s0, o, s_out, B,
                                             S, H, D, (cudaStream_t)stream)
              : dispatch_wkv6<float>(r, k, v, w, u, s0, o, s_out, B, S, H,
                                     D, (cudaStream_t)stream);
}
