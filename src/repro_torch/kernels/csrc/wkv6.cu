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
// (S = 1) are the same launch.
//
// Design (scan.cuh): value column j evolves alone (S_t[:, j] reads only
// v_t[j]), so a CTA owns 32 columns of one head, a lane each, grid
// (D / 32, H, B): 80 CTAs of 8 warps for rwkv6-3b's 40 heads of 64 at
// B = 1. A column's D key rows are split over the 8 warps (ScanShape<64>:
// 8 registers a lane), so all lanes of a warp read the same staged r, k
// and w elements (a shared-memory broadcast). Each warp stores its part of
// a step's readout in shared memory and the parts are summed once the
// 32-step chunk is done: the serial loop has no shuffle and waits on no
// other warp. The readout is computed as r_t^T S_{t-1} + v_t[j] (sum_i r_i
// u_i k_i): the bonus sum is one number a step, made by a warp a step with
// a shuffle sum before the serial loop starts on the chunk, so a state
// element costs one multiply and two FMAs a step. Inputs are read in
// their batch-major layout (the reference's time-major transposes are an
// artifact of scan). The float32 sums run in another order than XLA's
// einsums: the kernel agrees with ref.wkv6_scan_ref within 1e-5 relative
// Frobenius error (float32).
//
// Bound at rwkv6-3b's prefill (B 1, S 32,768, H 40, D 64; r, k, v and o
// bf16, w float32): 1.01 GB moved, 0.30 ms at 3.35 TB/s; 5 float32
// operations a state element and step and 5 a key row (the bonus and the
// readout), 27.3 GFLOP, 0.41 ms at 67 TFLOP/s. The serial loop is
// latency- and issue-bound; the next chunk's copies are in flight while
// it runs, but the widening, the bonus sums and the parts' sums are not,
// so the kernel sits well above its bound (PERF.md records the gap, the
// stages' shares from scripts/torch_scan_probe.py, and the first design:
// 4 warps, a column's key rows over 4 lanes with 16 registers each and
// two shuffles a step, 9.53 ms at the prefill shape).
//
// Left on the table: widening the next chunk while the serial loop runs
// (a producer warp), the 52 SMs that B = 1 leaves idle (80 CTAs), r, k and
// w staged once for both column blocks of a head (a cluster could share
// them), and a chunked (matrix) form of the recurrence on the tensor
// cores.
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

template <int N, typename T>
static int launch_wkv6(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0,
                       void* o, void* s_out, int B, int64_t S, int H,
                       cudaStream_t stream) {
  static bool smem_set = false;
  const int smem = Wkv6Layout<N, T>::SMEM_BYTES;
  cudaError_t e = scan_smem_limit(wkv6_scan_kernel<N, T>, smem, &smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / SCAN_COLS, H, B);
  wkv6_scan_kernel<N, T><<<grid, ScanShape<N>::THREADS, smem, stream>>>(
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
