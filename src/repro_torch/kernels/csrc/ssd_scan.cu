// ssd_scan: Mamba-2's selective scan over a whole sequence (sm_90a).
//
// Replaces no TPU kernel: the reference runs this recurrence as lax.scan
// (src/repro/models/mamba2.py:320-333, its step under chunked_scan with a
// chunk of 64). The port adds it for the reason wkv6.cu gives: a Python
// loop over time is several small launches a step.
//
//   h_t = exp(dt_t a) h_{t-1} + dt_t (x_t (x) B_t),   y_t = h_t C_t
//
// per (batch, head), h [D rows d, n state columns m] in float32. x is
// [B, S, H, D] and B, C are [B, S, n] in float32 or bfloat16 (widened in
// registers, the values of the reference's casts), dt [B, S, H] float32
// (after its softplus), a [H] float32, h0 [B, H, D, n] or null for zeros;
// y is [B, S, H, D] float32 (the D skip, the gate and the norm stay in
// torch) and h_last [B, H, D, n] float32. Prefill and a decode step
// (S = 1) are the same launch.
//
// Design (scan.cuh): row d of h evolves alone (it reads x_t[d] and the
// head's shared B_t, C_t, dt_t), so a CTA owns 32 rows of one head, a lane
// each, grid (D / 32, H, B): 128 CTAs of 8 warps for zamba2-1.2b's 64
// heads of 64 at B = 1, about one a SM. A row's n state columns are split
// over 8 warps (8 registers a lane at n = 64), their parts of a step's
// readout summed after the chunk, for the reasons wkv6.cu gives. The chunk
// stages B_t and C_t (shared by all heads), this CTA's x_t rows and dt_t;
// dt is one float a step at stride H, so the next chunk's values wait in
// registers rather than in 16-byte copies, and exp(dt_t a) is taken once a
// step while the chunk is staged (IEEE expf: the build sets no fast-math
// flag). A state element costs one multiply and two FMAs a step. The
// float32 sums run in another order than XLA's einsums: the kernel agrees
// with ref.ssd_scan_ref within 1e-5 relative Frobenius error (float32).
//
// Bound at zamba2-1.2b's prefill (B 1, S 32,768, H 64, D 64, n 64; x, B, C
// bf16, dt and y float32): 0.82 GB moved, 0.25 ms at 3.35 TB/s; 5 float32
// operations a state element and step, 42.9 GFLOP, 0.64 ms at 67 TFLOP/s.
// Like wkv6.cu's, the serial loop is latency- and issue-bound, and the
// widening and the parts' sums do not overlap it (the first design, 4
// lanes a row with a shuffle sum a step: 7.73 ms; PERF.md).
//
// Left on the table: the chunked SSD form (intra-chunk products on the
// tensor cores, the state passed between chunks), which is how Mamba-2
// reaches its bound; y written in the compute dtype with the D skip fused.
#include "scan.cuh"

template <int N, typename T>
struct SsdLayout {
  using Shape = ScanShape<N>;
  static constexpr int BC_VEC = N * (int)sizeof(T) / 16;   // a B or C row
  static constexpr int X_VEC = SCAN_COLS * (int)sizeof(T) / 16;
  // the raw chunk: SCAN_T rows of B, then of C and this CTA's x
  static constexpr int C_OFF = SCAN_T * BC_VEC * 16;
  static constexpr int X_OFF = 2 * C_OFF;
  static constexpr int RAW_BYTES = X_OFF + SCAN_T * X_VEC * 16;
  // then in float32: B, C rows, x, the warps' readout parts, dt, the decays
  static constexpr int SMEM_BYTES =
      RAW_BYTES + 4 * (2 * SCAN_T * N + SCAN_T * SCAN_COLS +
                       SCAN_T * Shape::THREADS + 2 * SCAN_T);
};

template <int N, typename T>
__global__ void __launch_bounds__(ScanShape<N>::THREADS)
    ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ Bv,
                    const T* __restrict__ Cv, const float* __restrict__ dt,
                    const float* __restrict__ a,
                    const float* __restrict__ h0, float* __restrict__ y,
                    float* __restrict__ h_out, int64_t S, int H, int D) {
  using L = SsdLayout<N, T>;
  constexpr int Q = L::Shape::Q, P = L::Shape::P;
  constexpr int THREADS = L::Shape::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw = smem;
  float* b_s = reinterpret_cast<float*>(smem + L::RAW_BYTES);
  float* c_s = b_s + SCAN_T * N;
  float* x_s = c_s + SCAN_T * N;
  float* part_s = x_s + SCAN_T * SCAN_COLS;
  float* dt_s = part_s + SCAN_T * THREADS;
  float* e_s = dt_s + SCAN_T;

  const int tid = threadIdx.x;
  const int lane = tid % 32, wp = tid / 32;   // row, part of the state
  const int d0 = blockIdx.x * SCAN_COLS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t x_step = (int64_t)H * D;                  // one time step
  const int64_t x_base = ((int64_t)b * S * H + h) * D + d0;
  const int64_t bc_base = (int64_t)b * S * N;
  const int64_t dt_base = (int64_t)b * S * H + h;
  const int64_t state = (((int64_t)b * H + h) * D + d0 + lane) * N +
                        wp * Q;                           // h[b, h, d, m0]
  const float a_h = a[h];

  // the chunk at t0 into raw; its dt values into a register of threads
  // 0 … SCAN_T − 1
  auto issue = [&](int64_t t0) {
    const int steps = scan_steps(S, t0);
    scan_copy_rows<L::BC_VEC>(raw, reinterpret_cast<const unsigned char*>(
        Bv + bc_base + t0 * N), N * sizeof(T), steps, tid, THREADS);
    scan_copy_rows<L::BC_VEC>(raw + L::C_OFF,
        reinterpret_cast<const unsigned char*>(Cv + bc_base + t0 * N),
        N * sizeof(T), steps, tid, THREADS);
    scan_copy_rows<L::X_VEC>(raw + L::X_OFF,
        reinterpret_cast<const unsigned char*>(x + x_base + t0 * x_step),
        x_step * sizeof(T), steps, tid, THREADS);
    scan_cp_async_commit();
    return tid < steps ? dt[dt_base + (t0 + tid) * H] : 0.f;
  };

  float st[Q];   // h[d0 + lane, wp·Q + m]
#pragma unroll
  for (int m = 0; m < Q; m += 4) {
    const float4 v = h0 ? *reinterpret_cast<const float4*>(h0 + state + m)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    st[m] = v.x;
    st[m + 1] = v.y;
    st[m + 2] = v.z;
    st[m + 3] = v.w;
  }

  float dt_next = issue(0);
  for (int64_t t0 = 0; t0 < S; t0 += SCAN_T) {
    const int steps = scan_steps(S, t0);
    scan_cp_async_wait_all();
    __syncthreads();
    scan_widen(b_s, reinterpret_cast<const T*>(raw), steps * N, tid, THREADS);
    scan_widen(c_s, reinterpret_cast<const T*>(raw + L::C_OFF), steps * N,
               tid, THREADS);
    scan_widen(x_s, reinterpret_cast<const T*>(raw + L::X_OFF),
               steps * SCAN_COLS, tid, THREADS);
    if (tid < SCAN_T) {
      dt_s[tid] = dt_next;
      e_s[tid] = expf(dt_next * a_h);
    }
    __syncthreads();
    if (t0 + SCAN_T < S) dt_next = issue(t0 + SCAN_T);
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float* bb = b_s + s * N + wp * Q;
      const float* cc = c_s + s * N + wp * Q;
      const float e = e_s[s];
      const float dx = dt_s[s] * x_s[s * SCAN_COLS + lane];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < Q; q += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(bb + q);
        const float4 c4 = *reinterpret_cast<const float4*>(cc + q);
        st[q] = fmaf(e, st[q], dx * b4.x);
        st[q + 1] = fmaf(e, st[q + 1], dx * b4.y);
        st[q + 2] = fmaf(e, st[q + 2], dx * b4.z);
        st[q + 3] = fmaf(e, st[q + 3], dx * b4.w);
        a0 = fmaf(st[q], c4.x, a0);
        a1 = fmaf(st[q + 1], c4.y, a1);
        a2 = fmaf(st[q + 2], c4.z, a2);
        a3 = fmaf(st[q + 3], c4.w, a3);
      }
      part_s[s * THREADS + tid] = (a0 + a1) + (a2 + a3);
    }
    __syncthreads();
    for (int s = wp; s < steps; s += P) {   // y = the parts' sum
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) acc += part_s[s * THREADS + p * 32 + lane];
      y[x_base + (t0 + s) * x_step + lane] = acc;
    }
  }
#pragma unroll
  for (int m = 0; m < Q; m += 4) {
    *reinterpret_cast<float4*>(h_out + state + m) =
        make_float4(st[m], st[m + 1], st[m + 2], st[m + 3]);
  }
}

template <int N, typename T>
static int launch_ssd(const void* x, const void* Bv, const void* Cv,
                      const void* dt, const void* a, const void* h0, void* y,
                      void* h_out, int B, int64_t S, int H, int D,
                      cudaStream_t stream) {
  static bool smem_set = false;
  const int smem = SsdLayout<N, T>::SMEM_BYTES;
  cudaError_t e = scan_smem_limit(ssd_scan_kernel<N, T>, smem, &smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(D / SCAN_COLS, H, B);
  ssd_scan_kernel<N, T><<<grid, ScanShape<N>::THREADS, smem, stream>>>(
      (const T*)x, (const T*)Bv, (const T*)Cv, (const float*)dt,
      (const float*)a, (const float*)h0, (float*)y, (float*)h_out, S, H, D);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_ssd(const void* x, const void* Bv, const void* Cv,
                        const void* dt, const void* a, const void* h0,
                        void* y, void* h_out, int B, int64_t S, int H, int D,
                        int n, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch_ssd<16, T>(x, Bv, Cv, dt, a, h0, y, h_out, B, S, H, D,
                               stream);
    case 32:
      return launch_ssd<32, T>(x, Bv, Cv, dt, a, h0, y, h_out, B, S, H, D,
                               stream);
    case 64:
      return launch_ssd<64, T>(x, Bv, Cv, dt, a, h0, y, h_out, B, S, H, D,
                               stream);
    case 128:
      return launch_ssd<128, T>(x, Bv, Cv, dt, a, h0, y, h_out, B, S, H, D,
                                stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fw_ssd_scan(const void* x, const void* Bv, const void* Cv,
                           const void* dt, const void* a, const void* h0,
                           void* y, void* h_out, int32_t B, int64_t S,
                           int32_t H, int32_t D, int32_t n, int32_t bf16,
                           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (D <= 0 || D % SCAN_COLS) return (int)cudaErrorInvalidValue;
  return bf16 ? dispatch_ssd<__nv_bfloat16>(x, Bv, Cv, dt, a, h0, y, h_out,
                                            B, S, H, D, n,
                                            (cudaStream_t)stream)
              : dispatch_ssd<float>(x, Bv, Cv, dt, a, h0, y, h_out, B, S, H,
                                    D, n, (cudaStream_t)stream);
}
