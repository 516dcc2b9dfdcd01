// ssd_scan: Mamba-2's selective scan over a whole sequence (sm_90a).
//
// Replaces no TPU kernel: the reference runs this recurrence as lax.scan
// (src/repro/models/mamba2.py:110-122, its step under chunked_scan with a
// chunk of 64). The port adds it for the reason wkv6.cu gives: a Python
// loop over time is several small launches a step.
//
//   h_t = exp(dt_t a) h_{t-1} + dt_t (x_t (x) B_t),   y_t = h_t C_t
//
// per (batch, head), h [D rows d, n state columns m] in float32. x is
// [B, S, H, D] and B, C are [B, S, n] in float32 or bfloat16 (the values
// of the reference's casts), dt [B, S, H] float32 (after its softplus), a
// [H] float32, h0 [B, H, D, n] or null for zeros; y is [B, S, H, D]
// float32 (the D skip, the gate and the norm stay in torch) and h_last
// [B, H, D, n] float32. Prefill and a decode step (S = 1) are the same
// call. Under autograd the call also writes the state before each 32-step
// chunk (ckpt [B, H, ceil(S/32), D, n] float32, null otherwise), from which
// ssd_scan_bwd.cu recomputes the chunk's states; it changes no other
// output's bytes.
//
// Two kernels (scan.cuh), one launch a call, a CTA owning 32 rows of one
// head's h, grid (D / 32, H, B): 128 CTAs for zamba2-1.2b's 64 heads of 64
// at B = 1. A call shorter than one chunk (a decode step) runs the serial
// kernel: a lane a row, a row's n state columns over 8 warps, their parts
// of a step's readout summed after the chunk; a state element costs a
// multiply and two FMAs a step.
//
// A call of a chunk or more runs Mamba-2's chunked form (state-space
// duality, arXiv:2405.21060 §6) in chunks of L = 32 steps, 8 consumer
// warps and 1 producer warp a CTA. Per chunk, with seg[i][j] the sum of
// dt·a over steps j + 1 … i:
//
//   M = (C·Bᵀ) ∘ exp(seg) ∘ dt_j (causal),  y = exp(prefix)·C·hᵀ + M·x,
//   h = exp(total)·h + Σ_s exp(suffix_s)·dt_s·x_s ⊗ B_s
//
// so the only serial dependence left is one state update a chunk. Every
// decay is exp of the sum of dt·a over its own segment (Mamba-2's
// segsum), never a difference of two cumulative sums, which cancels once
// a chunk's sum passes −87. The products run on the tensor cores as
// 3xTF32 (mma.sync m16n8k8; float32 accuracy, each product split into
// big and small TF32 parts); an operand read from bf16 inputs is exact in
// TF32, so G = C·Bᵀ is one product and the rest two. The producer warp
// copies each chunk as it arrives (B, C, x rows in their type, dt) into
// one of three stages, two chunks ahead, and forms the segment sums, the
// prefix and suffix decays and the state weights; stages are handed over
// with named barriers. Each consumer warp forms a 16 × 8 tile of M, a
// 16 × 8 tile of y, and 16 × 16 of the new h (kept in registers, written
// to the other of two shared copies); one consumer barrier a chunk
// separates M's tiles from their use. The sums run in another order than
// XLA's einsums: the kernel agrees with ref.ssd_scan_ref within 1e-5
// relative Frobenius error (float32).
//
// Bound at zamba2-1.2b's prefill (B 1, S 32,768, H 64, D 64, n 64; x, B, C
// bf16, dt and y float32): 0.82 GB moved, 0.25 ms at 3.35 TB/s, the bound
// chip_smoke.py states; the chunked form's products (chunks of 32, causal
// triangles once, C·Bᵀ once for all heads) are 38.9 GFLOP, 0.08 ms at
// 495 TFLOP/s (TF32), and the serial form's 5 float32 operations a state
// element and step 42.9 GFLOP, 0.64 ms at 67 TFLOP/s. PERF.md records
// the times and the stages' shares from scripts/torch_scan_probe.py;
// register-tiled products on the CUDA cores were bound by shared-memory
// wavefronts (a uniform 16-byte load costs 4) and slower than the serial
// form.
//
// Left on the table: chunks of 64 steps (half the barriers, more
// products), y written in the compute dtype with the D skip fused.
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

template <int N, typename T, bool CKPT>
__global__ void __launch_bounds__(ScanShape<N>::THREADS)
    ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ Bv,
                    const T* __restrict__ Cv, const float* __restrict__ dt,
                    const float* __restrict__ a,
                    const float* __restrict__ h0, float* __restrict__ y,
                    float* __restrict__ h_out, float* __restrict__ ckpt,
                    int64_t S, int H, int D) {
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
    // the call's one chunk: its checkpoint is the starting state
    if constexpr (CKPT) *reinterpret_cast<float4*>(ckpt + state + m) = v;
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

// The chunked kernel's layout: chunks of SCAN_T = 32 steps, 256 consumer
// threads (8 warps) and one producer warp, three stages. A stage holds the
// chunk's rows as they arrive (B, C and this CTA's x in T, dt in float32;
// each row padded by 16 or 32 bytes, so that the tensor-core fragments'
// loads fall in distinct banks) and what the producer forms from dt: the
// segment sums, exp(prefix), the steps' state weights and exp(total). The
// consumers' own arrays, in float32, two of each (odd and even chunks): the
// state h [32][N + 4] and M [L][L + 4].
template <int N, typename T>
struct SsdChunk {
  static constexpr int L = SCAN_T;                 // steps a chunk
  static constexpr int BP = N * (int)sizeof(T) + 16;          // B, C row
  static constexpr int XP =                        // an x row
      SCAN_COLS * (int)sizeof(T) + (sizeof(T) == 4 ? 32 : 16);
  static constexpr int NS = N + 4, MS = L + 4, LS = L + 1;
  static constexpr int CONS = 256, THREADS = CONS + 32;
  static constexpr int BC_VEC = N * (int)sizeof(T) / 16;   // a B or C row
  static constexpr int X_VEC = SCAN_COLS * (int)sizeof(T) / 16;
  // a stage (bytes)
  static constexpr int C_AT = L * BP, X_AT = 2 * L * BP;
  static constexpr int DT_AT = X_AT + L * XP;
  static constexpr int SEG_AT = DT_AT + 4 * L;
  static constexpr int PEXP_AT = SEG_AT + 4 * L * LS;
  static constexpr int WGT_AT = PEXP_AT + 4 * L;
  static constexpr int ETOT_AT = WGT_AT + 4 * L;
  static constexpr int STAGE = ETOT_AT + 16;
  static constexpr int OWN = 4 * 2 * (SCAN_COLS * NS + L * MS);
  static constexpr int SMEM_BYTES = 3 * STAGE + OWN;
  // operands read from T are exact in TF32 when T is bf16 (8-bit
  // mantissas), so their products need no small part
  static constexpr bool EXACT = sizeof(T) == 2;
  static_assert(L == 32 && STAGE % 16 == 0 && SEG_AT % 16 == 0, "layout");
};

// named barriers of the chunked kernel: a stage filled (producer →
// consumers; odd and even chunks), a stage's chunk done (consumers →
// producer), the chunk's M formed (consumers; by then every warp has also
// written its part of the last chunk's state)
#define SSD_FULL 1
#define SSD_EMPTY 3
#define SSD_MID 5

template <int N, typename T, bool CKPT>
__global__ void __launch_bounds__(SsdChunk<N, T>::THREADS, 1)
    ssd_scan_kernel_chunked(const T* __restrict__ x,
                            const T* __restrict__ Bv,
                            const T* __restrict__ Cv,
                            const float* __restrict__ dt,
                            const float* __restrict__ a,
                            const float* __restrict__ h0,
                            float* __restrict__ y,
                            float* __restrict__ h_out,
                            float* __restrict__ ckpt, int64_t S, int H,
                            int D) {
  using K = SsdChunk<N, T>;
  constexpr int L = K::L, BP = K::BP, XP = K::XP, NS = K::NS, MS = K::MS;
  constexpr int LS = K::LS, CONS = K::CONS, THREADS = K::THREADS;
  constexpr bool EXACT = K::EXACT;
  extern __shared__ __align__(16) unsigned char smem[];
  // h [d][m] before chunk c in hs + (c & 1)·32·NS, chunk c's M [i][j] in
  // ms + (c & 1)·L·MS
  float* hs = reinterpret_cast<float*>(smem + 3 * K::STAGE);
  float* ms = hs + 2 * SCAN_COLS * NS;

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int d0 = blockIdx.x * SCAN_COLS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t x_step = (int64_t)H * D;                  // one time step
  const int64_t x_base = ((int64_t)b * S * H + h) * D + d0;
  const int64_t bc_base = (int64_t)b * S * N;
  const int64_t dt_base = (int64_t)b * S * H + h;
  const int64_t state = (((int64_t)b * H + h) * D + d0) * N;   // h[b, h, d0]
  const int nch = (int)((S + L - 1) / L);
  auto stage = [&](int c) { return smem + (c % 3) * K::STAGE; };

  if (tid >= CONS) {   // the producer warp
    const float a_h = a[h];
    const unsigned all = 0xffffffffu;
    // chunk c's rows and dt, as they are, into its stage
    auto issue = [&](int c) {
      const int64_t t0 = (int64_t)c * L;
      const int steps = scan_steps(S, t0);
      unsigned char* sg = stage(c);
      const unsigned char* bsrc =
          reinterpret_cast<const unsigned char*>(Bv + bc_base + t0 * N);
      const unsigned char* csrc =
          reinterpret_cast<const unsigned char*>(Cv + bc_base + t0 * N);
      const unsigned char* xsrc =
          reinterpret_cast<const unsigned char*>(x + x_base + t0 * x_step);
      for (int q = lane; q < steps * K::BC_VEC; q += 32) {
        const int row = q / K::BC_VEC, col = (q % K::BC_VEC) * 16;
        scan_cp_async16(sg + row * BP + col, bsrc + row * N * sizeof(T) + col);
        scan_cp_async16(sg + K::C_AT + row * BP + col,
                        csrc + row * N * sizeof(T) + col);
      }
      for (int q = lane; q < steps * K::X_VEC; q += 32) {
        const int row = q / K::X_VEC, col = (q % K::X_VEC) * 16;
        scan_cp_async16(sg + K::X_AT + row * XP + col,
                        xsrc + row * x_step * sizeof(T) + col);
      }
      if (lane < steps) {
        scan_cp_async4(sg + K::DT_AT + 4 * lane,
                       dt + dt_base + (t0 + lane) * H);
      }
      scan_cp_async_commit();
      if (steps < L) {   // the last chunk's rows past the end: zeros
        for (int q = lane; q < (L - steps) * BP / 16; q += 32) {
          const int at = steps * BP + q * 16;
          *reinterpret_cast<uint4*>(sg + at) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(sg + K::C_AT + at) = make_uint4(0, 0, 0, 0);
        }
        for (int q = lane; q < (L - steps) * XP / 16; q += 32) {
          *reinterpret_cast<uint4*>(sg + K::X_AT + steps * XP + q * 16) =
              make_uint4(0, 0, 0, 0);
        }
      }
    };
    // chunk c's decays once its copies landed; ``last``: no later chunk's
    // copies are in flight. Every decay is exp of the sum of dt·a over its
    // own segment of the chunk, never a difference of two cumulative sums
    // (where a chunk's sum passes −87, a difference cancels).
    auto prep = [&](int c, bool last) {
      const int steps = scan_steps(S, (int64_t)c * L);
      unsigned char* sg = stage(c);
      scan_cp_async_wait_prior(last);
      __syncwarp();
      const float dtl =
          lane < steps ? reinterpret_cast<const float*>(sg + K::DT_AT)[lane]
                       : 0.f;
      const float da = dtl * a_h;
      float pre = da;            // steps 0 … s
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(all, pre, o);
        if (lane >= o) pre += v;
      }
      float suf = __shfl_down_sync(all, da, 1);   // steps s + 1 … L − 1
      if (lane == 31) suf = 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(all, suf, o);
        if (lane + o < 32) suf += v;
      }
      const float total = __shfl_sync(all, pre, 31);
      float* f = reinterpret_cast<float*>(sg + K::PEXP_AT);
      f[lane] = expf(pre);
      f[L + lane] = expf(suf) * dtl;   // step s's weight in the state
      if (lane == 0) f[2 * L] = expf(total);
      // seg[i][j] = the sum of dt·a over steps j + 1 … i (lane j, i ≥ j;
      // seg[j][j] = 0)
      float* seg = reinterpret_cast<float*>(sg + K::SEG_AT);
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const float di = __shfl_sync(all, da, i);
        if (i > lane) run += di;
        if (i >= lane) seg[i * LS + lane] = run;
      }
      scan_bar_arrive(SSD_FULL + (c & 1), THREADS);
    };
    // chunk c + 2's copies are in flight while chunk c runs, into the
    // stage of chunk c − 1 once it is done; chunk c + 1 is prepared
    issue(0);
    if (nch > 1) issue(1);
    prep(0, nch == 1);
    for (int c = 0; c < nch; ++c) {   // the consumers run chunk c
      if (c >= 1) scan_bar_sync(SSD_EMPTY + ((c - 1) & 1), THREADS);
      if (c + 2 < nch) {
        __syncwarp();
        issue(c + 2);
      }
      if (c + 1 < nch) prep(c + 1, c + 2 >= nch);
    }
    scan_bar_sync(SSD_EMPTY + ((nch - 1) & 1), THREADS);
    return;
  }

  // the consumers: m16n8k8 tiles, lane (g, t) = (lane / 4, lane % 4); a
  // warp takes rows 16·mt … 16·mt + 15 of each product
  const int g = lane >> 2, t = lane & 3, mt = wp & 1, wn = wp >> 1;
  // the state update's tiles (rows d, columns m): TPW n-tiles a warp; for
  // N = 16 only warps 0-3 have one
  constexpr int NT = N / 8, TPW = NT >= 4 ? NT / 4 : 1;
  const bool has_h = wn * TPW < NT;
  float hacc[TPW][4];
#pragma unroll
  for (int q = 0; q < TPW; ++q) {
    const int m = (wn * TPW + q) * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * mt + g + 8 * (e >> 1);
      hacc[q][e] = has_h && h0 ? h0[state + (int64_t)d * N + m + (e & 1)]
                               : 0.f;
      if (has_h) hs[d * NS + m + (e & 1)] = hacc[q][e];
    }
  }

  for (int c = 0; c < nch; ++c) {
    const int64_t t0 = (int64_t)c * L;
    const int steps = scan_steps(S, t0);
    const unsigned char* sg = stage(c);
    const T* bs = reinterpret_cast<const T*>(sg);
    const T* cs = reinterpret_cast<const T*>(sg + K::C_AT);
    const T* xs = reinterpret_cast<const T*>(sg + K::X_AT);
    const float* seg = reinterpret_cast<const float*>(sg + K::SEG_AT);
    const float* dts = reinterpret_cast<const float*>(sg + K::DT_AT);
    const float* pexp = reinterpret_cast<const float*>(sg + K::PEXP_AT);
    const float* wgt = pexp + L;
    float* m_c = ms + (c & 1) * L * MS;
    const float* h_c = hs + (c & 1) * SCAN_COLS * NS;   // h before chunk c
    constexpr int BE = BP / (int)sizeof(T), XE = XP / (int)sizeof(T);
    const T* crow = cs + 16 * mt * BE;
    if (CKPT && has_h) {   // the state before chunk c, for the backward
      float* ck = ckpt + (((int64_t)b * H + h) * nch + c) * D * N +
                  (int64_t)d0 * N;
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
        const int m = (wn * TPW + q) * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int d = 16 * mt + g + 8 * (e >> 1);
          *reinterpret_cast<float2*>(ck + (int64_t)d * N + m) =
              make_float2(hacc[q][e], hacc[q][e + 1]);
        }
      }
    }
    scan_bar_sync(SSD_FULL + (c & 1), THREADS);

    // 1. M = (C·Bᵀ) ∘ exp(seg) ∘ dt over the N state columns: warp (mt,
    // wn) takes rows 16·mt … and steps j = 8·wn …; rows 0-15 of steps
    // 16-31 are above the diagonal (zero, and never read)
    if (!(mt == 0 && wn >= 2)) {
      SsdAcc acc[2];   // even and odd k-steps: two shorter chains
      ssd_acc_zero(acc[0]);
      ssd_acc_zero(acc[1]);
      const T* brow = bs + 8 * wn * BE;
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 8) {
        const SsdFrag<4> fa = ssd_frag_a<EXACT>(
            [&](int r, int q) { return ssd_ld(crow + r * BE + k0 + q); }, g,
            t);
        const SsdFrag<2> fb = ssd_frag_b<EXACT>(
            [&](int kk, int n) { return ssd_ld(brow + n * BE + k0 + kk); }, g,
            t);
        ssd_mma3<EXACT, EXACT>(acc[(k0 >> 3) & 1], fa, fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * mt + g + 8 * (e >> 1);
        const int j = 8 * wn + 2 * t + (e & 1);
        const float v = ssd_acc_sum(acc[0], e) + ssd_acc_sum(acc[1], e);
        m_c[i * MS + j] =
            j <= i && j < steps ? v * expf(seg[i * LS + j]) * dts[j] : 0.f;
      }
    }
    scan_bar_sync(SSD_MID, CONS);

    // 2. y = exp(prefix)·C·hᵀ + M·x: warp (mt, wn) takes rows 16·mt … and
    // columns d = 8·wn …; M is zero past row 16·mt + 15
    {
      SsdAcc inter[2], intra;   // inter: even and odd k-steps
      ssd_acc_zero(inter[0]);
      ssd_acc_zero(inter[1]);
      ssd_acc_zero(intra);
      const float* hrow = h_c + 8 * wn * NS;
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 8) {
        const SsdFrag<4> fa = ssd_frag_a<EXACT>(
            [&](int r, int q) { return ssd_ld(crow + r * BE + k0 + q); }, g,
            t);
        const SsdFrag<2> fb = ssd_frag_b<false>(
            [&](int kk, int n) { return hrow[n * NS + k0 + kk]; }, g, t);
        ssd_mma3<EXACT, false>(inter[(k0 >> 3) & 1], fa, fb);
      }
      const float* mrow = m_c + 16 * mt * MS;
      const T* xcol = xs + 8 * wn;
      for (int k0 = 0; k0 < 16 * mt + 16; k0 += 8) {
        const SsdFrag<4> fa = ssd_frag_a<false>(
            [&](int r, int q) { return mrow[r * MS + k0 + q]; }, g, t);
        const SsdFrag<2> fb = ssd_frag_b<EXACT>(
            [&](int kk, int n) { return ssd_ld(xcol + (k0 + kk) * XE + n); },
            g, t);
        ssd_mma3<false, EXACT>(intra, fa, fb);
      }
      const int d = 8 * wn + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = 16 * mt + g + 8 * (e >> 1);
        if (i < steps) {
          const float p = pexp[i];
          const float i0 = ssd_acc_sum(inter[0], e) + ssd_acc_sum(inter[1], e);
          const float i1 =
              ssd_acc_sum(inter[0], e + 1) + ssd_acc_sum(inter[1], e + 1);
          *reinterpret_cast<float2*>(y + x_base + (t0 + i) * x_step + d) =
              make_float2(fmaf(p, i0, ssd_acc_sum(intra, e)),
                          fmaf(p, i1, ssd_acc_sum(intra, e + 1)));
        }
      }
    }

    // 3. h = exp(total)·h + (weight ∘ x)ᵀ·B over the chunk's steps, into
    // the other h
    if (has_h) {
      const float et = pexp[2 * L];
      SsdAcc acc[TPW];
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
        ssd_acc_zero(acc[q]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q].bb[e] = et * hacc[q][e];
      }
      const T* xcol = xs + 16 * mt;
#pragma unroll
      for (int k0 = 0; k0 < L; k0 += 8) {
        // (d, s) = weight_s · x[s][d]
        const SsdFrag<4> fa = ssd_frag_a<false>(
            [&](int r, int q) {
              return wgt[k0 + q] * ssd_ld(xcol + (k0 + q) * XE + r);
            },
            g, t);
#pragma unroll
        for (int q = 0; q < TPW; ++q) {
          const T* bcol = bs + k0 * BE + (wn * TPW + q) * 8;
          const SsdFrag<2> fb = ssd_frag_b<EXACT>(
              [&](int kk, int n) { return ssd_ld(bcol + kk * BE + n); }, g, t);
          ssd_mma3<false, EXACT>(acc[q], fa, fb);
        }
      }
      float* h_n = hs + ((c + 1) & 1) * SCAN_COLS * NS;
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
        const int m = (wn * TPW + q) * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[q][e] = ssd_acc_sum(acc[q], e);
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int dd = 16 * mt + g + 8 * (e >> 1);
          *reinterpret_cast<float2*>(h_n + dd * NS + m) =
              make_float2(hacc[q][e], hacc[q][e + 1]);
        }
      }
    }
    scan_bar_arrive(SSD_EMPTY + (c & 1), THREADS);
  }
  if (has_h) {
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
      const int m = (wn * TPW + q) * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * mt + g + 8 * (e >> 1);
        h_out[state + (int64_t)d * N + m + (e & 1)] = hacc[q][e];
      }
    }
  }
}

template <int N, typename T, bool CKPT>
static int launch_ssd(const void* x, const void* Bv, const void* Cv,
                      const void* dt, const void* a, const void* h0, void* y,
                      void* h_out, void* ckpt, int B, int64_t S, int H, int D,
                      cudaStream_t stream) {
  cudaError_t e;
  const dim3 grid(D / SCAN_COLS, H, B);
  if (S < SCAN_T) {   // shorter than one chunk: the serial kernel
    static bool smem_set = false;
    const int smem = SsdLayout<N, T>::SMEM_BYTES;
    e = scan_smem_limit(ssd_scan_kernel<N, T, CKPT>, smem, &smem_set);
    if (e != cudaSuccess) return (int)e;
    ssd_scan_kernel<N, T, CKPT><<<grid, ScanShape<N>::THREADS, smem, stream>>>(
        (const T*)x, (const T*)Bv, (const T*)Cv, (const float*)dt,
        (const float*)a, (const float*)h0, (float*)y, (float*)h_out,
        (float*)ckpt, S, H, D);
    return (int)cudaGetLastError();
  }
  using K = SsdChunk<N, T>;
  static bool chunk_set = false;
  e = scan_smem_limit(ssd_scan_kernel_chunked<N, T, CKPT>, K::SMEM_BYTES,
                      &chunk_set);
  if (e != cudaSuccess) return (int)e;
  ssd_scan_kernel_chunked<N, T, CKPT>
      <<<grid, K::THREADS, K::SMEM_BYTES, stream>>>(
      (const T*)x, (const T*)Bv, (const T*)Cv, (const float*)dt,
      (const float*)a, (const float*)h0, (float*)y, (float*)h_out,
      (float*)ckpt, S, H, D);
  return (int)cudaGetLastError();
}

template <typename T, bool CKPT>
static int dispatch_ssd(const void* x, const void* Bv, const void* Cv,
                        const void* dt, const void* a, const void* h0,
                        void* y, void* h_out, void* ckpt, int B, int64_t S,
                        int H, int D, int n, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch_ssd<16, T, CKPT>(x, Bv, Cv, dt, a, h0, y, h_out, ckpt,
                                     B, S, H, D, stream);
    case 32:
      return launch_ssd<32, T, CKPT>(x, Bv, Cv, dt, a, h0, y, h_out, ckpt,
                                     B, S, H, D, stream);
    case 64:
      return launch_ssd<64, T, CKPT>(x, Bv, Cv, dt, a, h0, y, h_out, ckpt,
                                     B, S, H, D, stream);
    case 128:
      return launch_ssd<128, T, CKPT>(x, Bv, Cv, dt, a, h0, y, h_out, ckpt,
                                      B, S, H, D, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool CKPT>
static int dispatch_ssd_io(const void* x, const void* Bv, const void* Cv,
                           const void* dt, const void* a, const void* h0,
                           void* y, void* h_out, void* ckpt, int B,
                           int64_t S, int H, int D, int n, int bf16,
                           cudaStream_t stream) {
  return bf16 ? dispatch_ssd<__nv_bfloat16, CKPT>(x, Bv, Cv, dt, a, h0, y,
                                                  h_out, ckpt, B, S, H, D, n,
                                                  stream)
              : dispatch_ssd<float, CKPT>(x, Bv, Cv, dt, a, h0, y, h_out,
                                          ckpt, B, S, H, D, n, stream);
}

// ckpt: null, or [B, H, ceil(S / SCAN_T), D, n] float32 for the state
// before each chunk (ssd_scan_bwd.cu reads them). The checkpoint writes are
// compiled in only for a non-null ckpt: a call without one runs a kernel
// with no checkpoint code at all; the other outputs are the same bytes
// either way
extern "C" int fw_ssd_scan(const void* x, const void* Bv, const void* Cv,
                           const void* dt, const void* a, const void* h0,
                           void* y, void* h_out, void* ckpt, int32_t B,
                           int64_t S, int32_t H, int32_t D, int32_t n,
                           int32_t bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (D <= 0 || D % SCAN_COLS) return (int)cudaErrorInvalidValue;
  return ckpt ? dispatch_ssd_io<true>(x, Bv, Cv, dt, a, h0, y, h_out, ckpt,
                                      B, S, H, D, n, bf16,
                                      (cudaStream_t)stream)
              : dispatch_ssd_io<false>(x, Bv, Cv, dt, a, h0, y, h_out,
                                       nullptr, B, S, H, D, n, bf16,
                                       (cudaStream_t)stream);
}
