// ssd_scan_bwd: the gradient of ssd_scan, Mamba-2's selective scan
// (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel for the
// scan; XLA differentiates its lax.scan (src/repro/models/mamba2.py:
// 110-122, under chunked_scan). The port adds it for the reason
// wkv6_bwd.cu gives.
//
// Per (batch, head), h [D rows d, n state columns m] in float32,
// decay_t = exp(dt_t a), G the gradient of the state after step t: the
// carried Q = decay_{t+1} G_{t+1} (dh_last after the last step) plus
// dy_t (x) C_t. Then
//
//   dx_t = dt_t G B_t,   dB_t = sum_{h,d} dt_t G x_t,   dC_t = sum_{h,d} dy_t h_t
//   ddt_t = sum_{d,m} G o (x_t (x) B_t + a decay_t h_{t-1})
//   da = sum_{b,t} dt_t decay_t sum_{d,m} G o h_{t-1},   Q <- decay_t G
//
// and dh0 is the last Q. h_{t-1} comes from the forward kernel's
// checkpoints (ssd_scan.cu writes the state before every 32-step chunk
// when asked, [B, H, ceil(S/32), D, n] float32), never from dividing by
// the decay, which underflows to 0. x, B and C come in float32 or bfloat16
// (widened in registers), dt, a and dy in float32; everything is computed
// in float32 and each gradient rounded once to its input's type.
//
// A CTA owns ROWS = 32 rows of one head's state (16 at n = 128) and all n
// columns, a thread a 4 × 4 tile of the state and of Q in registers: 256
// CTAs of 128 threads at zamba2-1.2b's training shape (B 2, H 64, D 64,
// n 64). It walks the chunks from the last, their rows copied with
// cp.async into one of two stages while the chunk before runs, each chunk
// in 8 sub-chunks of 4 steps as wkv6_bwd.cu's: pass A keeps the tile's
// state before each sub-chunk in shared memory, pass B steps a
// sub-chunk's 4 states into registers and runs its steps backward. A
// step's row sums (G B, for dx and ddt) go through a transposing shuffle
// butterfly over the warp's column groups, its column sums (G x, dy h, for
// dB and dC) over the warp's row groups by shuffles and over the warps
// through shared memory, and sum G o h_{t-1} over the warp and the warps;
// after each sub-chunk one barrier, then the CTA writes the sub-chunk's dx
// and its parts of dB, dC and ddt. B and C are shared by all heads, so
// their gradients sum over every head and row block, ddt over the row
// blocks and da over the batch rows and row blocks: per-CTA partials that
// a second pass (scan_sum_kernel) adds in a fixed order. No float atomics
// anywhere, so the bytes repeat run to run. The recomputed states use the
// serial forward's operations (the chunked forward's checkpoints differ
// from it only by rounding).
//
// Bound at zamba2-1.2b's training shape (B 2, S 4,096, H 64, D 64, n 64;
// x and dx bf16, B and C bf16, dt, dy, ddt float32): 549 MB moved (the
// inputs, the checkpoints' 268 MB and the gradients once each), 0.16 ms at
// 3.35 TB/s; 14 float32 operations a state element and step (the state's
// recompute 3, G 2, the products G B, G x, dy h and G h 8, Q 1), 30.1
// GFLOP, 0.45 ms at 67 TFLOP/s: operation-bound. The design recomputes
// the states twice and h_t once more (20 operations) and is issue-bound on
// each step's shuffles besides; dB's and dC's partials (268 MB each at
// that shape) cost a pass of their own. Mamba-2's chunked backward on the
// tensor cores is queued as later work (ROADMAP.md Queue 2).
#include "scan.cuh"

template <int N, typename T>
struct SsdBwd {
  static constexpr int ROWS = N == 128 ? 16 : 32;  // state rows a CTA
  static constexpr int CG = N / 4, RG = ROWS / 4;  // column, row groups
  static constexpr int THREADS = CG * RG, WARPS = THREADS / 32;
  static constexpr int RPW = 32 / CG;              // row groups a warp
  static constexpr int SUB = 4, NSUB = SCAN_T / SUB;
  static constexpr int ROUNDS = scan_log2(CG);
  // a stage (bytes): SCAN_T rows of B and C (T), this CTA's x (T) and dy
  // (float32), and dt (float32)
  static constexpr int C_AT = SCAN_T * N * (int)sizeof(T);
  static constexpr int X_AT = 2 * C_AT;
  static constexpr int Y_AT = X_AT + SCAN_T * ROWS * (int)sizeof(T);
  static constexpr int DT_AT = Y_AT + SCAN_T * ROWS * 4;
  static constexpr int STAGE = DT_AT + SCAN_T * 4;
  // then in float32: the stash (each thread's tile before sub-chunks
  // 1 … NSUB − 1) and, two of each by sub-chunk parity, a sub-chunk's row
  // sums G·B [SUB][ROWS], the warps' column parts [SUB][WARPS][2][N] (G·x,
  // dy·h) and their sums of G ∘ h_{t−1} [SUB][WARPS]
  static constexpr int STASH = (NSUB - 1) * 16 * THREADS;
  static constexpr int GB = 2 * SUB * ROWS;
  static constexpr int COLS = 2 * SUB * WARPS * 2 * N;
  static constexpr int GH = 2 * SUB * WARPS;
  static constexpr int SMEM_BYTES = 2 * STAGE + 4 * (STASH + GB + COLS + GH);
  static_assert(THREADS >= 32 && THREADS % 32 == 0 && ROWS <= 32, "layout");
  static_assert(STAGE % 16 == 0 && SMEM_BYTES <= 232448, "shared memory");
};

template <int N, typename T>
__global__ void __launch_bounds__(SsdBwd<N, T>::THREADS, 1)
    ssd_bwd_kernel(const T* __restrict__ x, const T* __restrict__ Bv,
                   const T* __restrict__ Cv, const float* __restrict__ dt,
                   const float* __restrict__ a,
                   const float* __restrict__ ckpt,
                   const float* __restrict__ dy,
                   const float* __restrict__ dh_last, T* __restrict__ dx,
                   float* __restrict__ db_part, float* __restrict__ dc_part,
                   float* __restrict__ ddt_part,
                   float* __restrict__ da_part, float* __restrict__ dh0,
                   int64_t S, int H, int D) {
  using L = SsdBwd<N, T>;
  constexpr int ROWS = L::ROWS, CG = L::CG, THREADS = L::THREADS;
  constexpr int WARPS = L::WARPS, SUB = L::SUB, NSUB = L::NSUB;
  constexpr int ROUNDS = L::ROUNDS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stash = reinterpret_cast<float*>(smem + 2 * L::STAGE);
  float* gb_s = stash + L::STASH;
  float* col_s = gb_s + L::GB;
  float* gh_s = col_s + L::COLS;

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int cg = lane % CG, rg = wp * L::RPW + lane / CG;
  const int i0 = 4 * rg, jc = 4 * cg;   // the tile: rows d0 + i0 …, columns jc …
  const int rb = blockIdx.x, d0 = rb * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int NR = gridDim.x, B = gridDim.z;
  const int64_t x_step = (int64_t)H * D;                  // one time step
  const int64_t x_base = ((int64_t)b * S * H + h) * D + d0;
  const int64_t bc_base = (int64_t)b * S * N;
  const int64_t dt_base = (int64_t)b * S * H + h;
  const int64_t state = (((int64_t)b * H + h) * D + d0) * N;   // h[b, h, d0]
  const int nch = (int)((S + SCAN_T - 1) / SCAN_T);
  const float a_h = a[h];
  auto stage = [&](int c) { return smem + (c & 1) * L::STAGE; };

  // chunk c's rows into its stage; the rows past the sequence's end get
  // zeros (dt = 0: a decay of 1 and no input, steps that leave the state
  // and Q as they are)
  auto issue = [&](int c) {
    const int64_t t0 = (int64_t)c * SCAN_T;
    const int steps = scan_steps(S, t0);
    unsigned char* sg = stage(c);
    scan_copy_rows<N * (int)sizeof(T) / 16>(
        sg, reinterpret_cast<const unsigned char*>(Bv + bc_base + t0 * N),
        N * sizeof(T), steps, tid, THREADS);
    scan_copy_rows<N * (int)sizeof(T) / 16>(
        sg + L::C_AT,
        reinterpret_cast<const unsigned char*>(Cv + bc_base + t0 * N),
        N * sizeof(T), steps, tid, THREADS);
    scan_copy_rows<ROWS * (int)sizeof(T) / 16>(
        sg + L::X_AT,
        reinterpret_cast<const unsigned char*>(x + x_base + t0 * x_step),
        x_step * sizeof(T), steps, tid, THREADS);
    scan_copy_rows<ROWS * 4 / 16>(
        sg + L::Y_AT,
        reinterpret_cast<const unsigned char*>(dy + x_base + t0 * x_step),
        x_step * 4, steps, tid, THREADS);
    if (tid < steps) {
      scan_cp_async4(sg + L::DT_AT + 4 * tid, dt + dt_base + (t0 + tid) * H);
    }
    scan_cp_async_commit();
    if (steps < SCAN_T) {
      const int bc = N * (int)sizeof(T), xr = ROWS * (int)sizeof(T);
      scan_zero(sg + steps * bc, (SCAN_T - steps) * bc, tid, THREADS);
      scan_zero(sg + L::C_AT + steps * bc, (SCAN_T - steps) * bc, tid,
                THREADS);
      scan_zero(sg + L::X_AT + steps * xr, (SCAN_T - steps) * xr, tid,
                THREADS);
      scan_zero(sg + L::Y_AT + steps * ROWS * 4, (SCAN_T - steps) * ROWS * 4,
                tid, THREADS);
      for (int s = steps + tid; s < SCAN_T; s += THREADS) {
        reinterpret_cast<float*>(sg + L::DT_AT)[s] = 0.f;
      }
    }
  };

  float Q[4][4];
  if (dh_last) {
    scan_tile_load(Q, dh_last + state + (int64_t)i0 * N + jc, N);
  } else {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) Q[ii][jj] = 0.f;
    }
  }
  float da_acc = 0.f;
  int sub = 0;   // sub-chunks run, for the parity of the double buffers

  issue(nch - 1);
  for (int c = nch - 1; c >= 0; --c) {
    scan_cp_async_wait_all();
    __syncthreads();
    if (c > 0) issue(c - 1);
    const unsigned char* sg = stage(c);
    const T* bs = reinterpret_cast<const T*>(sg);
    const T* cs = reinterpret_cast<const T*>(sg + L::C_AT);
    const T* xs = reinterpret_cast<const T*>(sg + L::X_AT);
    const float* ys = reinterpret_cast<const float*>(sg + L::Y_AT);
    const float* dts = reinterpret_cast<const float*>(sg + L::DT_AT);
    // one forward step of the tile: the serial forward's operations
    auto fwd = [&](float (&st)[4][4], int tl) {
      const float dl = dts[tl], e = expf(dl * a_h);
      float x4[4], b4[4];
      scan_load4(xs + tl * ROWS + i0, x4);
      scan_load4(bs + tl * N + jc, b4);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float dxi = dl * x4[ii];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          st[ii][jj] = fmaf(e, st[ii][jj], dxi * b4[jj]);
        }
      }
    };
    const float* ck = ckpt + (((int64_t)b * H + h) * nch + c) * D * N +
                      (int64_t)(d0 + i0) * N + jc;
    // pass A: the tile's state before sub-chunks 1 … NSUB − 1
    {
      float st[4][4];
      scan_tile_load(st, ck, N);
      for (int q = 1; q < NSUB; ++q) {
#pragma unroll
        for (int sl = 0; sl < SUB; ++sl) fwd(st, SUB * (q - 1) + sl);
        float* sp = stash + (q - 1) * 16 * THREADS;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          reinterpret_cast<float4*>(sp)[e * THREADS + tid] =
              make_float4(st[e][0], st[e][1], st[e][2], st[e][3]);
        }
      }
    }
    // pass B: the sub-chunks from the last, each's steps backward
    for (int q = NSUB - 1; q >= 0; --q) {
      float s4[SUB][4][4];   // the state before each of its steps
      if (q == 0) {
        scan_tile_load(s4[0], ck, N);
      } else {
        const float* sp = stash + (q - 1) * 16 * THREADS;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 v = reinterpret_cast<const float4*>(sp)[e * THREADS +
                                                                tid];
          s4[0][e][0] = v.x, s4[0][e][1] = v.y, s4[0][e][2] = v.z,
          s4[0][e][3] = v.w;
        }
      }
#pragma unroll
      for (int sl = 1; sl < SUB; ++sl) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s4[sl][ii][jj] = s4[sl - 1][ii][jj];
        }
        fwd(s4[sl], SUB * q + sl - 1);
      }
      const int par = sub & 1;
#pragma unroll
      for (int sl = SUB - 1; sl >= 0; --sl) {
        const int tl = SUB * q + sl;
        const float dl = dts[tl], e = expf(dl * a_h);
        float x4[4], y4[4], b4[4], c4[4];
        scan_load4(xs + tl * ROWS + i0, x4);
        scan_load4(ys + tl * ROWS + i0, y4);
        scan_load4(bs + tl * N + jc, b4);
        scan_load4(cs + tl * N + jc, c4);
        float gbr[4], gx[4] = {0.f, 0.f, 0.f, 0.f};
        float ch[4] = {0.f, 0.f, 0.f, 0.f}, gh = 0.f;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float dxi = dl * x4[ii];
          float acc = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float hp = s4[sl][ii][jj];
            const float hn = fmaf(e, hp, dxi * b4[jj]);
            const float g = fmaf(y4[ii], c4[jj], Q[ii][jj]);
            acc = fmaf(g, b4[jj], acc);
            gx[jj] = fmaf(g, x4[ii], gx[jj]);
            ch[jj] = fmaf(y4[ii], hn, ch[jj]);
            gh = fmaf(g, hp, gh);
            Q[ii][jj] = e * g;
          }
          gbr[ii] = acc;
        }
        // G·B: over the warp's column groups
        scan_butterfly<4, ROUNDS>(gbr, cg);
        if (cg < 4) {
          gb_s[(par * SUB + sl) * ROWS + i0 + scan_bfly_mine<4, ROUNDS>(cg)] =
              gbr[0];
        }
        // G·x and dy·h: over the warp's row groups, then (after the
        // barrier) the warps
#pragma unroll
        for (int m = CG; m < 32; m <<= 1) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            gx[jj] += __shfl_xor_sync(0xffffffffu, gx[jj], m);
            ch[jj] += __shfl_xor_sync(0xffffffffu, ch[jj], m);
          }
        }
        if (lane < CG) {
          float* cw = col_s + ((par * SUB + sl) * WARPS + wp) * 2 * N + jc;
          *reinterpret_cast<float4*>(cw) =
              make_float4(gx[0], gx[1], gx[2], gx[3]);
          *reinterpret_cast<float4*>(cw + N) =
              make_float4(ch[0], ch[1], ch[2], ch[3]);
        }
        gh = scan_warp_sum(gh);
        if (lane == 0) gh_s[(par * SUB + sl) * WARPS + wp] = gh;
      }
      __syncthreads();
      // the sub-chunk's dx and its parts of dB, dC, ddt and da
      const int64_t tb = (int64_t)c * SCAN_T + SUB * q;
      for (int e = tid; e < SUB * ROWS; e += THREADS) {
        const int sl = e / ROWS, d = e % ROWS, tl = SUB * q + sl;
        if (tb + sl < S) {
          dx[x_base + (tb + sl) * x_step + d] = scan_from_float<T>(
              dts[tl] * gb_s[(par * SUB + sl) * ROWS + d]);
        }
      }
      for (int e = tid; e < SUB * N; e += THREADS) {
        const int sl = e / N, m = e % N, tl = SUB * q + sl;
        if (tb + sl < S) {
          float gxs = 0.f, chs = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) {
            const float* cw = col_s + ((par * SUB + sl) * WARPS + w) * 2 * N;
            gxs += cw[m];
            chs += cw[N + m];
          }
          const int64_t at = (((int64_t)h * NR + rb) * B + b) * S * N +
                             (tb + sl) * N + m;
          db_part[at] = dts[tl] * gxs;
          dc_part[at] = chs;
        }
      }
      if (wp == 0) {
#pragma unroll
        for (int sl = 0; sl < SUB; ++sl) {
          const int tl = SUB * q + sl;
          if (tb + sl < S) {
            const float xg =
                lane < ROWS ? scan_to_float(xs[tl * ROWS + lane]) *
                                  gb_s[(par * SUB + sl) * ROWS + lane]
                            : 0.f;
            const float xgs = scan_warp_sum(xg);
            float ghs = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) {
              ghs += gh_s[(par * SUB + sl) * WARPS + w];
            }
            const float dl = dts[tl], e = expf(dl * a_h);
            if (lane == 0) {
              ddt_part[(int64_t)rb * B * S * H + dt_base + (tb + sl) * H] =
                  fmaf(a_h * e, ghs, xgs);
              da_acc = fmaf(dl * e, ghs, da_acc);
            }
          }
        }
      }
      ++sub;
    }
  }
  scan_tile_store(dh0 + state + (int64_t)i0 * N + jc, N, Q);
  if (tid == 0) da_part[((int64_t)rb * B + b) * H + h] = da_acc;
}

template <int N, typename T>
static int launch_ssd_bwd(const void* x, const void* Bv, const void* Cv,
                          const void* dt, const void* a, const void* ckpt,
                          const void* dy, const void* dh_last, void* dx,
                          void* dB, void* dC, void* ddt, void* da, void* dh0,
                          void* part, int B, int64_t S, int H, int D,
                          cudaStream_t stream) {
  using L = SsdBwd<N, T>;
  if (D % L::ROWS) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t e =
      scan_smem_limit(ssd_bwd_kernel<N, T>, L::SMEM_BYTES, &smem_set);
  if (e != cudaSuccess) return (int)e;
  const int NR = D / L::ROWS;
  const int64_t bsn = (int64_t)B * S * N, bsh = (int64_t)B * S * H;
  float* db_part = (float*)part;
  float* dc_part = db_part + (int64_t)H * NR * bsn;
  float* ddt_part = dc_part + (int64_t)H * NR * bsn;
  float* da_part = ddt_part + NR * bsh;
  const dim3 grid(NR, H, B);
  ssd_bwd_kernel<N, T><<<grid, L::THREADS, L::SMEM_BYTES, stream>>>(
      (const T*)x, (const T*)Bv, (const T*)Cv, (const float*)dt,
      (const float*)a, (const float*)ckpt, (const float*)dy,
      (const float*)dh_last, (T*)dx, db_part, dc_part, ddt_part, da_part,
      (float*)dh0, S, H, D);
  e = cudaGetLastError();
  // the second pass: dB and dC over the heads and row blocks, ddt over the
  // row blocks, da over the row blocks and batch rows
  if (e == cudaSuccess) e = scan_sum<T>(db_part, H * NR, bsn, bsn, (T*)dB,
                                        stream);
  if (e == cudaSuccess) e = scan_sum<T>(dc_part, H * NR, bsn, bsn, (T*)dC,
                                        stream);
  if (e == cudaSuccess) e = scan_sum<float>(ddt_part, NR, bsh, bsh,
                                            (float*)ddt, stream);
  if (e == cudaSuccess) e = scan_sum<float>(da_part, NR * B, H, H,
                                            (float*)da, stream);
  return (int)e;
}

template <typename T>
static int dispatch_ssd_bwd(const void* x, const void* Bv, const void* Cv,
                            const void* dt, const void* a, const void* ckpt,
                            const void* dy, const void* dh_last, void* dx,
                            void* dB, void* dC, void* ddt, void* da,
                            void* dh0, void* part, int B, int64_t S, int H,
                            int D, int n, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch_ssd_bwd<16, T>(x, Bv, Cv, dt, a, ckpt, dy, dh_last, dx,
                                   dB, dC, ddt, da, dh0, part, B, S, H, D,
                                   stream);
    case 32:
      return launch_ssd_bwd<32, T>(x, Bv, Cv, dt, a, ckpt, dy, dh_last, dx,
                                   dB, dC, ddt, da, dh0, part, B, S, H, D,
                                   stream);
    case 64:
      return launch_ssd_bwd<64, T>(x, Bv, Cv, dt, a, ckpt, dy, dh_last, dx,
                                   dB, dC, ddt, da, dh0, part, B, S, H, D,
                                   stream);
    case 128:
      return launch_ssd_bwd<128, T>(x, Bv, Cv, dt, a, ckpt, dy, dh_last, dx,
                                    dB, dC, ddt, da, dh0, part, B, S, H, D,
                                    stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x [B, S, H, D], Bv, Cv [B, S, n] (T), dt [B, S, H] and a [H] float32,
// ckpt [B, H, ceil(S / 32), D, n] float32 (ssd_scan's), dy [B, S, H, D]
// float32, dh_last [B, H, D, n] float32 or null for zeros → dx (T), dB,
// dC (T), ddt float32, da [H] and dh0 [B, H, D, n] float32. Scratch: part,
// float32, 2·H·NR·B·S·n + NR·B·S·H + NR·B·H elements (NR = D / 32 row
// blocks, D / 16 at n = 128).
extern "C" int fw_ssd_scan_bwd(const void* x, const void* Bv, const void* Cv,
                               const void* dt, const void* a,
                               const void* ckpt, const void* dy,
                               const void* dh_last, void* dx, void* dB,
                               void* dC, void* ddt, void* da, void* dh0,
                               void* part, int32_t B, int64_t S, int32_t H,
                               int32_t D, int32_t n, int32_t bf16,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (D <= 0 || D % SCAN_COLS) return (int)cudaErrorInvalidValue;
  return bf16 ? dispatch_ssd_bwd<__nv_bfloat16>(
                    x, Bv, Cv, dt, a, ckpt, dy, dh_last, dx, dB, dC, ddt, da,
                    dh0, part, B, S, H, D, n, (cudaStream_t)stream)
              : dispatch_ssd_bwd<float>(
                    x, Bv, Cv, dt, a, ckpt, dy, dh_last, dx, dB, dC, ddt, da,
                    dh0, part, B, S, H, D, n, (cudaStream_t)stream);
}
