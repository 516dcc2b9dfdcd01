// wkv6_scan_bwd: the gradient of wkv6_scan, RWKV-6's time recurrence
// (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel for the
// recurrence; XLA differentiates its lax.scan (src/repro/models/rwkv6.py:
// 121-134, under chunked_scan). The port adds it because autograd through
// the plain per-step loop costs seconds a layer at the training shape and
// keeps every step's state.
//
// Per (batch, head), S [D key rows i, D value columns j] in float32, G the
// gradient of the state after step t (dS_last after the last step):
//
//   dr_t = S_{t-1} dO_t + u o k_t (dO_t . v_t)
//   dk_t = G v_t + u o r_t (dO_t . v_t)
//   dv_t = G^T k_t + dO_t (sum_i r_t u k_t)
//   dw_t = rowsum(G o S_{t-1}),   du = sum_{b,t} r_t o k_t (dO_t . v_t)
//   G   <- diag(w_t) G + r_t dO_t^T,   dS0 = the last G
//
// S_{t-1} comes from the forward kernel's checkpoints (wkv6.cu writes the
// state before every 32-step chunk when asked, [B, H, ceil(S/32), D, D]
// float32), never from dividing by w: w = exp(-exp(.)) underflows to 0.
// Inputs are the forward's (r, k, v and dO in float32 or bfloat16, widened
// in registers; w, u float32); everything is computed in float32 and each
// gradient rounded once to its input's type.
//
// A CTA owns COLS value columns of one head for all D key rows (all 64 at
// rwkv6-3b's D = 64, so dr, dk and dw are whole in the CTA: 80 CTAs at
// B = 2, H = 40), a thread a 4 × 4 tile of the state and of G in
// registers. It walks the chunks from the last; each chunk's rows are
// copied with cp.async into one of two stages while the chunk before runs.
// A chunk runs in 8 sub-chunks of 4 steps: pass A steps the tile from the
// chunk's checkpoint and keeps its state before each sub-chunk in shared
// memory (a thread reads back only what it wrote, so no barrier); pass B
// takes the sub-chunks from the last, steps the 4 states of one into
// registers and runs its 4 steps backward. A step's row sums (dr, dk, dw:
// over the tile's columns, then over the warp's column groups) go through
// a transposing shuffle butterfly (scan_butterfly), its column sums (dv)
// over the warp's row groups by shuffles and over the warps through
// shared memory; after each sub-chunk one barrier, then the CTA writes
// the sub-chunk's gradients with the bonus terms. Every sum runs in a
// fixed order: no float atomics. du's sum over the batch rows (and, at
// D = 128, where a CTA owns 16 of the columns, dr's, dk's and dw's over
// the column CTAs) goes through per-CTA partials that a second pass
// (scan_sum_kernel) adds in a fixed order, so the bytes repeat run to run.
// The recomputed states use the forward's operation order, so they are
// the forward's own values.
//
// Bound at rwkv6-3b's training shape (B 2, S 4,096, H 40, D 64; r, k, v,
// dO and dr, dk, dv bf16, w and dw float32): 632 MB moved (the inputs, the
// checkpoints' 168 MB and the gradients once each), 0.19 ms at 3.35 TB/s;
// 14 float32 operations a state element and step (the state's recompute
// from its checkpoint 3, G's update 3, the four products 8), 18.8 GFLOP,
// 0.28 ms at 67 TFLOP/s: operation-bound. The design runs the recompute
// twice (pass A, pass B; 17 operations) and is issue-bound besides: each
// step's butterfly and shuffles, one warp of 8 a scheduler's pair, and
// 80 CTAs leave 52 SMs idle at B = 2. The chunked form (intra-chunk
// products on the tensor cores, log-space sub-chunks for the per-channel
// decay) is queued as later work (ROADMAP.md Queue 2).
#include "scan.cuh"

template <int N, typename T>
struct Wkv6Bwd {
  static constexpr int COLS = N == 128 ? 16 : N;   // value columns a CTA
  static constexpr int NC = N / COLS;              // CTAs a head
  static constexpr int CG = COLS / 4, RG = N / 4;  // column, row groups
  static constexpr int THREADS = CG * RG, WARPS = THREADS / 32;
  static constexpr int RPW = 32 / CG;              // row groups a warp
  static constexpr int SUB = 4, NSUB = SCAN_T / SUB;
  static constexpr int NV = 16;   // a step's row parts: 4 rows x dr, dk, dw, 0
  static constexpr int ROUNDS = scan_log2(CG);
  static constexpr int KEEP = ScanBfly<NV, ROUNDS>::KEEP;
  // a stage (bytes): SCAN_T rows of w (float32), r and k (T), and this
  // CTA's columns of v and dO (T)
  static constexpr int R_AT = SCAN_T * N * 4;
  static constexpr int K_AT = R_AT + SCAN_T * N * (int)sizeof(T);
  static constexpr int V_AT = K_AT + SCAN_T * N * (int)sizeof(T);
  static constexpr int O_AT = V_AT + SCAN_T * COLS * (int)sizeof(T);
  static constexpr int STAGE = O_AT + SCAN_T * COLS * (int)sizeof(T);
  // then in float32: the stash (each thread's tile before sub-chunks
  // 1 … NSUB − 1), a sub-chunk's row sums [SUB][3][N] and column parts
  // [SUB][WARPS][COLS] (two of each, by sub-chunk parity), the chunk's
  // bonus and dO·v sums
  static constexpr int STASH = (NSUB - 1) * 16 * THREADS;
  static constexpr int ROWS = 2 * SUB * 3 * N;
  static constexpr int DVS = 2 * SUB * WARPS * COLS;
  static constexpr int SMEM_BYTES =
      2 * STAGE + 4 * (STASH + ROWS + DVS + 2 * SCAN_T);
  static_assert(THREADS % 32 == 0 && N <= THREADS, "layout");
  static_assert(STAGE % 16 == 0 && SMEM_BYTES <= 232448, "shared memory");
};

template <int N, typename T>
__global__ void __launch_bounds__(Wkv6Bwd<N, T>::THREADS, 1)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ ckpt,
                    const T* __restrict__ dout,
                    const float* __restrict__ ds_last, T* __restrict__ dr,
                    T* __restrict__ dk, T* __restrict__ dv,
                    float* __restrict__ dw, float* __restrict__ part,
                    float* __restrict__ du_part, float* __restrict__ ds0,
                    int64_t S, int H) {
  using L = Wkv6Bwd<N, T>;
  constexpr int COLS = L::COLS, CG = L::CG, THREADS = L::THREADS;
  constexpr int WARPS = L::WARPS, SUB = L::SUB, NSUB = L::NSUB;
  constexpr int NV = L::NV, ROUNDS = L::ROUNDS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stash = reinterpret_cast<float*>(smem + 2 * L::STAGE);
  float* rows_s = stash + L::STASH;
  float* dv_s = rows_s + L::ROWS;
  float* bonus_s = dv_s + L::DVS;
  float* dov_s = bonus_s + SCAN_T;

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int cg = lane % CG, rg = wp * L::RPW + lane / CG;
  const int i0 = 4 * rg, jc = 4 * cg;   // the tile: rows i0 …, columns j0 + jc …
  const int cx = blockIdx.x, j0 = cx * COLS, h = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z;
  const int64_t step = (int64_t)H * N;                   // one time step
  const int64_t base = ((int64_t)b * S * H + h) * N;     // (b, 0, h, 0)
  const int64_t state = ((int64_t)b * H + h) * N * N;    // S[b, h]
  const int nch = (int)((S + SCAN_T - 1) / SCAN_T);
  auto stage = [&](int c) { return smem + (c & 1) * L::STAGE; };

  // chunk c's rows into its stage; the rows past the sequence's end get
  // w = 1 and zeros, steps that leave the state and G as they are
  auto issue = [&](int c) {
    const int64_t t0 = (int64_t)c * SCAN_T, at = base + t0 * step;
    const int steps = scan_steps(S, t0);
    unsigned char* sg = stage(c);
    scan_copy_rows<N * 4 / 16>(
        sg, reinterpret_cast<const unsigned char*>(w + at), step * 4, steps,
        tid, THREADS);
    scan_copy_rows<N * (int)sizeof(T) / 16>(
        sg + L::R_AT, reinterpret_cast<const unsigned char*>(r + at),
        step * sizeof(T), steps, tid, THREADS);
    scan_copy_rows<N * (int)sizeof(T) / 16>(
        sg + L::K_AT, reinterpret_cast<const unsigned char*>(k + at),
        step * sizeof(T), steps, tid, THREADS);
    scan_copy_rows<COLS * (int)sizeof(T) / 16>(
        sg + L::V_AT, reinterpret_cast<const unsigned char*>(v + at + j0),
        step * sizeof(T), steps, tid, THREADS);
    scan_copy_rows<COLS * (int)sizeof(T) / 16>(
        sg + L::O_AT, reinterpret_cast<const unsigned char*>(dout + at + j0),
        step * sizeof(T), steps, tid, THREADS);
    scan_cp_async_commit();
    if (steps < SCAN_T) {
      float* ws = reinterpret_cast<float*>(sg);
      for (int e = steps * N + tid; e < SCAN_T * N; e += THREADS) ws[e] = 1.f;
      const int rk = N * (int)sizeof(T), vo = COLS * (int)sizeof(T);
      scan_zero(sg + L::R_AT + steps * rk, (SCAN_T - steps) * rk, tid,
                THREADS);
      scan_zero(sg + L::K_AT + steps * rk, (SCAN_T - steps) * rk, tid,
                THREADS);
      scan_zero(sg + L::V_AT + steps * vo, (SCAN_T - steps) * vo, tid,
                THREADS);
      scan_zero(sg + L::O_AT + steps * vo, (SCAN_T - steps) * vo, tid,
                THREADS);
    }
  };

  float ul[N / 32];   // u at rows lane, lane + 32, … (the bonus sums)
#pragma unroll
  for (int i = 0; i < N / 32; ++i) ul[i] = u[(int64_t)h * N + lane + 32 * i];
  const float u_row = tid < N ? u[(int64_t)h * N + tid] : 0.f;

  float G[4][4];
  if (ds_last) {
    scan_tile_load(G, ds_last + state + (int64_t)i0 * N + j0 + jc, N);
  } else {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) G[ii][jj] = 0.f;
    }
  }
  float du_acc = 0.f;
  int sub = 0;   // sub-chunks run, for the parity of the double buffers

  issue(nch - 1);
  for (int c = nch - 1; c >= 0; --c) {
    scan_cp_async_wait_all();
    __syncthreads();
    if (c > 0) issue(c - 1);
    const unsigned char* sg = stage(c);
    const float* ws = reinterpret_cast<const float*>(sg);
    const T* rs = reinterpret_cast<const T*>(sg + L::R_AT);
    const T* ks = reinterpret_cast<const T*>(sg + L::K_AT);
    const T* vs = reinterpret_cast<const T*>(sg + L::V_AT);
    const T* os = reinterpret_cast<const T*>(sg + L::O_AT);
    // the chunk's per-step sums, a warp a step: the bonus sum_i r u k over
    // all rows, dO·v over this CTA's columns (read after the first
    // sub-chunk's barrier)
    for (int s = wp; s < SCAN_T; s += WARPS) {
      float bo = 0.f, dov = 0.f;
#pragma unroll
      for (int i = 0; i < N / 32; ++i) {
        const int row = s * N + lane + 32 * i;
        bo = fmaf(scan_to_float(rs[row]) * ul[i], scan_to_float(ks[row]), bo);
      }
      for (int j = lane; j < COLS; j += 32) {
        dov = fmaf(scan_to_float(os[s * COLS + j]),
                   scan_to_float(vs[s * COLS + j]), dov);
      }
      bo = scan_warp_sum(bo);
      dov = scan_warp_sum(dov);
      if (lane == 0) {
        bonus_s[s] = bo;
        dov_s[s] = dov;
      }
    }
    // one forward step of the tile: the forward kernel's operations
    auto fwd = [&](float (&st)[4][4], int tl) {
      float k4[4], w4[4], v4[4];
      scan_load4(ks + tl * N + i0, k4);
      scan_load4(ws + tl * N + i0, w4);
      scan_load4(vs + tl * COLS + jc, v4);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          st[ii][jj] = fmaf(w4[ii], st[ii][jj], k4[ii] * v4[jj]);
        }
      }
    };
    const float* ck = ckpt + (((int64_t)b * H + h) * nch + c) * N * N +
                      (int64_t)i0 * N + j0 + jc;
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
          const float4 x = reinterpret_cast<const float4*>(sp)[e * THREADS +
                                                                tid];
          s4[0][e][0] = x.x, s4[0][e][1] = x.y, s4[0][e][2] = x.z,
          s4[0][e][3] = x.w;
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
        float r4[4], k4[4], w4[4], v4[4], o4[4];
        scan_load4(rs + tl * N + i0, r4);
        scan_load4(ks + tl * N + i0, k4);
        scan_load4(ws + tl * N + i0, w4);
        scan_load4(vs + tl * COLS + jc, v4);
        scan_load4(os + tl * COLS + jc, o4);
        float p[NV], dvp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          float a_dr = 0.f, a_dk = 0.f, a_dw = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float sp = s4[sl][ii][jj], g = G[ii][jj];
            a_dr = fmaf(o4[jj], sp, a_dr);
            a_dk = fmaf(g, v4[jj], a_dk);
            a_dw = fmaf(g, sp, a_dw);
            dvp[jj] = fmaf(g, k4[ii], dvp[jj]);
            G[ii][jj] = fmaf(w4[ii], g, r4[ii] * o4[jj]);
          }
          p[4 * ii] = a_dr;
          p[4 * ii + 1] = a_dk;
          p[4 * ii + 2] = a_dw;
          p[4 * ii + 3] = 0.f;
        }
        // dr, dk, dw: over the warp's column groups
        scan_butterfly<NV, ROUNDS>(p, cg);
        const int mine = scan_bfly_mine<NV, ROUNDS>(cg);
        float* rw = rows_s + (par * SUB + sl) * 3 * N;
#pragma unroll
        for (int e = 0; e < L::KEEP; ++e) {
          const int idx = mine + e;
          if ((idx & 3) < 3) rw[(idx & 3) * N + i0 + (idx >> 2)] = p[e];
        }
        // dv: over the warp's row groups, then (after the barrier) warps
#pragma unroll
        for (int m = CG; m < 32; m <<= 1) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            dvp[jj] += __shfl_xor_sync(0xffffffffu, dvp[jj], m);
          }
        }
        if (lane < CG) {
          *reinterpret_cast<float4*>(
              dv_s + ((par * SUB + sl) * WARPS + wp) * COLS + jc) =
              make_float4(dvp[0], dvp[1], dvp[2], dvp[3]);
        }
      }
      __syncthreads();
      // the sub-chunk's gradients
      const int64_t tb = (int64_t)c * SCAN_T + SUB * q;
      for (int e = tid; e < SUB * COLS; e += THREADS) {
        const int sl = e / COLS, j = e % COLS, tl = SUB * q + sl;
        if (tb + sl < S) {
          float acc = 0.f;
#pragma unroll
          for (int x = 0; x < WARPS; ++x) {
            acc += dv_s[((par * SUB + sl) * WARPS + x) * COLS + j];
          }
          acc = fmaf(scan_to_float(os[tl * COLS + j]), bonus_s[tl], acc);
          dv[base + (tb + sl) * step + j0 + j] = scan_from_float<T>(acc);
        }
      }
      if (tid < N) {
#pragma unroll
        for (int sl = 0; sl < SUB; ++sl) {
          const int tl = SUB * q + sl;
          if (tb + sl < S) {
            const float* rw = rows_s + (par * SUB + sl) * 3 * N;
            const float rr = scan_to_float(rs[tl * N + tid]);
            const float kk = scan_to_float(ks[tl * N + tid]);
            const float dov = dov_s[tl];
            const float gr = fmaf(u_row * kk, dov, rw[tid]);
            const float gk = fmaf(u_row * rr, dov, rw[N + tid]);
            const float gw = rw[2 * N + tid];
            du_acc = fmaf(rr * kk, dov, du_acc);
            const int64_t at = base + (tb + sl) * step + tid;
            if (part) {   // a column CTA's parts of the row sums
              const int64_t tot = (int64_t)B * S * step;
              float* pp = part + (int64_t)cx * 3 * tot + at;
              pp[0] = gr;
              pp[tot] = gk;
              pp[2 * tot] = gw;
            } else {
              dr[at] = scan_from_float<T>(gr);
              dk[at] = scan_from_float<T>(gk);
              dw[at] = gw;
            }
          }
        }
      }
      ++sub;
    }
  }
  scan_tile_store(ds0 + state + (int64_t)i0 * N + j0 + jc, N, G);
  if (tid < N) du_part[(((int64_t)cx * B + b) * H + h) * N + tid] = du_acc;
}

template <int N, typename T>
static int launch_wkv6_bwd(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* ckpt,
                           const void* dout, const void* ds_last, void* dr,
                           void* dk, void* dv, void* dw, void* du, void* ds0,
                           void* part, void* du_part, int B, int64_t S,
                           int H, cudaStream_t stream) {
  using L = Wkv6Bwd<N, T>;
  if (L::NC > 1 && !part) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t e =
      scan_smem_limit(wkv6_bwd_kernel<N, T>, L::SMEM_BYTES, &smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(L::NC, H, B);
  wkv6_bwd_kernel<N, T><<<grid, L::THREADS, L::SMEM_BYTES, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, (const float*)ckpt, (const T*)dout,
      (const float*)ds_last, (T*)dr, (T*)dk, (T*)dv, (float*)dw,
      L::NC > 1 ? (float*)part : nullptr, (float*)du_part, (float*)ds0, S,
      H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the second pass: du over the batch rows and the column CTAs, and at
  // NC > 1 the row sums over the column CTAs
  const int64_t hn = (int64_t)H * N;
  e = scan_sum<float>((const float*)du_part, L::NC * B, hn, hn, (float*)du,
                      stream);
  if (e != cudaSuccess || L::NC == 1) return (int)e;
  const int64_t tot = (int64_t)B * S * hn;
  const float* pp = (const float*)part;
  e = scan_sum<T>(pp, L::NC, 3 * tot, tot, (T*)dr, stream);
  if (e == cudaSuccess) e = scan_sum<T>(pp + tot, L::NC, 3 * tot, tot,
                                        (T*)dk, stream);
  if (e == cudaSuccess) e = scan_sum<float>(pp + 2 * tot, L::NC, 3 * tot,
                                            tot, (float*)dw, stream);
  return (int)e;
}

template <typename T>
static int dispatch_wkv6_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* ckpt,
                             const void* dout, const void* ds_last, void* dr,
                             void* dk, void* dv, void* dw, void* du,
                             void* ds0, void* part, void* du_part, int B,
                             int64_t S, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_wkv6_bwd<32, T>(r, k, v, w, u, ckpt, dout, ds_last, dr,
                                    dk, dv, dw, du, ds0, part, du_part, B, S,
                                    H, stream);
    case 64:
      return launch_wkv6_bwd<64, T>(r, k, v, w, u, ckpt, dout, ds_last, dr,
                                    dk, dv, dw, du, ds0, part, du_part, B, S,
                                    H, stream);
    case 128:
      return launch_wkv6_bwd<128, T>(r, k, v, w, u, ckpt, dout, ds_last, dr,
                                     dk, dv, dw, du, ds0, part, du_part, B,
                                     S, H, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// r, k, v, dout [B, S, H, D] (T), w [B, S, H, D] and u [H, D] float32,
// ckpt [B, H, ceil(S / 32), D, D] float32 (wkv6_scan's), ds_last [B, H, D,
// D] float32 or null for zeros → dr, dk, dv (T), dw float32 [B, S, H, D],
// du [H, D] and ds0 [B, H, D, D] float32. Scratch: du_part [NC·B, H, D]
// float32 and, at D = 128 (NC = 8 column CTAs a head), part [NC, 3, B, S,
// H, D] float32 (null otherwise).
extern "C" int fw_wkv6_scan_bwd(const void* r, const void* k, const void* v,
                                const void* w, const void* u,
                                const void* ckpt, const void* dout,
                                const void* ds_last, void* dr, void* dk,
                                void* dv, void* dw, void* du, void* ds0,
                                void* part, void* du_part, int32_t B,
                                int64_t S, int32_t H, int32_t D, int32_t bf16,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  return bf16 ? dispatch_wkv6_bwd<__nv_bfloat16>(
                    r, k, v, w, u, ckpt, dout, ds_last, dr, dk, dv, dw, du,
                    ds0, part, du_part, B, S, H, D, (cudaStream_t)stream)
              : dispatch_wkv6_bwd<float>(
                    r, k, v, w, u, ckpt, dout, ds_last, dr, dk, dv, dw, du,
                    ds0, part, du_part, B, S, H, D, (cudaStream_t)stream);
}
