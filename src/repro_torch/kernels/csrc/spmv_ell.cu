// spmv_ell_slab: the ELL slab of the hybrid SpMV, y = P x in pull form.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell.py:49
// ``spmv_ell_slab`` (pallas_call at :60, body ``_spmv_kernel`` at :40).
//
//   y[r] = sum_{k < K} w[r, k] * x[idx[r, k]]     (float32)
//
// The COO spill tail stays outside the kernel (ops.spmv adds it, as the
// reference's wrapper does).
//
// Live lanes only. to_ell fills each row's first row_len[r] = min(in_deg,
// K) lanes and pads the rest with w = 0, idx = 0; the TPU kernel reads and
// multiplies every padded lane. Given row_len, this kernel reads only the
// live prefix of each row (at LiveJournal scale 36.5 M of the slab's
// 155.1 M lanes: 76% are padding). Without row_len (nullptr) every lane is
// live, for a bare slab.
//
// Exactness. Each row is summed in order, k = 0 .. len-1, from +0, each
// product and sum rounded on its own (__fmul_rn / __fadd_rn: nvcc would
// otherwise contract them into an FMA): the plain PyTorch version's
// (kernels/ref.py:spmv_ref) order. spmv_ref goes on to add 0 * x[0] for
// each padded lane, which is +-0 for a finite x[0], and y + (+-0) == y
// bit for bit unless y is -0; a round-to-nearest sum starting from +0 is
// -0 only if both addends are -0, so y never is (a row whose live products
// are all -0 sums to +0 in both). So with row_len the kernel is byte-equal
// to spmv_ref whenever x[0] is finite, which is all a power iteration
// feeds it; a non-finite x[0] makes spmv_ref's padded rows NaN and not the
// kernel's. Without row_len it is byte-equal for any x.
//
// Design. A warp owns 32 rows (a group) and walks its groups with a grid
// stride (a persistent grid of as many CTAs as the card holds at once).
// For each window of 32 lanes of its rows (one window at K <= 32), a warp
// scan of the rows' live lengths in the window lays their live lanes end
// to end, and the warp's 32 threads take consecutive live lanes: each
// thread finds its row by a binary search over the scan (shuffles), so no
// thread idles on padding and each row's live prefix is read at
// contiguous addresses (streaming loads, evict-first, so that x keeps its
// place in L2). Each thread gathers x[idx], forms its product and stages
// it in shared memory (element e at e + e/32: conflict-free writes, and
// conflict-free reads when every row is full); then lane r adds row r's
// products in order. Loads stay in flight during those adds: the next
// group's row lengths are loaded when a group starts, and the next
// window's (or next group's) first 128 live lanes are issued just before
// the adds. x is gathered through L1 and L2 (19.4 MB at LiveJournal scale,
// within the 50 MB L2). Index math is int64: the LiveJournal slab has
// rows*K = 155 M lanes.
//
// Bound (bytes, 3.35 TB/s): 8 B per live lane (idx and w), row_len, x and
// y each once: 0.35 GB at LiveJournal scale, >= 0.105 ms; the live
// prefixes in whole 32-byte sectors (each row starts a 128-byte line) are
// 0.44 GB, >= 0.148 ms.
//
// What bounds it. ncu does not run on the card's machine. chip_smoke.py
// phase 12 times this kernel beside cuSPARSE's CSR SpMV, over every lane,
// and over the live lanes with every id set to 0, which turns the x
// gathers into cache hits and leaves the slab's reads (PERF.md has the
// readings): the second time is the scattered sector reads of the live
// prefixes, and the gap between the two what the x gathers add over them.
// The streaming loads leave L2 to x. Edited builds tried while writing it
// (the slab read through __ldg, 2 or 8 live lanes loaded at once a
// thread, 6 CTAs an SM) were no faster.
//
// Left on the table: the slab's 128-byte row stride, which scatters the
// live lanes over 1.5 times their bytes in sectors; a compacted slab (the
// layout's redesign, with the COO spill tail that costs six times this
// kernel in a power iteration) reads them end to end. A row of more than
// 32 live lanes (K > 32) takes one window per 32 lanes, each with its
// own scan and adds.
#include "common.cuh"

#define FW_SPMV_WARPS (FW_THREADS / 32)
#define FW_SPMV_STAGE (32 * 32 + 32)   // one window's products, skewed
#define FW_SPMV_BATCH 4                // live lanes a thread loads at once
#define FW_FULL 0xffffffffu

// Live lanes of row g*32 + lane: row_len clamped to [0, K], K without
// row_len, 0 past the last row.
__device__ __forceinline__ int32_t fw_row_len(const int32_t* row_len,
                                              int64_t g, int lane,
                                              int64_t rows, int32_t K) {
  const int64_t r = g * 32 + lane;
  if (r >= rows) return 0;
  if (row_len == nullptr) return K;
  const int32_t l = __ldg(row_len + r);
  return l < 0 ? 0 : (l > K ? K : l);
}

// One window of a group: lane r's live lanes in it (lw), where they start
// in the warp's compacted order (off), and the window's total.
struct FwWindow {
  int32_t lw, off, total;
};

__device__ __forceinline__ FwWindow fw_window(int32_t len, int32_t k0,
                                              int lane) {
  int32_t lw = len - k0;
  lw = lw < 0 ? 0 : (lw > 32 ? 32 : lw);
  int32_t inc = lw;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t t = __shfl_up_sync(FW_FULL, inc, d);
    if (lane >= d) inc += t;
  }
  return FwWindow{lw, inc - lw, __shfl_sync(FW_FULL, inc, 31)};
}

__device__ __forceinline__ int fw_skew(int32_t e) { return e + (e >> 5); }

// Issues the loads of the window's compacted lanes e0 + u*32 + lane.
__device__ __forceinline__ void fw_issue(const int32_t* __restrict__ idx,
                                         const float* __restrict__ w,
                                         int64_t row0, int32_t K, int32_t k0,
                                         const FwWindow& win, int32_t e0,
                                         int lane,
                                         int32_t (&id)[FW_SPMV_BATCH],
                                         float (&wv)[FW_SPMV_BATCH]) {
#pragma unroll
  for (int u = 0; u < FW_SPMV_BATCH; ++u) {
    const int32_t e = e0 + u * 32 + lane;
    // the row of lane e: the last row whose live lanes start at or before e
    int32_t r = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      if (__shfl_sync(FW_FULL, win.off, r + s) <= e) r += s;
    }
    const int32_t start = __shfl_sync(FW_FULL, win.off, r);
    id[u] = 0;
    wv[u] = 0.0f;
    if (e < win.total) {
      const int64_t at = (row0 + r) * (int64_t)K + k0 + (e - start);
      id[u] = __ldcs(idx + at);
      wv[u] = __ldcs(w + at);
    }
  }
}

// Gathers x for the issued lanes and stages their products.
__device__ __forceinline__ void fw_stage(const float* __restrict__ x,
                                         float* prod, const FwWindow& win,
                                         int32_t e0, int lane,
                                         const int32_t (&id)[FW_SPMV_BATCH],
                                         const float (&wv)[FW_SPMV_BATCH]) {
  float xv[FW_SPMV_BATCH];
#pragma unroll
  for (int u = 0; u < FW_SPMV_BATCH; ++u) {
    xv[u] = e0 + u * 32 + lane < win.total ? __ldg(x + id[u]) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < FW_SPMV_BATCH; ++u) {
    const int32_t e = e0 + u * 32 + lane;
    if (e < win.total) prod[fw_skew(e)] = __fmul_rn(wv[u], xv[u]);
  }
}

// Lane r adds row r's staged products of the window to acc, in order.
__device__ __forceinline__ float fw_sum(const float* prod,
                                        const FwWindow& win, float acc) {
  int32_t j = 0;
  for (; j + 4 <= win.lw; j += 4) {
    const float a = prod[fw_skew(win.off + j)];
    const float b = prod[fw_skew(win.off + j + 1)];
    const float c = prod[fw_skew(win.off + j + 2)];
    const float d = prod[fw_skew(win.off + j + 3)];
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, a), b), c), d);
  }
  for (; j < win.lw; ++j) acc = __fadd_rn(acc, prod[fw_skew(win.off + j)]);
  return acc;
}

__global__ void __launch_bounds__(FW_THREADS)
    spmv_ell_kernel(const int32_t* __restrict__ idx,
                    const float* __restrict__ w, const float* __restrict__ x,
                    const int32_t* __restrict__ row_len,
                    float* __restrict__ y, int64_t rows, int32_t K) {
  __shared__ float stage[FW_SPMV_WARPS][FW_SPMV_STAGE];
  const int lane = threadIdx.x & 31;
  float* prod = stage[threadIdx.x >> 5];
  const int64_t groups = (rows + 31) / 32;
  const int64_t stride = (int64_t)gridDim.x * FW_SPMV_WARPS;
  int64_t g = (int64_t)blockIdx.x * FW_SPMV_WARPS + (threadIdx.x >> 5);
  if (g >= groups) return;
  int32_t id[FW_SPMV_BATCH];
  float wv[FW_SPMV_BATCH];
  int32_t len = fw_row_len(row_len, g, lane, rows, K);
  FwWindow win = fw_window(len, 0, lane);
  fw_issue(idx, w, g * 32, K, 0, win, 0, lane, id, wv);
  for (; g < groups; g += stride) {
    const int64_t row0 = g * 32;
    const int32_t max_len = __reduce_max_sync(FW_FULL, len);
    const int32_t len_next = fw_row_len(row_len, g + stride, lane, rows, K);
    float acc = 0.0f;
    for (int32_t k0 = 0;;) {
      // the window's first batch was issued before the last adds
      fw_stage(x, prod, win, 0, lane, id, wv);
      for (int32_t e0 = 32 * FW_SPMV_BATCH; e0 < win.total;
           e0 += 32 * FW_SPMV_BATCH) {
        fw_issue(idx, w, row0, K, k0, win, e0, lane, id, wv);
        fw_stage(x, prod, win, e0, lane, id, wv);
      }
      __syncwarp();
      const FwWindow cur = win;
      k0 += 32;
      const bool last = k0 >= max_len;
      if (last) {   // the next group's first window
        len = len_next;
        win = fw_window(len, 0, lane);
        fw_issue(idx, w, row0 + stride * 32, K, 0, win, 0, lane, id, wv);
      } else {
        win = fw_window(len, k0, lane);
        fw_issue(idx, w, row0, K, k0, win, 0, lane, id, wv);
      }
      acc = fw_sum(prod, cur, acc);
      __syncwarp();
      if (last) break;
    }
    if (row0 + lane < rows) y[row0 + lane] = acc;
  }
}

// CTAs of the persistent grid: as many as the card holds at once (read
// once per device; the launch path pays for no query after the first).
static cudaError_t fw_spmv_grid(int64_t groups, unsigned int* blocks) {
  static int64_t cap_of[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int64_t cap = dev < 64 ? cap_of[dev] : 0;
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, spmv_ell_kernel, FW_THREADS, 0);
    if (err != cudaSuccess) return err;
    cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) cap_of[dev] = cap;
  }
  const int64_t need = (groups + FW_SPMV_WARPS - 1) / FW_SPMV_WARPS;
  *blocks = (unsigned int)(need < cap ? need : cap);
  return cudaSuccess;
}

extern "C" int fw_spmv_ell_slab(const void* idx, const void* w, const void* x,
                                const void* row_len, void* y, int64_t rows,
                                int32_t K, void* stream) {
  if (rows > 0) {
    unsigned int blocks = 0;
    const cudaError_t err = fw_spmv_grid((rows + 31) / 32, &blocks);
    if (err != cudaSuccess) return (int)err;
    spmv_ell_kernel<<<blocks, FW_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const float*)w, (const float*)x,
        (const int32_t*)row_len, (float*)y, rows, K);
  }
  return (int)cudaGetLastError();
}
