// spmv_ell_slab: the ELL slab of the hybrid SpMV, y = P x in pull form.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell.py:49
// ``spmv_ell_slab`` (pallas_call at :60, body ``_spmv_kernel`` at :40).
//
//   y[r] = sum_{k < K} w[r, k] * x[idx[r, k]]     (float32)
//
// Padded lanes carry w = 0 and an in-range idx; they are computed, not
// skipped, as the TPU kernel does. The COO spill tail stays outside the
// kernel (ops.spmv adds it, as the reference's wrapper does).
//
// Bound (bytes, 3.35 TB/s): the slab read once (8 B per lane), x read once
// and y written once: 1.28 GB at LiveJournal scale, >= 0.382 ms.
//
// Design. Each row is summed in order, k = 0 .. K-1, each product and sum
// rounded on its own (__fmul_rn / __fadd_rn: nvcc would otherwise contract
// them into an FMA), so the result is the plain PyTorch version's
// (kernels/ref.py:spmv_ref) byte for byte. The sum of a row is sequential;
// the loads and gathers need not be. A warp owns 32 rows and walks them in
// chunks of at most 32 lanes: the warp's 32 x KC chunk of the slab is read
// by consecutive lanes at consecutive addresses (coalesced), every lane
// gathers its x[idx] and forms its product, the products land in shared
// memory, and then lane i adds row i's KC products in order. One thread
// per row, reading its own row, would make every warp load touch 32 rows'
// lines and leave each thread's gathers waiting on its own loads: on an
// H100 80GB HBM3 at 700 W, at LiveJournal scale, that layout took 2.31 ms
// against this one's 0.95 ms (chip_smoke.py; PERF.md). The TPU kernel pinned x whole in VMEM;
// here x is gathered through L1 and L2 (19.4 MB at LiveJournal scale,
// within the 50 MB L2). Index math is int64: the LiveJournal slab has
// rows*K = 155 M lanes.
//
// Left on the table: a partial chunk (K not a multiple of 32) maps lanes
// with an integer division; 76% of the LiveJournal slab's lanes are
// padding, read and multiplied as the reference's layout requires.
#include "common.cuh"

#define FW_SPMV_CHUNK 32            // lanes per chunk (a warp's width)
#define FW_SPMV_STRIDE 33           // odd row stride: no bank conflicts
#define FW_SPMV_WARPS (FW_THREADS / 32)

__global__ void spmv_ell_kernel(const int32_t* __restrict__ idx,
                                const float* __restrict__ w,
                                const float* __restrict__ x,
                                float* __restrict__ y, int64_t rows,
                                int32_t K) {
  __shared__ float prod[FW_SPMV_WARPS][32 * FW_SPMV_STRIDE];
  const int lane = threadIdx.x & 31;
  float* p = prod[threadIdx.x >> 5];
  const int64_t row0 =
      ((int64_t)blockIdx.x * FW_SPMV_WARPS + (threadIdx.x >> 5)) * 32;
  if (row0 >= rows) return;
  const int64_t nrow = rows - row0 < 32 ? rows - row0 : 32;
  float acc = 0.0f;
  for (int32_t k0 = 0; k0 < K; k0 += FW_SPMV_CHUNK) {
    const int32_t kc = K - k0 < FW_SPMV_CHUNK ? K - k0 : FW_SPMV_CHUNK;
    if (kc == FW_SPMV_CHUNK) {
      // a full chunk: lane j reads lane k0 + j of each row in turn
#pragma unroll 8
      for (int32_t r = 0; r < 32; ++r) {
        if (r < nrow) {
          const int64_t at = (row0 + r) * (int64_t)K + k0 + lane;
          p[r * FW_SPMV_STRIDE + lane] =
              __fmul_rn(__ldg(w + at), __ldg(x + __ldg(idx + at)));
        }
      }
    } else {
      // the 32 x kc chunk: element q is row q / kc, lane k0 + q % kc
      for (int32_t q = lane; q < 32 * kc; q += 32) {
        const int32_t r = q / kc, j = q - r * kc;
        if (r < nrow) {
          const int64_t at = (row0 + r) * (int64_t)K + k0 + j;
          p[r * FW_SPMV_STRIDE + j] =
              __fmul_rn(__ldg(w + at), __ldg(x + __ldg(idx + at)));
        }
      }
    }
    __syncwarp();
    if (lane < nrow) {
      for (int32_t j = 0; j < kc; ++j) {
        acc = __fadd_rn(acc, p[lane * FW_SPMV_STRIDE + j]);
      }
    }
    __syncwarp();
  }
  if (lane < nrow) y[row0 + lane] = acc;
}

extern "C" int fw_spmv_ell_slab(const void* idx, const void* w, const void* x,
                                void* y, int64_t rows, int32_t K,
                                void* stream) {
  if (rows > 0) {
    const int64_t rows_per_block = 32 * FW_SPMV_WARPS;
    const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
    spmv_ell_kernel<<<(unsigned int)blocks, FW_THREADS, 0,
                      (cudaStream_t)stream>>>((const int32_t*)idx,
                                              (const float*)w, (const float*)x,
                                              (float*)y, rows, K);
  }
  return (int)cudaGetLastError();
}
