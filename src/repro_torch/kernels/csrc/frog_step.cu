// frog_step: one fused plain (p_s = 1) walker superstep.
//
// Replaces the TPU kernel src/repro/kernels/frog_step.py:84 ``frog_step``
// (pallas_call at :112, body ``_frog_step_kernel`` at :40).
//
//   d         = deg[pos[f]]
//   next[f]   = d > 0 ? col_idx[row_ptr[pos[f]] + abs(bits[f]) % d] : pos[f]
//   counts[pos[f]] += die[f]
//
// Design: one thread per frog; the death tally is an int32 atomicAdd into
// counts[] in device memory. The TPU kernel tallied by a one-hot
// compare-and-reduce over (vertex block x frog block) tiles only because
// the TPU has no HBM atomics; integer atomics give the same counts in any
// order, so the outputs are byte-equal to the plain version. Edge offsets
// are computed in int64 (row_ptr + slot nears 2^31 at Twitter scale).
//
// Bound (bytes only, 3.35 TB/s): 16 B per frog streamed (pos, die, bits,
// next), one 32-byte sector per distinct sector of deg[], row_ptr[] and
// col_idx[] the frogs touch (at most three per frog), plus the 4n-byte
// counts output written once.
//
// Left on the table: the three dependent scattered loads per frog are
// latency-bound (one frog per thread, no prefetch of the next frog's
// row); hub vertices make the atomics on counts[] contend; frogs are not
// sorted by vertex, so sectors shared by nearby frogs are re-fetched from
// L2 instead of being reused in registers or shared memory.
#include "common.cuh"

__global__ void frog_step_kernel(const int32_t* __restrict__ pos,
                                 const int32_t* __restrict__ die,
                                 const int32_t* __restrict__ bits,
                                 const int32_t* __restrict__ row_ptr,
                                 const int32_t* __restrict__ col_idx,
                                 const int32_t* __restrict__ deg,
                                 int32_t* __restrict__ next,
                                 int32_t* __restrict__ counts, int64_t N) {
  int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= N) return;
  int32_t p = pos[f];
  int32_t d = deg[p];
  int32_t nxt = p;
  if (d > 0) {
    nxt = col_idx[(int64_t)row_ptr[p] + fw_slot(bits[f], d)];
  }
  next[f] = nxt;
  int32_t k = die[f];
  if (k != 0) atomicAdd(&counts[p], k);
}

extern "C" int fw_frog_step(const void* pos, const void* die,
                            const void* bits, const void* row_ptr,
                            const void* col_idx, const void* deg, void* next,
                            void* counts, int64_t N, void* stream) {
  if (N > 0) {
    frog_step_kernel<<<fw_blocks(N), FW_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)die, (const int32_t*)bits,
        (const int32_t*)row_ptr, (const int32_t*)col_idx,
        (const int32_t*)deg, (int32_t*)next, (int32_t*)counts, N);
  }
  return (int)cudaGetLastError();
}
