// stitch_gather and stitch_step: one query stitch round against the walk
// index slab endpoints[n, R] (flat, int32).
//
// stitch_gather replaces the TPU kernel src/repro/kernels/stitch.py:161
// ``stitch_gather`` (pallas_call at :188, body ``_stitch_gather_kernel`` at
// :146):
//
//   next[w] = endpoints[pos[w] * R + abs(bits[w]) % R]
//
// stitch_step replaces src/repro/kernels/stitch.py:99 ``stitch_step``
// (pallas_call at :124, body ``_stitch_kernel`` at :64): the same gather,
// plus counts[pos[w]] += stop[w].
//
// Design: one thread per walk; the slab index is int64 (pos · R nears
// 2^31 at Twitter scale); the stop tally is an int32 atomicAdd, which the
// TPU replaced by a one-hot compare-and-reduce for want of HBM atomics.
// Outputs are byte-equal to the plain versions.
//
// Bound (bytes only, 3.35 TB/s): 12 B per walk streamed for the gather
// (pos, bits, next; stitch_step adds 4 B of stop), one 32-byte sector per
// distinct slab sector read, plus stitch_step's 4n-byte counts output
// written once.
//
// Left on the table: W is 8192 walks per wave, so a round is ~32 blocks on
// 132 SMs and launch latency dominates; fusing all q_max rounds of a wave
// into one launch (each walk loops over its rounds in registers) would
// remove q_max − 1 launches and the pos round trips.
#include "common.cuh"

__global__ void stitch_gather_kernel(const int32_t* __restrict__ pos,
                                     const int32_t* __restrict__ bits,
                                     const int32_t* __restrict__ endpoints,
                                     int32_t* __restrict__ next, int64_t W,
                                     int32_t R) {
  int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  next[w] = endpoints[(int64_t)pos[w] * R + fw_slot(bits[w], R)];
}

__global__ void stitch_step_kernel(const int32_t* __restrict__ pos,
                                   const int32_t* __restrict__ stop,
                                   const int32_t* __restrict__ bits,
                                   const int32_t* __restrict__ endpoints,
                                   int32_t* __restrict__ next,
                                   int32_t* __restrict__ counts, int64_t W,
                                   int32_t R) {
  int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int32_t p = pos[w];
  next[w] = endpoints[(int64_t)p * R + fw_slot(bits[w], R)];
  int32_t s = stop[w];
  if (s != 0) atomicAdd(&counts[p], s);
}

extern "C" int fw_stitch_gather(const void* pos, const void* bits,
                                const void* endpoints, void* next, int64_t W,
                                int32_t R, void* stream) {
  if (W > 0) {
    stitch_gather_kernel<<<fw_blocks(W), FW_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)bits,
        (const int32_t*)endpoints, (int32_t*)next, W, R);
  }
  return (int)cudaGetLastError();
}

extern "C" int fw_stitch_step(const void* pos, const void* stop,
                              const void* bits, const void* endpoints,
                              void* next, void* counts, int64_t W, int32_t R,
                              void* stream) {
  if (W > 0) {
    stitch_step_kernel<<<fw_blocks(W), FW_THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)stop, (const int32_t*)bits,
        (const int32_t*)endpoints, (int32_t*)next, (int32_t*)counts, W, R);
  }
  return (int)cudaGetLastError();
}
