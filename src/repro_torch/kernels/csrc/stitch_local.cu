// stitch_gather_local and stitch_step_local: one query stitch round against
// one shard's block block[sz, R] (flat, int32) of the walk-index slab.
//
// stitch_gather_local replaces the TPU kernel src/repro/kernels/stitch.py:252
// ``stitch_gather_local`` (pallas_call at :280, body
// ``_stitch_gather_local_kernel`` at :233):
//
//   local   = pos[w] - base
//   owned   = 0 <= local < sz
//   next[w] = owned ? block[local * R + abs(bits[w]) % R] : 0
//
// stitch_step_local replaces src/repro/kernels/stitch.py:300
// ``stitch_step_local`` (pallas_call at :334, body ``_stitch_local_kernel``
// at :202): the same gather, plus counts[local] += stop[w] for owned walks.
// Walks that no shard owns contribute 0 and tally nothing, so the outputs
// summed over the shards equal stitch_gather / stitch_step.
//
// Design: one thread per walk; local and the block index in int64 (pos may
// lie far outside the shard); the slot through fw_slot (INT32_MIN safe);
// the stop tally an int32 atomicAdd into counts[sz], which the wrapper
// zeroes. The TPU kernel swept (vertex block x walk block) one-hot tiles
// for want of HBM atomics; integer atomics give the same counts in any
// order, so the outputs are byte-equal to the plain versions.
//
// Bound (bytes only, 3.35 TB/s): 12 B per walk streamed for the gather
// (pos, bits, next; stitch_step_local adds 4 B of stop), one 32-byte sector
// per distinct block sector the owned walks read, plus stitch_step_local's
// 4·sz-byte counts output written once.
//
// Left on the table: the loop wave launches this once per shard per round,
// each launch reading all W positions to find the ~W/S walks it owns; a
// launch over all shards at once is the fused wave's stitch_gather.
#include "common.cuh"

__global__ void stitch_gather_local_kernel(const int32_t* __restrict__ pos,
                                           const int32_t* __restrict__ bits,
                                           const int32_t* __restrict__ block,
                                           int32_t* __restrict__ next,
                                           int64_t W, int64_t base,
                                           int64_t sz, int32_t R) {
  int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int64_t local = (int64_t)pos[w] - base;
  int32_t out = 0;
  if (local >= 0 && local < sz) {
    out = block[local * R + fw_slot(bits[w], R)];
  }
  next[w] = out;
}

__global__ void stitch_step_local_kernel(const int32_t* __restrict__ pos,
                                         const int32_t* __restrict__ stop,
                                         const int32_t* __restrict__ bits,
                                         const int32_t* __restrict__ block,
                                         int32_t* __restrict__ next,
                                         int32_t* __restrict__ counts,
                                         int64_t W, int64_t base, int64_t sz,
                                         int32_t R) {
  int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int64_t local = (int64_t)pos[w] - base;
  int32_t out = 0;
  if (local >= 0 && local < sz) {
    out = block[local * R + fw_slot(bits[w], R)];
    int32_t s = stop[w];
    if (s != 0) atomicAdd(&counts[local], s);
  }
  next[w] = out;
}

extern "C" int fw_stitch_gather_local(const void* pos, const void* bits,
                                      const void* block, void* next,
                                      int64_t W, int64_t base, int64_t sz,
                                      int32_t R, void* stream) {
  if (W > 0) {
    stitch_gather_local_kernel<<<fw_blocks(W), FW_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)bits, (const int32_t*)block,
        (int32_t*)next, W, base, sz, R);
  }
  return (int)cudaGetLastError();
}

extern "C" int fw_stitch_step_local(const void* pos, const void* stop,
                                    const void* bits, const void* block,
                                    void* next, void* counts, int64_t W,
                                    int64_t base, int64_t sz, int32_t R,
                                    void* stream) {
  if (W > 0) {
    stitch_step_local_kernel<<<fw_blocks(W), FW_THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)stop, (const int32_t*)bits,
        (const int32_t*)block, (int32_t*)next, (int32_t*)counts, W, base, sz,
        R);
  }
  return (int)cudaGetLastError();
}
