// stitch_gather_local and stitch_step_local: one query stitch round against
// one shard's block block[sz, R] (flat, int32) of the walk-index slab;
// stitch_gather_local_rounds: a loop wave's rounds over all the blocks.
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
// stitch_gather_local_rounds is stitch_gather_local's redesign for the
// loop wave, which ran it once per shard per round (S x q_max launches,
// each reading all W positions to find the ~W/S walks its shard owns, and
// a host sum over the shards). One launch runs a wave's q_max rounds; each
// walk gathers from the block of the shard that owns its row:
//
//   rounds = min(q, q_max)
//   for j < rounds:
//     s = clamp(p / sz, 0, S - 1)
//     if (lost && lost[s]) { alive = false; break }
//     local = p - s * sz
//     p = 0 <= local < sz ? block_s[local * R + abs(s0 + j) % R] : 0
//   alive &= !(lost && lost[clamp(p / sz, 0, S - 1)])
//
// The blocks are not one slab: the kernel reads them through a table of S
// block pointers (blocks[s], int32[sz, R] each), so each may be a separate
// allocation, and a lost shard's pointer (null, or a block of its own) is
// never dereferenced, since a walk in its rows dies before the gather.
// This is the loop wave's structure, which the fused wave (one stacked
// slab, stitch_gather_rounds in stitch.cu) is compared against. A walk
// that no shard owns takes 0, as the per-shard sum gives it.
//
// Design: one thread per walk looping over its rounds in registers, as
// stitch_gather_rounds does (64-thread CTAs); local and the block index in
// int64 (local * R nears 2^31 at Twitter scale); the slot through fw_slot
// (INT32_MIN safe) with s0 + j added in uint32 (torch's int32 add wraps).
//
// Bound (bytes only, 3.35 TB/s): 16 B per walk streamed (pos, q, s0, next;
// alive adds 1 B, the mask S B), the 8·S-byte table, plus one 32-byte
// sector per distinct block sector each round reads.
// rng="device": as in stitch.cu, a key (int64[2]) in place of bits / s0,
// walk w's bits randint(key, (W,), 0, 2**30)[w] drawn in the kernel.
#include "common.cuh"
#include "threefry.cuh"

__global__ void stitch_gather_local_kernel(const int32_t* __restrict__ pos,
                                           const int32_t* __restrict__ bits,
                                           const int64_t* __restrict__ key,
                                           const int32_t* __restrict__ block,
                                           int32_t* __restrict__ next,
                                           int64_t W, int64_t base,
                                           int64_t sz, int32_t R) {
  int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int64_t local = (int64_t)pos[w] - base;
  int32_t out = 0;
  if (local >= 0 && local < sz) {
    out = block[local * R + fw_slot(fw_walk_bits(bits, key, w), R)];
  }
  next[w] = out;
}

__global__ void stitch_step_local_kernel(const int32_t* __restrict__ pos,
                                         const int32_t* __restrict__ stop,
                                         const int32_t* __restrict__ bits,
                                         const int64_t* __restrict__ key,
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
    out = block[local * R + fw_slot(fw_walk_bits(bits, key, w), R)];
    int32_t s = stop[w];
    if (s != 0) atomicAdd(&counts[local], s);
  }
  next[w] = out;
}

__global__ void stitch_gather_local_rounds_kernel(
    const int32_t* __restrict__ pos, const int32_t* __restrict__ q,
    const int32_t* __restrict__ s0, const int64_t* __restrict__ key,
    const int32_t* const* __restrict__ blocks,
    const uint8_t* __restrict__ lost, int32_t* __restrict__ next,
    uint8_t* __restrict__ alive_out, int64_t W, int32_t R, int32_t q_max,
    int32_t S, int32_t sz) {
  int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int32_t p = pos[w];
  const int32_t qw = q[w];
  const uint32_t s = (uint32_t)fw_walk_bits(s0, key, w);
  const int32_t rounds = qw < q_max ? qw : q_max;
  bool alive = true;
  for (int32_t j = 0; j < rounds; ++j) {
    const int32_t shard = fw_shard(p, S, sz);
    if (lost != nullptr && lost[shard] != 0) {
      alive = false;
      break;
    }
    const int64_t local = (int64_t)p - (int64_t)shard * sz;
    p = (local >= 0 && local < sz)
            ? blocks[shard][local * R +
                            fw_slot((int32_t)(s + (uint32_t)j), R)]
            : 0;
  }
  if (lost != nullptr) {
    alive_out[w] = alive && lost[fw_shard(p, S, sz)] == 0 ? 1 : 0;
  }
  next[w] = p;
}

extern "C" int fw_stitch_gather_local(const void* pos, const void* bits,
                                      const void* key, const void* block,
                                      void* next, int64_t W, int64_t base,
                                      int64_t sz, int32_t R, void* stream) {
  if (W > 0) {
    stitch_gather_local_kernel<<<fw_blocks(W), FW_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)bits, (const int64_t*)key,
        (const int32_t*)block, (int32_t*)next, W, base, sz, R);
  }
  return (int)cudaGetLastError();
}

extern "C" int fw_stitch_step_local(const void* pos, const void* stop,
                                    const void* bits, const void* key,
                                    const void* block, void* next,
                                    void* counts, int64_t W, int64_t base,
                                    int64_t sz, int32_t R, void* stream) {
  if (W > 0) {
    stitch_step_local_kernel<<<fw_blocks(W), FW_THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)stop, (const int32_t*)bits,
        (const int64_t*)key, (const int32_t*)block, (int32_t*)next,
        (int32_t*)counts, W, base, sz, R);
  }
  return (int)cudaGetLastError();
}

extern "C" int fw_stitch_gather_local_rounds(
    const void* pos, const void* q, const void* s0, const void* key,
    const void* blocks, const void* lost, void* next, void* alive, int64_t W,
    int32_t R, int32_t q_max, int32_t S, int32_t sz, void* stream) {
  if (W > 0) {
    stitch_gather_local_rounds_kernel<<<fw_round_blocks(W),
                                        FW_ROUNDS_THREADS, 0,
                                        (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)q, (const int32_t*)s0,
        (const int64_t*)key, (const int32_t* const*)blocks,
        (const uint8_t*)lost, (int32_t*)next, (uint8_t*)alive, W, R, q_max,
        S, sz);
  }
  return (int)cudaGetLastError();
}
