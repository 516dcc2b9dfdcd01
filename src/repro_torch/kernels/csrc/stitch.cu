// stitch_gather, stitch_step, stitch_gather_rounds and stitch_step_rounds:
// query stitch rounds against the walk index slab endpoints[n, R] (flat,
// int32).
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
// stitch_gather_rounds is the same TPU kernel's redesign for a whole
// wave: the reference calls stitch_gather once per round of the wave's
// ``lax.scan`` (src/repro/query/engine.py:291-310); here one launch runs
// all q_max rounds, each walk looping over its rounds in registers:
//
//   for j < q_max:
//     alive &= !(lost[clamp(p / sz, 0, S-1)] && j < q)      (with a mask)
//     if (j < q && alive) p = endpoints[p * R + abs(s0 + j) % R]
//   alive &= !lost[clamp(p / sz, 0, S-1)]                   (with a mask)
//
// stitch_step_rounds is stitch_step's redesign for walk_wave, which the
// reference runs as num_rounds + 1 stitch_step calls (src/repro/query/
// engine.py:375-380): one launch runs all of them and their stop tally,
//
//   for j < min(q, num_rounds + 1): p = endpoints[p * R + abs(s0 + j) % R]
//   if 0 <= q <= num_rounds: counts[p] += 1
//
// a walk being tallied at round j == q, where it stops, so at its final
// position; a walk with q > num_rounds takes num_rounds + 1 gathers and is
// never tallied, as in the round loop.
//
// pos, q and s0 are read once and pos (plus alive, one byte a walk, when a
// mask is passed) written once. s0 + j wraps as torch's int32 add does (it
// is done in uint32). A walk stops looping at j = min(q, q_max), or when
// it dies: every later round leaves it as it is.
//
// Design: one thread per walk; the slab index is int64 (pos · R nears
// 2^31 at Twitter scale); the stop tally is an int32 atomicAdd, which the
// TPU replaced by a one-hot compare-and-reduce for want of HBM atomics.
// Outputs are byte-equal to the plain versions.
//
// Bound (bytes only, 3.35 TB/s): 12 B per walk streamed for the gather
// (pos, bits, next; stitch_step adds 4 B of stop), one 32-byte sector per
// distinct slab sector read, plus stitch_step's 4n-byte counts output
// written once. stitch_gather_rounds: 16 B per walk (pos, q, s0, next;
// alive adds 1 B and the mask S B) plus one sector per distinct slab
// sector each round reads. stitch_step_rounds: the same 16 B a walk and
// sectors, plus the 4n-byte counts written once, which set the bound at
// n = 4,847,571 (19.4 MB against ~0.5 MB of walks and sectors).
//
// A wave is W = 8,192 walks: at 256 threads a round is 32 CTAs on 132
// SMs. The round kernels (stitch_gather_rounds and stitch_step_rounds
// here, stitch_gather_local_rounds in stitch_local.cu) run 64-thread CTAs
// (FW_ROUNDS_THREADS: 128 CTAs, about one per SM, so every SM holds
// walks). The size barely
// matters: 64, 128 and 256 threads were tried on one H100 and read about
// the same device time; a walk's chain of up to 8 dependent gathers, not
// the spread over SMs, sets it (chip_smoke.py phase 12 traces the device
// time of a launch), and the launch path sets the call's.
//
// rng="device" (the TPU kernels' use_device_rng, src/repro/kernels/
// stitch.py:47-61): each entry point takes a key (int64[2] in device
// memory) where bits / s0 go, which are then null, and walk w's bits are
// randint(key, (W,), 0, 2**30)[w], drawn in the kernel (threefry.cuh:
// fw_walk_bits). Where the TPU drew pltpu.prng_random_bits, this is the
// reference's own stream, so the device mode is byte-equal to the caller
// mode fed prng.randint's bits; it takes the bits' 4 B a walk off the
// memory path and their draw off the wave's launches.
#include "common.cuh"
#include "threefry.cuh"

__global__ void stitch_gather_kernel(const int32_t* __restrict__ pos,
                                     const int32_t* __restrict__ bits,
                                     const int64_t* __restrict__ key,
                                     const int32_t* __restrict__ endpoints,
                                     int32_t* __restrict__ next, int64_t W,
                                     int32_t R) {
  int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  next[w] = endpoints[(int64_t)pos[w] * R +
                      fw_slot(fw_walk_bits(bits, key, w), R)];
}

__global__ void stitch_step_kernel(const int32_t* __restrict__ pos,
                                   const int32_t* __restrict__ stop,
                                   const int32_t* __restrict__ bits,
                                   const int64_t* __restrict__ key,
                                   const int32_t* __restrict__ endpoints,
                                   int32_t* __restrict__ next,
                                   int32_t* __restrict__ counts, int64_t W,
                                   int32_t R) {
  int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int32_t p = pos[w];
  next[w] = endpoints[(int64_t)p * R + fw_slot(fw_walk_bits(bits, key, w), R)];
  int32_t s = stop[w];
  if (s != 0) atomicAdd(&counts[p], s);
}

// Whether vertex p lies in a lost shard: lost[fw_shard(p, S, sz)].
__device__ __forceinline__ bool fw_in_lost(const uint8_t* lost, int32_t p,
                                           int32_t S, int32_t sz) {
  return lost[fw_shard(p, S, sz)] != 0;
}

__global__ void stitch_gather_rounds_kernel(
    const int32_t* __restrict__ pos, const int32_t* __restrict__ q,
    const int32_t* __restrict__ s0, const int64_t* __restrict__ key,
    const int32_t* __restrict__ endpoints, const uint8_t* __restrict__ lost,
    int32_t* __restrict__ next, uint8_t* __restrict__ alive_out, int64_t W,
    int32_t R, int32_t q_max, int32_t S, int32_t sz) {
  int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int32_t p = pos[w];
  const int32_t qw = q[w];
  const uint32_t s = (uint32_t)fw_walk_bits(s0, key, w);
  const int32_t rounds = qw < q_max ? qw : q_max;
  bool alive = true;
  for (int32_t j = 0; j < rounds; ++j) {
    if (lost != nullptr && fw_in_lost(lost, p, S, sz)) {
      alive = false;
      break;
    }
    p = endpoints[(int64_t)p * R + fw_slot((int32_t)(s + (uint32_t)j), R)];
  }
  if (lost != nullptr) {
    alive_out[w] = alive && !fw_in_lost(lost, p, S, sz) ? 1 : 0;
  }
  next[w] = p;
}

__global__ void stitch_step_rounds_kernel(
    const int32_t* __restrict__ pos, const int32_t* __restrict__ q,
    const int32_t* __restrict__ s0, const int64_t* __restrict__ key,
    const int32_t* __restrict__ endpoints, int32_t* __restrict__ next,
    int32_t* __restrict__ counts, int64_t W, int32_t R, int32_t num_rounds,
    int32_t n) {
  int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int32_t p = pos[w];
  const int32_t qw = q[w];
  const uint32_t s = (uint32_t)fw_walk_bits(s0, key, w);
  // num_rounds < 2**31 - 1 (the wrapper checks), so the + 1 never wraps
  const int32_t rounds = qw <= num_rounds ? qw : num_rounds + 1;
  for (int32_t j = 0; j < rounds; ++j) {
    p = endpoints[(int64_t)p * R + fw_slot((int32_t)(s + (uint32_t)j), R)];
  }
  if (qw >= 0 && qw <= num_rounds && (uint32_t)p < (uint32_t)n) {
    atomicAdd(&counts[p], 1);
  }
  next[w] = p;
}

extern "C" int fw_stitch_gather(const void* pos, const void* bits,
                                const void* key, const void* endpoints,
                                void* next, int64_t W, int32_t R,
                                void* stream) {
  if (W > 0) {
    stitch_gather_kernel<<<fw_blocks(W), FW_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)bits, (const int64_t*)key,
        (const int32_t*)endpoints, (int32_t*)next, W, R);
  }
  return (int)cudaGetLastError();
}

extern "C" int fw_stitch_step(const void* pos, const void* stop,
                              const void* bits, const void* key,
                              const void* endpoints, void* next,
                              void* counts, int64_t W, int32_t R,
                              void* stream) {
  if (W > 0) {
    stitch_step_kernel<<<fw_blocks(W), FW_THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)stop, (const int32_t*)bits,
        (const int64_t*)key, (const int32_t*)endpoints, (int32_t*)next,
        (int32_t*)counts, W, R);
  }
  return (int)cudaGetLastError();
}

extern "C" int fw_stitch_gather_rounds(const void* pos, const void* q,
                                       const void* s0, const void* key,
                                       const void* endpoints,
                                       const void* lost, void* next,
                                       void* alive, int64_t W, int32_t R,
                                       int32_t q_max, int32_t S, int32_t sz,
                                       void* stream) {
  if (W > 0) {
    stitch_gather_rounds_kernel<<<fw_round_blocks(W), FW_ROUNDS_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)q, (const int32_t*)s0,
        (const int64_t*)key, (const int32_t*)endpoints,
        (const uint8_t*)lost, (int32_t*)next, (uint8_t*)alive, W, R, q_max,
        S, sz);
  }
  return (int)cudaGetLastError();
}

extern "C" int fw_stitch_step_rounds(const void* pos, const void* q,
                                     const void* s0, const void* key,
                                     const void* endpoints, void* next,
                                     void* counts, int64_t W, int32_t R,
                                     int32_t num_rounds, int32_t n,
                                     void* stream) {
  if (W > 0) {
    stitch_step_rounds_kernel<<<fw_round_blocks(W), FW_ROUNDS_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)q, (const int32_t*)s0,
        (const int64_t*)key, (const int32_t*)endpoints, (int32_t*)next,
        (int32_t*)counts, W, R, num_rounds, n);
  }
  return (int)cudaGetLastError();
}
