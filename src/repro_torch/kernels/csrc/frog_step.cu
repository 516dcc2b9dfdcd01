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
#include "threefry.cuh"

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

// ---------------------------------------------------------------------------
// The walk with its own draws: rng="device" of frog_step.py:84 (the TPU
// kernel's use_device_rng), with the reference's threefry streams in place
// of the TPU's prng_random_bits, so the answers stay byte-equal to the
// reference and to the plain versions (kernels/ref.py:frog_superstep_ref,
// frog_hop_ref).
//
// frog_superstep: one whole superstep of the batch walk (core/frogwild.py),
// in place. For frog f, with (k_die, k_move) = split(step key):
//
//   if alive[f]:
//     if bernoulli(k_die, p_T, ctr = f):  counts[pos[f]] += 1, alive[f] = 0
//     else: pos[f] = successor(pos[f], randint(k_move, 0, 2**30, ctr = f))
//
// frog_hop: one hop of the walk-index build (query/index.py), in place; walk
// f is slot r = f % R of row c = f / R, its bits randint(fold_in(row_keys[c],
// step), 0, 2**30, ctr = r); no death, no tally. With a visited operand it
// also records the segment's visited-block mask (common.cuh:fw_visit), which
// the reference builds in XLA around its Pallas step (_block_one_hot and an
// OR in the scan, src/repro/query/index.py:237-285): the hop already holds
// the vertex it reached in a register, so the bit costs a 32-byte row write
// at hop 0 and one word's read-modify-write at a recorded later hop, where
// separate torch passes would read and write the [N, 8] rows several times
// a hop.
//
// Design: one thread per frog. A dead frog costs its one alive byte: no
// draw, no gather (after s steps 0.85^s of the frogs live). Thread 0
// derives the step's keys (three threefry blocks) once per CTA into shared
// memory; for the hop the CTA derives the keys of the rows its walks cover
// (at most 256, two blocks each), one row per thread. Keys derived by each
// live thread instead read 9.1 us a superstep launch against 7.8 us per
// CTA over the batch walk's 32 supersteps (one H100 80GB HBM3, 700 W, from
// a trace of chip_smoke.py phase 12); a hop, bound by its gathers,
// took the same 0.34 ms either way.
//
// Bound, per superstep: bytes at 3.35 TB/s: alive read for every frog (1 B),
// pos read and written for the live (8 B), alive written for the dying,
// and for the survivors one 32-byte sector of deg, row_ptr and col_idx per
// distinct sector they touch, plus the dying frogs' counts sectors;
// operations: about 75 integer instructions per threefry block, one block
// per live frog (the death coin) and one per survivor (the slot), over
// 132 SMs x 64 INT32 lanes x the SM clock. A hop: 8 B per walk, the row
// keys, the scattered sectors, and 1 + 2/R blocks a walk (per-CTA keys);
// with masks, 32 B a walk written at hop 0 and one 32-byte sector read and
// written a walk at a recorded later hop.
// Which binds depends on the step (phase 12 computes both from the run's
// data).

__device__ __forceinline__ int32_t fw_successor(
    int32_t p, int32_t bits, const int32_t* __restrict__ row_ptr,
    const int32_t* __restrict__ col_idx, const int32_t* __restrict__ deg) {
  const int32_t d = deg[p];
  return d > 0 ? col_idx[(int64_t)row_ptr[p] + fw_slot(bits, d)] : p;
}

__global__ void frog_superstep_kernel(int32_t* __restrict__ pos,
                                      uint8_t* __restrict__ alive,
                                      int32_t* __restrict__ counts,
                                      const int64_t* __restrict__ step_key,
                                      float p_T,
                                      const int32_t* __restrict__ row_ptr,
                                      const int32_t* __restrict__ col_idx,
                                      const int32_t* __restrict__ deg,
                                      int64_t N) {
  __shared__ FwStepKeys s_keys;
  if (threadIdx.x == 0) s_keys = fw_step_keys(fw_key_at(step_key, 0));
  __syncthreads();
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= N || !alive[f]) return;
  const FwStepKeys k = s_keys;
  const int32_t p = pos[f];
  if (fw_bernoulli(k.die, p_T, (uint64_t)f)) {
    atomicAdd(&counts[p], 1);
    alive[f] = 0;
    return;
  }
  pos[f] = fw_successor(p, fw_randint30(k.move_lo, (uint64_t)f), row_ptr,
                        col_idx, deg);
}

__global__ void frog_hop_kernel(int32_t* __restrict__ pos,
                                const int64_t* __restrict__ row_keys,
                                uint32_t step, int32_t R,
                                const int32_t* __restrict__ row_ptr,
                                const int32_t* __restrict__ col_idx,
                                const int32_t* __restrict__ deg,
                                uint32_t* __restrict__ visited,
                                int32_t record, int32_t mask_bs, int64_t N) {
  __shared__ FwKey s_keys[FW_THREADS];
  const int64_t f0 = (int64_t)blockIdx.x * blockDim.x;
  const int64_t c0 = fw_div(f0, R);           // the CTA's first row
  const uint32_t r0 = (uint32_t)(f0 - c0 * R);
  const uint32_t lrow = (r0 + threadIdx.x) / (uint32_t)R;
  const uint32_t r = r0 + threadIdx.x - lrow * (uint32_t)R;
  const int64_t left = N - f0;
  const uint32_t cnt = left < blockDim.x ? (uint32_t)left : blockDim.x;
  const uint32_t rows = (r0 + cnt - 1) / (uint32_t)R + 1;
  if (threadIdx.x < rows) {
    s_keys[threadIdx.x] =
        fw_hop_key(fw_key_at(row_keys, c0 + threadIdx.x), step);
  }
  __syncthreads();
  const int64_t f = f0 + threadIdx.x;
  if (f >= N) return;
  const int32_t nxt = fw_successor(pos[f], fw_randint30(s_keys[lrow], r),
                                   row_ptr, col_idx, deg);
  pos[f] = nxt;
  if (visited != nullptr) fw_visit(visited, f, nxt, step, record, mask_bs);
}

extern "C" int fw_frog_superstep(void* pos, void* alive, void* counts,
                                 const void* step_key, float p_T,
                                 const void* row_ptr, const void* col_idx,
                                 const void* deg, int64_t N, void* stream) {
  if (N > 0) {
    frog_superstep_kernel<<<fw_blocks(N), FW_THREADS, 0,
                            (cudaStream_t)stream>>>(
        (int32_t*)pos, (uint8_t*)alive, (int32_t*)counts,
        (const int64_t*)step_key, p_T, (const int32_t*)row_ptr,
        (const int32_t*)col_idx, (const int32_t*)deg, N);
  }
  return (int)cudaGetLastError();
}

extern "C" int fw_frog_hop(void* pos, const void* row_keys, int32_t step,
                           int32_t R, const void* row_ptr,
                           const void* col_idx, const void* deg,
                           void* visited, int32_t record, int32_t mask_bs,
                           int64_t N, void* stream) {
  if (N > 0) {
    frog_hop_kernel<<<fw_blocks(N), FW_THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t*)pos, (const int64_t*)row_keys, (uint32_t)step, R,
        (const int32_t*)row_ptr, (const int32_t*)col_idx,
        (const int32_t*)deg, (uint32_t*)visited, record, mask_bs, N);
  }
  return (int)cudaGetLastError();
}
