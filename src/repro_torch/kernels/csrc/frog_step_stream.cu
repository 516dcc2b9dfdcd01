// frog_step_stream_sorted: the plain (p_s = 1) walker superstep over frogs
// sorted by vertex, reading the graph as per-vertex-block slabs.
//
// Replaces the TPU kernel src/repro/kernels/frog_step_stream.py:215
// ``frog_step_stream_sorted`` (pallas_call at :257, body ``_stream_kernel``
// at :157). It computes what frog_step computes, on sorted frogs:
//
//   v = the vertex block of the frog's run, local = pos - v * BV
//   d         = deg[v, local]
//   next[f]   = d > 0 ? col[v, row_off[v, local] + abs(bits[f]) % d] : pos
//   counts[pos[f]] += die[f]
//
// Layout (kernels/frog_step_stream.py:BlockedCSR): row_off and deg are
// int32[num_vb, BV], col is int32[num_vb, E_blk] with each block's edges at
// the front. The wrapper (ops.frog_step, impl "stream") sorts the frogs by
// vertex, finds each block's run seg_off[v] .. seg_off[v+1], and cuts the
// runs into CTA work items of at most FB frogs: cta_vid[c] is the block of
// item c (num_vb for a spare item, which exits), cta_lo[c] its first frog.
//
// Design: one CTA per work item. It stages its block's row_off and deg
// (2 x BV int32) in shared memory and tallies deaths into a shared
// int32[BV] histogram that it adds to the global counts once, one
// atomicAdd per nonzero bin. Its col slab (E_blk int32) it stages only
// where that pays: staging reads E_blk·4 bytes, while the run's frogs read
// at most one 32-byte sector each from device memory, so a CTA stages when
// its run has at least E_blk / 8 frogs and the launch allows it. The
// wrapper allows it (stage_col, which also sizes the shared memory) when
// the slab fits and the frogs average E_blk / 8 per block; at 400,000
// frogs over 9,468 blocks of E_blk ~ 7.6k they average 42, and every CTA
// reads col from device memory. A hub block whose E_blk·4 exceeds the
// slab is read from device memory the same way. The TPU kernel padded
// every block's run to whole frog blocks and tallied by prefix sums over
// the sorted tile; runs are cut without padding here, and the shared
// histogram gives the same integers in any order.
//
// Bound (bytes only, 3.35 TB/s): 16 B per frog streamed (pos, die, bits,
// next), one 32-byte sector per distinct sector of row_off, deg and col the
// frogs touch, and the 4·n_pad-byte counts output written once.
#include "common.cuh"
#include "threefry.cuh"

// Sets *smem to a streamed launch's dynamic shared memory (row_off, deg,
// the histogram and the staged col slab) and raises the kernel's limit
// when that exceeds 48 KB; returns the error of raising it.
template <typename Kernel>
static cudaError_t fw_stream_smem(Kernel kernel, int32_t BV, int32_t E_blk,
                                  int32_t stage_col, size_t* smem) {
  *smem = sizeof(int32_t) * ((size_t)3 * BV + (stage_col ? (size_t)E_blk : 0));
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

__global__ void frog_step_stream_kernel(
    const int32_t* __restrict__ pos, const int32_t* __restrict__ die,
    const int32_t* __restrict__ bits, const int32_t* __restrict__ cta_vid,
    const int32_t* __restrict__ cta_lo, const int32_t* __restrict__ seg_off,
    const int32_t* __restrict__ row_off, const int32_t* __restrict__ deg,
    const int32_t* __restrict__ col, int32_t* __restrict__ next,
    int32_t* __restrict__ counts, int32_t num_vb, int32_t BV, int32_t E_blk,
    int32_t FB, int32_t stage_col) {
  extern __shared__ int32_t smem[];
  const int32_t v = cta_vid[blockIdx.x];
  if (v >= num_vb) return;                 // spare work item
  int32_t* s_row_off = smem;
  int32_t* s_deg = smem + BV;
  int32_t* s_hist = smem + 2 * BV;
  int32_t* s_col = smem + 3 * BV;
  const int64_t vbase = (int64_t)v * BV;
  for (int32_t i = threadIdx.x; i < BV; i += blockDim.x) {
    s_row_off[i] = row_off[vbase + i];
    s_deg[i] = deg[vbase + i];
    s_hist[i] = 0;
  }
  const int64_t lo = cta_lo[blockIdx.x];
  const int64_t end = seg_off[v + 1];
  const int64_t hi = lo + FB < end ? lo + FB : end;
  const bool stage = stage_col && (hi - lo) * 8 >= E_blk;
  const int32_t* gcol = col + (int64_t)v * E_blk;
  if (stage) {
    for (int32_t i = threadIdx.x; i < E_blk; i += blockDim.x) {
      s_col[i] = gcol[i];
    }
  }
  __syncthreads();
  const int32_t* cols = stage ? s_col : gcol;
  for (int64_t f = lo + threadIdx.x; f < hi; f += blockDim.x) {
    const int32_t p = pos[f];
    const int32_t local = (int32_t)((int64_t)p - vbase);
    const int32_t d = s_deg[local];
    int32_t nxt = p;
    if (d > 0) nxt = cols[s_row_off[local] + fw_slot(bits[f], d)];
    next[f] = nxt;
    const int32_t k = die[f];
    if (k != 0) atomicAdd(&s_hist[local], k);
  }
  __syncthreads();
  for (int32_t i = threadIdx.x; i < BV; i += blockDim.x) {
    const int32_t h = s_hist[i];
    if (h != 0) atomicAdd(&counts[vbase + i], h);
  }
}

extern "C" int fw_frog_step_stream_sorted(
    const void* pos, const void* die, const void* bits, const void* cta_vid,
    const void* cta_lo, const void* seg_off, const void* row_off,
    const void* deg, const void* col, void* next, void* counts,
    int64_t num_cta, int32_t num_vb, int32_t BV, int32_t E_blk, int32_t FB,
    int32_t stage_col, void* stream) {
  if (num_cta <= 0) return (int)cudaGetLastError();
  size_t smem;
  cudaError_t err =
      fw_stream_smem(frog_step_stream_kernel, BV, E_blk, stage_col, &smem);
  if (err != cudaSuccess) return (int)err;
  frog_step_stream_kernel<<<(unsigned int)num_cta, FW_THREADS, smem,
                            (cudaStream_t)stream>>>(
      (const int32_t*)pos, (const int32_t*)die, (const int32_t*)bits,
      (const int32_t*)cta_vid, (const int32_t*)cta_lo,
      (const int32_t*)seg_off, (const int32_t*)row_off, (const int32_t*)deg,
      (const int32_t*)col, (int32_t*)next, (int32_t*)counts, num_vb, BV,
      E_blk, FB, stage_col);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The streamed walk with its own draws: rng="device" of
// frog_step_stream.py:215, the reference's threefry streams drawn in the
// kernel (plain versions: kernels/ref.py:frog_superstep_stream_sorted_ref,
// frog_hop_stream_sorted_ref).
//
// Frogs arrive sorted by vertex (pos_s) with order[f], the original index
// of sorted frog f from the wrapper's sort. The draws are keyed by that
// original index, so they equal the resident kernels' (frog_step.cu), and
// the results go back to it: pos[order[f]] (and alive[order[f]]) are
// written in place, which replaces the unsort and the gathers of the
// caller's die and bits into the sorted order.
//
//   superstep: o = order[f]; skip unless alive[o]; bernoulli(k_die, p_T,
//              ctr = o) tallies into the shared histogram and clears
//              alive[o]; else pos[o] = the successor with randint(k_move,
//              0, 2**30, ctr = o). Thread 0 derives the step's keys once
//              per CTA while the slabs stage (keys per thread read the same
//              43 us a launch on one H100).
//   hop:       o = order[f] is slot o % R of row o / R; pos[o] = the
//              successor with randint(fold_in(row_keys[o / R], step), 0,
//              2**30, ctr = o % R). Sorted walks of one row are scattered,
//              so the caller draws the rows' hop keys for the step (randint's
//              low stream of fold_in(row key, step), ops.frog_hop_stream_
//              sorted, C x 16 B that stay in L2) and a walk reads its row's
//              and draws one block, where deriving the key itself took
//              three. The hop touches no mask row: a segment walk's hops
//              0 … L − 2 write their pos into rows of a trail buffer, and
//              frog_segment_masks below writes every walk's mask row from
//              them in one coalesced pass.
//
// The shared row_off/deg staging, the col slab staged where it pays and
// the shared death histogram are the caller-bits kernel's above.
//
// Bound: a superstep reads pos_s and order for every sorted frog (12 B) and
// alive at order (1 B), writes pos (4 B) for each survivor and alive for
// each dying frog, reads each touched block's row_off/deg slabs and the
// survivors' col sectors; two threefry blocks per live frog (about 75
// integer instructions each). A hop: 16 B a walk plus the hop keys and the
// col sectors, one block a walk.
//
// Left on the table (ROADMAP R5): every sorted frog is visited, dead ones
// included, and every visited block stages its 4 KB of row_off/deg; at the
// batch shape (400,000 frogs over 9,468 blocks, about 42 a block) a
// superstep launch takes 43 us on one H100 against its 16 us bound
// (chip_smoke.py phase 12 and 13).

template <bool kHop>
__device__ __forceinline__ void stream_walk(
    const int32_t* __restrict__ pos_s, const int64_t* __restrict__ order,
    int32_t* __restrict__ pos, uint8_t* __restrict__ alive,
    int32_t* __restrict__ counts, const int64_t* __restrict__ keys,
    float p_T, int32_t R, const int32_t* __restrict__ cta_vid,
    const int32_t* __restrict__ cta_lo, const int32_t* __restrict__ seg_off,
    const int32_t* __restrict__ row_off, const int32_t* __restrict__ deg,
    const int32_t* __restrict__ col, int32_t num_vb, int32_t BV,
    int32_t E_blk, int32_t FB, int32_t stage_col) {
  extern __shared__ int32_t smem[];
  __shared__ FwStepKeys s_keys;
  const int32_t v = cta_vid[blockIdx.x];
  if (v >= num_vb) return;                 // spare work item
  int32_t* s_row_off = smem;
  int32_t* s_deg = smem + BV;
  int32_t* s_hist = smem + 2 * BV;
  int32_t* s_col = smem + 3 * BV;
  const int64_t vbase = (int64_t)v * BV;
  for (int32_t i = threadIdx.x; i < BV; i += blockDim.x) {
    s_row_off[i] = row_off[vbase + i];
    s_deg[i] = deg[vbase + i];
    if (!kHop) s_hist[i] = 0;
  }
  if (!kHop && threadIdx.x == 0) {
    s_keys = fw_step_keys(fw_key_at(keys, 0));
  }
  const int64_t lo = cta_lo[blockIdx.x];
  const int64_t end = seg_off[v + 1];
  const int64_t hi = lo + FB < end ? lo + FB : end;
  const bool stage = stage_col && (hi - lo) * 8 >= E_blk;
  const int32_t* gcol = col + (int64_t)v * E_blk;
  if (stage) {
    for (int32_t i = threadIdx.x; i < E_blk; i += blockDim.x) {
      s_col[i] = gcol[i];
    }
  }
  __syncthreads();
  const int32_t* cols = stage ? s_col : gcol;
  for (int64_t f = lo + threadIdx.x; f < hi; f += blockDim.x) {
    const int64_t o = order[f];
    int32_t bits;
    if (kHop) {
      const int64_t c = fw_div(o, R);
      bits = fw_randint30(fw_key_at(keys, c), (uint64_t)(o - c * R));
    } else {
      if (!alive[o]) continue;
      const FwStepKeys k = s_keys;
      if (fw_bernoulli(k.die, p_T, (uint64_t)o)) {
        atomicAdd(&s_hist[pos_s[f] - vbase], 1);
        alive[o] = 0;
        continue;
      }
      bits = fw_randint30(k.move_lo, (uint64_t)o);
    }
    const int32_t p = pos_s[f];
    const int32_t local = (int32_t)((int64_t)p - vbase);
    const int32_t d = s_deg[local];
    const int32_t nxt = d > 0 ? cols[s_row_off[local] + fw_slot(bits, d)] : p;
    pos[o] = nxt;
  }
  if (kHop) return;
  __syncthreads();
  for (int32_t i = threadIdx.x; i < BV; i += blockDim.x) {
    const int32_t h = s_hist[i];
    if (h != 0) atomicAdd(&counts[vbase + i], h);
  }
}

__global__ void frog_superstep_stream_kernel(
    const int32_t* __restrict__ pos_s, const int64_t* __restrict__ order,
    int32_t* __restrict__ pos, uint8_t* __restrict__ alive,
    int32_t* __restrict__ counts, const int64_t* __restrict__ step_key,
    float p_T, const int32_t* __restrict__ cta_vid,
    const int32_t* __restrict__ cta_lo, const int32_t* __restrict__ seg_off,
    const int32_t* __restrict__ row_off, const int32_t* __restrict__ deg,
    const int32_t* __restrict__ col, int32_t num_vb, int32_t BV,
    int32_t E_blk, int32_t FB, int32_t stage_col) {
  stream_walk<false>(pos_s, order, pos, alive, counts, step_key, p_T, 1,
                     cta_vid, cta_lo, seg_off, row_off, deg, col, num_vb, BV,
                     E_blk, FB, stage_col);
}

__global__ void frog_hop_stream_kernel(
    const int32_t* __restrict__ pos_s, const int64_t* __restrict__ order,
    int32_t* __restrict__ pos, const int64_t* __restrict__ hop_keys,
    int32_t R, const int32_t* __restrict__ cta_vid,
    const int32_t* __restrict__ cta_lo, const int32_t* __restrict__ seg_off,
    const int32_t* __restrict__ row_off, const int32_t* __restrict__ deg,
    const int32_t* __restrict__ col, int32_t num_vb, int32_t BV,
    int32_t E_blk, int32_t FB, int32_t stage_col) {
  stream_walk<true>(pos_s, order, pos, nullptr, nullptr, hop_keys, 0.0f, R,
                    cta_vid, cta_lo, seg_off, row_off, deg, col, num_vb, BV,
                    E_blk, FB, stage_col);
}

extern "C" int fw_frog_superstep_stream_sorted(
    const void* pos_s, const void* order, void* pos, void* alive,
    void* counts, const void* step_key, float p_T, const void* cta_vid,
    const void* cta_lo, const void* seg_off, const void* row_off,
    const void* deg, const void* col, int64_t num_cta, int32_t num_vb,
    int32_t BV, int32_t E_blk, int32_t FB, int32_t stage_col, void* stream) {
  if (num_cta <= 0) return (int)cudaGetLastError();
  size_t smem;
  cudaError_t err = fw_stream_smem(frog_superstep_stream_kernel, BV, E_blk,
                                   stage_col, &smem);
  if (err != cudaSuccess) return (int)err;
  frog_superstep_stream_kernel<<<(unsigned int)num_cta, FW_THREADS, smem,
                                 (cudaStream_t)stream>>>(
      (const int32_t*)pos_s, (const int64_t*)order, (int32_t*)pos,
      (uint8_t*)alive, (int32_t*)counts, (const int64_t*)step_key, p_T,
      (const int32_t*)cta_vid, (const int32_t*)cta_lo,
      (const int32_t*)seg_off, (const int32_t*)row_off, (const int32_t*)deg,
      (const int32_t*)col, num_vb, BV, E_blk, FB, stage_col);
  return (int)cudaGetLastError();
}

extern "C" int fw_frog_hop_stream_sorted(
    const void* pos_s, const void* order, void* pos, const void* hop_keys,
    int32_t R, const void* cta_vid, const void* cta_lo,
    const void* seg_off, const void* row_off, const void* deg,
    const void* col, int64_t num_cta, int32_t num_vb, int32_t BV,
    int32_t E_blk, int32_t FB, int32_t stage_col, void* stream) {
  if (num_cta <= 0) return (int)cudaGetLastError();
  size_t smem;
  cudaError_t err =
      fw_stream_smem(frog_hop_stream_kernel, BV, E_blk, stage_col, &smem);
  if (err != cudaSuccess) return (int)err;
  frog_hop_stream_kernel<<<(unsigned int)num_cta, FW_THREADS, smem,
                           (cudaStream_t)stream>>>(
      (const int32_t*)pos_s, (const int64_t*)order, (int32_t*)pos,
      (const int64_t*)hop_keys, R, (const int32_t*)cta_vid,
      (const int32_t*)cta_lo, (const int32_t*)seg_off,
      (const int32_t*)row_off, (const int32_t*)deg, (const int32_t*)col,
      num_vb, BV, E_blk, FB, stage_col);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// frog_segment_masks: the streamed segment walk's visited-block masks in one
// pass (plain version: kernels/ref.py:frog_segment_masks_ref). Hops 0 … L − 2
// of a walk over sorted walks store their positions into the rows of a
// trail, int32[T, N] with T = L − 1; walk f's mask row is the OR of the
// block bits of trail[0 … T − 1][f] (common.cuh:fw_mask_or), ORed into the
// row's old words when ``accumulate`` is set (a later recorded hop of
// frog_hop's per-hop form, T = 1). One thread a walk: T coalesced int32
// reads and two 16-byte stores, where a sorted hop writing its walks' rows
// read and wrote a scattered 32-byte sector a walk.
//
// Bound (bytes, 3.35 TB/s): 4 T B a walk read and 32 B written (and 32 B
// read when accumulating).

__global__ void frog_segment_masks_kernel(const int32_t* __restrict__ trail,
                                          int32_t T,
                                          uint32_t* __restrict__ visited,
                                          int32_t mask_bs, int32_t accumulate,
                                          int64_t N) {
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= N) return;
  uint32_t w[FW_MASK_WORDS] = {};
  if (accumulate) {
    const uint4* row4 = reinterpret_cast<const uint4*>(
        visited + f * FW_MASK_WORDS);
    const uint4 a = row4[0], b = row4[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
  for (int32_t t = 0; t < T; ++t) fw_mask_or(w, trail[t * N + f], mask_bs);
  fw_mask_store(visited, f, w);
}

extern "C" int fw_frog_segment_masks(const void* trail, int32_t T,
                                     void* visited, int32_t mask_bs,
                                     int32_t accumulate, int64_t N,
                                     void* stream) {
  if (N > 0) {
    frog_segment_masks_kernel<<<fw_blocks(N), FW_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const int32_t*)trail, T, (uint32_t*)visited, mask_bs, accumulate,
        N);
  }
  return (int)cudaGetLastError();
}
