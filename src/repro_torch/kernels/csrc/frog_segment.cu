// frog_segment_walk: a walk-index segment walk, all L hops and the
// visited-block masks of hops 0 … L − 2, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/frog_step.py:84 ``frog_step``
// (pallas_call at :112) and its streamed twin frog_step_stream.py:215
// (:257) as the reference's segment walk uses them:
// src/repro/query/index.py:248 ``_segment_walk_rows``, a lax.scan (:284)
// of ``_segment_step`` (:217, one ``ops.frog_step`` a hop) with
// ``_block_one_hot`` (:237) ORed into the mask (:280). Plain version:
// kernels/ref.py:frog_segment_walk_ref, the loop of frog_hop_ref and
// hop_visits. For row c of the chunk (vertex vertices[c], key
// row_keys[c]) and slot r < R, walk f = c · R + r:
//
//   p = vertices[c]; mask = 0
//   for step < L:  p = successor(p, randint(fold_in(row_keys[c], step),
//                                           0, 2**30, ctr = r))
//                  if step < L - 1: mask |= block bit of p
//   endpoints[f] = p; visited[f] = mask
//
// Bound (bytes, 3.35 TB/s): the chunk's vertices and row keys read once
// (20 B a row), endpoints and masks written once (36 B a walk), one
// 32-byte sector of row_ptr per distinct sector the L hops touch together
// (19 MB at LiveJournal scale, it stays in L2), and one of col_idx per
// distinct sector each hop touches. What binds is the col_idx gathers:
// col_idx (275 MB) does not fit the 50 MB L2, so a walk's random col_idx
// read costs a DRAM sector at every hop, however many walks read the same
// sector.
//
// Design, against what the L frog_hop launches cost (frog_step.cu): the
// walk's position and its 8 mask words stay in registers across the hops,
// so nothing is read back between hops: no start copy, no pos read and
// write a hop, no mask row read and written at each recorded hop; the row
// is stored once as two 16-byte stores, adjacent threads on adjacent rows.
// A vertex's degree is row_ptr[p + 1] - row_ptr[p], in the sector of
// row_ptr[p] 7 times in 8, so a hop gathers two sectors, not deg's third
// (deg equals diff(row_ptr) for every CSRGraph; the wrapper says so and
// tests/test_torch_segment_walk.py holds it). The
// col_idx gathers load under an L2 evict-first policy, so the stream of
// lines read once does not push row_ptr (19 MB) out of L2. One walk a
// thread, f = blockIdx.x · 256 + tid, so every store coalesces (K = 2 and
// 4 walks a thread, advanced hop by hop with K gather chains in flight,
// read the same on one H100; PERF.md keeps that sweep). The CTA derives
// its rows' hop keys (fold_in(row key, step) and randint's low stream, two
// threefry blocks a row and step) into shared memory, Lc steps at a time
// where a table of every step would not fit; a walk then draws one block
// a hop.
#include "common.cuh"
#include "threefry.cuh"

// shared memory for a CTA's table of hop keys
#define FW_SEGMENT_KEY_BYTES (48 * 1024)

// an L2 cache policy that evicts the lines it loads first
__device__ __forceinline__ uint64_t fw_evict_first_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ int32_t fw_load_policy(const int32_t* p,
                                                  uint64_t pol) {
  int32_t v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(pol));
  return v;
}

__global__ void __launch_bounds__(FW_THREADS) frog_segment_walk_kernel(
    const int32_t* __restrict__ vertices, const int64_t* __restrict__ row_keys,
    int32_t R, int32_t L, int32_t Lc, const int32_t* __restrict__ row_ptr,
    const int32_t* __restrict__ col_idx, int32_t* __restrict__ endpoints,
    uint32_t* __restrict__ visited, int32_t mask_bs, int64_t N) {
  extern __shared__ FwKey s_keys[];          // [Lc][rows]
  const uint64_t stream = fw_evict_first_policy();
  const int64_t base = (int64_t)blockIdx.x * FW_THREADS;
  const int64_t c0 = fw_div(base, R);        // the CTA's first row
  const int64_t last = base + FW_THREADS < N ? base + FW_THREADS - 1 : N - 1;
  const uint32_t rows = (uint32_t)(fw_div(last, R) - c0) + 1;
  // a lane past N walks walk N - 1 again and stores nothing
  const int64_t f0 = base + threadIdx.x;
  const int64_t f = f0 < N ? f0 : N - 1;
  const int64_t c = fw_div(f, R);
  const uint32_t lrow = (uint32_t)(c - c0);
  const uint32_t slot = (uint32_t)(f - c * R);
  int32_t p = vertices[c];
  uint32_t w[FW_MASK_WORDS];
#pragma unroll
  for (int i = 0; i < FW_MASK_WORDS; ++i) w[i] = 0u;
  for (int32_t s0 = 0; s0 < L; s0 += Lc) {
    const int32_t ns = L - s0 < Lc ? L - s0 : Lc;
    if (s0 > 0) __syncthreads();             // the last table is read
    for (uint32_t i = threadIdx.x; i < rows * (uint32_t)ns; i += FW_THREADS) {
      const uint32_t s = i / rows;
      s_keys[i] = fw_hop_key(fw_key_at(row_keys, c0 + (i - s * rows)),
                             (uint32_t)s0 + s);
    }
    __syncthreads();
    for (int32_t s = 0; s < ns; ++s) {
      // row_ptr's loads in flight while the slot's block is drawn
      const int32_t rp = row_ptr[p];
      const int32_t d = row_ptr[p + 1] - rp;
      const int32_t b = fw_randint30(s_keys[s * rows + lrow], slot);
      if (d > 0) {
        p = fw_load_policy(col_idx + (int64_t)rp + fw_slot(b, d), stream);
      }
      if (s0 + s < L - 1) fw_mask_or(w, p, mask_bs);
    }
  }
  if (f0 < N) {
    endpoints[f0] = p;
    fw_mask_store(visited, f0, w);
  }
}

// The most rows F consecutive walks of R a row span.
static inline int64_t fw_segment_rows(int64_t F, int32_t R) {
  const int64_t rows = (F + R - 2) / R + 1;
  return rows < F ? rows : F;
}

extern "C" int fw_frog_segment_walk(const void* vertices, const void* row_keys,
                                    int32_t R, int32_t L, const void* row_ptr,
                                    const void* col_idx, void* endpoints,
                                    void* visited, int32_t mask_bs, int64_t N,
                                    void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const int64_t rows = fw_segment_rows(FW_THREADS, R);
  int64_t Lc = FW_SEGMENT_KEY_BYTES / (rows * (int64_t)sizeof(FwKey));
  Lc = Lc < L ? Lc : L;
  Lc = Lc > 1 ? Lc : 1;
  const size_t smem = (size_t)(rows * Lc) * sizeof(FwKey);
  frog_segment_walk_kernel<<<fw_blocks(N), FW_THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const int32_t*)vertices, (const int64_t*)row_keys, R, L, (int32_t)Lc,
      (const int32_t*)row_ptr, (const int32_t*)col_idx, (int32_t*)endpoints,
      (uint32_t*)visited, mask_bs, N);
  return (int)cudaGetLastError();
}
