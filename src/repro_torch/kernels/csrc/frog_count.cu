// frog_count: histogram of frog destinations into n int32 bins.
//
// Replaces the TPU kernel src/repro/kernels/frog_scatter.py:46
// ``frog_count`` (pallas_call at :60, body ``_frog_scatter_kernel`` at
// :28).
//
//   counts[v] = #{f : dest[f] == v},  dest outside [0, n) ignored
//
// Design: one thread per frog, an int32 atomicAdd into the bins in device
// memory. The TPU kernel built one-hot match tiles because it has no HBM
// atomics. The serving wave tallies into (Q+1)·n bins (43.6 M at
// LiveJournal scale), far beyond shared memory, so the bins stay global.
//
// Bound (bytes only, 3.35 TB/s): 4 B per frog read plus the 4n-byte bins
// output written once (the output dominates at the wave's shapes: 175 MB
// against 32 KB of destinations).
//
// Left on the table: the wrapper zero-fills all n bins although a wave
// touches at most N of them; a sparse tally (sort + run-length, or
// privatised shared-memory bins per bin range) would move N-proportional
// bytes instead.
#include "common.cuh"

__global__ void frog_count_kernel(const int32_t* __restrict__ dest,
                                  int32_t* __restrict__ counts, int64_t N,
                                  int64_t n) {
  int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= N) return;
  int32_t d = dest[f];
  if (d >= 0 && (int64_t)d < n) atomicAdd(&counts[d], 1);
}

extern "C" int fw_frog_count(const void* dest, void* counts, int64_t N,
                             int64_t n, void* stream) {
  if (N > 0) {
    frog_count_kernel<<<fw_blocks(N), FW_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)dest, (int32_t*)counts, N, n);
  }
  return (int)cudaGetLastError();
}
