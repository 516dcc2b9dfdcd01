// Shared helpers for the FrogWild walker kernels (sm_90a).
//
// Every kernel here is launched through a plain C entry point that the
// Python wrappers in repro_torch/kernels/ops.py load with ctypes. An entry
// point launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so a refused launch surfaces in Python at once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FW_THREADS 256
// CTA size of the kernels that run a wave's stitch rounds (stitch.cu and
// stitch_local.cu)
#define FW_ROUNDS_THREADS 64

// The reference's slot draw for m > 0: ``abs(bits) % m`` on int32, where
// ``jnp.abs`` wraps INT32_MIN to itself and ``%`` is a floor modulo. Done
// in unsigned arithmetic: |b| < 2**31 gives |b| % m, and INT32_MIN (|b| ==
// 2**31) gives the floor modulo of -2**31. A signed abs followed by a
// signed modulo is not safe here: the compiler may take the abs as
// non-negative and turn the modulo unsigned, which is wrong for INT32_MIN.
__device__ __forceinline__ int32_t fw_slot(int32_t b, int32_t m) {
  uint32_t a = b < 0 ? 0u - (uint32_t)b : (uint32_t)b;
  uint32_t r = a % (uint32_t)m;
  if (a == 0x80000000u && r != 0) r = (uint32_t)m - r;
  return (int32_t)r;
}

// f / R for a non-negative f: 32-bit division while f fits (the 64-bit one
// is a long software routine)
__device__ __forceinline__ int64_t fw_div(int64_t f, int32_t R) {
  return f <= 0xFFFFFFFFll ? (int64_t)((uint32_t)f / (uint32_t)R) : f / R;
}

// The shard that owns row p of a slab cut into S blocks of sz rows:
// clamp(p / sz, 0, S - 1). C's division truncates where torch's floors,
// which differs only for p < 0, and there both clamp to shard 0.
__device__ __forceinline__ int32_t fw_shard(int32_t p, int32_t S,
                                            int32_t sz) {
  int32_t shard = p / sz;
  return shard < 0 ? 0 : (shard > S - 1 ? S - 1 : shard);
}

static inline unsigned int fw_blocks(int64_t n) {
  return (unsigned int)((n + FW_THREADS - 1) / FW_THREADS);
}

static inline unsigned int fw_round_blocks(int64_t n) {
  return (unsigned int)((n + FW_ROUNDS_THREADS - 1) / FW_ROUNDS_THREADS);
}
