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

// A walk-index segment's visited-block mask (query/index.py's
// visited_blocks): uint32[N, FW_MASK_WORDS] a walk, bit b of word w set
// when the segment's walk stood on a vertex of id block 32 w + b (blocks
// of mask_bs consecutive ids). The build records the intermediate hops
// only (0 … L − 2). A vertex whose block is past the mask's 256 (a
// padding row of the reference's padded graph) sets no bit. A row is one
// walk's, so one thread writes it and no atomics are needed.
#define FW_MASK_WORDS 8

// ORs vertex v's block bit into a row held in registers (the words are
// indexed with constants only, so the row stays out of local memory)
__device__ __forceinline__ void fw_mask_or(uint32_t (&w)[FW_MASK_WORDS],
                                           int32_t v, int32_t mask_bs) {
  const uint32_t blk = (uint32_t)v / (uint32_t)mask_bs;
  const uint32_t word = blk >> 5;
  const uint32_t bit = blk < 32u * FW_MASK_WORDS ? 1u << (blk & 31u) : 0u;
#pragma unroll
  for (uint32_t i = 0; i < FW_MASK_WORDS; ++i) w[i] |= word == i ? bit : 0u;
}

// walk f's whole row as two 16-byte stores
__device__ __forceinline__ void fw_mask_store(
    uint32_t* __restrict__ visited, int64_t f,
    const uint32_t (&w)[FW_MASK_WORDS]) {
  uint4* row4 = reinterpret_cast<uint4*>(visited + f * FW_MASK_WORDS);
  row4[0] = make_uint4(w[0], w[1], w[2], w[3]);
  row4[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// One hop's part of the mask (frog_hop): hop 0 writes the walk's whole
// row, the bit of the vertex it reached when ``record`` is set and zeros
// otherwise (a one-hop segment); a later hop with ``record`` set ORs its
// bit into the row.
__device__ __forceinline__ void fw_visit(uint32_t* __restrict__ visited,
                                         int64_t f, int32_t v,
                                         uint32_t step, int32_t record,
                                         int32_t mask_bs) {
  if (step == 0) {
    uint32_t w[FW_MASK_WORDS] = {};
    if (record) fw_mask_or(w, v, mask_bs);
    fw_mask_store(visited, f, w);
    return;
  }
  const uint32_t blk = (uint32_t)v / (uint32_t)mask_bs;
  if (record && blk < 32u * FW_MASK_WORDS) {
    visited[f * FW_MASK_WORDS + (blk >> 5)] |= 1u << (blk & 31u);
  }
}

static inline unsigned int fw_blocks(int64_t n) {
  return (unsigned int)((n + FW_THREADS - 1) / FW_THREADS);
}

static inline unsigned int fw_round_blocks(int64_t n) {
  return (unsigned int)((n + FW_ROUNDS_THREADS - 1) / FW_ROUNDS_THREADS);
}
