// Threefry-2x32 on the device, bit for bit as repro_torch/prng.py (and
// jax.random under jax_threefry_partitionable, jax 0.9.0) computes it.
//
// Not a kernel: the walker kernels (frog_step.cu, frog_step_stream.cu) and
// the stitch kernels (stitch.cu, stitch_local.cu) include it to draw the
// reference's own key streams in the kernel, so a superstep's death coins
// and a wave's slot bits never pass through device memory, and
// threefry_draw.cu builds prng.py's draws on it.
//
//   threefry2x32(k, (x0, x1))  20 rounds, rotations (13, 15, 26, 6) and
//                              (17, 29, 16, 24), key schedule
//                              (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) as prng.py:48
//   split(k, i), fold_in(k, d) threefry(k, (0, i)) / threefry(k, (0, d))
//   bits(k, ctr)               y0 ^ y1 of threefry(k, (ctr >> 32, ctr & M))
//   randint30(split(k, 1), c)  prng.randint(k, ., 0, 2**30) at counter c:
//                              the span exceeds 2**16, so the high stream's
//                              multiplier wraps to 0 (prng.py:152-158) and
//                              only bits(split(k, 1), c) mod 2**30 is left
//   walk_bits(bits, key, w)    a stitch round's slot bits of walk w: the
//                              caller's bits[w], or under rng="device"
//                              randint(key, (W,), 0, 2**30)[w] from the key
//   bernoulli(k, p, c)         float32((bits >> 9) | 0x3F800000) - 1 < p,
//                              the subtraction rounded to nearest
//                              (__fsub_rn, so no contraction or fast-math
//                              flag can change it) and p rounded to float32
//                              on the host, as prng.bernoulli does
//
// A key arrives as the port holds it: two int64 words of uint32 values in
// device memory; the low 32 bits of each word are the key.
#pragma once

#include <stdint.h>

struct FwKey {
  uint32_t k0, k1;
};

__device__ __forceinline__ FwKey fw_key_at(const int64_t* __restrict__ keys,
                                           int64_t i) {
  return FwKey{(uint32_t)keys[2 * i], (uint32_t)keys[2 * i + 1]};
}

__device__ __forceinline__ uint2 fw_threefry2x32(FwKey k, uint32_t x0,
                                                 uint32_t x1) {
  const uint32_t ks0 = k.k0, ks1 = k.k1, ks2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  x0 += ks0;
  x1 += ks1;
#define FW_MIX(r)                    \
  x0 += x1;                          \
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
#define FW_ROUNDS_A FW_MIX(13) FW_MIX(15) FW_MIX(26) FW_MIX(6)
#define FW_ROUNDS_B FW_MIX(17) FW_MIX(29) FW_MIX(16) FW_MIX(24)
  FW_ROUNDS_A x0 += ks1; x1 += ks2 + 1u;
  FW_ROUNDS_B x0 += ks2; x1 += ks0 + 2u;
  FW_ROUNDS_A x0 += ks0; x1 += ks1 + 3u;
  FW_ROUNDS_B x0 += ks1; x1 += ks2 + 4u;
  FW_ROUNDS_A x0 += ks2; x1 += ks0 + 5u;
#undef FW_ROUNDS_B
#undef FW_ROUNDS_A
#undef FW_MIX
  return make_uint2(x0, x1);
}

__device__ __forceinline__ FwKey fw_split(FwKey k, uint32_t i) {
  const uint2 y = fw_threefry2x32(k, 0u, i);
  return FwKey{y.x, y.y};
}

__device__ __forceinline__ FwKey fw_fold_in(FwKey k, uint32_t d) {
  return fw_split(k, d);
}

__device__ __forceinline__ uint32_t fw_bits(FwKey k, uint64_t ctr) {
  const uint2 y = fw_threefry2x32(k, (uint32_t)(ctr >> 32), (uint32_t)ctr);
  return y.x ^ y.y;
}

// randint(k, ., 0, 2**30) at counter ctr, given k_lo = fw_split(k, 1)
__device__ __forceinline__ int32_t fw_randint30(FwKey k_lo, uint64_t ctr) {
  return (int32_t)(fw_bits(k_lo, ctr) & 0x3FFFFFFFu);
}

// The slot bits of walk w in a stitch kernel: bits[w], or with a key
// (rng="device", bits null) randint(key, (W,), 0, 2**30)[w]. Each walk
// derives split(key, 1) itself: the stitch kernels are bound by their
// chains of dependent gathers, not by two threefry blocks a walk.
__device__ __forceinline__ int32_t fw_walk_bits(
    const int32_t* __restrict__ bits, const int64_t* __restrict__ key,
    int64_t w) {
  return key != nullptr
             ? fw_randint30(fw_split(fw_key_at(key, 0), 1), (uint64_t)w)
             : bits[w];
}

__device__ __forceinline__ bool fw_bernoulli(FwKey k, float p, uint64_t ctr) {
  const float u = __fsub_rn(
      __uint_as_float((fw_bits(k, ctr) >> 9) | 0x3F800000u), 1.0f);
  return u < p;
}

// The batch walk's keys of one superstep: (k_die, k_move) = split(step
// key), and k_move's low stream split(k_move, 1), which randint draws from.
struct FwStepKeys {
  FwKey die, move_lo;
};

__device__ __forceinline__ FwStepKeys fw_step_keys(FwKey step_key) {
  return FwStepKeys{fw_split(step_key, 0), fw_split(fw_split(step_key, 1), 1)};
}

// The index build's key of one row at one hop: randint's low stream of
// fold_in(row key, step).
__device__ __forceinline__ FwKey fw_hop_key(FwKey row_key, uint32_t step) {
  return fw_split(fw_fold_in(row_key, step), 1);
}
