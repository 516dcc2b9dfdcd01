// threefry_bits, threefry_randint, threefry_uniform, threefry_bernoulli,
// threefry_split and threefry_fold_in: repro_torch/prng.py's draws, one
// launch each, bit for bit as prng.py (and jax.random under
// jax_threefry_partitionable, jax 0.9.0) computes them.
//
// No TPU kernel: the reference draws with jax.random, which XLA fuses into
// one pass a draw (e.g. src/repro/core/frogwild.py:199, src/repro/query/
// engine.py:240, src/repro/query/index.py:267). prng.py's torch version
// runs threefry as int64 elementwise ops, some hundred launches a draw;
// these kernels give each draw one launch when the key lies on the card.
// The cipher and its streams are threefry.cuh's, shared with the walker
// kernels, so there is one definition of them.
//
// A key is an int64[2] pair of uint32 words in device memory, read in the
// kernel (no host sync); nkeys keys (a batch, [..., 2] contiguous) each draw
// the whole shape, output row k holding key k's draw:
//
//   bits      out[k, c] = y0 ^ y1 of threefry(key_k, (c >> 32, c & M))
//                         (int64 holding the uint32, as prng.random_bits)
//   randint   hi = split(key_k, 0), lo = split(key_k, 1);
//             off = ((bits(hi, c) % span) * mult + bits(lo, c) % span)
//                   % span, all in uint32 with wraparound, out = lo + off
//             (int32). mult = (2**16 % span)**2 % span in uint32, from the
//             host; it is 0 for span > 2**16, and then the high stream is
//             not drawn: its term is 0 whatever its bits, so the bytes stay
//   uniform   __fsub_rn(float((bits >> 9) | 0x3F800000), 1) (float32)
//   bernoulli uniform < p, p rounded to float32 on the host (bool)
//   split     out[k, i] = threefry(key_k, (0, i)), i < num (int64 pairs)
//   fold_in   out[e] = threefry(key, (0, data & M)) per element e, the key
//             and the data each either one value or one per element
//             (int32 or int64 data, taken mod 2**32)
//
// Design: one thread per output element. Derived keys (randint's two
// split keys) are computed once per CTA into shared memory, one key per
// thread for the keys the CTA's 256 elements cover (at most 256), as
// frog_hop does for its row keys; every element then costs one threefry
// block (two for randint at span <= 2**16). Index arithmetic is 32-bit
// while the flat index fits (fw_udiv), 64-bit past it.
//
// Bound (operations): about 75 integer instructions a threefry block
// (chip_smoke.py's THREEFRY_OPS) over 132 SMs x 64 INT32 lanes x the SM
// clock, against the output's bytes at 3.35 TB/s (8 B an element for
// bits, 4 for randint and uniform, 1 for bernoulli, 16 for split and
// fold_in): at 1,980 MHz a block takes 4.5 ps of issue and 8 bytes 2.4 ps,
// so every draw but a 16-byte split or fold_in is operation-bound.
#include "common.cuh"
#include "threefry.cuh"

enum FwDraw { kBits = 0, kUniform = 1, kBernoulli = 2 };

// a / b for non-negative a and positive b: 32-bit division while both fit
__device__ __forceinline__ uint64_t fw_udiv(uint64_t a, uint64_t b) {
  return (a | b) <= 0xFFFFFFFFull ? (uint64_t)((uint32_t)a / (uint32_t)b)
                                  : a / b;
}

__device__ __forceinline__ float fw_uniform(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// The element (key row, counter) of flat index f0 + threadIdx.x, and the
// CTA's first key row, for a draw of `size` elements a key.
struct FwAt {
  uint64_t row0;   // the CTA's first key row
  uint32_t lrow;   // this thread's key row, relative to row0
  uint64_t ctr;    // this thread's counter within its key's draw
};

__device__ __forceinline__ FwAt fw_at(uint64_t f0, uint64_t size) {
  const uint64_t row0 = fw_udiv(f0, size);
  const uint64_t local = f0 - row0 * size + threadIdx.x;
  const uint64_t lrow = fw_udiv(local, size);
  return FwAt{row0, (uint32_t)lrow, local - lrow * size};
}

// bits, uniform and bernoulli: one block an element, the key read as is
template <int Kind>
__global__ void threefry_draw_kernel(const int64_t* __restrict__ keys,
                                     void* __restrict__ out, uint64_t total,
                                     uint64_t size, float p) {
  const uint64_t f = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= total) return;
  const FwAt at = fw_at((uint64_t)blockIdx.x * blockDim.x, size);
  const uint32_t b =
      fw_bits(fw_key_at(keys, (int64_t)(at.row0 + at.lrow)), at.ctr);
  if (Kind == kBits) {
    ((int64_t*)out)[f] = (int64_t)b;
  } else if (Kind == kUniform) {
    ((float*)out)[f] = fw_uniform(b);
  } else {
    ((uint8_t*)out)[f] = fw_uniform(b) < p ? 1 : 0;
  }
}

// randint: the CTA derives the split keys of its key rows into shared
// memory, then each element draws from them
__global__ void threefry_randint_kernel(const int64_t* __restrict__ keys,
                                        int32_t* __restrict__ out,
                                        uint64_t total, uint64_t size,
                                        uint32_t lo, uint32_t span,
                                        uint32_t mult) {
  __shared__ FwKey s_lo[FW_THREADS], s_hi[FW_THREADS];
  const uint64_t f0 = (uint64_t)blockIdx.x * blockDim.x;
  const FwAt at = fw_at(f0, size);
  const uint64_t left = total - f0;
  const uint32_t cnt = left < blockDim.x ? (uint32_t)left : blockDim.x;
  const uint32_t rows =
      (uint32_t)fw_udiv(f0 - at.row0 * size + cnt - 1, size) + 1;
  if (threadIdx.x < rows) {
    const FwKey k = fw_key_at(keys, (int64_t)(at.row0 + threadIdx.x));
    s_lo[threadIdx.x] = fw_split(k, 1);
    if (mult != 0) s_hi[threadIdx.x] = fw_split(k, 0);
  }
  __syncthreads();
  const uint64_t f = f0 + threadIdx.x;
  if (f >= total) return;
  uint32_t off = fw_bits(s_lo[at.lrow], at.ctr) % span;
  if (mult != 0) {
    off += (fw_bits(s_hi[at.lrow], at.ctr) % span) * mult;
    off %= span;
  }
  out[f] = (int32_t)(lo + off);
}

// split: out[k, i] = threefry(key_k, (0, i)) for i < num
__global__ void threefry_split_kernel(const int64_t* __restrict__ keys,
                                      int64_t* __restrict__ out,
                                      uint64_t total, uint64_t num) {
  const uint64_t f = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= total) return;
  const uint64_t k = fw_udiv(f, num);
  const FwKey y =
      fw_split(fw_key_at(keys, (int64_t)k), (uint32_t)(f - k * num));
  out[2 * f] = (int64_t)y.k0;
  out[2 * f + 1] = (int64_t)y.k1;
}

// fold_in: out[e] = threefry(key, (0, data)) per element; key_step and
// data_step are 1 (one per element) or 0 (one for all); data is int32
// (data_bytes 4) or int64 (8), or null with the value `scalar`
__global__ void threefry_fold_in_kernel(const int64_t* __restrict__ keys,
                                        int64_t key_step,
                                        const void* __restrict__ data,
                                        int64_t data_step, int32_t data_bytes,
                                        uint32_t scalar,
                                        int64_t* __restrict__ out,
                                        uint64_t total) {
  const uint64_t f = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= total) return;
  const int64_t e = (int64_t)f;
  uint32_t d = scalar;
  if (data != nullptr) {
    d = data_bytes == 4
            ? (uint32_t)((const int32_t*)data)[e * data_step]
            : (uint32_t)((const int64_t*)data)[e * data_step];
  }
  const FwKey y = fw_fold_in(fw_key_at(keys, e * key_step), d);
  out[2 * f] = (int64_t)y.k0;
  out[2 * f + 1] = (int64_t)y.k1;
}

static inline unsigned int fw_grid(uint64_t total) {
  return (unsigned int)((total + FW_THREADS - 1) / FW_THREADS);
}

template <int Kind>
static int fw_draw(const void* keys, void* out, int64_t nkeys, int64_t size,
                   float p, void* stream) {
  const uint64_t total = (uint64_t)nkeys * (uint64_t)size;
  if (total > 0) {
    threefry_draw_kernel<Kind><<<fw_grid(total), FW_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const int64_t*)keys, out, total, (uint64_t)size, p);
  }
  return (int)cudaGetLastError();
}

extern "C" int fw_threefry_bits(const void* keys, void* out, int64_t nkeys,
                                int64_t size, void* stream) {
  return fw_draw<kBits>(keys, out, nkeys, size, 0.0f, stream);
}

extern "C" int fw_threefry_randint(const void* keys, void* out,
                                   int64_t nkeys, int64_t size, int32_t lo,
                                   uint32_t span, uint32_t mult,
                                   void* stream) {
  const uint64_t total = (uint64_t)nkeys * (uint64_t)size;
  if (total > 0) {
    threefry_randint_kernel<<<fw_grid(total), FW_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const int64_t*)keys, (int32_t*)out, total, (uint64_t)size,
        (uint32_t)lo, span, mult);
  }
  return (int)cudaGetLastError();
}

extern "C" int fw_threefry_uniform(const void* keys, void* out,
                                   int64_t nkeys, int64_t size,
                                   void* stream) {
  return fw_draw<kUniform>(keys, out, nkeys, size, 0.0f, stream);
}

extern "C" int fw_threefry_bernoulli(const void* keys, void* out,
                                     int64_t nkeys, int64_t size, float p,
                                     void* stream) {
  return fw_draw<kBernoulli>(keys, out, nkeys, size, p, stream);
}

extern "C" int fw_threefry_split(const void* keys, void* out, int64_t nkeys,
                                 int64_t num, void* stream) {
  const uint64_t total = (uint64_t)nkeys * (uint64_t)num;
  if (total > 0) {
    threefry_split_kernel<<<fw_grid(total), FW_THREADS, 0,
                            (cudaStream_t)stream>>>(
        (const int64_t*)keys, (int64_t*)out, total, (uint64_t)num);
  }
  return (int)cudaGetLastError();
}

extern "C" int fw_threefry_fold_in(const void* keys, int64_t key_step,
                                   const void* data, int64_t data_step,
                                   int32_t data_bytes, uint32_t scalar,
                                   void* out, int64_t total, void* stream) {
  if (total > 0) {
    threefry_fold_in_kernel<<<fw_grid((uint64_t)total), FW_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const int64_t*)keys, key_step, data, data_step, data_bytes, scalar,
        (int64_t*)out, (uint64_t)total);
  }
  return (int)cudaGetLastError();
}
