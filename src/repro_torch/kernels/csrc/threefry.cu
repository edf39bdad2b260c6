// Per-row random draws of one scheduling interval with JAX's threefry2x32
// bits (non-partitionable mode), for every grid cell at once.
//
// Replaces the jax.random calls of the reference's in-loop learners, which
// are not a Pallas kernel: the per-row fold_in / split / bernoulli of
// src/repro/core/mab.py:104-139 (decide_train_rows, the MAB's eps-greedy
// draw), :243-263 (gillis_decide_rows) and
// src/repro/env/jaxsim/engines.py:165-172 (the random+daso arm).  Contract
// (repro_torch/kernels/ref.py::threefry_rows_ref's): key (G, 2) int64
// holding uint32 words; for cell g and row a,
//     k = fold_in(fold_in(key[g], t), a)
// with split (the MAB and Gillis draws):
//     (k1, k2) = split(k); explore = U_w(k1) < p[g]; coin = U_64(k2) < 0.5
// where U_32 is JAX's float32 uniform (23 bits) and U_64 its float64 one
// (52 bits); p (G,) float64 holds the explore probability (a float32 value
// exactly when w = 32, so the float64 comparison equals JAX's float32 one);
// without split (the random arm): coin = U_64(k) < 0.5.  Outputs are bool
// (G, A).
//
// Design (a simple first kernel): one thread per (cell, row).  Each thread
// runs its threefry hashes (2 fold_ins, then 2 for the split and 2 for the
// uniforms; 3 in all without split) with the 20 rounds unrolled in
// registers, and writes one byte per output.  No shared memory, no
// communication between threads.  The eager twin takes about 7 launches per
// round, some 170 per hash; here an interval's draws are one launch.
//
// Bound: the function reads the keys and p once (24 bytes per cell) and
// writes 2 bytes per row, so at the main path's G=16 and A <= 64 it moves
// ~2 KB; its integer work is ~80 32-bit operations per hash (20 rounds of an
// add, a funnel shift and a xor, 5 key injections), ~0.5 k per row.  Both
// are far below a microsecond: the kernel is bound by its launch.
// Integer adds, xors and funnel shifts round nothing, so it equals the twin
// bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr uint32_t PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds with rotations r0..r3.
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// threefry2x32 of the counter (x0, x1) under the key (k0, k1), in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ PARITY;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

// fold_in(key, d): the key becomes threefry(key, (0, d)).
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t d) {
  uint32_t y0 = 0u, y1 = d;
  threefry(k0, k1, y0, y1);
  k0 = y0; k1 = y1;
}

// JAX's float32 uniform of a key: 32 bits from the counter (0, 0), the top
// 23 as the mantissa of a float in [1, 2), minus 1 (exact).
__device__ __forceinline__ float uniform32(uint32_t k0, uint32_t k1) {
  uint32_t x0 = 0u, x1 = 0u;
  threefry(k0, k1, x0, x1);
  return __uint_as_float((x0 >> 9) | 0x3F800000u) - 1.0f;
}

// JAX's float64 uniform of a key: 64 bits a << 32 | b from the counter
// (0, 1), the top 52 as the mantissa of a double in [1, 2), minus 1.
__device__ __forceinline__ double uniform64(uint32_t k0, uint32_t k1) {
  uint32_t a = 0u, b = 1u;
  threefry(k0, k1, a, b);
  const uint64_t bits = ((uint64_t)a << 32) | (uint64_t)b;
  return __longlong_as_double(
             (long long)((bits >> 12) | 0x3FF0000000000000ull)) - 1.0;
}

__global__ void __launch_bounds__(THREADS)
threefry_rows_kernel(const int64_t* __restrict__ key,
                     const double* __restrict__ p, uint32_t t, int G, int A,
                     int split, int width, bool* __restrict__ explore,
                     bool* __restrict__ coin) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)G * A) return;
  const int g = (int)(idx / A);
  const uint32_t a = (uint32_t)(idx - (long long)g * A);
  uint32_t k0 = (uint32_t)key[2 * g], k1 = (uint32_t)key[2 * g + 1];
  fold_in(k0, k1, t);
  fold_in(k0, k1, a);
  if (!split) {
    coin[idx] = uniform64(k0, k1) < 0.5;
    return;
  }
  // split: (a_i, b_i) = threefry(k, (i, i + 2)); keys (a0, a1), (b0, b1)
  uint32_t a0 = 0u, b0 = 2u, a1 = 1u, b1 = 3u;
  threefry(k0, k1, a0, b0);
  threefry(k0, k1, a1, b1);
  const double u = width == 32 ? (double)uniform32(a0, a1)
                               : uniform64(a0, a1);
  explore[idx] = u < p[g];
  coin[idx] = uniform64(b0, b1) < 0.5;
}

}  // namespace

extern "C" int threefry_rows_launch(const void* key, const void* p,
                                    unsigned int t, int G, int A, int split,
                                    int width, void* explore, void* coin,
                                    void* stream) {
  if (G < 1 || A < 1 || (split && width != 32 && width != 64))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)G * A;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  threefry_rows_kernel<<<(unsigned)blocks, THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const int64_t*)key, (const double*)p, (uint32_t)t, G, A, split, width,
      (bool*)explore, (bool*)coin);
  return (int)cudaGetLastError();
}
