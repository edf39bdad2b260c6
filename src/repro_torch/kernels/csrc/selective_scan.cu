// Mamba-1 selective scan: h_t = dA_t * h_{t-1} + dBx_t, y_t = <h_t, C_t>,
// for float32 or bfloat16 dA and dBx, with the state in float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py::
// selective_scan (pl.pallas_call at :61), and in the model the chunked
// associative scan src/repro/models/ssm.py::selective_scan, which computes
// the same function.  Contract (repro_torch/kernels/ref.py::
// selective_scan_ref's): dA and dBx (b, s, d_in, n) of one dtype, C (b, s, n)
// float32 (the wrapper converts a bfloat16 C, exactly), all contiguous; y
// (b, s, d_in) float32; h_0 = 0; n <= 16.  Optionally also the state after
// the last step, h_final (b, d_in, n) float32: the decode cache that the
// reference's models/ssm.py::mamba_prefill keeps (its selective_scan
// returns (y, h_final)); each thread writes its n registers once, after
// the walk.
//
// Design (a simple first kernel): one thread per (batch row, channel) keeps
// that channel's n states in registers and walks the sequence in order, as
// the TPU kernel's fori loop does over its VMEM-resident chunk.  The TPU kept
// the state in VMEM scratch across the sequence-chunk grid axis; here the
// sequence loop is inside the thread, so nothing carries between CTAs.
// Neighbouring threads take neighbouring channels, so one step's n-wide rows
// of a warp are one contiguous 32*n*sizeof(T) span, read with 16-byte loads;
// each thread loads U steps ahead before it computes them, to keep enough
// bytes in flight.  C is the same for every channel of a batch row, so a
// chunk of CH steps of it is staged in shared memory.  One CTA of 128 threads
// per (128 channels, batch row); ragged d_in and s are masked, not padded.
//
// Bound: the function must read dA and dBx once and write y once; at
// falcon-mamba-7b's serving shape (b=4, s=1024, d_in=8192, n=16, float32)
// that is 4.30 GB + 0.13 GB, 1.32 ms at 3.35 TB/s; its 2*b*s*d_in*n*2
// float32 operations take 0.13 ms at 67 TFLOP/s, so it is bound by bytes.
// The state update is a product then a sum (two roundings under the build's
// -fmad=false, as the eager twin computes it); y sums the n products in
// order 0..n-1, while the twin's einsum sums in its own order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // channels per CTA
constexpr int CH = 64;        // steps of C staged per chunk
constexpr int U = 4;          // steps loaded ahead
constexpr int MAX_N = 16;

template <typename T>
__device__ __forceinline__ void unpack(const uint4 w, float* out);

template <>
__device__ __forceinline__ void unpack<float>(const uint4 w, float* out) {
  out[0] = __uint_as_float(w.x);
  out[1] = __uint_as_float(w.y);
  out[2] = __uint_as_float(w.z);
  out[3] = __uint_as_float(w.w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4 w,
                                                      float* out) {
  // a bfloat16 is the high half of the float32 of the same value; the lower
  // address (element 0) is the low half of each little-endian word
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One channel's n values of one step, as float32.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float* out) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int v = 0; v < BYTES / 16; ++v)
      unpack<T>(__ldcs(q + v), out + v * (16 / (int)sizeof(T)));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

template <int N>
__device__ __forceinline__ float step(float* h, const float* a,
                                      const float* bx, const float* c) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    h[i] = a[i] * h[i] + bx[i];
    acc = acc + h[i] * c[i];
  }
  return acc;
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const T* __restrict__ dA, const T* __restrict__ dBx,
                const float* __restrict__ C, float* __restrict__ y,
                float* __restrict__ h_final, int s, int d_in) {
  __shared__ float cs[CH * N];
  const int bi = blockIdx.y;
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  const bool active = ch < d_in;
  const size_t row = (size_t)d_in * N;  // elements of one step
  const T* pa = dA + (size_t)bi * s * row + (size_t)ch * N;
  const T* pb = dBx + (size_t)bi * s * row + (size_t)ch * N;
  const float* pc = C + (size_t)bi * s * N;
  float* py = y + (size_t)bi * s * d_in + ch;

  float h[N];
#pragma unroll
  for (int i = 0; i < N; ++i) h[i] = 0.0f;

  for (int t0 = 0; t0 < s; t0 += CH) {
    const int nt = min(CH, s - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < nt * N; e += THREADS)
      cs[e] = pc[(size_t)t0 * N + e];
    __syncthreads();
    if (!active) continue;
    int tt = 0;
    for (; tt + U <= nt; tt += U) {
      float a[U][N], bx[U][N];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t off = (size_t)(t0 + tt + u) * row;
        load_row<T, N>(pa + off, a[u]);
        load_row<T, N>(pb + off, bx[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        py[(size_t)(t0 + tt + u) * d_in] =
            step<N>(h, a[u], bx[u], cs + (tt + u) * N);
    }
    for (; tt < nt; ++tt) {
      float a[N], bx[N];
      const size_t off = (size_t)(t0 + tt) * row;
      load_row<T, N>(pa + off, a);
      load_row<T, N>(pb + off, bx);
      py[(size_t)(t0 + tt) * d_in] = step<N>(h, a, bx, cs + tt * N);
    }
  }
  if (h_final != nullptr && active) {
    float* ph = h_final + ((size_t)bi * d_in + ch) * N;
#pragma unroll
    for (int i = 0; i < N; ++i) ph[i] = h[i];
  }
}

template <typename T, int N>
int launch(const void* dA, const void* dBx, const void* C, void* y,
           void* h_final, int b, int s, int d_in, cudaStream_t st) {
  const dim3 grid((d_in + THREADS - 1) / THREADS, b);
  scan_kernel<T, N><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(dA), static_cast<const T*>(dBx),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(h_final), s, d_in);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(const void* dA, const void* dBx, const void* C, void* y,
               void* h_final, int b, int s, int d_in, int n,
               cudaStream_t st) {
  switch (n) {
#define SCAN_CASE(NN) \
  case NN:            \
    return launch<T, NN>(dA, dBx, C, y, h_final, b, s, d_in, st);
    SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3) SCAN_CASE(4)
    SCAN_CASE(5) SCAN_CASE(6) SCAN_CASE(7) SCAN_CASE(8)
    SCAN_CASE(9) SCAN_CASE(10) SCAN_CASE(11) SCAN_CASE(12)
    SCAN_CASE(13) SCAN_CASE(14) SCAN_CASE(15) SCAN_CASE(16)
#undef SCAN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (dA and dBx); C is float32; h_final
// (b, d_in, n) float32, or null for none.
extern "C" int selective_scan_launch(const void* dA, const void* dBx,
                                     const void* C, void* y, void* h_final,
                                     int b, int s, int d_in, int n,
                                     int dtype, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || d_in < 1 || n < 1 || n > MAX_N)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_n<float>(dA, dBx, C, y, h_final, b, s, d_in, n, st);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(dA, dBx, C, y, h_final, b, s, d_in, n,
                                     st);
  return (int)cudaErrorInvalidValue;
}
