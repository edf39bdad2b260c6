// RG-LRU linear recurrence: h_t = a_t * h_{t-1} + bx_t, elementwise over the
// width, for float32 or bfloat16 a and bx, with h in float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan
// (pl.pallas_call at :53), and in the model the chunked associative scan
// src/repro/models/rglru.py::linear_recurrence, which computes the same
// function.  Contract (repro_torch/kernels/ref.py::rglru_scan_ref's): a and
// bx (b, s, w) of one dtype, contiguous; h (b, s, w) float32; h_0 = 0.  The
// TPU kernel pads a with 1 and bx with 0 to whole chunks; here ragged s and w
// are masked, not padded.
//
// Design (a simple first kernel): one thread per (batch row, channel) keeps
// h in a register and walks the sequence in order, as the TPU kernel's fori
// loop does over its VMEM-resident chunk; the TPU carried h in VMEM scratch
// across the sequence-chunk grid axis, here the sequence loop is inside the
// thread, so nothing carries between CTAs.  Neighbouring threads take
// neighbouring channels, so each step of a warp reads one contiguous span of
// 32 values per tensor and writes one of h.  The recurrence itself costs two
// dependent operations per step; what bounds the kernel is keeping enough
// bytes in flight with few threads (at recurrentgemma-9b's serving shape
// only b*w = 16384 threads, ~4 warps per SM, while HBM wants ~15 KB in flight
// per SM).  So each thread holds two register buffers of U steps of a and bx
// and loads the next U steps while it consumes the current ones: 2U = 16
// steps in flight, 128 bytes per thread in float32.  A CTA is one warp, so
// the 512 CTAs of the serving shape spread evenly over the SMs.  (Of the CTA
// sizes 32/64/128 and U = 4/8/16 tried on the card, this pair was fastest in
// float32.)
//
// Bound: the function must read a and bx once and write h once; at
// recurrentgemma-9b's serving shape (b=4, s=1024, w=4096, float32) that is
// 201 MB, 0.060 ms at 3.35 TB/s; its 2 operations per element (34 MFLOP) are
// negligible, so it is bound by bytes.  Each step is a product, then a sum,
// written as __fmul_rn / __fadd_rn so that no build flag contracts them: the
// kernel rounds as the eager twin and equals it bitwise in float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;  // channels per CTA
constexpr int U = 8;         // steps per register buffer

// One value as float32, read once (streaming).  bfloat16 arrives as its 16
// bits, the high half of the float32 of the same value.
__device__ __forceinline__ float load_f32(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_f32(const uint16_t* p) {
  const unsigned short bits =
      __ldcs(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float((uint32_t)bits << 16);
}

// U steps from t0 on, 0 past the end of the sequence.
template <typename T>
__device__ __forceinline__ void load_steps(const T* __restrict__ pa,
                                           const T* __restrict__ pb, int t0,
                                           int s, size_t stride, float* a,
                                           float* bx) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    const bool in = t < s;
    a[u] = in ? load_f32(pa + (size_t)t * stride) : 0.0f;
    bx[u] = in ? load_f32(pb + (size_t)t * stride) : 0.0f;
  }
}

__device__ __forceinline__ void run_steps(float& h, const float* a,
                                          const float* bx, int t0, int s,
                                          size_t stride,
                                          float* __restrict__ ph) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (t0 + u < s) {
      h = __fadd_rn(__fmul_rn(a[u], h), bx[u]);
      ph[(size_t)(t0 + u) * stride] = h;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                 float* __restrict__ h_out, int s, int w) {
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  if (ch >= w) return;
  const size_t base = (size_t)blockIdx.y * s * w + ch;
  const T* pa = a + base;
  const T* pb = bx + base;
  float* ph = h_out + base;

  float h = 0.0f;
  float a0[U], b0[U], a1[U], b1[U];
  load_steps(pa, pb, 0, s, (size_t)w, a0, b0);
  for (int t0 = 0; t0 < s; t0 += 2 * U) {
    load_steps(pa, pb, t0 + U, s, (size_t)w, a1, b1);
    run_steps(h, a0, b0, t0, s, (size_t)w, ph);
    load_steps(pa, pb, t0 + 2 * U, s, (size_t)w, a0, b0);
    run_steps(h, a1, b1, t0 + U, s, (size_t)w, ph);
  }
}

template <typename T>
int launch(const void* a, const void* bx, void* h, int b, int s, int w,
           cudaStream_t st) {
  const dim3 grid((w + THREADS - 1) / THREADS, b);
  rglru_kernel<T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(a),
                                            static_cast<const T*>(bx),
                                            static_cast<float*>(h), s, w);
  return (int)cudaGetLastError();
}


// The backward, for the output's gradient gh_out (b, s, w) float32: the
// state's gradient runs down the sequence, gh_t = gh_out_t + a_{t+1}
// gh_{t+1} (0 past the end), and g_a_t = gh_t h_{t-1} (h_0 = 0),
// g_bx_t = gh_t, each in the inputs' dtype; h is the forward's output.
//
// Design: the forward's, walked downwards.  One
// thread per (batch row, channel) keeps the carry a_{t+1} gh_{t+1} in a
// register and walks t = s-1 .. 0 in order, a sum then a product per step
// as the twin (ref.rglru_scan_bwd_ref) forms them, __fadd_rn / __fmul_rn,
// so the kernel equals the twin bitwise.  Only b * w threads exist (16384
// at recurrentgemma-9b's (4, 1024, 4096)), so each keeps three streams in
// flight: two register buffers of U steps of a_t, h_{t-1} and gh_out_t,
// the next U steps loading while the current ones are consumed, each
// value read once (__ldcs: h_{t-1} is read by step t only) and both
// gradients written with streaming stores.  A CTA is BWD_THREADS
// neighbouring channels (one warp), so each step of a warp reads and
// writes contiguous spans.  U is BWD_U_F32 = 16 steps for float32 inputs
// (what the model passes) and BWD_U_BF16 = 8 for bfloat16, the fastest of
// tools/kernel_variants.py's sweep (CTA sizes 32/64/128 x U 4/8/16) on an
// H100 for each (PERF.md).
//
// Bound: a, h and gh_out read once, g_a and g_bx written once: 20 bytes
// per element in float32, 335 MB at (4, 1024, 4096), 0.100 ms at 3.35
// TB/s; two operations per element, so bytes bound it.
constexpr int BWD_THREADS = 32;  // channels per CTA
constexpr int BWD_U_F32 = 16;    // steps per register buffer, float32
constexpr int BWD_U_BF16 = 8;    // and bfloat16 inputs

template <typename T>
struct BwdU {
  static constexpr int value =
      sizeof(T) == sizeof(float) ? BWD_U_F32 : BWD_U_BF16;
};

__device__ __forceinline__ void store_as(float* p, float x) { __stcs(p, x); }
__device__ __forceinline__ void store_as(uint16_t* p, float x) {
  // round to nearest even, as torch's float32 -> bfloat16 cast (no NaNs
  // reach here from finite inputs)
  const uint32_t u = __float_as_uint(x);
  __stcs(reinterpret_cast<unsigned short*>(p),
         (unsigned short)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16));
}

// U steps from t0 down (t0, t0 - 1, ..): a_t, h_{t-1} and gh_out_t, 0
// before the start of the sequence (and h_{-1} = h_0 = 0).
template <int U, typename T>
__device__ __forceinline__ void load_back(const T* __restrict__ pa,
                                          const float* __restrict__ ph,
                                          const float* __restrict__ pg,
                                          int t0, size_t stride, float* a,
                                          float* hp, float* g) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 - u;
    a[u] = t >= 0 ? load_f32(pa + (size_t)t * stride) : 0.0f;
    hp[u] = t >= 1 ? __ldcs(ph + (size_t)(t - 1) * stride) : 0.0f;
    g[u] = t >= 0 ? __ldcs(pg + (size_t)t * stride) : 0.0f;
  }
}

template <int U, typename T>
__device__ __forceinline__ void run_back(float& carry, const float* a,
                                         const float* hp, const float* g,
                                         int t0, size_t stride,
                                         T* __restrict__ pga,
                                         T* __restrict__ pgb) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 - u;
    if (t >= 0) {
      const float gh = __fadd_rn(g[u], carry);
      store_as(pgb + (size_t)t * stride, gh);
      store_as(pga + (size_t)t * stride, __fmul_rn(gh, hp[u]));
      carry = __fmul_rn(a[u], gh);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
    rglru_bwd_kernel(const T* __restrict__ a, const float* __restrict__ h,
                     const float* __restrict__ gh_out, T* __restrict__ g_a,
                     T* __restrict__ g_bx, int s, int w) {
  const int ch = blockIdx.x * BWD_THREADS + threadIdx.x;
  if (ch >= w) return;
  const size_t base = (size_t)blockIdx.y * s * w + ch;
  const T* pa = a + base;
  const float* ph = h + base;
  const float* pg = gh_out + base;
  T* pga = g_a + base;
  T* pgb = g_bx + base;

  constexpr int U = BwdU<T>::value;
  float carry = 0.0f;  // a_{t+1} gh_{t+1}
  float a0[U], h0[U], g0[U], a1[U], h1[U], g1[U];
  load_back<U>(pa, ph, pg, s - 1, (size_t)w, a0, h0, g0);
  for (int t0 = s - 1; t0 >= 0; t0 -= 2 * U) {
    load_back<U>(pa, ph, pg, t0 - U, (size_t)w, a1, h1, g1);
    run_back<U>(carry, a0, h0, g0, t0, (size_t)w, pga, pgb);
    load_back<U>(pa, ph, pg, t0 - 2 * U, (size_t)w, a0, h0, g0);
    run_back<U>(carry, a1, h1, g1, t0 - U, (size_t)w, pga, pgb);
  }
}

template <typename T>
int launch_bwd(const void* a, const void* h, const void* gh, void* g_a,
               void* g_bx, int b, int s, int w, cudaStream_t st) {
  const dim3 grid((w + BWD_THREADS - 1) / BWD_THREADS, b);
  rglru_bwd_kernel<T><<<grid, BWD_THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const float*>(h),
      static_cast<const float*>(gh), static_cast<T*>(g_a),
      static_cast<T*>(g_bx), s, w);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (a and bx); h is float32.  Returns the
// launch's CUDA error code.
extern "C" int rglru_scan_launch(const void* a, const void* bx, void* h,
                                 int b, int s, int w, int dtype,
                                 void* stream) {
  if (b < 1 || b > 65535 || s < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, bx, h, b, s, w, st);
  if (dtype == 1) return launch<uint16_t>(a, bx, h, b, s, w, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: a (b, s, w) in dtype (0 float32, 1 bfloat16), h and gh
// (b, s, w) float32 -> g_a, g_bx (b, s, w) in dtype.  Returns the launch's
// CUDA error code.
extern "C" int rglru_scan_bwd_launch(const void* a, const void* h,
                                     const void* gh, void* g_a, void* g_bx,
                                     int b, int s, int w, int dtype,
                                     void* stream) {
  if (b < 1 || b > 65535 || s < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_bwd<float>(a, h, gh, g_a, g_bx, b, s, w, st);
  if (dtype == 1)
    return launch_bwd<uint16_t>(a, h, gh, g_a, g_bx, b, s, w, st);
  return (int)cudaErrorInvalidValue;
}
