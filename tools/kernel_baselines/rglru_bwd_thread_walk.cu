// The earlier rglru_scan backward of csrc/rglru_scan.cu, kept as the
// baseline of `tools/kernel_variants.py rglru bwd`: one thread per (batch
// row, channel), 32-thread CTAs, walking the sequence backwards with one
// load each of a_t, h_{t-1} and gh_out_t per step and nothing loaded
// ahead.  Same contract and bits as the committed kernel
// (rglru_scan_bwd_launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;

__device__ __forceinline__ float load_f32(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_f32(const uint16_t* p) {
  const unsigned short bits =
      __ldcs(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float((uint32_t)bits << 16);
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(uint16_t* p, float x) {
  const uint32_t u = __float_as_uint(x);
  *p = (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_bwd_kernel(const T* __restrict__ a, const float* __restrict__ h,
                     const float* __restrict__ gh_out, T* __restrict__ g_a,
                     T* __restrict__ g_bx, int s, int w) {
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  if (ch >= w) return;
  const size_t base = (size_t)blockIdx.y * s * w + ch;
  float carry = 0.0f;  // a_{t+1} gh_{t+1}
  for (int t = s - 1; t >= 0; --t) {
    const size_t at = base + (size_t)t * w;
    const float gh = __fadd_rn(gh_out[at], carry);
    const float hp = t > 0 ? h[at - w] : 0.0f;
    store_as(g_bx + at, gh);
    store_as(g_a + at, __fmul_rn(gh, hp));
    carry = __fmul_rn(load_f32(a + at), gh);
  }
}

template <typename T>
int launch_bwd(const void* a, const void* h, const void* gh, void* g_a,
               void* g_bx, int b, int s, int w, cudaStream_t st) {
  const dim3 grid((w + THREADS - 1) / THREADS, b);
  rglru_bwd_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const float*>(h),
      static_cast<const float*>(gh), static_cast<T*>(g_a),
      static_cast<T*>(g_bx), s, w);
  return (int)cudaGetLastError();
}

}  // namespace

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
