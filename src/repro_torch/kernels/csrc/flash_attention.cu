// Causal / sliding-window / non-causal GQA attention with an online softmax,
// for float32 or bfloat16 q, k, v, computed in float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (pl.pallas_call at :87).  Contract (that kernel's and
// repro_torch/kernels/ref.py::attention_ref's): q (b, sq, h, hd), k and v
// (b, sk, kvh, hd), all contiguous and of one dtype; query head kv*g + gi
// (g = h / kvh) reads kv head kv; positions are 0..s-1 on both sides, so the
// causal mask is top-left aligned when sq != sk; key j is visible to query i
// when (!causal || i >= j) && (window <= 0 || i - j < window); scores are
// scaled by hd^-0.5; the running max, denominator and accumulator are
// float32; the output (b, sq, h, hd) has q's dtype.  A row that sees no key
// gets the reference's answer for that case (its softmax over all-masked
// scores is uniform): the mean of v over all sk keys.
//
// Design (a simple first kernel, no tensor cores): one CTA of 128 threads per
// (batch, kv head, q tile).  The q tile holds bq = 128 / g query positions
// times the g query heads that share the kv head, one query row per thread,
// so every K/V tile is read from device memory once per kv head and serves
// all g heads.  The q tile is staged through shared memory (coalesced) into
// each thread's registers; K/V tiles of BK keys are converted to float32 into
// shared memory and read back as broadcasts.  Each thread keeps its row's
// running max, denominator and hd accumulators in registers, so no reduction
// crosses threads.  Tiles wholly past the causal diagonal of the q tile, and
// wholly before its sliding window, are never loaded.
//
// Bound: for TinyLlama-1.1B's prefill shape (b=4, sq=sk=1024, h=32, kvh=4,
// hd=64, bf16) the causal half of QK^T and PV is 2*b*h*sq*sk*hd = 17.2 GFLOP
// and the function must move 37.7 MB (q, k, v read once, o written once), so
// at 989 TFLOP/s bf16 (tensor cores) and 3.35 TB/s it is compute-bound at
// ~0.017 ms.  This kernel runs on the CUDA cores in float32 (67 TFLOP/s peak)
// with four FMAs per shared-memory load, and hd=64 takes 251 registers (two
// CTAs per SM), so it is bound by issue and shared-memory bandwidth:
// chip_smoke.py measured 1.31 ms per call at that shape on an NVIDIA H100
// 80GB HBM3 with a 700 W power limit (PERF.md).  The tensor-core (wgmma/TMA)
// version is later work (ROADMAP queue 2).  All products are written as
// fmaf(); the build's -fmad=false leaves the other arithmetic uncontracted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // one query row per thread
constexpr int BK = 32;        // keys per K/V tile

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
constexpr int smem_bytes() {
  return (THREADS * (HD + 1) + 2 * BK * HD) * (int)sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int sq,
                           int sk, int h, int kvh, int bq, int causal,
                           int window, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [THREADS][HD + 1]
  float* ks = qs + THREADS * (HD + 1);          // [BK][HD]
  float* vs = ks + BK * HD;                     // [BK][HD]

  const int g = h / kvh;
  const int kv = blockIdx.y;
  const int bi = blockIdx.z;
  const int q0 = blockIdx.x * bq;
  const int nq = min(bq, sq - q0);  // query positions in this tile
  const int tid = threadIdx.x;

  // q tile: for each position the g heads of this kv head are contiguous
  const int row_elems = g * HD;
  for (int e = tid; e < nq * row_elems; e += THREADS) {
    const int qi = e / row_elems;
    const int rest = e - qi * row_elems;  // gi * HD + d
    const size_t src = (((size_t)bi * sq + q0 + qi) * h + kv * g) * HD + rest;
    qs[(qi * g + rest / HD) * (HD + 1) + rest % HD] = to_f32(q[src]);
  }
  __syncthreads();

  const int qi = tid / g;
  const int gi = tid - qi * g;
  const int qpos = q0 + qi;
  const bool active = qi < nq;

  float qr[HD];
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? qs[tid * (HD + 1) + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // keys any row of this tile can see
  const int q_last = q0 + nq - 1;
  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  lo = (lo / BK) * BK;
  const int hi = causal ? min(sk, q_last + 1) : sk;

  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);

  for (int k0 = lo; k0 < hi; k0 += BK) {
    const int nk = min(BK, hi - k0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int j = e / HD;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        const size_t src =
            (((size_t)bi * sk + k0 + j) * kvh + kv) * HD + (e - j * HD);
        kx = to_f32(k[src]);
        vx = to_f32(v[src]);
      }
      ks[e] = kx;
      vs[e] = vx;
    }
    __syncthreads();
    if (!active) continue;

    float s[BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 kk = ks4[j * (HD / 4) + d4];
        dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      const int kpos = k0 + j;
      const bool ok = j < nk && (!causal || qpos >= kpos) &&
                      (window <= 0 || qpos - kpos < window);
      s[j] = ok ? dot * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    if (tmax == -INFINITY) continue;  // nothing visible in this tile

    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);  // 0 while m is still -inf
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for masked keys
      l += p;
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 vv = vs4[j * (HD / 4) + d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
  }

  if (!active) return;
  T* dst = o + (((size_t)bi * sq + qpos) * h + kv * g + gi) * HD;
  if (l > 0.f) {
#pragma unroll
    for (int d = 0; d < HD; ++d) dst[d] = from_f32<T>(acc[d] / l);
    return;
  }
  // no visible key: uniform weights over all sk keys, as the reference
  for (int d = 0; d < HD; ++d) {
    float sum = 0.f;
    for (int j = 0; j < sk; ++j)
      sum += to_f32(v[(((size_t)bi * sk + j) * kvh + kv) * HD + d]);
    dst[d] = from_f32<T>(sk > 0 ? sum / (float)sk : 0.f);
  }
}

constexpr int MAX_DEVICES = 64;

// Raises the kernel's dynamic shared-memory limit past the 48 KB default,
// once per instantiation and device (the attribute is per device).
template <typename T, int HD>
cudaError_t allow_smem(int bytes) {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int h, int kvh, int causal, int window,
           cudaStream_t stream) {
  const int g = h / kvh;
  const int bq = THREADS / g;
  const int bytes = smem_bytes<HD>();
  const cudaError_t err = allow_smem<T, HD>(bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + bq - 1) / bq, kvh, b);
  flash_attention_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, h, kvh, bq,
      causal, window, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int sk, int h, int kvh, int hd, int causal,
                int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, sq, sk, h, kvh, causal, window,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, b, sq, sk, h, kvh, causal, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, sq, sk, h, kvh, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, sq, sk, h, kvh, causal, window,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's CUDA error code.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int sk, int h, int kvh, int hd,
                                      int causal, int window, int dtype,
                                      void* stream) {
  if (b < 1 || sq < 1 || sk < 0 || kvh < 1 || h % kvh != 0 ||
      h / kvh > THREADS || b > 65535 || kvh > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, b, sq, sk, h, kvh, hd, causal,
                              window, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, kvh, hd,
                                      causal, window, st);
  return (int)cudaErrorInvalidValue;
}
