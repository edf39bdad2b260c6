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
// Design (a simple first kernel, no tensor cores): one CTA per (batch, kv
// head, q tile).  The q tile holds bq = ROWS / g query positions times the g
// query heads that share the kv head, so every K/V tile is read from device
// memory once per kv head and serves all g heads.  Up to hd=128 a query row
// belongs to one thread (ROWS = 128 threads); at hd=256 the row's 512
// float32 registers (q and accumulator) would not fit in one thread's 255,
// so SPLIT = 4 threads of one warp share a row, each holding 64 of its
// dims (ROWS = 64 rows of 256 threads); their partial dot products are
// joined with __shfl_xor_sync, whose butterfly gives all four the same sum
// bitwise, so they keep one running max and denominator.  A thread's dims
// are interleaved float4 chunks (chunk c*SPLIT + part), and the four threads
// of a row sit 8 lanes apart: each quarter-warp reads one 16-byte word of a
// K/V row (a broadcast) and the four quarter-warps adjacent words (no bank
// conflict); on the card this placement beat neighbouring lanes, and four
// threads per row beat two (spills) and eight (more shuffles).  The
// q tile is staged through shared memory (coalesced) into registers; K/V
// tiles of BK keys are converted to float32 into shared memory and read back
// as broadcasts.  Each thread keeps its row's running max, denominator and
// accumulators in registers.  Tiles wholly past the causal diagonal of the q
// tile, and wholly before its sliding window, are never loaded.
//
// Bound: for TinyLlama-1.1B's prefill shape (b=4, sq=sk=1024, h=32, kvh=4,
// hd=64, bf16) the causal half of QK^T and PV is 2*b*h*sq*sk*hd = 17.2 GFLOP
// and the function must move 37.7 MB (q, k, v read once, o written once), so
// at 989 TFLOP/s bf16 (tensor cores) and 3.35 TB/s it is compute-bound at
// ~0.017 ms; at recurrentgemma-9b's (b=4, s=1024, h=16, kvh=1, hd=256) it is
// 34.4 GFLOP, ~0.035 ms.  This kernel runs on the CUDA cores in float32 (67
// TFLOP/s peak) with four FMAs per shared-memory load, and hd=64 takes 251
// registers (two CTAs per SM), so it is bound by instruction throughput and
// shared-memory bandwidth: chip_smoke.py measured 1.31 ms per call at
// TinyLlama's shape and 2.6 ms at recurrentgemma's on an NVIDIA H100 80GB
// HBM3 with a 700 W power limit (PERF.md).  The tensor-core (wgmma/TMA)
// version is later work (ROADMAP queue 2).  All
// products are written as fmaf(); the build's -fmad=false leaves the other
// arithmetic uncontracted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;  // keys per K/V tile

// Threads per query row, threads per CTA and query rows per CTA of a head dim.
template <int HD>
struct Tile {
  static constexpr int SPLIT = HD > 128 ? 4 : 1;
  static constexpr int THREADS = HD > 128 ? 256 : 128;
  static constexpr int ROWS = THREADS / SPLIT;
  static constexpr int DH = HD / SPLIT;  // dims per thread
  static_assert(DH % 4 == 0, "a thread's dims are whole float4 chunks");
};

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
  return (Tile<HD>::ROWS * (HD + 1) + 2 * BK * HD) * (int)sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(Tile<HD>::THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int sq,
                           int sk, int h, int kvh, int bq, int causal,
                           int window, float scale) {
  constexpr int THREADS = Tile<HD>::THREADS;
  constexpr int SPLIT = Tile<HD>::SPLIT;
  constexpr int ROWS = Tile<HD>::ROWS;
  constexpr int DH = Tile<HD>::DH;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [ROWS][HD + 1]
  float* ks = qs + ROWS * (HD + 1);             // [BK][HD]
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

  // the SPLIT threads of a row sit 32 / SPLIT lanes apart in one warp
  constexpr int WROWS = 32 / SPLIT;  // rows per warp
  const int lane = tid & 31;
  const int row = (tid >> 5) * WROWS + lane % WROWS;
  const int part = lane / WROWS;  // which float4 chunks of the row
  const int qi = row / g;
  const int gi = row - qi * g;
  const int qpos = q0 + qi;
  const bool active = qi < nq;

  // dims 4*(c*SPLIT + part) .. +3 of the row are this thread's chunk c
  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int c = 0; c < DH / 4; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * (c * SPLIT + part) + i;
      qr[4 * c + i] = active ? qs[row * (HD + 1) + d] : 0.f;
      acc[4 * c + i] = 0.f;
    }
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
    // with SPLIT > 1 every lane of the warp takes part in the shuffles, so
    // rows past the tile compute (and discard) their scores too
    if (SPLIT == 1 && !active) continue;

    float s[BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DH / 4; ++c) {
        const float4 kk = ks4[j * (HD / 4) + c * SPLIT + part];
        dot = fmaf(qr[4 * c + 0], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
#pragma unroll
      for (int off = 1; off < SPLIT; off <<= 1)
        dot = dot + __shfl_xor_sync(0xffffffffu, dot, off * WROWS);
      const int kpos = k0 + j;
      const bool ok = j < nk && (!causal || qpos >= kpos) &&
                      (window <= 0 || qpos - kpos < window);
      s[j] = ok ? dot * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    if (!active || tmax == -INFINITY) continue;  // nothing visible here

    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);  // 0 while m is still -inf
    l *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for masked keys
      l += p;
#pragma unroll
      for (int c = 0; c < DH / 4; ++c) {
        const float4 vv = vs4[j * (HD / 4) + c * SPLIT + part];
        acc[4 * c + 0] = fmaf(p, vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (!active) return;
  T* dst = o + (((size_t)bi * sq + qpos) * h + kv * g + gi) * HD;
  if (l > 0.f) {
#pragma unroll
    for (int c = 0; c < DH / 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[4 * (c * SPLIT + part) + i] = from_f32<T>(acc[4 * c + i] / l);
    return;
  }
  // no visible key: uniform weights over all sk keys, as the reference
  for (int c = 0; c < DH / 4; ++c) {
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * (c * SPLIT + part) + i;
      float sum = 0.f;
      for (int j = 0; j < sk; ++j)
        sum += to_f32(v[(((size_t)bi * sk + j) * kvh + kv) * HD + d]);
      dst[d] = from_f32<T>(sk > 0 ? sum / (float)sk : 0.f);
    }
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
  if (g > Tile<HD>::ROWS) return (int)cudaErrorInvalidValue;
  const int bq = Tile<HD>::ROWS / g;
  const int bytes = smem_bytes<HD>();
  const cudaError_t err = allow_smem<T, HD>(bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + bq - 1) / bq, kvh, b);
  flash_attention_kernel<T, HD><<<grid, Tile<HD>::THREADS, bytes, stream>>>(
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
    case 256:
      return launch<T, 256>(q, k, v, o, b, sq, sk, h, kvh, causal, window,
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
      b > 65535 || kvh > 65535)
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
