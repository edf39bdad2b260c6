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


// ------------------------------------------------------------- backward
//
// The gradient of the scan for the output's gradient gy (b, s, d_in)
// float32: with the state's gradient running backwards,
//   gh_t = C_t gy_t + dA_{t+1} gh_{t+1}   (gh_s = 0 past the end),
//   g_dA_t = gh_t h_{t-1},  g_dBx_t = gh_t,  g_C_t = sum_d gy_t[d] h_t[d],
// g_dA and g_dBx in the inputs' dtype, g_C float32.  Apart from g_C the
// recurrences are independent per state, so one thread per (batch row,
// channel, state): NP lanes per channel (n rounded up to a power of two),
// 32 / NP channels per warp, whose step t of dA or dBx is one contiguous
// span, read with loads issued several steps ahead.  Three launches, no
// atomics, so g_C is the same on every run:
//   1. scan_ckpt_kernel, forward: recompute h_t, keep h before every
//      CKPT-th step in ckpt (b, ceil(s / CKPT), d_in, n) float32, 1 / CKPT
//      of the states, and reduce gy_t h_t over the CTA's channels: an xor
//      butterfly over the warp's channels, then the warps in order through
//      shared memory, one partial per (batch row, step, CTA, state);
//   2. scan_bwd_kernel, backward, chunk by chunk from the last: load the
//      chunk's CKPT steps of dA, dBx and C gy into registers, recompute its
//      states from its checkpoint (the same product, then sum, as pass 1,
//      so the same bits), then walk gh down the chunk.  A kernel of its
//      own, so each pass has its own registers and occupancy;
//   3. scan_bwd_gc_kernel: each step's partials summed over the CTAs in
//      order.
// The function must read dA, dBx and write g_dA, g_dBx once (bound by
// bytes, 2.604 ms at (4, 1024, 8192, 16) float32 on an H100); this design
// reads dA and dBx twice (two thirds of the bound at best).  Keeping the
// checkpoints from the training forward would drop pass 1's reads.

template <typename T>
__device__ __forceinline__ void store(T* p, float x);
template <>
__device__ __forceinline__ void store<float>(float* p, float x) {
  __stcs(p, x);
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p,
                                                     float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float load1(const T* p) {
  return to_f32(__ldcs(p));
}

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int CKPT = 8;   // steps per checkpoint (a chunk of pass 2)
constexpr int GC = 32;    // steps of g_C partials per CTA barrier (pass 1)
constexpr int UB = 16;    // steps loaded ahead in pass 1
// (CKPT and UB: the fastest of a sweep of text variants at (4 and 1, 1024,
// 8192, 16) float32 on an H100)

// lanes per channel: n rounded up to a power of two
__host__ __device__ constexpr int lanes_per_channel(int n) {
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 16;
}

// Pass 1: one thread per (batch row, channel, state); the checkpoints and
// the g_C partials
template <typename T, int N>
__global__ void __launch_bounds__(BWD_THREADS)
    scan_ckpt_kernel(const T* __restrict__ dA, const T* __restrict__ dBx,
                     const float* __restrict__ gy, float* __restrict__ ckpt,
                     float* __restrict__ partial, int s, int d_in) {
  constexpr int NP = lanes_per_channel(N);
  constexpr int CPC = BWD_THREADS / NP;  // channels per CTA
  static_assert(GC % CKPT == 0 && GC % UB == 0, "chunks nest");
  __shared__ float wsum[GC][BWD_WARPS][NP];
  const int bi = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int i = tid % NP;  // the state
  const int ch = blk * CPC + tid / NP;
  const bool live_ch = ch < d_in;
  const bool active = live_ch && i < N;
  const size_t row = (size_t)d_in * N;  // elements of one step
  const size_t base = (size_t)bi * s * row + (size_t)ch * N + i;
  const float* pg = gy + (size_t)bi * s * d_in + ch;
  const int nck = (s + CKPT - 1) / CKPT;
  float* pk = ckpt + (size_t)bi * nck * row + (size_t)ch * N + i;

  float h = 0.0f;
  for (int t0 = 0; t0 < s; t0 += GC) {
    const int nt = min(GC, s - t0);
    for (int tt = 0; tt < nt; tt += UB) {
      float a[UB], bx[UB], gg[UB];
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const size_t t = (size_t)(t0 + tt + u);
        const bool ok = tt + u < nt;
        a[u] = ok && active ? to_f32(dA[base + t * row]) : 0.0f;
        bx[u] = ok && active ? to_f32(dBx[base + t * row]) : 0.0f;
        gg[u] = ok && live_ch ? pg[t * d_in] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        if (tt + u >= nt) break;  // the same for the whole CTA
        if ((tt + u) % CKPT == 0 && active)
          pk[(size_t)((t0 + tt + u) / CKPT) * row] = h;
        h = a[u] * h + bx[u];
        float c = gg[u] * h;
#pragma unroll
        for (int off = NP; off < 32; off <<= 1)
          c = c + __shfl_xor_sync(0xffffffffu, c, off);
        if (lane < NP) wsum[tt + u][warp][lane] = c;
      }
    }
    __syncthreads();
    for (int e = tid; e < nt * N; e += BWD_THREADS) {
      const int tt = e / N;
      const int j = e - tt * N;
      float acc = wsum[tt][0][j];
      for (int w = 1; w < BWD_WARPS; ++w) acc = acc + wsum[tt][w][j];
      partial[(((size_t)bi * s + t0 + tt) * nblk + blk) * N + j] = acc;
    }
    __syncthreads();
  }
}

// Pass 2: the same threads, chunk by chunk from the last
template <typename T, int N>
__global__ void __launch_bounds__(BWD_THREADS)
    scan_bwd_kernel(const T* __restrict__ dA, const T* __restrict__ dBx,
                    const float* __restrict__ C, const float* __restrict__ gy,
                    const float* __restrict__ ckpt, T* __restrict__ g_dA,
                    T* __restrict__ g_dBx, int s, int d_in) {
  constexpr int NP = lanes_per_channel(N);
  constexpr int CPC = BWD_THREADS / NP;
  const int bi = blockIdx.y;
  const int i = threadIdx.x % NP;
  const int ch = blockIdx.x * CPC + threadIdx.x / NP;
  if (ch >= d_in || i >= N) return;
  const size_t row = (size_t)d_in * N;
  const size_t base = (size_t)bi * s * row + (size_t)ch * N + i;
  const float* pc = C + (size_t)bi * s * N + i;
  const float* pg = gy + (size_t)bi * s * d_in + ch;
  const int nck = (s + CKPT - 1) / CKPT;
  const float* pk = ckpt + (size_t)bi * nck * row + (size_t)ch * N + i;

  float carry = 0.0f;  // dA_{t+1} gh_{t+1}
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * CKPT;
    const int nt = min(CKPT, s - t0);
    float a[CKPT], hp[CKPT], cg[CKPT];
#pragma unroll
    for (int u = 0; u < CKPT; ++u) {
      const size_t t = (size_t)(t0 + u);
      const bool ok = u < nt;
      a[u] = ok ? load1(dA + base + t * row) : 0.0f;
      hp[u] = ok ? load1(dBx + base + t * row) : 0.0f;
      cg[u] = ok ? pc[t * N] * pg[t * d_in] : 0.0f;
    }
    // the chunk's states from its checkpoint: hp[u] = h before step u
    float hh = pk[(size_t)c * row];
#pragma unroll
    for (int u = 0; u < CKPT; ++u) {
      const float bx = hp[u];
      hp[u] = hh;
      hh = a[u] * hh + bx;
    }
#pragma unroll
    for (int u = CKPT - 1; u >= 0; --u) {
      if (u >= nt) continue;
      const size_t off = base + (size_t)(t0 + u) * row;
      const float gh = cg[u] + carry;
      store<T>(g_dBx + off, gh);
      store<T>(g_dA + off, gh * hp[u]);
      carry = a[u] * gh;
    }
  }
}

// g_C (b, s, n) = the sum of the nblk partials of each (row, step, state),
// in CTA order
__global__ void scan_bwd_gc_kernel(const float* __restrict__ partial,
                                   float* __restrict__ g_C, long long total,
                                   int nblk, int n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long bt = e / n;
  const int i = (int)(e - bt * n);
  const float* p = partial + (size_t)bt * nblk * n + i;
  float acc = p[0];
  for (int k = 1; k < nblk; ++k) acc = acc + p[(size_t)k * n];
  g_C[e] = acc;
}

template <typename T, int N>
int launch_bwd(const void* dA, const void* dBx, const void* C, const void* gy,
               void* ckpt, void* g_dA, void* g_dBx, void* partial, void* g_C,
               int b, int s, int d_in, cudaStream_t st) {
  constexpr int CPC = BWD_THREADS / lanes_per_channel(N);
  const int nblk = (d_in + CPC - 1) / CPC;
  const dim3 grid(nblk, b);
  scan_ckpt_kernel<T, N><<<grid, BWD_THREADS, 0, st>>>(
      static_cast<const T*>(dA), static_cast<const T*>(dBx),
      static_cast<const float*>(gy), static_cast<float*>(ckpt),
      static_cast<float*>(partial), s, d_in);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_bwd_kernel<T, N><<<grid, BWD_THREADS, 0, st>>>(
      static_cast<const T*>(dA), static_cast<const T*>(dBx),
      static_cast<const float*>(C), static_cast<const float*>(gy),
      static_cast<const float*>(ckpt), static_cast<T*>(g_dA),
      static_cast<T*>(g_dBx), s, d_in);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)b * s * N;
  scan_bwd_gc_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(g_C), total,
      nblk, N);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* dA, const void* dBx, const void* C,
                 const void* gy, void* ckpt, void* g_dA, void* g_dBx,
                 void* partial, void* g_C, int b, int s, int d_in, int n,
                 cudaStream_t st) {
  switch (n) {
#define SCAN_BWD_CASE(NN)                                                 \
  case NN:                                                                \
    return launch_bwd<T, NN>(dA, dBx, C, gy, ckpt, g_dA, g_dBx, partial, \
                             g_C, b, s, d_in, st);
    SCAN_BWD_CASE(1) SCAN_BWD_CASE(2) SCAN_BWD_CASE(3) SCAN_BWD_CASE(4)
    SCAN_BWD_CASE(5) SCAN_BWD_CASE(6) SCAN_BWD_CASE(7) SCAN_BWD_CASE(8)
    SCAN_BWD_CASE(9) SCAN_BWD_CASE(10) SCAN_BWD_CASE(11) SCAN_BWD_CASE(12)
    SCAN_BWD_CASE(13) SCAN_BWD_CASE(14) SCAN_BWD_CASE(15) SCAN_BWD_CASE(16)
#undef SCAN_BWD_CASE
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

// The backward's scratch at (s, d_in, n): writes into dims[2] the
// checkpoints per row, ceil(s / CKPT), and the channel blocks of the g_C
// partials, ceil(d_in / channels per CTA).  The stream is unused (the
// signature is the launchers').
extern "C" int selective_scan_bwd_scratch(void* dims, int s, int d_in, int n,
                                          void* stream) {
  (void)stream;
  if (s < 1 || d_in < 1 || n < 1 || n > MAX_N)
    return (int)cudaErrorInvalidValue;
  const int cpc = BWD_THREADS / lanes_per_channel(n);
  ((int*)dims)[0] = (s + CKPT - 1) / CKPT;
  ((int*)dims)[1] = (d_in + cpc - 1) / cpc;
  return 0;
}

// The backward: gy (b, s, d_in) float32 -> g_dA, g_dBx (b, s, d_in, n) in
// the inputs' dtype and g_C (b, s, n) float32.  ckpt (b, ceil(s / CKPT),
// d_in, n) float32 and partial (b, s, ceil(d_in / cta_channels), n)
// float32 are scratch.  Three launches.
extern "C" int selective_scan_bwd_launch(const void* dA, const void* dBx,
                                         const void* C, const void* gy,
                                         void* ckpt, void* g_dA, void* g_dBx,
                                         void* partial, void* g_C, int b,
                                         int s, int d_in, int n, int dtype,
                                         void* stream) {
  if (b < 1 || b > 65535 || s < 1 || d_in < 1 || n < 1 || n > MAX_N)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_bwd<float>(dA, dBx, C, gy, ckpt, g_dA, g_dBx, partial,
                               g_C, b, s, d_in, n, st);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(dA, dBx, C, gy, ckpt, g_dA, g_dBx,
                                       partial, g_C, b, s, d_in, n, st);
  return (int)cudaErrorInvalidValue;
}
