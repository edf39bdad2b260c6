// The earlier BestFit kernel of csrc/placement.cu, kept as the baseline of
// `tools/kernel_variants.py bestfit`: one 32-thread block per cell with the
// per-worker state in shared memory; each step loads its fragment's index
// and RAM from global memory, stores the masked scores to shared memory and
// runs a warp argmax that shuffles a double and an index per level.  Same C
// entry and result as the committed kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 128;
constexpr unsigned FULL = 0xffffffffu;

// first maximum of v[0..n) over the warp: every lane returns the index
__device__ __forceinline__ int warp_argmax(const double* v, int n) {
  const int lane = threadIdx.x;
  double best = -INFINITY;
  int idx = 0x7fffffff;
  for (int w = lane; w < n; w += 32) {
    const double x = v[w];
    if (x > best || idx == 0x7fffffff) {
      best = x;
      idx = w;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double ob = __shfl_xor_sync(FULL, best, off);
    const int oi = __shfl_xor_sync(FULL, idx, off);
    if (oi != 0x7fffffff &&
        (idx == 0x7fffffff || ob > best || (ob == best && oi < idx))) {
      best = ob;
      idx = oi;
    }
  }
  return idx;
}

__global__ void __launch_bounds__(32)
bestfit_kernel(const int64_t* pos, const int64_t* n_new, int P,
               const double* ram, const double* ram_free0,
               const double* load0, const double* score0,
               const double* stat, const double* cap, int32_t* req,
               int KF, int n) {
  __shared__ double s_free[MAX_N], s_load[MAX_N], s_score[MAX_N];
  __shared__ double s_buf[MAX_N], s_static[MAX_N], s_cap[MAX_N];
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  for (int w = lane; w < n; w += 32) {
    s_free[w] = ram_free0[(size_t)g * n + w];
    s_load[w] = load0[(size_t)g * n + w];
    s_score[w] = score0[(size_t)g * n + w];
    s_static[w] = stat[w];
    s_cap[w] = cap[w];
  }
  __syncwarp();
  const double* ram_g = ram + (size_t)g * KF;
  int32_t* req_g = req + (size_t)g * KF;
  const int64_t trips = n_new[g] < P ? n_new[g] : P;
  for (int64_t i = 0; i < trips; ++i) {
    const int64_t p = pos[(size_t)g * P + i];
    const double rm = ram_g[p];
    for (int w = lane; w < n; w += 32)
      s_buf[w] = s_free[w] < rm ? -1e9 : s_score[w];
    __syncwarp();
    const int w = warp_argmax(s_buf, n);
    const double nf = s_free[w] - rm;
    const double nl = s_load[w] + 1.0;
    const double ns = -nl + s_static[w] + 0.1 * nf / s_cap[w];
    __syncwarp();
    if (lane == 0) {
      req_g[p] = w;
      s_free[w] = nf;
      s_load[w] = nl;
      s_score[w] = ns;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int bestfit_scan_launch(const void* pos, const void* n_new, int G,
                                   int P, const void* ram,
                                   const void* ram_free0, const void* load0,
                                   const void* score0, const void* stat,
                                   const void* cap, void* req, int KF, int n,
                                   void* stream) {
  if (n < 1 || n > MAX_N || G < 1 || P < 1 || KF < 1)
    return (int)cudaErrorInvalidValue;
  bestfit_kernel<<<G, 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)pos, (const int64_t*)n_new, P, (const double*)ram,
      (const double*)ram_free0, (const double*)load0, (const double*)score0,
      (const double*)stat, (const double*)cap, (int32_t*)req, KF, n);
  return (int)cudaGetLastError();
}
