// The two sequential placement scans of one scheduling interval, batched over
// grid cells: greedy BestFit requests and the RAM feasibility repair.
//
// These replace no Pallas kernel: in the JAX reference they are the
// lax.fori_loop bodies of src/repro/env/jaxsim/kernels.py (bestfit_requests,
// loop at :202; apply_requests, loop at :271).  Their eager PyTorch twins
// (repro_torch/kernels/placement.py) run one Python iteration per fragment,
// ~20 tiny launches each, which dominates an interval once the fleet is
// loaded (thousands of iterations).  Here each cell's whole scan is one warp.
//
// Design: one 32-thread block per grid cell.  The per-worker state (n <=
// MAX_N floats: free RAM, load and score for BestFit; RAM in use for the
// repair) lives in shared memory.  Every lane runs the scalar logic of the
// scan redundantly on broadcast reads, so branches stay warp-uniform; lane 0
// alone writes, then __syncwarp().  Each argmax over workers is a warp
// reduction that keeps the first maximum (torch.argmax / jnp.argmax).  Each
// cell stops at its own trip count, read on the device, so the host never
// waits for it.  Compiled with -fmad=false: the score arithmetic rounds like
// the eager twin, operation by operation.
//
// Bound: the scans are sequential chains of dependent loads and warp
// reductions; the bytes they must move (tens of KB per cell) take well under
// a microsecond at 3.35 TB/s.  Latency per step bounds them: chip_smoke.py
// measured 0.63 ms (BestFit, 779 steps in the longest cell) and 1.07 ms
// (repair, 683 slots) per call on the G=16 main-path grid on an NVIDIA H100
// 80GB HBM3 with a 700 W power limit (PERF.md).

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

__global__ void __launch_bounds__(32)
repair_kernel(const int64_t* order, const int64_t* trip, int K, int F,
              const uint8_t* alive, const uint8_t* done, const uint8_t* chain,
              const int32_t* stage, const int32_t* req, const double* ram,
              const double* cap, int32_t* worker2, uint8_t* placed, int n) {
  __shared__ double s_used[MAX_N], s_cap[MAX_N], s_head[MAX_N];
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  for (int w = lane; w < n; w += 32) {
    s_used[w] = 0.0;
    s_cap[w] = cap[w];
  }
  __syncwarp();
  const size_t kf = (size_t)g * K * F;
  const size_t k0 = (size_t)g * K;
  const int64_t trips = trip[g] < K ? trip[g] : K;
  for (int64_t i = 0; i < trips; ++i) {
    const int64_t slot = order[k0 + i];
    const bool pb = alive[k0 + slot];
    const bool ch = chain[k0 + slot];
    const int st = stage[k0 + slot];
    const size_t row = kf + (size_t)slot * F;
    bool ok = true;
    for (int f = 0; f < F; ++f) {
      const bool act = pb && !done[row + f] && ok;
      if (!act) continue;
      const bool holds = !ch || f == st;
      int w = req[row + f];
      w = w < 0 ? 0 : (w > n - 1 ? n - 1 : w);
      const double rm = ram[row + f];
      const bool infeas = holds && (s_used[w] + rm > s_cap[w]);
      int w2 = w;
      bool admit = true;
      if (infeas) {
        for (int v = lane; v < n; v += 32) s_head[v] = s_cap[v] - s_used[v];
        __syncwarp();
        const int cand = warp_argmax(s_head, n);
        const bool fb_ok = s_head[cand] >= rm;
        __syncwarp();
        if (fb_ok) {
          w2 = cand;
        } else {
          admit = false;
          ok = false;
        }
      }
      if (admit) {
        if (lane == 0) {
          worker2[row + f] = w2;
          if (holds) s_used[w2] = s_used[w2] + rm;
        }
        __syncwarp();
      }
    }
    if (pb && !ok && lane == 0)
      for (int f = 0; f < F; ++f) worker2[row + f] = -1;
    if (pb && lane == 0) placed[k0 + slot] = ok;
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

extern "C" int repair_scan_launch(const void* order, const void* trip, int G,
                                  int K, int F, const void* alive,
                                  const void* done, const void* chain,
                                  const void* stage, const void* req,
                                  const void* ram, const void* cap,
                                  void* worker2, void* placed, int n,
                                  void* stream) {
  if (n < 1 || n > MAX_N || G < 1 || K < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  repair_kernel<<<G, 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)order, (const int64_t*)trip, K, F,
      (const uint8_t*)alive, (const uint8_t*)done, (const uint8_t*)chain,
      (const int32_t*)stage, (const int32_t*)req, (const double*)ram,
      (const double*)cap, (int32_t*)worker2, (uint8_t*)placed, n);
  return (int)cudaGetLastError();
}
