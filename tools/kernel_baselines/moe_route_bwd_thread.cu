// The earlier gate backward of csrc/moe_route.cu, kept as the baseline of
// `tools/kernel_variants.py route bwd`: one thread per token in 128-thread
// CTAs, each walking its row of E logits three times (max, sum, output)
// with two expf per expert and its k picks in local memory.  Same contract
// as the committed kernel (moe_route_bwd_launch); its sums run in expert
// order, so the results differ in the last bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BWD_THREADS = 128;
constexpr int MAX_K = 64;
constexpr int MAX_E = 1024;

__global__ void __launch_bounds__(BWD_THREADS)
    route_bwd_kernel(const float* __restrict__ logits,
                     const int* __restrict__ eid,
                     const float* __restrict__ g_gate,
                     float* __restrict__ g_logits, long long tokens, int E,
                     int k) {
  const long long tok = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
  if (tok >= tokens) return;
  const float* lg = logits + tok * E;
  float* out = g_logits + tok * E;
  float mx = -INFINITY;
  for (int e = 0; e < E; ++e) mx = fmaxf(mx, lg[e]);
  float sum = 0.f;
  for (int e = 0; e < E; ++e) sum = sum + expf(lg[e] - mx);
  int ids[MAX_K];
  float v[MAX_K], gv[MAX_K];
  float vs = 0.f;
  for (int j = 0; j < k; ++j) {
    ids[j] = eid[tok * k + j];
    v[j] = expf(lg[ids[j]] - mx) / sum;
    vs = vs + v[j];
  }
  const bool free_sum = vs >= 1e-9f;
  const float den = free_sum ? vs : 1e-9f;
  float dot = 0.f;
  if (free_sum) {
    for (int j = 0; j < k; ++j)
      dot = dot + g_gate[tok * k + j] * (v[j] / den);
  }
  float dot2 = 0.f;
  for (int j = 0; j < k; ++j) {
    gv[j] = (g_gate[tok * k + j] - dot) / den;
    dot2 = dot2 + gv[j] * v[j];
  }
  for (int e = 0; e < E; ++e) {
    float gp = 0.f;
    for (int j = 0; j < k; ++j)
      if (ids[j] == e) gp = gv[j];
    out[e] = (expf(lg[e] - mx) / sum) * (gp - dot2);
  }
}

}  // namespace

extern "C" int moe_route_bwd_launch(const void* logits, const void* eid,
                                    const void* g_gate, void* g_logits,
                                    int G, int gs, int E, int k,
                                    void* stream) {
  if (G < 1 || gs < 1 || E < 1 || E > MAX_E || k < 1 || k > E ||
      k > MAX_K)
    return (int)cudaErrorInvalidValue;
  const long long tokens = (long long)G * gs;
  const long long blocks = (tokens + BWD_THREADS - 1) / BWD_THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  route_bwd_kernel<<<(unsigned)blocks, BWD_THREADS, 0,
                     (cudaStream_t)stream>>>(
      static_cast<const float*>(logits), static_cast<const int*>(eid),
      static_cast<const float*>(g_gate), static_cast<float*>(g_logits),
      tokens, E, k);
  return (int)cudaGetLastError();
}
