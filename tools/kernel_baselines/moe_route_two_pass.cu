// The earlier moe_route kernel of csrc/moe_route.cu, kept as the baseline
// of `tools/kernel_variants.py route`: two launches over 32-token tiles.
// Pass 1 (a warp per token, eight per CTA): softmax, top-k by k rounds of a
// warp argmax over a shared-memory row, gates, the tile's per-expert counts.
// Pass 2 (a CTA per tile): each expert's offset summed over the group's
// earlier tiles in tile order, then ranks within the tile by
// __match_any_sync.  Same contract and result as the committed kernel; the
// scratch is G * moe_route_tiles(gs) * E int32 counts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;     // warps per CTA in pass 1
constexpr int TILE = 32;     // tokens per tile
constexpr int MAX_E = 1024;  // experts

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(WARPS * 32)
    route_pass1(const float* __restrict__ logits, int* __restrict__ eid,
                float* __restrict__ gate, int* __restrict__ counts, int gs,
                int E, int k, int tiles) {
  extern __shared__ float smem[];
  int* cnt = reinterpret_cast<int*>(smem);  // [E]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* p = smem + E + warp * E;           // this warp's row [E]
  const int g = blockIdx.x / tiles;
  const int tile = blockIdx.x - g * tiles;
  const int t0 = tile * TILE;
  const int nt = min(TILE, gs - t0);

  for (int e = threadIdx.x; e < E; e += blockDim.x) cnt[e] = 0;
  __syncthreads();

  for (int tt = warp; tt < nt; tt += WARPS) {
    const size_t tok = (size_t)g * gs + t0 + tt;
    const float* x = logits + tok * E;
    float m = -INFINITY;
    for (int e = lane; e < E; e += 32) {
      const float v = x[e];
      p[e] = v;
      m = fmaxf(m, v);
    }
    m = warp_max(m);
    float s = 0.0f;
    for (int e = lane; e < E; e += 32) {
      const float v = expf(p[e] - m);
      p[e] = v;
      s = s + v;
    }
    s = warp_sum(s);
    for (int e = lane; e < E; e += 32) p[e] = p[e] / s;
    __syncwarp();

    int* eo = eid + tok * k;
    float* go = gate + tok * k;
    float total = 0.0f;
    for (int j = 0; j < k; ++j) {
      // probabilities lie in [0, 1]; a picked one is set to -1
      float bv = -2.0f;
      int bi = E;
      for (int e = lane; e < E; e += 32) {
        const float v = p[e];
        if (v > bv) {
          bv = v;
          bi = e;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (bi >= E) bi = 0;  // only NaN probabilities get here
      total = total + bv;
      if (lane == 0) {
        eo[j] = bi;
        go[j] = bv;
        p[bi] = -1.0f;
        atomicAdd(&cnt[bi], 1);
      }
      __syncwarp();
    }
    const float denom = fmaxf(total, 1e-9f);
    for (int j = lane; j < k; j += 32) go[j] = go[j] / denom;
    __syncwarp();
  }
  __syncthreads();
  int* co = counts + (size_t)blockIdx.x * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) co[e] = cnt[e];
}

__global__ void __launch_bounds__(128)
    route_pass2(const int* __restrict__ eid, const int* __restrict__ counts,
                int* __restrict__ slot, int gs, int E, int k, int tiles) {
  extern __shared__ int base[];  // [E]
  const int g = blockIdx.x / tiles;
  const int tile = blockIdx.x - g * tiles;
  const int* cg = counts + (size_t)g * tiles * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int off = 0;
    for (int t = 0; t < tile; ++t) off += cg[(size_t)t * E + e];
    base[e] = off;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const int t0 = tile * TILE;
  const int n = min(TILE, gs - t0) * k;
  const size_t first = ((size_t)g * gs + t0) * k;
  const unsigned below = (1u << lane) - 1u;
  for (int c = 0; c < n; c += 32) {
    const int i = c + lane;
    const bool valid = i < n;
    const int e = valid ? eid[first + i] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(peers & below);
    const int s = valid ? base[e] + rank : 0;
    __syncwarp();
    if (valid) {
      slot[first + i] = s;
      if (rank == 0) base[e] = base[e] + __popc(peers);
    }
    __syncwarp();
  }
}

}  // namespace

// Tiles per group, for the wrapper's scratch size (G * tiles * E int32).
extern "C" int moe_route_tiles(int gs) { return (gs + TILE - 1) / TILE; }

extern "C" int moe_route_launch(const void* logits, void* eid, void* gate,
                                void* slot, void* counts, int G, int gs,
                                int E, int k, void* stream) {
  if (G < 1 || gs < 1 || E < 1 || E > MAX_E || k < 1 || k > E)
    return (int)cudaErrorInvalidValue;
  const int tiles = moe_route_tiles(gs);
  if ((long long)G * tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t sm1 = sizeof(float) * (size_t)E * (1 + WARPS);
  route_pass1<<<G * tiles, WARPS * 32, sm1, st>>>(
      static_cast<const float*>(logits), static_cast<int*>(eid),
      static_cast<float*>(gate), static_cast<int*>(counts), gs, E, k, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  route_pass2<<<G * tiles, 128, sizeof(int) * (size_t)E, st>>>(
      static_cast<const int*>(eid), static_cast<const int*>(counts),
      static_cast<int*>(slot), gs, E, k, tiles);
  return (int)cudaGetLastError();
}
