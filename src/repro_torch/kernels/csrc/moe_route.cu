// MoE routing: softmax -> top-k -> normalised gates -> per-expert capacity
// slots, for G independent token groups.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_route.py::moe_route
// (pl.pallas_call at :83).  Contract (repro_torch/kernels/ref.py::
// moe_route_ref's): logits (G, gs, E) float32, contiguous; outputs eid int32,
// gate float32 and slot int32, each (G, gs, k).  Per token: probabilities are
// the float32 softmax (max-subtracted expf, IEEE division); the k experts are
// the k largest probabilities, distinct, the lower index first among equal
// values (lax.top_k's order; the Pallas kernel instead picks expert 0 again
// once every remaining probability is 0); gates are the picked probabilities
// over max(their sum, 1e-9).  slot is the number of earlier entries of the
// same expert in the group, in flattened (token, choice) order, so the
// counters start at 0 in every group.
//
// Design.  The TPU kernel walks token blocks in grid order and carries the
// per-expert counters in VMEM; CTAs run in no order, so the counters become
// two passes over tiles of TILE tokens:
//   pass 1 (one CTA per (group, tile), one warp per token): softmax, top-k by
//     k rounds of a warp argmax (ties to the lower index), gates, and the
//     tile's per-expert pick count (integer shared-memory atomics: a count
//     does not depend on their order);
//   pass 2 (one CTA per (group, tile)): each expert's offset is the sum of
//     its counts in the group's earlier tiles, in tile order; then one warp
//     walks the tile's entries in (token, choice) order, 32 at a time, and
//     ranks each among the chunk's entries of the same expert with
//     __match_any_sync, so every slot is exact and the same on every run.
//
// Bound: at the serving shape (G=1, gs=4096, E=60, k=4) the function reads
// 0.98 MB of logits and writes 0.20 MB, 0.35 us at 3.35 TB/s; the two
// launches set its time.  Products and sums are written out; the build's
// -fmad=false keeps them uncontracted.

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
