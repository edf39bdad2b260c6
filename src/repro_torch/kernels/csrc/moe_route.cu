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
// Design: one launch.  The TPU kernel walks token blocks in grid order and
// carries the per-expert counters in VMEM; here every tile of tokens is a
// CTA, and the counters become a decoupled look-back:
//   1. a CTA's tile is its block index when the grid fits one wave (every
//      CTA is resident then, or will be once other work drains), else a
//      ticket from an atomic counter, so that a tile only ever waits on
//      tiles that are already running;
//   2. each token is a sub-warp of L lanes (L = ceil(E / VPL) rounded up to
//      a power of two: 16 lanes of 4 logits at E = 60, 32 tokens per CTA),
//      which holds its logits in registers: max, sum and each of the k
//      argmax rounds are log2(L) butterfly levels; an argmax reduces one
//      64-bit key (probability bits above the complemented index, so equal
//      values go to the lower index), built once per logit;
//   3. the tile publishes its per-expert counts (flag 1; the inclusive
//      prefix, flag 2, for tile 0): stores, a CTA barrier, one release store;
//   4. it ranks its (token, choice) entries: each ranking warp takes 32
//      entries at a time and ranks each among the entries of its expert with
//      __match_any_sync, over running per-warp counts;
//   5. every thread polls one predecessor's flag, and the counts of the
//      predecessors back to the nearest inclusive prefix are summed as int4
//      columns, all of a thread's loads in flight at once; the tile then
//      publishes its own inclusive prefix and writes slot = prefix + rank.
// Every slot is exact and the same on every run: no unordered atomic decides
// an output (shared-memory integer adds form counts, which no order
// changes).  The ticket and the flags are cleared by a cudaMemsetAsync on the
// launch's stream, so the call stays capturable in a CUDA graph; a wait that
// spins past ~2^26 polls traps instead of hanging the card.
//
// Bound: at the serving shape (G=1, gs=4096, E=60, k=4) the function reads
// 0.98 MB of logits and writes 0.20 MB, 0.35 us at 3.35 TB/s; latency sets
// its time.  tools/kernel_variants.py measured, from CUDA graphs on an
// NVIDIA H100 80GB HBM3 with a 700 W power limit, 9.4 us per call (the
// earlier two-pass design: 18.4 us), of which the memset node alone takes
// 1.6-2.5 us and an empty kernel node ~1.05 us; the kernel spans ~6.3 us from
// the first CTA's entry to the last's exit, and per CTA the token phase
// takes ~2.2 us and the look-back ~1.8 us (PERF.md).
// Products and sums are written out; the build's -fmad=false keeps them
// uncontracted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int MAX_E = 1024;     // experts
constexpr int TILE = 32;        // tokens per CTA, at most
constexpr int VPL = 4;          // logits per lane (32 when E > 32 * VPL);
                                // a power of two
constexpr int MAX_THREADS = 512;
constexpr int MAX_ENT = 2048;   // (token, choice) entries per tile, at most
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SPIN_LIMIT = 1ll << 26;

struct Plan {
  int V, L, tt, threads, tiles, rank_warps, chunks_per_warp;
  size_t smem;
};

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

inline Plan make_plan(int gs, int E, int k) {
  Plan p;
  p.V = E <= 32 * VPL ? VPL : 32;
  p.L = pow2_at_least((E + p.V - 1) / p.V);
  p.tt = TILE;
  if (p.tt > MAX_THREADS / p.L) p.tt = MAX_THREADS / p.L;
  if (p.tt > MAX_ENT / k) p.tt = MAX_ENT / k;
  if (p.tt > gs) p.tt = gs;
  if (p.tt < 1) p.tt = 1;
  p.threads = (p.tt * p.L + 31) / 32 * 32;
  p.tiles = (gs + p.tt - 1) / p.tt;
  const int chunks = (p.tt * k + 31) / 32;
  const int warps = p.threads / 32;
  p.rank_warps = chunks < warps ? chunks : warps;
  p.chunks_per_warp = (chunks + p.rank_warps - 1) / p.rank_warps;
  p.smem = sizeof(int) * ((size_t)3 * p.tt * k + (size_t)(2 + p.rank_warps) * E);
  return p;
}

// count rows are padded to whole int4s, and start 16-byte aligned after
// the ticket and the flags
__host__ __device__ inline int row_stride(int E) { return (E + 3) & ~3; }
__host__ __device__ inline size_t flag_words(int G, int tiles) {
  return ((size_t)1 + (size_t)G * tiles + 3) & ~(size_t)3;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// max of a register array as a tree (V a power of two)
template <int V, typename T>
__device__ __forceinline__ T tree_max(T (&t)[V]) {
#pragma unroll
  for (int w = 1; w < V; w *= 2)
#pragma unroll
    for (int v = 0; v + w < V; v += 2 * w)
      t[v] = t[v] > t[v + w] ? t[v] : t[v + w];
  return t[0];
}

template <int V>
__global__ void __launch_bounds__(MAX_THREADS)
    route_kernel(const float* __restrict__ logits, int* __restrict__ eid,
                 float* __restrict__ gate, int* __restrict__ slot,
                 int* __restrict__ scratch, int G, int gs, int E, int k,
                 int L, int tt, int tiles, int rank_warps,
                 int chunks_per_warp, int ticketed) {
  extern __shared__ __align__(16) int smem[];
  const int cap = tt * k;
  int* s_e = smem;                                   // [cap] expert ids
  float* s_g = reinterpret_cast<float*>(s_e + cap);  // [cap] probabilities
  int* s_loc = reinterpret_cast<int*>(s_g + cap);    // [cap] rank in warp
  int* s_cnt = s_loc + cap;                          // [E] tile counts
  int* s_base = s_cnt + E;                           // [E] earlier tiles
  int* s_cc = s_base + E;                            // [rank_warps][E]
  __shared__ int s_ticket, s_near;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int R = row_stride(E);
  int* ticket = scratch;
  int* flag = scratch + 1;                      // [G * tiles]
  int* agg = scratch + flag_words(G, tiles);    // [G * tiles][R]
  int* incl = agg + (size_t)G * tiles * R;      // [G * tiles][R]

  // ---- 1. which tile: the block index when the grid fits one wave (every
  // CTA is then resident, or will be once other work drains), else a
  // ticket; without one the logits' loads start before the first barrier
  if (ticketed && tid == 0) s_ticket = atomicAdd(ticket, 1);
  for (int i = tid; i < (2 + rank_warps) * E; i += nthr) s_cnt[i] = 0;
  if (ticketed) __syncthreads();
  const int tk = ticketed ? s_ticket : blockIdx.x;
  const int g = tk / tiles;
  const int tile = tk - g * tiles;
  const int t0 = tile * tt;
  const int nt = min(tt, gs - t0);

  // ---- 2. one token per sub-warp of L lanes; logit e = sl + L * v
  const int sw = tid / L, sl = tid - sw * L;
  const bool valid = sw < nt;
  const size_t tok = (size_t)g * gs + t0 + sw;
  unsigned long long keys[V];   // probability bits above ~e; 0 once picked
  {
    const float* row = logits + tok * E;
    float x[V], t[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int e = sl + L * v;
      x[v] = (valid && e < E) ? row[e] : -INFINITY;
      t[v] = x[v];
    }
    if (!ticketed) __syncthreads();  // the counts are zero before any add
    float m = tree_max(t);
    for (int off = L >> 1; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off, L));
#pragma unroll
    for (int v = 0; v < V; ++v) {
      x[v] = expf(x[v] - m);
      t[v] = x[v];
    }
    // the sum in a fixed pairwise order
#pragma unroll
    for (int w = 1; w < V; w *= 2)
#pragma unroll
      for (int v = 0; v + w < V; v += 2 * w) t[v] = t[v] + t[v + w];
    float s = t[0];
    for (int off = L >> 1; off > 0; off >>= 1)
      s = s + __shfl_xor_sync(FULL, s, off, L);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int e = sl + L * v;
      keys[v] = e < E ? ((unsigned long long)__float_as_uint(x[v] / s) << 32) |
                            (unsigned)~e
                      : 0ull;
    }
  }
  float total = 0.0f;
  for (int j = 0; j < k; ++j) {
    unsigned long long t[V];
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = keys[v];
    unsigned long long best = tree_max(t);
    for (int off = L >> 1; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, best, off, L);
      best = o > best ? o : best;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) keys[v] = keys[v] == best ? 0ull : keys[v];
    const int bi = (int)~(unsigned)best;
    const float bv = __uint_as_float((unsigned)(best >> 32));
    total = total + bv;
    if (valid && sl == 0) {
      s_e[sw * k + j] = bi;
      s_g[sw * k + j] = bv;
      atomicAdd(s_cnt + bi, 1);  // a count: the same in any order
    }
  }
  __syncthreads();

  // ---- 3. publish the tile's counts (the inclusive prefix for tile 0):
  // stores, a CTA barrier, then one release store of the flag by the last
  // thread (whose warp does not rank), before the outputs' stores, which
  // the release would otherwise wait for
  const size_t gt = (size_t)g * tiles + tile;
  int* out = tile == 0 ? incl : agg;
  for (int e = tid; e < E; e += nthr) __stcg(out + gt * R + e, s_cnt[e]);
  __syncthreads();
  if (tid == nthr - 1) st_release(flag + gt, tile == 0 ? 2 : 1);
  if (valid) {
    const float denom = fmaxf(total, 1e-9f);
    for (int i = sl; i < k; i += L) {
      eid[tok * k + i] = s_e[sw * k + i];
      gate[tok * k + i] = s_g[sw * k + i] / denom;
    }
  }

  // ---- 4. rank the tile's entries in (token, choice) order
  const int n_ent = nt * k;
  if (warp < rank_warps) {
    int* row = s_cc + warp * E;
    const int c1 = min((warp + 1) * chunks_per_warp, (n_ent + 31) / 32);
    for (int c = warp * chunks_per_warp; c < c1; ++c) {
      const int i = c * 32 + lane;
      const bool ok = i < n_ent;
      const int e = ok ? s_e[i] : -1;
      const unsigned peers = __match_any_sync(FULL, e);
      const int r = __popc(peers & ((1u << lane) - 1u));
      if (ok) s_loc[i] = row[e] + r;
      __syncwarp();
      if (ok && r == 0) row[e] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  for (int e = tid; e < E; e += nthr) {
    int off = 0;
    for (int w = 0; w < rank_warps; ++w) {
      const int c = s_cc[w * E + e];
      s_cc[w * E + e] = off;
      off += c;
    }
  }
  __syncthreads();

  // ---- 5. look back: thread i polls predecessor j - i of a window of up
  // to nthr; the window's counts back to the nearest inclusive prefix are
  // summed as int4 columns, `groups` threads per column, all loads of a
  // thread in flight at once
  if (tile > 0) {
    const int C4 = R / 4;
    const int groups = nthr >= C4 ? nthr / C4 : 1;
    int j = tile - 1;  // nearest predecessor not yet summed
    for (;;) {
      const int W = min(j + 1, nthr);
      const int* fp = flag + (size_t)g * tiles + (j - tid);
      int f = tid < W ? ld_acquire(fp) : 0;
      int near = W;
      for (long long spin = 0;; ++spin) {
        if (tid == 0) s_near = W;
        __syncthreads();
        if (tid < W && f == 2) atomicMin(&s_near, tid);
        __syncthreads();
        near = s_near;
        if (!__syncthreads_or(tid < W && tid <= near && f == 0)) break;
        if (spin > SPIN_LIMIT) __trap();
        if (tid < W && f == 0) f = ld_acquire(fp);
      }
      const int need = near < W ? near + 1 : W;
      for (int q = tid; q < groups * C4; q += nthr) {
        const int c = q % C4;
        int4 a = make_int4(0, 0, 0, 0);
#pragma unroll 8
        for (int i = q / C4; i < need; i += groups) {
          const size_t jt = (size_t)g * tiles + (j - i);
          const int4 b = __ldcg(reinterpret_cast<const int4*>(
              (i == near ? incl : agg) + jt * R) + c);
          a.x += b.x;
          a.y += b.y;
          a.z += b.z;
          a.w += b.w;
        }
        // integers: any order gives one sum (padding columns are skipped)
        const int v4[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * c + u < E && v4[u]) atomicAdd(s_base + 4 * c + u, v4[u]);
      }
      __syncthreads();
      if (near < W) break;
      j -= W;
    }
    for (int e = tid; e < E; e += nthr)
      __stcg(incl + gt * R + e, s_base[e] + s_cnt[e]);
    __syncthreads();
    if (tid == nthr - 1) st_release(flag + gt, 2);
  }

  // ---- 6. slots
  const size_t first = ((size_t)g * gs + t0) * k;
  for (int i = tid; i < n_ent; i += nthr) {
    const int e = s_e[i];
    const int w = (i >> 5) / chunks_per_warp;
    slot[first + i] = s_base[e] + s_cc[w * E + e] + s_loc[i];
  }
}

}  // namespace

// int32 words of scratch the wrapper allocates for one call (16-byte
// aligned): the ticket, a flag per tile, and two count rows per tile.
extern "C" long long moe_route_scratch(int G, int gs, int E, int k) {
  if (G < 1 || gs < 1 || E < 1 || k < 1) return 4;
  const Plan p = make_plan(gs, E, k);
  return (long long)flag_words(G, p.tiles) +
         2LL * G * p.tiles * row_stride(E);
}

// launch shape: out = {logits per lane, lanes per token, tokens per CTA,
// threads per CTA, tiles per group, ranking warps, dynamic shared bytes}
extern "C" void moe_route_plan(int gs, int E, int k, int* out) {
  const Plan p = make_plan(gs, E, k);
  out[0] = p.V;
  out[1] = p.L;
  out[2] = p.tt;
  out[3] = p.threads;
  out[4] = p.tiles;
  out[5] = p.rank_warps;
  out[6] = (int)p.smem;
}

namespace {

template <int V>
cudaError_t launch_route(const Plan& p, int G, const void* logits, void* eid,
                         void* gate, void* slot, void* scratch, int gs,
                         int E, int k, cudaStream_t st) {
  cudaError_t err;
  if (p.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(route_kernel<V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  // CTAs of one wave: the card's SM count and the kernel's occupancy at
  // this launch shape, kept from the last call on the same device
  static std::mutex mu;
  static int c_dev = -1, c_threads = 0, c_wave = 0;
  static size_t c_smem = 0;
  int dev, wave;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> hold(mu);
    if (dev != c_dev || p.threads != c_threads || p.smem != c_smem) {
      int sms, per_sm;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, route_kernel<V>, p.threads, p.smem);
      if (err != cudaSuccess) return err;
      c_dev = dev;
      c_threads = p.threads;
      c_smem = p.smem;
      c_wave = per_sm * sms;
    }
    wave = c_wave;
  }
  const int blocks = G * p.tiles;
  route_kernel<V><<<blocks, p.threads, p.smem, st>>>(
      static_cast<const float*>(logits), static_cast<int*>(eid),
      static_cast<float*>(gate), static_cast<int*>(slot),
      static_cast<int*>(scratch), G, gs, E, k, p.L, p.tt, p.tiles,
      p.rank_warps, p.chunks_per_warp, blocks > wave ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" int moe_route_launch(const void* logits, void* eid, void* gate,
                                void* slot, void* scratch, int G, int gs,
                                int E, int k, void* stream) {
  if (G < 1 || gs < 1 || E < 1 || E > MAX_E || k < 1 || k > E)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(gs, E, k);
  if ((long long)G * p.tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(int) * (1 + (size_t)G * p.tiles), st);
  if (err != cudaSuccess) return (int)err;
  return (int)(p.V == VPL ? launch_route<VPL>(p, G, logits, eid, gate, slot,
                                              scratch, gs, E, k, st)
                          : launch_route<32>(p, G, logits, eid, gate, slot,
                                             scratch, gs, E, k, st));
}

// ------------------------------------------------------------- backward
//
// The gradient of the gates for g_gate (G, gs, k) float32 with the
// forward's eid (eid and slot carry none): per token, with p the float32
// softmax of its logits (recomputed as the forward forms it: max-subtracted
// expf, the sum in the forward's fixed pairwise order, IEEE division),
// v_j = p[eid_j] and sum = v_1 + .. + v_k, gate_j = v_j / max(sum, 1e-9), so
//   g_v_j = (g_gate_j - sum_i g_gate_i gate_i) / sum   when sum >= 1e-9,
//   g_v_j = g_gate_j / 1e-9                            otherwise (the
//   clamp's gradient, as the twin's torch.clamp passes it),
// and through the softmax g_logits_e = p_e (g_p_e - sum_j g_v_j v_j), with
// g_p_e = g_v_j at e = eid_j and 0 elsewhere.  (With finite logits the
// largest probability is at least 1 / E, so the clamp cannot bind; the
// branch is kept for the contract.)
//
// Design: the forward's layout.  A CTA takes
// BWD_TOKENS tokens (at most bwd_threads / L), each a sub-warp of L lanes
// holding V logits in registers (logit e = lane + L * v), so a token's
// row is read and its gradient written in coalesced spans; max and sum are
// a register tree then xor butterflies in one fixed order, so every lane
// holds the same bits and two runs agree; each exp is computed once and
// kept.  The k picks (eid_j, g_gate_j) are loaded by lanes j < k (j >= L
// in further rounds) and broadcast by shuffles; v_j is read from the lane
// that holds expert eid_j by one shuffle (its register slot eid_j / L is
// the same in every lane of the token).  The three sums over the picks
// (sum, the gates' dot product, the g_v dot product) run in pick order in
// every lane.  No shared memory, no atomics.
//
// Bound: the logits read once, eid and g_gate read once, g_logits written
// once: 8 E + 8 k bytes per token, 2.1 MB at (1, 4096, 60, 4), 0.6 us at
// 3.35 TB/s; a few operations per logit.  Latency sets its time.

namespace {

constexpr int MAX_K = 64;
constexpr int BWD_TOKENS = 32;  // tokens per CTA, at most

// threads per CTA at most: at 32 logits per lane (E > 128) a thread keeps
// 64 floats of its row and their gradients, which 512-thread CTAs' 128
// registers cannot hold
template <int V>
__host__ __device__ constexpr int bwd_threads() {
  return V > VPL ? 256 : MAX_THREADS;
}

template <int V>
__global__ void __launch_bounds__(bwd_threads<V>())
    route_bwd_kernel(const float* __restrict__ logits,
                     const int* __restrict__ eid,
                     const float* __restrict__ g_gate,
                     float* __restrict__ g_logits, long long tokens, int E,
                     int k, int L, int tt) {
  const int sw = threadIdx.x / L, sl = threadIdx.x - sw * L;
  const long long tok = (long long)blockIdx.x * tt + sw;
  // every lane of the warp takes part in the shuffles; lanes past the last
  // token (or past the CTA's tokens) load and store nothing
  const bool valid = sw < tt && tok < tokens;
  const float* row = logits + tok * E;
  const int* ids = eid + tok * k;
  const float* gg = g_gate + tok * k;

  // picks j0 + lane of a round; round 0 loads beside the row, so its
  // latency overlaps the row's
  auto load = [&](int j0, int& my_e, float& my_g) {
    const int j = j0 + sl;
    my_e = valid && j < k ? __ldg(ids + j) : 0;
    my_g = valid && j < k ? __ldg(gg + j) : 0.f;
  };
  int e0;
  float g0;
  load(0, e0, g0);
  auto take_round = [&](int j0, int& my_e, float& my_g) {
    if (j0 == 0) {
      my_e = e0;
      my_g = g0;
    } else {
      load(j0, my_e, my_g);
    }
  };

  float p[V], t[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int e = sl + L * v;
    p[v] = (valid && e < E) ? __ldcs(row + e) : -INFINITY;
    t[v] = p[v];
  }
  float m = tree_max(t);
  for (int off = L >> 1; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL, m, off, L));
#pragma unroll
  for (int v = 0; v < V; ++v) {
    p[v] = expf(p[v] - m);
    t[v] = p[v];
  }
  // the sum in the forward's fixed pairwise order
#pragma unroll
  for (int w = 1; w < V; w *= 2)
#pragma unroll
    for (int v = 0; v + w < V; v += 2 * w) t[v] = t[v] + t[v + w];
  float s = t[0];
  for (int off = L >> 1; off > 0; off >>= 1)
    s = s + __shfl_xor_sync(FULL, s, off, L);
#pragma unroll
  for (int v = 0; v < V; ++v) p[v] = p[v] / s;  // the probabilities

  // pick j of a round is broadcast from lane j % L; v_j comes from the
  // lane holding expert e_j, slot e_j / L
  auto pick = [&](int j, int my_e, float my_g, int& e_j, float& g_j) {
    e_j = __shfl_sync(FULL, my_e, j % L, L);
    g_j = __shfl_sync(FULL, my_g, j % L, L);
    float mine = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v == e_j / L) mine = p[v];
    return __shfl_sync(FULL, mine, e_j % L, L);
  };

  float vs = 0.f;
  for (int j0 = 0; j0 < k; j0 += L) {
    int my_e, e_j;
    float my_g, g_j;
    take_round(j0, my_e, my_g);
    for (int j = j0; j < min(k, j0 + L); ++j)
      vs = vs + pick(j, my_e, my_g, e_j, g_j);
  }
  const bool free_sum = vs >= 1e-9f;
  const float den = free_sum ? vs : 1e-9f;
  // every lane runs every shuffle (two tokens of a warp may differ in
  // free_sum), then the clamp's branch takes 0
  float dot = 0.f;
  for (int j0 = 0; j0 < k; j0 += L) {
    int my_e, e_j;
    float my_g, g_j;
    take_round(j0, my_e, my_g);
    for (int j = j0; j < min(k, j0 + L); ++j) {
      const float v_j = pick(j, my_e, my_g, e_j, g_j);
      dot = dot + g_j * (v_j / den);
    }
  }
  if (!free_sum) dot = 0.f;
  float gp[V];
#pragma unroll
  for (int v = 0; v < V; ++v) gp[v] = 0.f;
  float dot2 = 0.f;
  for (int j0 = 0; j0 < k; j0 += L) {
    int my_e, e_j;
    float my_g, g_j;
    take_round(j0, my_e, my_g);
    for (int j = j0; j < min(k, j0 + L); ++j) {
      const float v_j = pick(j, my_e, my_g, e_j, g_j);
      const float gv = (g_j - dot) / den;
      dot2 = dot2 + gv * v_j;
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (sl + L * v == e_j) gp[v] = gv;
    }
  }
  if (!valid) return;
  float* out = g_logits + tok * E;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int e = sl + L * v;
    if (e < E) __stcs(out + e, p[v] * (gp[v] - dot2));
  }
}

template <int V>
cudaError_t launch_route_bwd(const Plan& p, long long tokens,
                             const void* logits, const void* eid,
                             const void* g_gate, void* g_logits, int E,
                             int k, cudaStream_t st) {
  int tt = BWD_TOKENS;
  if (tt > bwd_threads<V>() / p.L) tt = bwd_threads<V>() / p.L;
  if (tt > tokens) tt = (int)tokens;
  const int threads = (tt * p.L + 31) / 32 * 32;
  const long long blocks = (tokens + tt - 1) / tt;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  route_bwd_kernel<V><<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const float*>(logits), static_cast<const int*>(eid),
      static_cast<const float*>(g_gate), static_cast<float*>(g_logits),
      tokens, E, k, p.L, tt);
  return cudaGetLastError();
}

}  // namespace

// The gates' backward: logits (G, gs, E) float32, eid (G, gs, k) int32 and
// g_gate (G, gs, k) float32 -> g_logits (G, gs, E) float32.  k <= 64.
extern "C" int moe_route_bwd_launch(const void* logits, const void* eid,
                                    const void* g_gate, void* g_logits,
                                    int G, int gs, int E, int k,
                                    void* stream) {
  if (G < 1 || gs < 1 || E < 1 || E > MAX_E || k < 1 || k > E ||
      k > MAX_K)
    return (int)cudaErrorInvalidValue;
  const long long tokens = (long long)G * gs;
  const Plan p = make_plan(gs, E, k);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(p.V == VPL
                   ? launch_route_bwd<VPL>(p, tokens, logits, eid, g_gate,
                                           g_logits, E, k, st)
                   : launch_route_bwd<32>(p, tokens, logits, eid, g_gate,
                                          g_logits, E, k, st));
}
