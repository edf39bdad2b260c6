// The two sequential placement scans of one scheduling interval, batched over
// grid cells: greedy BestFit requests and the RAM feasibility repair.
//
// These replace no Pallas kernel: in the JAX reference they are the
// lax.fori_loop bodies of src/repro/env/jaxsim/kernels.py (bestfit_requests,
// loop at :202; apply_requests, loop at :271).  Their eager PyTorch twins
// (repro_torch/kernels/placement.py) run one Python iteration per fragment,
// ~20 tiny launches each, which dominates an interval once the fleet is
// loaded (thousands of iterations).
//
// Each cell's walk is one CTA, and each stops at its own trip count, read on
// the device, so the host never waits for it.  Compiled with -fmad=false:
// the arithmetic rounds like the eager twin, operation by operation, and
// each worker's RAM receives its additions in the twin's admission order, so
// both kernels equal their twins bit for bit.  Each argmax over workers keeps
// the first maximum (torch.argmax / jnp.argmax).
//
// BestFit (see bestfit_kernel): one warp per cell keeps the per-worker state
// in registers (lane l owns workers l + 32j) and stages the walk's operands,
// which are fixed before it starts, 32 steps at a time ahead of it.  A step
// is a compare and a select per register slot, three warp reductions of an
// order-preserving 64-bit key (__reduce_max_sync on its halves, then
// __reduce_min_sync on the index), and the winner's float64 update, which
// every lane computes once for its worker in the winner's register slot.
//
// Repair (see repair_kernel): the walk's inputs are known before it starts,
// so three gathering warps copy the walked slots' records into shared memory
// a chunk ahead of the walking warp, which reads shared memory and registers
// only.  The common feasible step is a compare and an add on one worker's
// RAM; the headroom argmax runs only on the infeasible path, and its result
// is cached while no admission can have moved it.
//
// Bound: the scans are sequential chains; the bytes they must move (tens of
// KB per cell) take well under a microsecond at 3.35 TB/s.  Latency per step
// bounds them.  chip_smoke.py and tools/kernel_variants.py measured, from
// CUDA graphs on the G=16 main-path grid on an NVIDIA H100 80GB HBM3 with a
// 700 W power limit: BestFit 0.156 ms per call at interval 30 (779 steps in
// the longest cell, ~200 ns per step: ~53 cycles of masks and keys, ~105 in
// the three reductions, ~236 in the winner's update, whose float64 division
// dominates) and 0.90 ms at interval 99 (4563 steps); the earlier design,
// state in shared memory and a global load chain and a double-and-index
// shuffle argmax per step, took 0.614 and 3.57 ms.  Repair 0.264 ms per
// call (683 slots, 387 ns per slot; the design before it, one warp walking
// the operands in global memory, took 1.067-1.093 ms) (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 128;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- BestFit
//
// One warp per cell.  Lane l owns workers l + 32j (j < J = ceil(n / 32)) and
// keeps their free RAM, load, score, static term, capacity and the score's
// key in registers, so a step touches no memory but the one request it
// stores.  The walk's inputs are fixed before it starts: the lanes load the
// fragment indices and RAM of the next 32 steps together (step 32c + l in
// lane l), BF_AHEAD chunks of pos ahead of the walk so the dependent RAM
// gather never waits, and each step takes its RAM from the owning lane by
// shuffle.  A step selects, per register slot, the score's key or the
// masked key (-1e9, where the fragment does not fit), reduces its lane's J
// entries, then the warp (warp_first_max); every lane then computes the
// winner's new free RAM, load, score and key for its worker in the winner's
// register slot (one float64 division, uniform, no divergent branch), and
// only the owner keeps them; lane (step & 31), which holds the fragment's
// index, stores the request.  tools/kernel_variants.py holds the committed
// choices (this argmax, dividing once per lane, BF_AHEAD) beside the other
// argmax forms, update forms and staging depths it times.

constexpr int BF_AHEAD = 2;     // chunks of 32 steps whose pos is in flight

// An unsigned key that orders doubles as the twin's argmax does: -0.0 and
// +0.0 equal (x + 0.0 is +0.0 for both), NaN above every number (torch.argmax
// takes the first NaN).  Key 0 (a NaN bit pattern) marks "no worker".
__device__ __forceinline__ unsigned long long order_key(double x) {
  x = __dadd_rn(x, 0.0);
  const unsigned long long b = (unsigned long long)__double_as_longlong(x);
  const unsigned long long k = (b >> 63) ? ~b : (b | (1ull << 63));
  return x != x ? ~0ull : k;
}

// The first maximum over the warp: every lane gives its own best (key, index)
// and every lane returns the smallest index whose key is the largest.
__device__ __forceinline__ int warp_first_max(unsigned long long key,
                                              int idx) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mh = __reduce_max_sync(FULL, hi);
  const unsigned ml = __reduce_max_sync(FULL, hi == mh ? lo : 0u);
  return (int)__reduce_min_sync(
      FULL, (hi == mh && lo == ml) ? (unsigned)idx : 0xffffffffu);
}

template <int J>
__global__ void __launch_bounds__(32)
bestfit_kernel(const int64_t* pos, const int64_t* n_new, int P,
               const double* ram, const double* ram_free0,
               const double* load0, const double* score0,
               const double* stat, const double* cap, int32_t* req,
               int KF, int n) {
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  // per worker: free RAM, load, score, static term, capacity, and the
  // score's key (0 for a register slot past n: it never wins)
  double fr[J], ld[J], sc[J], st[J], cp[J];
  unsigned long long sk[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int w = lane + 32 * j;
    const bool own = w < n;
    fr[j] = own ? ram_free0[(size_t)g * n + w] : 0.0;
    ld[j] = own ? load0[(size_t)g * n + w] : 0.0;
    sc[j] = own ? score0[(size_t)g * n + w] : 0.0;
    st[j] = own ? stat[w] : 0.0;
    cp[j] = own ? cap[w] : 1.0;
    sk[j] = own ? order_key(sc[j]) : 0;
  }
  const unsigned long long masked = order_key(-1e9);
  const int64_t* pos_g = pos + (size_t)g * P;
  const double* ram_g = ram + (size_t)g * KF;
  int32_t* req_g = req + (size_t)g * KF;
  const int64_t t64 = n_new[g] < P ? n_new[g] : P;
  const int trips = t64 > 0 ? (int)t64 : 0;
  // pos rows past n_new are padding: only steps < trips are read
  auto pos_at = [&](int c) -> int64_t {
    const int i = 32 * c + lane;
    return i < trips ? pos_g[i] : 0;
  };
  auto ram_at = [&](int c, int64_t p) -> double {
    return 32 * c + lane < trips ? ram_g[p] : 0.0;
  };
  int64_t pq[BF_AHEAD];   // pos of chunks c .. c + BF_AHEAD - 1
#pragma unroll
  for (int a = 0; a < BF_AHEAD; ++a) pq[a] = pos_at(a);
  double rc = ram_at(0, pq[0]);
  for (int c = 0; 32 * c < trips; ++c) {
    // the pos of the chunk after the ring, and the next chunk's RAM (its
    // pos arrived a chunk ago unless BF_AHEAD is 1)
    const int64_t pn = pos_at(c + BF_AHEAD);
    const double rn = ram_at(c + 1, BF_AHEAD > 1 ? pq[1 % BF_AHEAD] : pn);
    const int64_t pc = pq[0];
    const int nst = min(32, trips - 32 * c);
    double rm = __shfl_sync(FULL, rc, 0);
    for (int s = 0; s < nst; ++s) {
      const double rm_next = __shfl_sync(FULL, rc, (s + 1) & 31);
      // the masked score's key: order_key(fr < rm ? -1e9 : sc), with the
      // score's key kept from its last change
      unsigned long long bk = 0;
      int bi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const bool fits = !(fr[j] < rm);
        const unsigned long long k = sk[j] ? (fits ? sk[j] : masked) : 0;
        if (k > bk) {
          bk = k;
          bi = lane + 32 * j;
        }
      }
      int w = warp_first_max(bk, bi);
      if (w >= n) w = 0;
      // the winner's new free RAM, load, score and key (the twin's
      // arithmetic, operation by operation), computed by every lane for
      // its worker in the winner's register slot and kept by the owner
      const int jw = w >> 5;
      double f = fr[0], l = ld[0], t = st[0], cw = cp[0];
#pragma unroll
      for (int j = 1; j < J; ++j) {
        f = jw == j ? fr[j] : f;
        l = jw == j ? ld[j] : l;
        t = jw == j ? st[j] : t;
        cw = jw == j ? cp[j] : cw;
      }
      const double f1 = f - rm;
      const double l1 = l + 1.0;
      const double s1 = -l1 + t + 0.1 * f1 / cw;
      const unsigned long long k1 = order_key(s1);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const bool win = w == lane + 32 * j;
        fr[j] = win ? f1 : fr[j];
        ld[j] = win ? l1 : ld[j];
        sc[j] = win ? s1 : sc[j];
        sk[j] = win ? k1 : sk[j];
      }
      if (lane == s) req_g[pc] = w;
      rm = rm_next;
    }
#pragma unroll
    for (int a = 0; a + 1 < BF_AHEAD; ++a) pq[a] = pq[a + 1];
    pq[BF_AHEAD - 1] = pn;
    rc = rn;
  }
}

// ---------------------------------------------------------------- repair
//
// One CTA per cell: warp 0 walks, the other REPAIR_WARPS - 1 warps gather.
// The walk's inputs are all known before it starts; only the per-worker RAM
// in use (s_used) and the slot's ok flag carry from one step to the next.
// So the gathering warps copy the walked slots' records into shared memory,
// a chunk of up to REPAIR_CHUNK slots at a time, into a two-buffer ring
// (named barriers FULL/EMPTY per buffer), while warp 0 walks the previous
// chunk from shared memory and registers alone.  Records are compacted: a
// slot that is not alive, and a fragment that is done, cannot act, so
// neither is kept; each kept slot keeps its index and the end of its
// fragment records (the slot boundary), which the failure rule needs.  Lane
// 0 stores each worker and placed flag as the walk makes it: nothing in the
// walk reads them back, stores do not stall it, and one thread storing in
// walk order keeps the last write of a slot the one that counts.  A chunk
// holds fewer slots when F is wide; F past ~8500 (one slot per buffer) is
// refused with cudaErrorInvalidValue.

constexpr int REPAIR_WARPS = 4;             // warp 0 walks, the rest gather
constexpr int REPAIR_CHUNK = 64;            // slots per chunk (fewer if F is wide)
constexpr int RTHREADS = REPAIR_WARPS * 32;
constexpr int GTHREADS = RTHREADS - 32;     // gathering threads
constexpr int GWARPS = REPAIR_WARPS - 1;
constexpr int BAR_FULL = 1;                 // + buffer: chunk gathered
constexpr int BAR_EMPTY = 3;                // + buffer: chunk walked
constexpr int BAR_GATHER = 5;               // among the gathering warps
constexpr size_t REPAIR_SMEM_LIMIT = 200 * 1024;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// One chunk buffer: a fragment record is the RAM it asks for and a code
// word (clamped requested worker | holds RAM << 7 | f << 8); a slot record
// is the slot and the end of its fragment records.
struct Chunk {
  double* rm;        // [ch * F]
  int32_t* code;     // [ch * F]
  int32_t* slot;     // [ch] kept slots, in walk order
  int32_t* end;      // [ch] end of each kept slot's fragment records
  int32_t* tslot;    // [ch] gather scratch: the slot at each walk step
  int32_t* tcnt;     // [ch] gather scratch: acting fragments, -1 if not alive
  int32_t* nslot;    // [1] kept slots in the chunk
};

__host__ __device__ inline size_t chunk_bytes(int ch, int F) {
  const size_t b = (size_t)ch * F * 12 + (size_t)ch * 16 + 4;
  return (b + 15) & ~(size_t)15;
}

// slots per chunk for F fragments per slot: two buffers fit the limit
inline int repair_chunk(int F) {
  const size_t per_slot = (size_t)F * 12 + 16;
  const size_t fit = (REPAIR_SMEM_LIMIT / 2 - 32) / per_slot;
  return (int)(fit < (size_t)REPAIR_CHUNK ? fit : REPAIR_CHUNK);
}

__device__ inline Chunk chunk_at(unsigned char* base, int ch, int F) {
  Chunk c;
  const size_t nr = (size_t)ch * F;
  c.rm = (double*)base;
  c.code = (int32_t*)(base + nr * 8);
  c.slot = c.code + nr;
  c.end = c.slot + ch;
  c.tslot = c.end + ch;
  c.tcnt = c.tslot + ch;
  c.nslot = c.tcnt + ch;
  return c;
}

// Gather walk steps [i0, i0 + cnt) of one cell into `c` (gathering
// threads only; gt in [0, GTHREADS)).  Each thread takes a contiguous run
// of steps, so an exclusive scan in thread order keeps the walk order.
__device__ void gather_chunk(const Chunk& c, int gt, int cnt,
                             const int64_t* order, const uint8_t* alive,
                             const uint8_t* done, const uint8_t* chain,
                             const int32_t* stage, const int32_t* req,
                             const double* ram, int F, int n,
                             int (*scan)[2]) {
  const int per = (cnt + GTHREADS - 1) / GTHREADS;
  const int q0 = min(gt * per, cnt), q1 = min(q0 + per, cnt);
  int ns = 0, nr = 0;
  for (int q = q0; q < q1; ++q) {
    const int slot = (int)order[q];
    int a = -1;
    if (alive[slot]) {
      const uint8_t* d = done + (size_t)slot * F;
      a = 0;
      for (int f = 0; f < F; ++f) a += !d[f];
      ++ns;
      nr += a;
    }
    c.tslot[q] = slot;
    c.tcnt[q] = a;
  }
  const int lane = gt & 31, wp = gt >> 5;
  int is = ns, ir = nr;
  for (int off = 1; off < 32; off <<= 1) {
    const int s = __shfl_up_sync(FULL, is, off);
    const int r = __shfl_up_sync(FULL, ir, off);
    if (lane >= off) {
      is += s;
      ir += r;
    }
  }
  if (lane == 31) {
    scan[wp][0] = is;
    scan[wp][1] = ir;
  }
  bar_sync(BAR_GATHER, GTHREADS);
  int so = is - ns, ro = ir - nr, total = 0;
  for (int w = 0; w < GWARPS; ++w) {
    if (w < wp) {
      so += scan[w][0];
      ro += scan[w][1];
    }
    total += scan[w][0];
  }
  if (gt == 0) *c.nslot = total;
  for (int q = q0; q < q1; ++q) {
    if (c.tcnt[q] < 0) continue;
    const int slot = c.tslot[q];
    const size_t row = (size_t)slot * F;
    const bool ch = chain[slot];
    const int st = stage[slot];
    for (int f = 0; f < F; ++f) {
      if (done[row + f]) continue;
      int w = req[row + f];
      w = w < 0 ? 0 : (w > n - 1 ? n - 1 : w);
      const int holds = (!ch || f == st) ? 1 : 0;
      c.code[ro] = w | (holds << 7) | (f << 8);
      c.rm[ro] = ram[row + f];
      ++ro;
    }
    c.slot[so] = slot;
    c.end[so] = ro;
    ++so;
  }
}

// first maximum of cap - used over the warp (the torch.argmax rule); every
// lane returns it, and its headroom in *h
__device__ __forceinline__ int headroom_argmax(const double* used,
                                               const double* cap, int n,
                                               double* h) {
  const int lane = threadIdx.x & 31;
  double best = -INFINITY;
  int idx = 0x7fffffff;
  for (int w = lane; w < n; w += 32) {
    const double x = cap[w] - used[w];
    if (x > best || idx == 0x7fffffff) {
      best = x;
      idx = w;
    }
  }
  double m = best;
  for (int off = 16; off > 0; off >>= 1)
    m = fmax(m, __shfl_xor_sync(FULL, m, off));
  const unsigned mine =
      (idx != 0x7fffffff && best == m) ? (unsigned)idx : 0xffffffffu;
  unsigned c = __reduce_min_sync(FULL, mine);
  if (c == 0xffffffffu) c = 0;
  *h = cap[c] - used[c];
  return (int)c;
}

__global__ void __launch_bounds__(RTHREADS)
repair_kernel(const int64_t* order, const int64_t* trip, int K, int F,
              const uint8_t* alive, const uint8_t* done, const uint8_t* chain,
              const int32_t* stage, const int32_t* req, const double* ram,
              const double* cap, int32_t* worker2, uint8_t* placed, int n,
              int ch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_used[MAX_N], s_cap[MAX_N];
  __shared__ int s_scan[2][GWARPS][2];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t kf = (size_t)g * K * F;
  const size_t k0 = (size_t)g * K;
  const int64_t t64 = trip[g] < K ? trip[g] : K;
  const int trips = t64 > 0 ? (int)t64 : 0;
  const int nchunk = (trips + ch - 1) / ch;
  const size_t cbytes = chunk_bytes(ch, F);

  if (tid >= 32) {
    // gather: chunk c into buffer c & 1, once the walk of chunk c - 2 left it
    const int gt = tid - 32;
    for (int c = 0; c < nchunk; ++c) {
      const int b = c & 1;
      if (c >= 2) bar_sync(BAR_EMPTY + b, RTHREADS);
      const int i0 = c * ch;
      gather_chunk(chunk_at(smem + b * cbytes, ch, F), gt,
                   min(ch, trips - i0), order + k0 + i0,
                   alive + k0, done + kf, chain + k0, stage + k0, req + kf,
                   ram + kf, F, n, s_scan[b]);
      bar_arrive(BAR_FULL + b, RTHREADS);
    }
    return;
  }

  // walk: every lane runs the scalar logic on broadcast shared-memory
  // reads (warp-uniform branches); lane 0 alone stores, in walk order
  const int lane = tid;
  for (int w = lane; w < n; w += 32) {
    s_used[w] = 0.0;
    s_cap[w] = cap[w];
  }
  __syncwarp();
  // cached first maximum of the headroom and its value: it stays the first
  // maximum while no admission lowered its headroom and none raised another
  // worker's (an admission of RAM >= 0 only lowers one)
  int cand = -1;
  double hc = 0.0;
  bool dirty = false;
  for (int c = 0; c < nchunk; ++c) {
    const int b = c & 1;
    bar_sync(BAR_FULL + b, RTHREADS);
    const Chunk cb = chunk_at(smem + b * cbytes, ch, F);
    const int ns = *cb.nslot;
    int r = 0;
    for (int s = 0; s < ns; ++s) {
      const int slot = cb.slot[s];
      const int r1 = cb.end[s];
      int32_t* w2row = worker2 + kf + (size_t)slot * F;
      bool ok = true;
      for (; r < r1; ++r) {
        const int code = cb.code[r];
        const double rm = cb.rm[r];
        int w = code & 127;
        if (code & 128) {
          double u = s_used[w];
          if (u + rm > s_cap[w]) {
            if (cand < 0 || dirty || s_cap[cand] - s_used[cand] != hc) {
              cand = headroom_argmax(s_used, s_cap, n, &hc);
              dirty = false;
            }
            if (!(hc >= rm)) {
              ok = false;
              break;
            }
            w = cand;
            u = s_used[cand];
          }
          s_used[w] = u + rm;
          dirty = dirty || !(rm >= 0.0);
        }
        if (lane == 0) w2row[code >> 8] = w;
      }
      if (!ok) {
        if (lane == 0)
          for (int f = 0; f < F; ++f) w2row[f] = -1;
        r = r1;
      }
      if (lane == 0) placed[k0 + slot] = ok;
    }
    if (c + 2 < nchunk) bar_arrive(BAR_EMPTY + b, RTHREADS);
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
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* p = (const int64_t*)pos;
  const auto* nn = (const int64_t*)n_new;
  const auto* rm = (const double*)ram;
  const auto* f0 = (const double*)ram_free0;
  const auto* l0 = (const double*)load0;
  const auto* s0 = (const double*)score0;
  const auto* sp = (const double*)stat;
  const auto* cp = (const double*)cap;
  auto* rq = (int32_t*)req;
  switch ((n + 31) / 32) {
    case 1:
      bestfit_kernel<1><<<G, 32, 0, st>>>(p, nn, P, rm, f0, l0, s0, sp, cp,
                                          rq, KF, n);
      break;
    case 2:
      bestfit_kernel<2><<<G, 32, 0, st>>>(p, nn, P, rm, f0, l0, s0, sp, cp,
                                          rq, KF, n);
      break;
    case 3:
      bestfit_kernel<3><<<G, 32, 0, st>>>(p, nn, P, rm, f0, l0, s0, sp, cp,
                                          rq, KF, n);
      break;
    default:
      bestfit_kernel<4><<<G, 32, 0, st>>>(p, nn, P, rm, f0, l0, s0, sp, cp,
                                          rq, KF, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int repair_scan_launch(const void* order, const void* trip, int G,
                                  int K, int F, const void* alive,
                                  const void* done, const void* chain,
                                  const void* stage, const void* req,
                                  const void* ram, const void* cap,
                                  void* worker2, void* placed, int n,
                                  void* stream) {
  if (n < 1 || n > MAX_N || G < 1 || K < 1 || F < 1 || F >= (1 << 23))
    return (int)cudaErrorInvalidValue;
  const int ch = repair_chunk(F);
  if (ch < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * chunk_bytes(ch, F);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        repair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  repair_kernel<<<G, RTHREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)order, (const int64_t*)trip, K, F,
      (const uint8_t*)alive, (const uint8_t*)done, (const uint8_t*)chain,
      (const int32_t*)stage, (const int32_t*)req, (const double*)ram,
      (const double*)cap, (int32_t*)worker2, (uint8_t*)placed, n, ch);
  return (int)cudaGetLastError();
}

// walk layout for F fragments per slot: out = {warps per CTA, slots per
// chunk, dynamic shared memory bytes}
extern "C" void repair_scan_plan(int F, int* out) {
  const int ch = repair_chunk(F);
  out[0] = REPAIR_WARPS;
  out[1] = ch;
  out[2] = ch < 1 ? 0 : (int)(2 * chunk_bytes(ch, F));
}
