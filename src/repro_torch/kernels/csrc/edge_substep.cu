// One scheduling interval of SplitPlace substep physics, batched over grid cells.
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_substep.py::edge_substep
// (pl.pallas_call at :192, body _kernel at :40).  Same function, same float64
// formulas in the same order as its eager twin repro_torch/kernels/ref.py:
// repeated `substeps` times, the per-worker load/RAM census (non-chain
// fragments plus each chain's active stage), MIPS sharing with swap slowdown,
// instruction burn-down, chain handoff, activation transfer under
// min-NIC x mobility bandwidth, stage advance and the eq. 13-16 metric dot.
//
// Design: a thread-block cluster of CLUSTER CTAs per grid cell, the substep
// loop inside the kernel.
//   * CTA `rank` owns the cell's task rows rank, rank + CLUSTER, ... and
//     keeps their carries (instr, transfer, done, stage, task_done, resp) and
//     hot statics (worker, out_bytes, chain, placed, nfrag, ram_task) in
//     dynamic shared memory for the whole interval: read once, written once.
//     Statics read only when a task finishes (sla, arrival, acc_t, wait_s,
//     decision) stay in global memory.  Rows are interleaved, not cut into
//     contiguous ranges, because live tasks crowd the low rows (free slots
//     are taken from the front): with ranges, rank 0 held nearly all the
//     work and the others waited for it at every cluster barrier.
//   * A task whose fragments are all done and that was done before the
//     interval (a free or retired slot) does nothing in any substep; each CTA
//     lists its other tasks once, in task order, and every substep walks that
//     list only: the census a thread per (task, fragment), the burn-down a
//     thread per task.
//   * Census across the cluster: load counts are int32 shared-memory atomics
//     (exact); a worker's RAM load is summed per warp in (task batch,
//     fragment, lane) order by the lane that owns the worker, then per CTA
//     over warps in warp order.  Each CTA then reads every rank's partials
//     through distributed shared memory and sums them in rank order, so all
//     CTAs of the cell hold the same bits.  The partials are double-buffered
//     by substep parity, so one cluster barrier per substep is enough
//     (plus three CTA barriers: after the census, after the totals, after
//     the burn-down).
//   * Metric dot: each CTA's four float columns (per warp a fixed
//     xor-butterfly, then warps in order) and five counts of a substep are
//     left in shared memory; rank 0 reads them at the next substep's cluster
//     barrier and adds the substep's total, summed over ranks in rank order,
//     onto the cell's metrics: the twin's "per-substep total, then add".
//   * Busy seconds have one owner per worker (a thread of rank 0); the
//     per-worker completion census is integer counts summed over ranks.
//   * Any size: K < CLUSTER leaves CTAs with no task (they still join the
//     census); G may exceed the clusters that fit the card at once (they run
//     in waves).  When one CTA's share of the cell, ceil(K / CLUSTER) tasks,
//     does not fit SMEM_LIMIT bytes (at F=8, past K = 6208 with 8 CTAs), the
//     same kernel keeps the carries in the output tensors in global memory
//     and walks every task of its share (ON_CHIP = false).  No size falls
//     back to another kernel or to the twin.
//
// Determinism: every float64 sum is taken without float atomics, in the
// fixed orders above; two runs give identical bits.  The file is compiled
// with -fmad=false so that `instr - rate*dt` and friends round like the
// eager twin.
//
// Out-of-range stage (stage >= F or < 0, which the reference's fuzz
// exercises): the reference's gather fills, so such a stage is not runnable,
// holds no RAM, moves no transfer and reads as done.  The kernel never
// indexes with it.
//
// What bounds it on an H100 (3.35 TB/s, 132 SMs): one call reads its carries
// and statics once and writes its outputs once, about 46*K*F + 76*K bytes per
// cell (~1.1 MB at K=2464, F=8; 17.5 MB for the G=16 main-path grid, 5.2 us
// at full bandwidth).  The kernel is bound by latency instead: per substep a
// census, a CTA barrier, a cluster barrier with distributed-shared-memory
// reads, a CTA barrier, the burn-down and a CTA barrier, 30 times per
// interval; the barriers, not the arithmetic, take most of each substep.
// Keeping the carries on chip takes the L2 round trips out of each substep,
// the active-task list cuts its walk from K tasks to the live ones, the
// interleaved rows spread those over the cluster, and each worker's MIPS
// share is formed once per substep instead of once per runnable fragment.
// chip_smoke.py measured 0.1911 ms per call from CUDA graphs (6.4 us per
// substep) at the G=16 main-path interval on an NVIDIA H100 80GB HBM3 with a
// 700 W power limit, against 0.852-0.873 ms for the earlier design of one
// CTA per cell with the carries in L2 (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;            // CTAs per grid cell
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int MAX_N = 128;            // workers per cell
constexpr int WSLOTS = MAX_N / 32;    // workers owned by one lane
constexpr int NMET = 9;               // packed metric columns
// METRIC_COLS = n_fin, sum_resp, n_viol, sum_acc, sum_reward, sum_wait,
// fin_layer, fin_semantic, fin_compressed: four float sums, five counts
constexpr int NFLT = 4;
constexpr int NCNT = 5;
__constant__ int FLT_OF_COL[NMET] = {-1, 0, -1, 1, 2, 3, -1, -1, -1};
__constant__ int CNT_OF_COL[NMET] = {0, -1, 1, -1, -1, -1, 2, 3, 4};
constexpr unsigned FULL = 0xffffffffu;
// dynamic shared memory a CTA may take for its tasks (the static arrays
// below take ~18 KB more of the 227 KB)
constexpr size_t SMEM_LIMIT = 200 * 1024;

struct Ptrs {
  // carries in
  const double* instr; const uint8_t* done; const double* transfer;
  const int32_t* stage; const uint8_t* task_done; const double* resp;
  const double* now; const double* metrics;
  // interval statics
  const int32_t* worker; const double* ram_task; const double* out_bytes;
  const int32_t* nfrag; const uint8_t* chain; const uint8_t* placed;
  const double* sla; const double* arrival; const double* acc_t;
  const double* wait_s; const int32_t* decision; const double* bw_mult;
  const double* mips; const double* cap; const double* net_bw;
  // outputs
  double* o_instr; uint8_t* o_done; double* o_transfer; int32_t* o_stage;
  uint8_t* o_task_done; double* o_resp; double* o_now; double* o_metrics;
  double* o_busy; double* o_pwt;
};

// Byte offsets of one CTA's on-chip task store for T tasks of F fragments.
struct Layout {
  size_t instr, transfer, out_bytes, resp, ram_task, worker, stage, nfrag,
      active, done, task_done, chain, placed, td_in, bytes;
};

__host__ __device__ inline size_t bump(size_t& at, size_t bytes) {
  const size_t here = at;
  at += (bytes + 15) & ~(size_t)15;
  return here;
}

__host__ __device__ inline Layout layout(int T, int F) {
  Layout L;
  size_t at = 0;
  const size_t tf = (size_t)T * F;
  L.instr = bump(at, 8 * tf);
  L.transfer = bump(at, 8 * tf);
  L.out_bytes = bump(at, 8 * tf);
  L.resp = bump(at, 8 * (size_t)T);
  L.ram_task = bump(at, 8 * (size_t)T);
  L.worker = bump(at, 4 * tf);
  L.stage = bump(at, 4 * (size_t)T);
  L.nfrag = bump(at, 4 * (size_t)T);
  L.active = bump(at, 4 * (size_t)T);
  L.done = bump(at, tf);
  L.task_done = bump(at, T);
  L.chain = bump(at, T);
  L.placed = bump(at, T);
  L.td_in = bump(at, T);
  L.bytes = at;
  return L;
}

// One CTA's tasks: carries and hot statics.  On chip (ON_CHIP) they are
// indexed by the CTA's local task t; in global memory by the task's row in
// the cell, t * CLUSTER + rank.
struct Tasks {
  double* instr; double* transfer; uint8_t* done;            // (., F)
  const double* out_bytes; const int32_t* worker;            // (., F)
  int32_t* stage; uint8_t* task_done; double* resp;          // (.,)
  const double* ram_task; const int32_t* nfrag; const uint8_t* chain;
  const uint8_t* placed; const uint8_t* task_done_in;
};

__device__ __forceinline__ int clampw(int w, int n) {
  return w < 0 ? 0 : (w > n - 1 ? n - 1 : w);
}

// the cell's metric total of the substep with parity pp, summed over ranks
// in rank order, added onto s_m (rank 0, threads tid < NMET)
__device__ __forceinline__ void add_metrics(cg::cluster_group& cluster,
                                            double* s_m, double (*s_fc)[NFLT],
                                            int (*s_ic)[NCNT], int pp,
                                            int tid) {
  int fin = 0;
  for (int r = 0; r < CLUSTER; ++r)
    fin += cluster.map_shared_rank(&s_ic[pp][0], r)[0];
  if (fin == 0) return;
  const int fc = FLT_OF_COL[tid];
  double tot = 0.0;
  if (fc >= 0) {
    for (int r = 0; r < CLUSTER; ++r)
      tot += cluster.map_shared_rank(&s_fc[pp][0], r)[fc];
  } else {
    const int ic = CNT_OF_COL[tid];
    int c = 0;
    for (int r = 0; r < CLUSTER; ++r)
      c += cluster.map_shared_rank(&s_ic[pp][0], r)[ic];
    tot = (double)c;
  }
  s_m[tid] = s_m[tid] + tot;
}

template <bool ON_CHIP>
__global__ void __launch_bounds__(THREADS)
edge_substep_kernel(Ptrs p, int K, int F, int n, int substeps, double dt,
                    double swap_slowdown, double nic_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the CTA's tasks are the cell's rows rank, rank + CLUSTER, ...: live
  // tasks crowd the low rows (free slots are taken from the front), and
  // interleaving spreads them over the cluster
  const int per = (K + CLUSTER - 1) / CLUSTER;
  const int nk = rank < K ? (K - rank + CLUSTER - 1) / CLUSTER : 0;

  __shared__ int s_cnt[2][MAX_N];           // this CTA's load counts
  __shared__ double s_ramc[2][MAX_N];       // this CTA's RAM load
  __shared__ double s_part[NWARP][MAX_N];   // per-warp RAM load
  __shared__ double s_rate[MAX_N];          // MIPS share under swap
  __shared__ double s_mips[MAX_N], s_cap[MAX_N], s_net[MAX_N], s_bwm[MAX_N];
  __shared__ double s_busy[MAX_N];
  __shared__ int s_pwt[MAX_N];
  __shared__ double s_fsum[NWARP][NFLT];    // per-warp metric floats
  __shared__ double s_fc[2][NFLT];          // this CTA's metric floats
  __shared__ int s_ic[2][NCNT];             // this CTA's metric counts
  __shared__ double s_m[NMET];              // the cell's metrics (rank 0)
  __shared__ int s_wcount[NWARP];

  const size_t cell = (size_t)g * K;        // the cell's first row
  // row of local task t in the cell, and where Tasks keeps it
  auto row_of = [&](int a) { return (size_t)a * CLUSTER + rank; };
  auto at = [&](int a) { return ON_CHIP ? (size_t)a : row_of(a); };
  Tasks t;
  int* active = nullptr;
  if constexpr (ON_CHIP) {
    const Layout L = layout(per, F);
    double* instr = (double*)(smem + L.instr);
    double* transfer = (double*)(smem + L.transfer);
    double* out_bytes = (double*)(smem + L.out_bytes);
    double* resp = (double*)(smem + L.resp);
    double* ram_task = (double*)(smem + L.ram_task);
    int32_t* worker = (int32_t*)(smem + L.worker);
    int32_t* stage = (int32_t*)(smem + L.stage);
    int32_t* nfrag = (int32_t*)(smem + L.nfrag);
    uint8_t* done = smem + L.done;
    uint8_t* task_done = smem + L.task_done;
    uint8_t* chain = smem + L.chain;
    uint8_t* placed = smem + L.placed;
    uint8_t* td_in = smem + L.td_in;
    active = (int*)(smem + L.active);
    for (int i = tid; i < nk * F; i += THREADS) {
      const int k = i / F;
      const size_t gi = (cell + row_of(k)) * F + (i - k * F);
      instr[i] = p.instr[gi];
      transfer[i] = p.transfer[gi];
      out_bytes[i] = p.out_bytes[gi];
      worker[i] = p.worker[gi];
      done[i] = p.done[gi];
    }
    for (int k = tid; k < nk; k += THREADS) {
      const size_t gk = cell + row_of(k);
      resp[k] = p.resp[gk];
      ram_task[k] = p.ram_task[gk];
      stage[k] = p.stage[gk];
      nfrag[k] = p.nfrag[gk];
      task_done[k] = p.task_done[gk];
      td_in[k] = p.task_done[gk];
      chain[k] = p.chain[gk];
      placed[k] = p.placed[gk];
    }
    t = Tasks{instr, transfer, done, out_bytes, worker, stage, task_done,
              resp, ram_task, nfrag, chain, placed, td_in};
  } else {
    // the carries live in the outputs: copy this CTA's tasks over first
    for (int i = tid; i < nk * F; i += THREADS) {
      const int k = i / F;
      const size_t gi = (cell + row_of(k)) * F + (i - k * F);
      p.o_instr[gi] = p.instr[gi];
      p.o_transfer[gi] = p.transfer[gi];
      p.o_done[gi] = p.done[gi];
    }
    for (int k = tid; k < nk; k += THREADS) {
      const size_t gk = cell + row_of(k);
      p.o_stage[gk] = p.stage[gk];
      p.o_task_done[gk] = p.task_done[gk];
      p.o_resp[gk] = p.resp[gk];
    }
    const size_t cf = cell * F;
    t = Tasks{p.o_instr + cf, p.o_transfer + cf, p.o_done + cf,
              p.out_bytes + cf, p.worker + cf, p.o_stage + cell,
              p.o_task_done + cell, p.o_resp + cell, p.ram_task + cell,
              p.nfrag + cell, p.chain + cell, p.placed + cell,
              p.task_done + cell};
  }
  for (int w = tid; w < n; w += THREADS) {
    s_mips[w] = p.mips[w];
    s_cap[w] = p.cap[w];
    s_net[w] = p.net_bw[w];
    s_bwm[w] = p.bw_mult[(size_t)g * n + w];
    s_cnt[0][w] = 0;
    s_cnt[1][w] = 0;
    s_busy[w] = 0.0;
    s_pwt[w] = 0;
  }
  if (tid < 2 * NCNT) s_ic[tid / NCNT][tid % NCNT] = 0;
  if (rank == 0 && tid < NMET) s_m[tid] = p.metrics[(size_t)g * NMET + tid];
  __syncthreads();

  // ---- the tasks that can change: each warp lists a contiguous block of
  // the CTA's tasks, so the list is in task order
  int nact = nk;
  if constexpr (ON_CHIP) {
    const int blk = ((nk + NWARP - 1) / NWARP + 31) & ~31;
    const int b0 = min(nk, warp * blk), b1 = min(nk, b0 + blk);
    int cnt = 0;
    for (int base = b0; base < b1; base += 32) {
      const int k = base + lane;
      bool live = false;
      if (k < b1) {
        live = !t.task_done_in[k];
        for (int f = 0; f < F && !live; ++f) live = !t.done[(size_t)k * F + f];
      }
      cnt += __popc(__ballot_sync(FULL, live));
    }
    if (lane == 0) s_wcount[warp] = cnt;
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < NWARP; ++w) {
      if (w < warp) off += s_wcount[w];
      total += s_wcount[w];
    }
    for (int base = b0; base < b1; base += 32) {
      const int k = base + lane;
      bool live = false;
      if (k < b1) {
        live = !t.task_done_in[k];
        for (int f = 0; f < F && !live; ++f) live = !t.done[(size_t)k * F + f];
      }
      const unsigned bal = __ballot_sync(FULL, live);
      if (live) active[off + __popc(bal & ((1u << lane) - 1))] = k;
      off += __popc(bal);
    }
    nact = total;
    __syncthreads();
  }

  double now_s = p.now[g];
  const int npair = nact * F;
  for (int step = 0; step < substeps; ++step) {
    const int par = step & 1;
    // ---- 1. census, a thread per (task, fragment): load counts (atomics)
    // + ordered per-warp RAM sums
    double racc[WSLOTS];
#pragma unroll
    for (int j = 0; j < WSLOTS; ++j) racc[j] = 0.0;
    for (int base = 0; base < npair; base += THREADS) {
      const int i = base + tid;
      bool holds = false;
      int w = 0;
      double rt = 0.0;
      if (i < npair) {
        const int a = i / F;
        const int f = i - a * F;
        const size_t k = at(ON_CHIP ? active[a] : a);
        const size_t j = k * F + f;
        const int wk = t.worker[j];
        const bool nd = !t.done[j];
        const bool ch = t.chain[k];
        const bool is_stage = f == t.stage[k];
        w = clampw(wk, n);
        holds = (!ch || is_stage) && wk >= 0 && nd;
        rt = t.ram_task[k];
        if (!ch) {
          if (holds) atomicAdd(&s_cnt[par][w], 1);
        } else if (is_stage && t.transfer[j] <= 0.0 && t.placed[k] &&
                   wk >= 0 && nd) {
          atomicAdd(&s_cnt[par][w], 1);       // the chain's runnable stage
        }
      }
      unsigned bal = __ballot_sync(FULL, holds);
      while (bal) {
        const int src = __ffs(bal) - 1;
        bal &= bal - 1;
        const int ws = __shfl_sync(FULL, w, src);
        const double v = __shfl_sync(FULL, rt, src);
        if (lane == (ws & 31)) {
#pragma unroll
          for (int j = 0; j < WSLOTS; ++j)
            if (j == (ws >> 5)) racc[j] += v;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < WSLOTS; ++j) {
      const int w = lane + 32 * j;
      if (w < n) s_part[warp][w] = racc[j];
    }
    __syncthreads();

    // ---- 2. this CTA's RAM partials; its metric floats of the last substep
    for (int w = tid; w < n; w += THREADS) {
      double r = 0.0;
      for (int wp = 0; wp < NWARP; ++wp) r += s_part[wp][w];
      s_ramc[par][w] = r;
    }
    if (step > 0 && tid < NFLT) {
      double v = 0.0;
      for (int wp = 0; wp < NWARP; ++wp) v += s_fsum[wp][tid];
      s_fc[par ^ 1][tid] = v;
    }
    cluster.sync();

    // ---- 3. the cell's per-worker totals, in rank order; rank 0 adds the
    // last substep's metric total
    for (int w = tid; w < n; w += THREADS) {
      int ld = 0;
      double rl = 0.0;
      for (int r = 0; r < CLUSTER; ++r) {
        ld += cluster.map_shared_rank(&s_cnt[par][0], r)[w];
        rl += cluster.map_shared_rank(&s_ramc[par][0], r)[w];
      }
      // a fragment's rate, as the twin forms it, once per worker
      double rate = s_mips[w] / fmax((double)ld, 1.0);
      if (rl > s_cap[w]) rate = rate * swap_slowdown;
      s_rate[w] = rate;
      if (ld > 0) s_busy[w] = s_busy[w] + dt;
      s_cnt[par ^ 1][w] = 0;
    }
    if (tid < NCNT) s_ic[par][tid] = 0;
    if (step > 0 && rank == 0 && tid < NMET)
      add_metrics(cluster, s_m, s_fc, s_ic, par ^ 1, tid);
    __syncthreads();

    // ---- 4. burn-down, handoff, completion, transfer, stage advance, a
    // thread per task
    double floc[NFLT];
#pragma unroll
    for (int j = 0; j < NFLT; ++j) floc[j] = 0.0;
    bool fin_any = false;
    for (int i = tid; i < nact; i += THREADS) {
      const int a = ON_CHIP ? active[i] : i;
      const size_t k = at(a);
      const int s = t.stage[k];
      const bool in_rng = s >= 0 && s < F;
      const bool ch = t.chain[k];
      const bool pl = t.placed[k];
      const int nf = t.nfrag[k];
      const size_t row = k * F;
      const double cur_tl = in_rng ? t.transfer[row + s] : 0.0;
      bool hand_prev = false;
      bool all_done = true;
      for (int f = 0; f < F; ++f) {
        const size_t j = row + f;
        const int wk = t.worker[j];
        bool dn = t.done[j];
        const double t_start = t.transfer[j];
        const bool runnable = (!ch || (t_start <= 0.0 && f == s)) && pl &&
                              wk >= 0 && !dn;
        bool newly = false;
        if (runnable) {
          const double left = t.instr[j] - s_rate[clampw(wk, n)] * dt;
          t.instr[j] = left;
          newly = left <= 0.0;
          if (newly) {
            dn = true;
            t.done[j] = 1;
          }
        }
        // the activation of a stage that just finished lands on the next one
        if (hand_prev) t.transfer[j] = t.out_bytes[j - 1];
        hand_prev = newly && ch && f < nf - 1;
        all_done = all_done && dn;
      }
      if (all_done && !t.task_done[k]) {
        t.task_done[k] = 1;
        const size_t gk = cell + row_of(a);
        const double resp_t = now_s - p.arrival[gk];
        t.resp[k] = resp_t;
        const double sl = p.sla[gk];
        const double ac = p.acc_t[gk];
        const int dk = p.decision[gk];
        const int d = dk < 0 ? 0 : (dk > 2 ? 2 : dk);
        floc[0] += resp_t;
        floc[1] += ac;
        floc[2] += ((resp_t <= sl ? 1.0 : 0.0) + ac) / 2.0;
        floc[3] += p.wait_s[gk];
        atomicAdd(&s_ic[par][0], 1);
        if (resp_t > sl) atomicAdd(&s_ic[par][1], 1);
        atomicAdd(&s_ic[par][2 + d], 1);
        fin_any = true;
      }
      const bool chactive = ch && pl && !t.task_done_in[k];
      if (chactive && in_rng && s > 0 && cur_tl > 0.0) {
        const int w_s = clampw(t.worker[row + s], n);
        const int w_p = clampw(t.worker[row + (s + F - 1) % F], n);
        const double bw = fmin(nic_cap, fmin(s_net[w_p] / 100.0,
                                             s_net[w_s] / 100.0)) *
                          fmin(s_bwm[w_p], s_bwm[w_s]);
        t.transfer[row + s] = t.transfer[row + s] - bw * 1e6 * dt;
      }
      const bool done_s = in_rng ? (bool)t.done[row + s] : true;
      if (chactive && done_s && s < nf - 1) t.stage[k] = s + 1;
    }
    // this warp's metric floats of the substep, in a fixed order
    if (__any_sync(FULL, fin_any)) {
#pragma unroll
      for (int j = 0; j < NFLT; ++j) {
        double v = floc[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(FULL, v, off);
        if (lane == 0) s_fsum[warp][j] = v;
      }
    } else if (lane == 0) {
#pragma unroll
      for (int j = 0; j < NFLT; ++j) s_fsum[warp][j] = 0.0;
    }
    // the next census reads fragments other threads burned down
    __syncthreads();
    now_s = now_s + dt;
  }

  // ---- per-worker completion census of the interval
  for (int i = tid; i < nact; i += THREADS) {
    const int a = ON_CHIP ? active[i] : i;
    const size_t k = at(a);
    const size_t g0 = (cell + row_of(a)) * F;
    for (int f = 0; f < F; ++f) {
      if (t.done[k * F + f] && !p.done[g0 + f])
        atomicAdd(&s_pwt[clampw(t.worker[k * F + f], n)], 1);
    }
  }
  // (the last substep's barrier made its burn-down and s_fsum visible)
  if (substeps > 0 && tid < NFLT) {
    double v = 0.0;
    for (int wp = 0; wp < NWARP; ++wp) v += s_fsum[wp][tid];
    s_fc[(substeps - 1) & 1][tid] = v;
  }
  if constexpr (ON_CHIP) {
    for (int i = tid; i < nk * F; i += THREADS) {
      const int k = i / F;
      const size_t gi = (cell + row_of(k)) * F + (i - k * F);
      p.o_instr[gi] = t.instr[i];
      p.o_transfer[gi] = t.transfer[i];
      p.o_done[gi] = t.done[i];
    }
    for (int k = tid; k < nk; k += THREADS) {
      const size_t gk = cell + row_of(k);
      p.o_stage[gk] = t.stage[k];
      p.o_task_done[gk] = t.task_done[k];
      p.o_resp[gk] = t.resp[k];
    }
  }
  cluster.sync();
  if (rank == 0) {
    if (substeps > 0 && tid < NMET)
      add_metrics(cluster, s_m, s_fc, s_ic, (substeps - 1) & 1, tid);
    if (tid < NMET) p.o_metrics[(size_t)g * NMET + tid] = s_m[tid];
    for (int w = tid; w < n; w += THREADS) {
      int c = 0;
      for (int r = 0; r < CLUSTER; ++r)
        c += cluster.map_shared_rank(&s_pwt[0], r)[w];
      p.o_busy[(size_t)g * n + w] = s_busy[w];
      p.o_pwt[(size_t)g * n + w] = (double)c;
    }
    if (tid == 0) p.o_now[g] = now_s;
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

// The launch of the variant that K needs: its cluster shape, the dynamic
// shared memory and the attributes that allow them.
struct Plan {
  const void* kernel;
  size_t smem;
  bool on_chip;
};

Plan plan_for(int K, int F) {
  const int per = (K + CLUSTER - 1) / CLUSTER;
  const size_t bytes = layout(per, F).bytes;
  if (bytes <= SMEM_LIMIT)
    return {(const void*)edge_substep_kernel<true>, bytes, true};
  return {(const void*)edge_substep_kernel<false>, 0, false};
}

cudaError_t prepare(const Plan& pl, int G, cudaStream_t stream,
                    cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return e;
  if (CLUSTER > 8) {
    e = cudaFuncSetAttribute(pl.kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(G * CLUSTER);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = pl.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// ptrs: the 23 inputs in CARRY_NAMES + STATIC_NAMES order, then the 10
// outputs in OUT_NAMES order.  Returns the launch's CUDA error (0 if none).
extern "C" int edge_substep_launch(void* const* ptrs, int G, int K, int F,
                                   int n, int substeps, double dt,
                                   double swap_slowdown, double nic_cap,
                                   void* stream) {
  if (n < 1 || n > MAX_N || G < 1 || K < 1 || F < 1 || substeps < 0)
    return (int)cudaErrorInvalidValue;
  Ptrs p;
  int a = 0;
  p.instr = (const double*)ptrs[a++];
  p.done = (const uint8_t*)ptrs[a++];
  p.transfer = (const double*)ptrs[a++];
  p.stage = (const int32_t*)ptrs[a++];
  p.task_done = (const uint8_t*)ptrs[a++];
  p.resp = (const double*)ptrs[a++];
  p.now = (const double*)ptrs[a++];
  p.metrics = (const double*)ptrs[a++];
  p.worker = (const int32_t*)ptrs[a++];
  p.ram_task = (const double*)ptrs[a++];
  p.out_bytes = (const double*)ptrs[a++];
  p.nfrag = (const int32_t*)ptrs[a++];
  p.chain = (const uint8_t*)ptrs[a++];
  p.placed = (const uint8_t*)ptrs[a++];
  p.sla = (const double*)ptrs[a++];
  p.arrival = (const double*)ptrs[a++];
  p.acc_t = (const double*)ptrs[a++];
  p.wait_s = (const double*)ptrs[a++];
  p.decision = (const int32_t*)ptrs[a++];
  p.bw_mult = (const double*)ptrs[a++];
  p.mips = (const double*)ptrs[a++];
  p.cap = (const double*)ptrs[a++];
  p.net_bw = (const double*)ptrs[a++];
  p.o_instr = (double*)ptrs[a++];
  p.o_done = (uint8_t*)ptrs[a++];
  p.o_transfer = (double*)ptrs[a++];
  p.o_stage = (int32_t*)ptrs[a++];
  p.o_task_done = (uint8_t*)ptrs[a++];
  p.o_resp = (double*)ptrs[a++];
  p.o_now = (double*)ptrs[a++];
  p.o_metrics = (double*)ptrs[a++];
  p.o_busy = (double*)ptrs[a++];
  p.o_pwt = (double*)ptrs[a++];
  const Plan pl = plan_for(K, F);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = prepare(pl, G, (cudaStream_t)stream, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  if (pl.on_chip)
    e = cudaLaunchKernelEx(&cfg, edge_substep_kernel<true>, p, K, F, n,
                           substeps, dt, swap_slowdown, nic_cap);
  else
    e = cudaLaunchKernelEx(&cfg, edge_substep_kernel<false>, p, K, F, n,
                           substeps, dt, swap_slowdown, nic_cap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch shape for K tasks of F fragments over G cells: out = {CTAs
// per cluster, threads per CTA, dynamic shared memory bytes per CTA,
// carries on chip (1) or in global memory (0), clusters the card runs at
// once}.  Returns the CUDA error of the occupancy query (0 if none).
extern "C" int edge_substep_plan(int G, int K, int F, int* out) {
  const Plan pl = plan_for(K, F);
  out[0] = CLUSTER;
  out[1] = THREADS;
  out[2] = (int)pl.smem;
  out[3] = pl.on_chip ? 1 : 0;
  out[4] = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = prepare(pl, G < 1 ? 1 : G, nullptr, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveClusters(&out[4], pl.kernel, &cfg);
  return (int)e;
}

extern "C" const char* edge_substep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
