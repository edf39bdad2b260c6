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
// Design (a simple, correct first version):
//   * one CTA per grid cell, the substep loop inside the kernel;
//   * one thread owns whole tasks (k = tid, tid + THREADS, ...), so a task's
//     burn-down, handoff, completion and stage advance need no other thread;
//   * the per-worker arrays (n <= MAX_N: load counts, RAM load, swap flags,
//     completion counts) live in shared memory; busy seconds in a register of
//     thread w;
//   * the (K, F) carries stay in global memory (at K=2368, F=8 two float64
//     arrays alone are ~300 KB, over the 227 KB a block may use); one cell's
//     slot store is ~0.6 MB, so L2 (50 MB) holds every cell of the grid;
//   * three block barriers per substep: census -> per-worker totals ->
//     burn-down/handoff/metrics (plus one more on substeps where a task
//     finished, for the metric reduction).
//
// Determinism: load counts, completion counts and the count columns of the
// metric dot (finished, violations, finished per split decision) are integers
// (int32 shared-memory atomics, exact).  Every float64 sum is taken without
// float atomics, in a fixed order: a worker's RAM load is summed per warp in
// (task batch, fragment, lane) order by the lane that owns the worker, then
// over warps in warp order; the four float columns of the metric dot are a
// fixed xor-butterfly per warp, then warps in order.  Two runs give identical
// bits.  The file is compiled with
// -fmad=false so that `instr - rate*dt` and friends round like the eager twin.
//
// Out-of-range stage (stage >= F, which the reference's fuzz exercises): the
// reference's gather fills, so such a stage is not runnable, holds no RAM,
// moves no transfer and reads as done.  The kernel never indexes with it.
//
// What bounds it on an H100 (3.35 TB/s, 132 SMs): one call reads its carries
// and statics once and writes its outputs once, about 46*K*F + 76*K bytes per
// cell (~1.1 MB at K=2464, F=8; 17.5 MB for the G=16 main-path grid, 5.2 us
// at full bandwidth).  The kernel is bound by latency instead: 30 substeps x
// 3-4 block barriers, each substep re-reading the cell's carries from L2
// with a thread per task, and only G of the 132 SMs busy (one CTA per cell).
// chip_smoke.py measured 0.87 ms per call at that shape on an NVIDIA H100
// 80GB HBM3 with a 700 W power limit (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
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

__device__ __forceinline__ int clampw(int w, int n) {
  return w < 0 ? 0 : (w > n - 1 ? n - 1 : w);
}

__global__ void __launch_bounds__(THREADS)
edge_substep_kernel(Ptrs p, int K, int F, int n, int substeps, double dt,
                    double swap_slowdown, double nic_cap) {
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ int s_load_cnt[MAX_N];
  __shared__ int s_pwt[MAX_N];
  __shared__ double s_part[NWARP][MAX_N];
  __shared__ double s_load[MAX_N];
  __shared__ unsigned char s_swap[MAX_N];
  __shared__ double s_fsum[NWARP][NFLT];
  __shared__ int s_icnt[NCNT];
  __shared__ double s_m[NMET];
  __shared__ double s_mips[MAX_N], s_cap[MAX_N], s_net[MAX_N], s_bwm[MAX_N];

  const size_t KF = (size_t)K * F;
  const size_t cf = (size_t)g * KF;   // (K, F) base of this cell
  const size_t ck = (size_t)g * K;    // (K,) base of this cell

  const double* instr_in = p.instr + cf;
  const uint8_t* done_in = p.done + cf;
  const double* transfer_in = p.transfer + cf;
  const int32_t* worker = p.worker + cf;
  const double* out_bytes = p.out_bytes + cf;
  const uint8_t* task_done_in = p.task_done + ck;
  const double* ram_task = p.ram_task + ck;
  const int32_t* nfrag = p.nfrag + ck;
  const uint8_t* chain = p.chain + ck;
  const uint8_t* placed = p.placed + ck;
  const double* sla = p.sla + ck;
  const double* arrival = p.arrival + ck;
  const double* acc_t = p.acc_t + ck;
  const double* wait_s = p.wait_s + ck;
  const int32_t* decision = p.decision + ck;

  double* instr = p.o_instr + cf;
  uint8_t* done = p.o_done + cf;
  double* transfer = p.o_transfer + cf;
  int32_t* stage = p.o_stage + ck;
  uint8_t* task_done = p.o_task_done + ck;
  double* resp = p.o_resp + ck;

  for (int w = tid; w < n; w += THREADS) {
    s_mips[w] = p.mips[w];
    s_cap[w] = p.cap[w];
    s_net[w] = p.net_bw[w];
    s_bwm[w] = p.bw_mult[(size_t)g * n + w];
    s_load_cnt[w] = 0;
    s_pwt[w] = 0;
  }
  if (tid < NMET) s_m[tid] = p.metrics[(size_t)g * NMET + tid];
  if (tid < NCNT) s_icnt[tid] = 0;
  // each thread copies the carries of the tasks it owns
  for (int k = tid; k < K; k += THREADS) {
    for (int f = 0; f < F; ++f) {
      const size_t i = (size_t)k * F + f;
      instr[i] = instr_in[i];
      done[i] = done_in[i];
      transfer[i] = transfer_in[i];
    }
    stage[k] = p.stage[ck + k];
    task_done[k] = task_done_in[k];
    resp[k] = p.resp[ck + k];
  }
  double now_s = p.now[g];
  double busy = 0.0;                  // worker `tid` (tid < n)
  const int task_iters = (K + THREADS - 1) / THREADS;
  __syncthreads();

  for (int step = 0; step < substeps; ++step) {
    // ---- 1. census: load counts (atomics) + ordered per-warp RAM sums
    double racc[WSLOTS];
#pragma unroll
    for (int j = 0; j < WSLOTS; ++j) racc[j] = 0.0;
    for (int it = 0; it < task_iters; ++it) {
      const int k = it * THREADS + tid;
      const bool valid = k < K;
      const int s = valid ? stage[k] : -1;
      const bool ch = valid && chain[k];
      const bool pl = valid && placed[k];
      const double rt = valid ? ram_task[k] : 0.0;
      for (int f = 0; f < F; ++f) {
        bool holds = false;
        int w = 0;
        if (valid) {
          const size_t i = (size_t)k * F + f;
          const int wk = worker[i];
          const bool nd = !done[i];
          const bool is_stage = f == s;
          w = clampw(wk, n);
          holds = (!ch || is_stage) && wk >= 0 && nd;
          if (!ch) {
            if (holds) atomicAdd(&s_load_cnt[w], 1);
          } else if (is_stage && transfer[i] <= 0.0 && pl && wk >= 0 && nd) {
            atomicAdd(&s_load_cnt[w], 1);     // the chain's runnable stage
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
    }
#pragma unroll
    for (int j = 0; j < WSLOTS; ++j) {
      const int w = lane + 32 * j;
      if (w < n) s_part[warp][w] = racc[j];
    }
    __syncthreads();

    // ---- 2. per-worker totals, swap flags, busy time
    if (tid < n) {
      double rl = 0.0;
      for (int wp = 0; wp < NWARP; ++wp) rl += s_part[wp][tid];
      const double ld = (double)s_load_cnt[tid];
      s_load_cnt[tid] = 0;
      s_load[tid] = ld;
      s_swap[tid] = rl > s_cap[tid];
      if (ld > 0.0) busy = busy + dt;
    }
    __syncthreads();

    // ---- 3. burn-down, handoff, completion, transfer, stage advance
    double floc[NFLT];
#pragma unroll
    for (int j = 0; j < NFLT; ++j) floc[j] = 0.0;
    int fin_any = 0;
    for (int k = tid; k < K; k += THREADS) {
      const int s = stage[k];
      const bool in_rng = s >= 0 && s < F;
      const bool ch = chain[k];
      const bool pl = placed[k];
      const int nf = nfrag[k];
      const size_t row = (size_t)k * F;
      const double cur_tl = in_rng ? transfer[row + s] : 0.0;
      bool hand_prev = false;
      bool all_done = true;
      for (int f = 0; f < F; ++f) {
        const size_t i = row + f;
        const int wk = worker[i];
        bool dn = done[i];
        const double t_start = transfer[i];
        const bool runnable = (!ch || (t_start <= 0.0 && f == s)) && pl &&
                              wk >= 0 && !dn;
        bool newly = false;
        if (runnable) {
          const int w = clampw(wk, n);
          double rate = s_mips[w] / fmax(s_load[w], 1.0);
          if (s_swap[w]) rate = rate * swap_slowdown;
          const double left = instr[i] - rate * dt;
          instr[i] = left;
          newly = left <= 0.0;
          if (newly) {
            dn = true;
            done[i] = 1;
          }
        }
        // the activation of a stage that just finished lands on the next one
        if (hand_prev) transfer[i] = out_bytes[i - 1];
        hand_prev = newly && ch && f < nf - 1;
        all_done = all_done && dn;
      }
      if (all_done && !task_done[k]) {
        task_done[k] = 1;
        const double resp_t = now_s - arrival[k];
        resp[k] = resp_t;
        const double sl = sla[k];
        const double ac = acc_t[k];
        const int dk = decision[k];
        const int d = dk < 0 ? 0 : (dk > 2 ? 2 : dk);
        floc[0] += resp_t;
        floc[1] += ac;
        floc[2] += ((resp_t <= sl ? 1.0 : 0.0) + ac) / 2.0;
        floc[3] += wait_s[k];
        atomicAdd(&s_icnt[0], 1);
        if (resp_t > sl) atomicAdd(&s_icnt[1], 1);
        atomicAdd(&s_icnt[2 + d], 1);
        fin_any = 1;
      }
      const bool chactive = ch && pl && !task_done_in[k];
      if (chactive && in_rng && s > 0 && cur_tl > 0.0) {
        const int w_s = clampw(worker[row + s], n);
        const int w_p = clampw(worker[row + (s + F - 1) % F], n);
        const double bw = fmin(nic_cap, fmin(s_net[w_p] / 100.0,
                                             s_net[w_s] / 100.0)) *
                          fmin(s_bwm[w_p], s_bwm[w_s]);
        transfer[row + s] = transfer[row + s] - bw * 1e6 * dt;
      }
      const bool done_s = in_rng ? (bool)done[row + s] : true;
      if (chactive && done_s && s < nf - 1) stage[k] = s + 1;
    }

    // ---- 4. metric dot: the float columns in a fixed order, the counts
    // exact (only on substeps where a task finished)
    if (__syncthreads_or(fin_any)) {
#pragma unroll
      for (int j = 0; j < NFLT; ++j) {
        double v = floc[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
        if (lane == 0) s_fsum[warp][j] = v;
      }
      __syncthreads();
      if (tid < NMET) {
        double tot = 0.0;
        const int fc = FLT_OF_COL[tid];
        if (fc >= 0) {
          for (int wp = 0; wp < NWARP; ++wp) tot += s_fsum[wp][fc];
        } else {
          const int ic = CNT_OF_COL[tid];
          tot = (double)s_icnt[ic];
          s_icnt[ic] = 0;
        }
        s_m[tid] = s_m[tid] + tot;
      }
    }
    now_s = now_s + dt;
  }

  // ---- per-worker completion census of the interval
  for (int k = tid; k < K; k += THREADS) {
    for (int f = 0; f < F; ++f) {
      const size_t i = (size_t)k * F + f;
      if (done[i] && !done_in[i]) atomicAdd(&s_pwt[clampw(worker[i], n)], 1);
    }
  }
  __syncthreads();
  if (tid < n) {
    p.o_busy[(size_t)g * n + tid] = busy;
    p.o_pwt[(size_t)g * n + tid] = (double)s_pwt[tid];
  }
  if (tid < NMET) p.o_metrics[(size_t)g * NMET + tid] = s_m[tid];
  if (tid == 0) p.o_now[g] = now_s;
}

}  // namespace

// ptrs: the 23 inputs in CARRY_NAMES + STATIC_NAMES order, then the 10
// outputs in OUT_NAMES order.  Returns cudaGetLastError() after the launch.
extern "C" int edge_substep_launch(void* const* ptrs, int G, int K, int F,
                                   int n, int substeps, double dt,
                                   double swap_slowdown, double nic_cap,
                                   void* stream) {
  if (n < 1 || n > MAX_N || G < 1 || K < 1 || F < 1)
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
  edge_substep_kernel<<<G, THREADS, 0, (cudaStream_t)stream>>>(
      p, K, F, n, substeps, dt, swap_slowdown, nic_cap);
  return (int)cudaGetLastError();
}
