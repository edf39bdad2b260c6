#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels side by side on one GPU.

    PYTHONPATH=src python3 tools/kernel_variants.py \
        [flash|rglru|sim|bestfit|route|all [NAME ...]]

Builds text variants of ``csrc/rglru_scan.cu`` (CTA size 32/64/128 ×
steps per register buffer 4/8/16) and of the bfloat16 tensor-core kernel
of ``csrc/flash_attention.cu`` at each serving head dim (its
``MmaTile<hd>``: products by ``mma.sync`` (step 1) or ``wgmma`` (step 2),
4 to 16 warps per CTA, 64 or 128 keys per K/V tile (32 or 64 at hd=256),
a cp.async ring of 2 or 3 stages), each with the port's nvcc flags, into
``kernels/_build/variants/``; checks each against the eager twin and
times it with CUDA events at the serving shapes (rglru_scan:
recurrentgemma-9b's b=4, s=1024, w=4096, float32 and bfloat16; flash,
bfloat16, b=4, s=1024, causal: TinyLlama-1.1B's 32/4 heads at hd=64,
qwen2-moe-a2.7b's 16/16 at hd=128, recurrentgemma-9b's 16/1 at hd=256
with window 2048; each flash variant is also held against the twin at
ragged and windowed shapes of its head dim).  The committed rglru source
is the variant ``t32_u8``; the committed ``MmaTile`` values name the
flash variant chosen per head dim.  Prints the card, one line per variant
and round (two rounds, in turns), and a JSON line of the medians.  An
argument limits the run to one kernel, and further ones to the variants
whose names contain one of them.  Exits non-zero without a GPU or
when a variant disagrees with the twin.

``sim`` builds variants of the two simulator kernels and times them at
one real interval of the main-path grid (``chip_smoke.main_path_interval``:
G=16, K=2464, F=8, n=50, 30 substeps) from CUDA graphs, in turns, holding
each against its twin (``edge_substep`` at rtol=1e-12 with bools and ints
exact, ``repair_scan`` exactly): ``csrc/edge_substep.cu`` with 1, 2, 4, 8
and 16 CTAs per cluster (16 is a non-portable cluster size) and 128 or
256 threads per CTA, and the repair of ``csrc/placement.cu`` with 2, 4 or
8 warps per CTA and 32 to 256 slots per gathered chunk.  The committed
values name the fastest.  It also times the committed ``edge_substep`` at
0, 1 and 30 substeps (the cost of one substep) and builds a profiling
copy of it that stamps ``clock64()`` at each phase of each substep, and
prints the mean cycles per phase for rank 0 and the last rank of cell 0.

``bestfit`` builds the BestFit kernel of ``csrc/placement.cu`` with each
argmax form (``BF_ARGMAX``: 0, the committed one, keyed
``__reduce_max_sync`` on the key's halves then ``__reduce_min_sync`` on
the index, 1 an ``fmax`` butterfly on the doubles then the index, 2 a
butterfly shuffling the 64-bit key and the index, 3 form 0 with a ballot
shortcut) and update form (``BF_UPDATE``: 2, the committed one, every
lane divides once for its worker in the winner's register slot, 0 the
winner's lane divides in a divergent branch, 1 every lane divides for
each of its workers before the argmax), the other forms as text edits of
the committed source, and 1, 2 or 3 chunks of 32 steps' ``pos`` loaded
ahead (``BF_AHEAD``), beside the earlier design (``tools/kernel_baselines/
bestfit_smem.cu``: state in shared memory, a global load chain and a
double-and-index shuffle argmax per step); holds each against the twin
exactly at the shapes of ``chip_smoke.bestfit_cases`` and at two real
main-path intervals, 30 and the one whose longest cell walks the most, and
times them there from CUDA graphs.  ``route`` builds ``csrc/moe_route.cu``
with 2, 4, 8 or 16 logits per lane (``VPL``: 32, 16, 8 or 4 lanes per
token at E=60, so 16, 32, 32 and 32 tokens per CTA under ``TILE`` = 32),
beside the earlier two-pass design (``tools/kernel_baselines/
moe_route_two_pass.cu``); holds each against the twin at
``chip_smoke.MOE_ROUTE_CASES`` and an underflowing row (ids and slots
exactly, gates within 1e-5, bitwise repeatable) and times them at
qwen2-moe's serving shape (G=1, gs=4096, E=60, k=4) from CUDA graphs.
The committed values are the fastest.

``all wide`` builds seven libraries of ``csrc/flash_attention.cu``, the
i-th carrying option i of the forward and backward tile lists of head dims
112 and 192 (``WIDE_FWD``, ``WIDE_BWD``: kimi-k2-1t-a32b's and
nemotron-4-340b's heads), holds each kernel against the twins at
``WIDE_EDGES`` and the serving shapes and times forward and backward there
from CUDA graphs.  ``all bwd`` builds the rglru_scan backward at 32/64/128
channels per CTA × 4/8/16 steps per register buffer and the moe_route
backward at 4–32 tokens per CTA, each beside its earlier design
(``tools/kernel_baselines/``), holds them against the twins (rglru
bitwise) and times them from CUDA graphs.  (``all`` alone runs every
sweep.)
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


#: bfloat16 flash variants per serving head dim: (step, warps per CTA,
#: keys per K/V tile, cp.async stages), those that fit the 227 KB of
#: shared memory
SMEM_LIMIT = 232448


#: warps per CTA tried per head dim: the wgmma accumulators of larger
#: CTAs do not fit the 64K registers of an SM at hd 128 and 256
WARPS = {64: (4, 8, 12, 16), 128: (4, 8, 12), 256: (4, 8)}


def _smem(hd, step, warps, bn, stages):
    rows = 16 * warps + 2 * stages * bn
    return 2 * (rows * (hd + 8) if step == 1 else rows * hd + 512)


FLASH_OPTIONS = {hd: [o for o in (
    [(1, 4, bn, 2) for bn in ((32, 64) if hd == 256 else (64, 128))]
    + [(2, w, bn, st) for w in WARPS[hd]
       for bn in ((32, 64) if hd == 256 else (64, 128)) for st in (2, 3)])
    if _smem(hd, *o) <= SMEM_LIMIT] for hd in (64, 128, 256)}
#: the serving shape timed per head dim: (b, s, h, kvh, window), causal
FLASH_SERVING = {64: (4, 1024, 32, 4, 0), 128: (4, 1024, 16, 16, 0),
                 256: (4, 1024, 16, 1, 2048)}
#: shapes each variant is also held at: (b, sq, sk, h, kvh, causal, window)
FLASH_EDGES = [(1, 200, 200, 8, 2, True, 0), (1, 200, 200, 16, 16, True, 5),
               (1, 90, 40, 8, 1, False, 0), (2, 70, 70, 16, 1, True, 0),
               (1, 24, 8, 2, 1, True, 4), (1, 20, 20, 128, 1, True, 0)]


def _sub(src, pairs):
    for old, new in pairs:
        if old not in src:
            raise AssertionError(f"variant edit not found: {old!r}")
        src = src.replace(old, new)
    return src


#: the profiling copy of edge_substep.cu: clock64() stamps of thread 0 of
#: each CTA of cell 0, per substep (row step + 1) before the census (0),
#: after its CTA barrier (1), after the cluster barrier (2), after the
#: next CTA barrier (3) and after the burn-down and its barrier (4); in row
#: 0 at entry (5),
#: before the substep loop (6) and before the last cluster barrier (7)
PROF_STEPS = 64
PROF_HEAD = f"""
__device__ long long prof_stamps[16 * {PROF_STEPS + 1} * 8];
extern "C" int prof_read(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, prof_stamps, sizeof(prof_stamps));
}}
"""
_ENTRY = ("  const int g = blockIdx.x / CLUSTER;\n"
          "  const int tid = threadIdx.x;\n")


def _stamp(phase, indent):
    row = "0" if phase >= 5 else f"(step < {PROF_STEPS} ? step + 1 : 0)"
    return (f"{indent}if (g == 0 && tid == 0) prof_stamps[(rank * "
            f"{PROF_STEPS + 1} + {row}) * 8 + {phase}] = clock64();\n")


def _profiled(src):
    src = src.replace("namespace {", PROF_HEAD + "\nnamespace {", 1)
    edits = [(_ENTRY, _ENTRY + _stamp(5, "  "))]
    for phase, mark in enumerate(("    // ---- 1. census",
                                  "    // ---- 2. this CTA's",
                                  "    // ---- 3. the cell's",
                                  "    // ---- 4. burn-down")):
        edits.append((mark, _stamp(phase, "    ") + mark))
    end = "    now_s = now_s + dt;\n  }"
    edits.append((end, "    now_s = now_s + dt;\n" + _stamp(4, "    ")
                  + "  }"))
    for phase, mark in ((6, "  double now_s = p.now[g];"),
                        (7, "  // no CTA leaves while")):
        edits.append((mark, _stamp(phase, "  ") + mark))
    return _sub(src, edits)


def sim_variants(csrc):
    """{name: (source, kind)} of the simulator kernels' variants."""
    es = (csrc / "edge_substep.cu").read_text()
    pc = (csrc / "placement.cu").read_text()
    out = {}
    for c in (1, 2, 4, 8, 16):
        for t in (128, 256):
            out[f"sim_edge_c{c}_t{t}"] = (_sub(es, [
                ("constexpr int CLUSTER = 8;", f"constexpr int CLUSTER = {c};"),
                ("constexpr int THREADS = 256;",
                 f"constexpr int THREADS = {t};")]), "sim_edge")
    out["sim_edge_prof"] = (_profiled(es), "sim_prof")
    for w in (2, 4, 8):
        for ch in (32, 64, 128, 256):
            out[f"sim_repair_w{w}_ch{ch}"] = (_sub(pc, [
                ("constexpr int REPAIR_WARPS = 4;",
                 f"constexpr int REPAIR_WARPS = {w};"),
                ("constexpr int REPAIR_CHUNK = 64;",
                 f"constexpr int REPAIR_CHUNK = {ch};")]), "sim_repair")
    return out


BASELINES = os.path.join(ROOT, "tools", "kernel_baselines")


def _baseline(name):
    with open(os.path.join(BASELINES, name)) as f:
        return f.read()


#: the profiling copy of moe_route.cu: %globaltimer stamps of thread 0 of
#: each CTA at entry (0), after taking its tile (1), after the token phase
#: (2), after publishing its counts (3), after the ranking (4), after the
#: look-back (5) and at exit (6)
ROUTE_PROF_CTAS = 4096
ROUTE_PROF_HEAD = f"""
__device__ unsigned long long route_prof[{ROUTE_PROF_CTAS} * 8];
extern "C" int prof_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, route_prof, sizeof(route_prof));
}}
__global__ void empty_kernel() {{}}
// the launch's two graph nodes alone: the flags' memset, an empty kernel
extern "C" int memset_only(void* p, long long bytes, void* stream) {{
  return (int)cudaMemsetAsync(p, 0, (size_t)bytes, (cudaStream_t)stream);
}}
extern "C" int empty_only(void* stream) {{
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}}
"""


def _route_stamp(phase, indent):
    return (f"{indent}if (threadIdx.x == 0 && blockIdx.x < "
            f"{ROUTE_PROF_CTAS}) {{ unsigned long long t_; asm volatile("
            f"\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
            f"route_prof[blockIdx.x * 8 + {phase}] = t_; }}\n")


def _route_profiled(src):
    src = src.replace("namespace {", ROUTE_PROF_HEAD + "\nnamespace {", 1)
    edits = []
    for phase, mark in enumerate((
            "  const int tid = threadIdx.x, nthr = blockDim.x;\n",
            "  // ---- 2.", "  // ---- 3.", "  // ---- 4.", "  // ---- 5.",
            "  // ---- 6.")):
        edits.append((mark, _route_stamp(phase, "  ") + mark))
    end = "    slot[first + i] = s_base[e] + s_cc[w * E + e] + s_loc[i];\n  }\n"
    edits.append((end, end + _route_stamp(6, "  ")))
    return _sub(src, edits)


def _set(src, name, value):
    """``src`` with ``constexpr int <name> = <value>;``."""
    out, n = re.subn(rf"constexpr int {name} = \d+;",
                     f"constexpr int {name} = {value};", src)
    if n != 1:
        raise AssertionError(f"{name}: {n} definitions")
    return out


#: the profiling copy of the BestFit kernel: clock64() of every lane at the
#: start of each step (0), before the warp argmax (1), after it (2) and
#: after the update (3), summed over each cell's steps; lane 0 writes its
#: cell's three sums and step count at exit
BESTFIT_PROF_CELLS = 64
BESTFIT_PROF_HEAD = f"""
__device__ long long bestfit_prof[{BESTFIT_PROF_CELLS} * 4];
extern "C" int prof_read(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, bestfit_prof, sizeof(bestfit_prof));
}}
"""


def _bestfit_profiled(src):
    src = src.replace("namespace {", BESTFIT_PROF_HEAD + "\nnamespace {", 1)
    return _sub(src, [
        ("  double rc = ram_at(0, pq[0]);\n",
         "  double rc = ram_at(0, pq[0]);\n"
         "  long long pf0 = 0, pf1 = 0, pf2 = 0, pfn = 0;\n"),
        ("      // the masked score's key",
         "      const long long c0_ = clock64();\n"
         "      // the masked score's key"),
        ("      int w = warp_first_max(bk, bi);\n",
         "      const long long c1_ = clock64();\n"
         "      int w = warp_first_max(bk, bi);\n"
         "      const long long c2_ = clock64();\n"),
        ("      if (lane == s) req_g[pc] = w;\n",
         "      const long long c3_ = clock64();\n"
         "      pf0 += c1_ - c0_; pf1 += c2_ - c1_; pf2 += c3_ - c2_; ++pfn;\n"
         "      if (lane == s) req_g[pc] = w;\n"),
        ("    rc = rn;\n  }\n}",
         "    rc = rn;\n  }\n"
         f"  if (g < {BESTFIT_PROF_CELLS} && lane == 0) {{\n"
         "    bestfit_prof[4 * g] = pf0; bestfit_prof[4 * g + 1] = pf1;\n"
         "    bestfit_prof[4 * g + 2] = pf2; bestfit_prof[4 * g + 3] = pfn;\n"
         "  }\n}")])


#: the committed BestFit argmax (form 0: a keyed ``__reduce_max_sync`` on
#: the key's halves, then ``__reduce_min_sync`` on the index) and the other
#: forms the sweep times in its place: 1 an ``fmax`` butterfly on the
#: doubles then the index, 2 a butterfly shuffling the 64-bit key and the
#: index, 3 form 0 with a ballot shortcut when one lane holds the high half
BF_ARGMAX_0 = """\
__device__ __forceinline__ int warp_first_max(unsigned long long key,
                                              int idx) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mh = __reduce_max_sync(FULL, hi);
  const unsigned ml = __reduce_max_sync(FULL, hi == mh ? lo : 0u);
  return (int)__reduce_min_sync(
      FULL, (hi == mh && lo == ml) ? (unsigned)idx : 0xffffffffu);
}
"""
BF_ARGMAX = {
    1: """\
__device__ __forceinline__ int warp_first_max(unsigned long long key,
                                              double val, int idx) {
  double m = key ? val : -INFINITY;
  for (int off = 16; off > 0; off >>= 1)
    m = fmax(m, __shfl_xor_sync(FULL, m, off));
  return (int)__reduce_min_sync(
      FULL, (key && val == m) ? (unsigned)idx : 0xffffffffu);
}
""",
    2: """\
__device__ __forceinline__ int warp_first_max(unsigned long long key,
                                              int idx) {
  unsigned long long k = key;
  unsigned i = (unsigned)idx;
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long ok = __shfl_xor_sync(FULL, k, off);
    const unsigned oi = __shfl_xor_sync(FULL, i, off);
    if (ok > k || (ok == k && oi < i)) {
      k = ok;
      i = oi;
    }
  }
  return (int)i;
}
""",
    3: """\
__device__ __forceinline__ int warp_first_max(unsigned long long key,
                                              int idx) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mh = __reduce_max_sync(FULL, hi);
  const unsigned at = __ballot_sync(FULL, hi == mh);
  if (__popc(at) == 1) return __shfl_sync(FULL, idx, __ffs(at) - 1);
  const unsigned ml = __reduce_max_sync(FULL, hi == mh ? lo : 0u);
  return (int)__reduce_min_sync(
      FULL, (hi == mh && lo == ml) ? (unsigned)idx : 0xffffffffu);
}
"""}
#: form 1 also carries each lane's best double beside its key
BF_ARGMAX_VAL = [
    ("      int bi = 0x7fffffff;\n",
     "      double bv = 0.0;\n      int bi = 0x7fffffff;\n"),
    ("          bi = lane + 32 * j;\n",
     "          bv = fits ? sc[j] : -1e9;\n          bi = lane + 32 * j;\n"),
    ("warp_first_max(bk, bi)", "warp_first_max(bk, bv, bi)")]

#: the committed update (form 2: every lane divides once after the argmax,
#: for its worker in the winner's register slot) and the others: 0 the
#: winner's lane divides after the argmax, in a divergent branch; 1 every
#: lane divides for each of its workers before the argmax
BF_UPDATE_2 = """\
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
"""
BF_UPDATE = {
    0: [(BF_UPDATE_2, """\
      if (lane == (w & 31)) {
        const int jw = w >> 5;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (j == jw) {
            const double f = fr[j] - rm;
            const double l = ld[j] + 1.0;
            sc[j] = -l + st[j] + 0.1 * f / cp[j];
            sk[j] = order_key(sc[j]);
            fr[j] = f;
            ld[j] = l;
          }
        }
      }
""")],
    1: [("      // the masked score's key", """\
      double nf[J], ns[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        nf[j] = fr[j] - rm;
        ns[j] = -(ld[j] + 1.0) + st[j] + 0.1 * nf[j] / cp[j];
      }
      // the masked score's key"""), (BF_UPDATE_2, """\
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const bool win = w == lane + 32 * j;
        fr[j] = win ? nf[j] : fr[j];
        ld[j] = win ? ld[j] + 1.0 : ld[j];
        sc[j] = win ? ns[j] : sc[j];
        sk[j] = win ? order_key(ns[j]) : sk[j];
      }
""")]}


def bestfit_variant(pc, form, ahead, update):
    """``placement.cu`` with argmax form ``form``, ``ahead`` chunks of pos
    staged and update form ``update`` (0, 2 and 2 are the committed
    values)."""
    src = _set(pc, "BF_AHEAD", ahead)
    if form:
        src = _sub(src, [(BF_ARGMAX_0, BF_ARGMAX[form])]
                   + (BF_ARGMAX_VAL if form == 1 else []))
    if update != 2:
        src = _sub(src, BF_UPDATE[update])
    return src


def placement_variants(csrc):
    """{name: (source, kind)} of the BestFit kernel's and moe_route's
    variants, each beside its earlier design."""
    pc = (csrc / "placement.cu").read_text()
    mr = (csrc / "moe_route.cu").read_text()
    out = {"bestfit_smem": (_baseline("bestfit_smem.cu"), "bestfit"),
           "route_two_pass": (_baseline("moe_route_two_pass.cu"), "route")}
    shapes = [(form, 2, update) for form in (0, 1, 2, 3)
              for update in (0, 1, 2)] + [(0, 1, 2), (0, 3, 2)]
    for form, ahead, update in shapes:
        out[f"bestfit_a{form}_d{ahead}_u{update}"] = (
            bestfit_variant(pc, form, ahead, update), "bestfit")
    for vpl in (2, 4, 8, 16):
        out[f"route_v{vpl}"] = (_set(mr, "VPL", vpl), "route")
    out["route_prof"] = (_route_profiled(mr), "route_prof")
    out["bestfit_prof"] = (_bestfit_profiled(pc), "bestfit_prof")
    return out


def variants(csrc):
    """{name: (source, kernel)} of every variant."""
    rg = (csrc / "rglru_scan.cu").read_text()
    fa = (csrc / "flash_attention.cu").read_text()
    out = sim_variants(csrc)
    out.update(placement_variants(csrc))
    for threads in (32, 64, 128):
        for u in (4, 8, 16):
            out[f"rglru_t{threads}_u{u}"] = (_sub(rg, [
                ("constexpr int THREADS = 32;",
                 f"constexpr int THREADS = {threads};"),
                ("constexpr int U = 8;", f"constexpr int U = {u};")]),
                "rglru")
    out.update(wide_variants(fa))
    out.update(bwd_variants(csrc))
    for hd, options in FLASH_OPTIONS.items():
        line = re.search(rf"struct MmaTile<{hd}> {{\n  static constexpr int "
                         rf"WARPS = \d+, BN = \d+, STAGES = \d+, STEP = "
                         rf"\d+;", fa)
        if line is None:
            raise AssertionError(f"MmaTile<{hd}> not found")
        for step, warps, bn, stages in options:
            out[f"flash_hd{hd}_step{step}_w{warps}_bn{bn}_st{stages}"] = (
                fa.replace(line.group(0), (
                    f"struct MmaTile<{hd}> {{\n  static constexpr int WARPS "
                    f"= {warps}, BN = {bn}, STAGES = {stages}, STEP = "
                    f"{step};")), f"flash{hd}")
    return out


def build(names_sources, out_dir):
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in names_sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n"
                               f"{log}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        # ptxas -v: registers and spills of the variant's kernel (the
        # bf16 kernels of the swept head dims for a flash variant)
        hd = re.search(r"flash_hd(\d+)_", name)
        dims = [hd.group(1)] if hd else ["112", "192"] \
            if name.startswith("flash_wide") else None
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif entry and ("Used" in line or "spill" in line) and (
                    dims is None or any(f"mma_kernelILi{d}E" in entry
                                        for d in dims)):
                print(f"{name}: {entry.split()[-1]} {line.strip()}",
                      flush=True)
    return libs


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _flash_launcher(lib):
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    return fn


def _flash_call(fn, name, q, k, v, o, causal, window, stream):
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq,
            sk, h, kvh, hd, int(causal), window, 1, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _edge_launcher(lib):
    fn = lib.edge_substep_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_double,
                   ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
    return fn


def _edge_call(fn, name, args, outs, kw):
    import torch
    G, K, F = args[8].shape
    n = args[20].shape[0]
    ptrs = (ctypes.c_void_p * (len(args) + len(outs)))(
        *[t.data_ptr() for t in args], *[t.data_ptr() for t in outs])
    rc = fn(ptrs, G, K, F, n, kw["substeps"], kw["dt"], kw["swap_slowdown"],
            kw["nic_cap"], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _repair_call(lib, name, ops, worker2, placed):
    import torch
    fn = lib.repair_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9 + [
                       ctypes.c_int, ctypes.c_void_p]
    G, K, F = ops[6].shape
    rc = fn(ops[0].data_ptr(), ops[1].data_ptr(), G, K, F,
            *[t.data_ptr() for t in ops[2:9]], worker2.data_ptr(),
            placed.data_ptr(), ops[8].shape[0],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _bestfit_call(lib, name, ops, out):
    import torch
    fn = lib.bestfit_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int] + [ctypes.c_void_p] * 7 + [
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    G, K, F = ops[8].shape
    rc = fn(ops[0].data_ptr(), ops[1].data_ptr(), G, ops[0].shape[1],
            *[t.data_ptr() for t in ops[2:8]], out.data_ptr(), K * F,
            ops[7].shape[0], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def bestfit_main(table, libs, times):
    """Time the BestFit variants at two main-path intervals."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels import placement
    names = [n for n, (_, k) in table.items() if k == "bestfit"]
    if not names and not any(k == "bestfit_prof" for _, k in table.values()):
        return
    late, walk = chip_smoke.longest_walk_interval()
    at = {t: chip_smoke.main_path_interval(t)[0] for t in (30, late)}
    checks = dict(at)
    for where, ops in chip_smoke.bestfit_cases().items():
        checks[where] = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                         for a in ops]
    want = {w: placement.bestfit_scan_ref(*ops) for w, ops in checks.items()}
    for name in names:
        for where, ops in checks.items():
            out, again = ops[8].clone(), ops[8].clone()
            _bestfit_call(libs[name], name, ops, out)
            _bestfit_call(libs[name], name, ops, again)
            torch.cuda.synchronize()
            if not (torch.equal(out, want[where])
                    and torch.equal(out, again)):
                raise AssertionError(f"{name} at {where}: differs from the "
                                     "twin or between runs")
    print(f"bestfit: intervals 30 ({int(at[30][1].max())} steps in the "
          f"longest cell) and {late} ({walk} steps, the longest of the run); "
          f"every variant equals the twin there and at "
          f"{len(checks) - 2} edge shapes", flush=True)
    bestfit_profile(table, libs, at)
    for rnd in range(2):
        for name in names:
            for t, ops in at.items():
                out = ops[8].clone()
                ms = chip_smoke.graph_ms(
                    lambda: _bestfit_call(libs[name], name, ops, out), 10)
                key = f"{name} @{t}"
                times.setdefault(key, []).append(ms)
                print(f"round {rnd} {key}: {ms:.5f} ms/call, "
                      f"{ms * 1e6 / int(ops[1].max()):.1f} ns per step of "
                      f"the longest cell", flush=True)


def plan_tiles(lib, gs, E, k):
    """Tiles per group of a moe_route library."""
    fn = lib.moe_route_plan
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 7)()
    fn(gs, E, k, out)
    return out[4]


def bestfit_profile(table, libs, at):
    """Cycles per step of the longest cell's walk by phase, from the
    clock64() copy, at each of the intervals ``at``."""
    import torch
    import chip_smoke
    for name in (n for n, (_, k) in table.items() if k == "bestfit_prof"):
        read = libs[name].prof_read
        read.restype = ctypes.c_int
        read.argtypes = [ctypes.c_void_p]
        for t, ops in at.items():
            out = ops[8].clone()
            _bestfit_call(libs[name], name, ops, out)
            torch.cuda.synchronize()
            st = np.zeros(BESTFIT_PROF_CELLS * 4, dtype=np.int64)
            if read(st.ctypes.data) != 0:
                raise RuntimeError(f"{name}: prof_read failed")
            st = st.reshape(-1, 4)[int(ops[1].argmax())]
            n = max(int(st[3]), 1)
            ms = chip_smoke.graph_ms(
                lambda: _bestfit_call(libs[name], name, ops, out), 10)
            print(f"{name} @{t}: the longest cell walks {n} steps; per "
                  f"step {st[0] / n:.0f} cycles to the argmax (masks and "
                  f"keys), {st[1] / n:.0f} in it, {st[2] / n:.0f} in the "
                  f"update (the winner's division); the copy takes "
                  f"{ms:.5f} ms/call, {ms * 1e6 / n:.1f} ns per step",
                  flush=True)


def _route_call(lib, name, logits, k, outs, scratch):
    import torch
    fn = lib.moe_route_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    G, gs, E = logits.shape
    rc = fn(logits.data_ptr(), *[o.data_ptr() for o in outs],
            scratch.data_ptr(), G, gs, E, k,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _route_scratch(lib, G, gs, E, k):
    import torch
    if hasattr(lib, "moe_route_scratch"):
        fn = lib.moe_route_scratch
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int] * 4
        words = fn(G, gs, E, k)
    else:
        fn = lib.moe_route_tiles
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int]
        words = G * fn(gs) * E
    return torch.empty((words,), dtype=torch.int32, device="cuda")


def route_main(table, libs, times):
    """Time the moe_route variants at qwen2-moe's serving shape."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels.ref import moe_route_ref
    names = [n for n, (_, k) in table.items() if k == "route"]
    if not names:
        return
    rng = np.random.RandomState(0)
    cases = [(chip_smoke._route_logits(rng, G, gs, E), k)
             for G, gs, E, k in chip_smoke.MOE_ROUTE_CASES]
    cases.append((torch.tensor([[[0.0, -200.0, -200.0, -200.0]]],
                               device="cuda"), 2))
    for name in names:
        for logits, k in cases:
            want = moe_route_ref(logits, k)
            G, gs, E = logits.shape
            scratch = _route_scratch(libs[name], G, gs, E, k)
            got = [torch.empty_like(w) for w in want]
            again = [torch.empty_like(w) for w in want]
            _route_call(libs[name], name, logits, k, got, scratch)
            _route_call(libs[name], name, logits, k, again, scratch)
            torch.cuda.synchronize()
            ok = (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
                  and float((got[1] - want[1]).abs().max()) <= 1e-5
                  and all(torch.equal(a, b) for a, b in zip(got, again)))
            if not ok:
                raise AssertionError(f"{name} at {tuple(logits.shape)} k={k}: "
                                     "differs from the twin or between runs")
    G, gs, E, k = chip_smoke.MOE_SERVING
    logits = chip_smoke._route_logits(rng, G, gs, E)
    print(f"route: every variant equals the twin at "
          f"{len(chip_smoke.MOE_ROUTE_CASES)} shapes and an underflowing "
          f"row; timed at G={G} gs={gs} E={E} k={k}", flush=True)
    for rnd in range(2):
        for name in names:
            scratch = _route_scratch(libs[name], G, gs, E, k)
            outs = [torch.empty((G, gs, k), dtype=dt, device="cuda")
                    for dt in (torch.int32, torch.float32, torch.int32)]
            ms = chip_smoke.graph_ms(
                lambda: _route_call(libs[name], name, logits, k, outs,
                                    scratch), 50)
            times.setdefault(name, []).append(ms)
            print(f"round {rnd} {name}: {ms:.5f} ms/call", flush=True)
    for name in (n for n, (_, k) in table.items() if k == "route_prof"):
        lib = libs[name]
        scratch = _route_scratch(lib, G, gs, E, k)
        outs = [torch.empty((G, gs, k), dtype=dt, device="cuda")
                for dt in (torch.int32, torch.float32, torch.int32)]
        read = lib.prof_read
        read.restype = ctypes.c_int
        read.argtypes = [ctypes.c_void_p]
        spans, phases = [], []
        for _ in range(20):
            _route_call(lib, name, logits, k, outs, scratch)
            torch.cuda.synchronize()
            st = np.zeros(ROUTE_PROF_CTAS * 8, dtype=np.uint64)
            if read(st.ctypes.data) != 0:
                raise RuntimeError(f"{name}: prof_read failed")
            st = st.reshape(ROUTE_PROF_CTAS, 8).astype(np.int64)
            used = st[:, 6] > 0
            st = st[used]
            spans.append(float(st[:, 6].max() - st[:, 0].min()))
            phases.append(np.diff(st[:, :7], axis=1))
        ph = np.concatenate(phases)
        names_ = ("tile", "token phase", "publish counts", "ranking",
                  "look-back", "slots")
        mem = lib.memset_only
        mem.restype = ctypes.c_int
        mem.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        emp = lib.empty_only
        emp.restype = ctypes.c_int
        emp.argtypes = [ctypes.c_void_p]
        stream = torch.cuda.current_stream
        flags_bytes = 4 * (1 + G * plan_tiles(lib, gs, E, k))
        mem_ms = chip_smoke.graph_ms(lambda: mem(
            scratch.data_ptr(), flags_bytes, stream().cuda_stream), 50)
        emp_ms = chip_smoke.graph_ms(lambda: emp(stream().cuda_stream), 50)
        print(f"{name}: from CUDA graphs, the flags' memset alone "
              f"{mem_ms * 1e3:.3f} us, an empty kernel alone "
              f"{emp_ms * 1e3:.3f} us", flush=True)
        print(f"{name}: {int(ph.shape[0] / 20)} CTAs; kernel span (first "
              f"entry to last exit) median {np.median(spans) / 1e3:.3f} us; "
              "per CTA, mean / max ns: " + ", ".join(
                  f"{n_} {ph[:, i].mean():.0f} / {ph[:, i].max():.0f}"
                  for i, n_ in enumerate(names_)), flush=True)


def sim_main(table, libs, times):
    """Time the simulator kernels' variants at a main-path interval."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels import placement
    from repro_torch.kernels.edge_substep import OUT_NAMES, edge_substep_cuda
    from repro_torch.kernels.ref import edge_substep_ref
    kinds = {kind: [n for n, (_, k) in table.items() if k == kind]
             for kind in ("sim_edge", "sim_prof", "sim_repair")}
    if not any(kinds.values()):
        return
    _, repair, args, kw = chip_smoke.main_path_interval()
    G, K, F = args[8].shape
    print(f"sim: main-path interval G={G} K={K} F={F} "
          f"n={args[20].shape[0]} substeps={kw['substeps']}, "
          f"{int(repair[1].max())} repair slots in the longest cell",
          flush=True)
    want = edge_substep_ref(*args, **kw)
    outs = [torch.empty_like(w) for w in want]
    for name in kinds["sim_edge"]:
        fn = _edge_launcher(libs[name])
        _edge_call(fn, name, args, outs, kw)
        again = [torch.empty_like(w) for w in want]
        _edge_call(fn, name, args, again, kw)
        torch.cuda.synchronize()
        chip_smoke.compare(outs, want, OUT_NAMES, name)
        if not chip_smoke.bitwise_equal(outs, again):
            raise AssertionError(f"{name}: two runs differ")
    rwant = placement.repair_scan_ref(*repair)
    for name in kinds["sim_repair"]:
        w2, pl = repair[9].clone(), repair[10].clone()
        _repair_call(libs[name], name, repair, w2, pl)
        torch.cuda.synchronize()
        if not (torch.equal(w2, rwant[0]) and torch.equal(pl, rwant[1])):
            raise AssertionError(f"{name}: differs from the twin")
    for rnd in range(2):
        for name in kinds["sim_edge"]:
            fn = _edge_launcher(libs[name])
            ms = chip_smoke.graph_ms(
                lambda: _edge_call(fn, name, args, outs, kw), 20)
            times.setdefault(name, []).append(ms)
            print(f"round {rnd} {name}: {ms:.5f} ms/call, "
                  f"{ms * 1e3 / kw['substeps']:.3f} us/substep, equal to "
                  f"the twin", flush=True)
        for name in kinds["sim_repair"]:
            w2, pl = repair[9].clone(), repair[10].clone()
            ms = chip_smoke.graph_ms(
                lambda: _repair_call(libs[name], name, repair, w2, pl), 20)
            times.setdefault(name, []).append(ms)
            print(f"round {rnd} {name}: {ms:.5f} ms/call, "
                  f"{ms * 1e6 / int(repair[1].max()):.1f} ns per slot of "
                  f"the longest walk, equal to the twin", flush=True)
    if kinds["sim_edge"]:
        per = {}
        for steps in (0, 1, kw["substeps"]):
            kws = dict(kw, substeps=steps)
            per[steps] = chip_smoke.graph_ms(
                lambda: edge_substep_cuda(*args, **kws), 20)
        one = (per[kw["substeps"]] - per[1]) / (kw["substeps"] - 1)
        print(f"committed edge_substep: {per[0]:.5f} ms at 0 substeps, "
              f"{per[1]:.5f} at 1, {per[kw['substeps']]:.5f} at "
              f"{kw['substeps']}: {one * 1e3:.3f} us per further substep",
              flush=True)
    for name in kinds["sim_prof"]:
        fn = _edge_launcher(libs[name])
        _edge_call(fn, name, args, outs, kw)
        torch.cuda.synchronize()
        chip_smoke.compare(outs, want, OUT_NAMES, name)
        read = libs[name].prof_read
        read.restype = ctypes.c_int
        read.argtypes = [ctypes.c_void_p]
        stamps = np.zeros(16 * (PROF_STEPS + 1) * 8, dtype=np.int64)
        if read(stamps.ctypes.data) != 0:
            raise RuntimeError(f"{name}: prof_read failed")
        stamps = stamps.reshape(16, PROF_STEPS + 1, 8)
        c = int(re.search(r"constexpr int CLUSTER = (\d+);",
                          table[name][0]).group(1))
        steps = min(kw["substeps"], PROF_STEPS)
        for rank in sorted({0, c - 1}):
            st = stamps[rank]
            body = st[1:steps + 1]
            ph = [float(np.mean(body[:, j + 1] - body[:, j]))
                  for j in range(4)]
            print(f"{name} cell 0 rank {rank}: set-up "
                  f"{st[0, 6] - st[0, 5]} cycles; per substep (mean of "
                  f"{steps}) census {ph[0]:.0f}, CTA partials + cluster "
                  f"barrier {ph[1]:.0f}, cluster totals + CTA barrier "
                  f"{ph[2]:.0f}, burn-down + CTA barrier {ph[3]:.0f} cycles; loop "
                  f"{st[0, 7] - st[0, 6]} cycles to the end", flush=True)


# ------------------------------ flash hd 112 / 192; the redesigned backwards

#: kimi-k2-1t-a32b's (hd=112) and nemotron-4-340b's (hd=192) serving
#: heads, bfloat16, b=4, s=1024, causal: (b, s, h, kvh)
WIDE_SERVING = {112: (4, 1024, 64, 8), 192: (4, 1024, 96, 8)}
#: their bfloat16 tiles: forward (step, warps, keys per K/V tile, stages)
#: and backward (QWARPS, QN, KWARPS, BN, BM) per head dim, the committed
#: ones first; library i carries option i of each of the four lists (the
#: head dims' kernels are independent), so the sweep builds 7 libraries
#: for 28 kernel variants
WIDE_FWD = {112: [(1, 4, 32, 2), (1, 4, 128, 2), (1, 8, 64, 2),
                  (1, 8, 128, 2), (1, 4, 64, 3), (1, 4, 64, 2),
                  (1, 8, 128, 3)],
            192: [(2, 8, 64, 3), (2, 4, 64, 2), (2, 8, 32, 2), (2, 4, 32, 2),
                  (2, 8, 64, 2), (2, 4, 128, 2), (1, 4, 64, 2)]}
WIDE_BWD = {112: [(4, 32, 4, 64, 64), (4, 64, 4, 64, 64), (4, 64, 8, 128, 64),
                  (8, 64, 4, 64, 64), (4, 64, 2, 32, 64),
                  (4, 32, 8, 128, 64), (4, 64, 4, 64, 32)],
            192: [(8, 32, 8, 64, 64), (4, 64, 8, 64, 64), (4, 32, 8, 32, 64),
                  (4, 32, 8, 64, 64), (4, 32, 16, 64, 64),
                  (4, 64, 16, 64, 64), (4, 32, 8, 64, 32)]}
#: shapes each wide variant is also held at, forward and backward:
#: (b, sq, sk, h, kvh, causal, window)
WIDE_EDGES = [(1, 150, 150, 8, 1, True, 0), (1, 130, 130, 12, 2, True, 17),
              (1, 90, 40, 4, 2, False, 0), (1, 20, 20, 96, 1, True, 0)]


def _wide_lines(src, hd, fwd, bwd):
    step, warps, bn, stages = fwd
    qw, qn, kw, kbn, bm = bwd
    for struct, body in (
            ("MmaTile", f"WARPS = {warps}, BN = {bn}, STAGES = {stages}, "
                        f"STEP = {step};"),
            ("BwdMma", f"QWARPS = {qw}, QN = {qn}, KWARPS = {kw}, BN = "
                       f"{kbn}, BM = {bm};")):
        src, n = re.subn(rf"(struct {struct}<{hd}> {{\n  static constexpr "
                         rf"int )[^;]*;", rf"\g<1>{body}", src)
        if n != 1:
            raise AssertionError(f"{struct}<{hd}>: {n} definitions")
    return src


def wide_variants(fa):
    """{name: (source, kind)}: flash_attention.cu with option i of each of
    WIDE_FWD's and WIDE_BWD's lists."""
    n = len(WIDE_FWD[112])
    if any(len(v) != n for v in (*WIDE_FWD.values(), *WIDE_BWD.values())):
        raise AssertionError("WIDE_FWD / WIDE_BWD lists differ in length")
    out = {}
    for i in range(n):
        src = fa
        for hd in WIDE_FWD:
            src = _wide_lines(src, hd, WIDE_FWD[hd][i], WIDE_BWD[hd][i])
        out[f"flash_wide_v{i}"] = (src, "flashwide")
    return out


def bwd_variants(csrc):
    """{name: (source, kind)}: rglru_scan.cu's backward with BWD_THREADS
    channels per CTA and U steps per register buffer (both dtypes),
    moe_route.cu's
    with BWD_TOKENS tokens per CTA, and the earlier designs of both
    (``tools/kernel_baselines``)."""
    rg = (csrc / "rglru_scan.cu").read_text()
    mr = (csrc / "moe_route.cu").read_text()
    out = {}
    for threads in (32, 64, 128):
        for u in (4, 8, 16):
            src = _set(rg, "BWD_THREADS", threads)
            out[f"rglru_bwd_t{threads}_u{u}"] = (
                _set(_set(src, "BWD_U_F32", u), "BWD_U_BF16", u), "rglrubwd")
    out["rglru_bwd_thread_walk"] = (_baseline("rglru_bwd_thread_walk.cu"),
                                    "rglrubwd")
    for tokens in (4, 8, 16, 32):
        out[f"route_bwd_tok{tokens}"] = (_set(mr, "BWD_TOKENS", tokens),
                                         "routebwd")
    out["route_bwd_thread"] = (_baseline("moe_route_bwd_thread.cu"),
                               "routebwd")
    return out


def _entry(lib, symbol, pointers, ints):
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints \
        + [ctypes.c_void_p]
    return fn


def _wide_fwd(lib, q, k, v, o, lse, causal, window):
    import torch
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rc = _entry(lib, "flash_attention_lse_launch", 7, 9)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), None, None, b, sq, sk, h,
        kvh, hd, int(causal), window, 1,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash forward: CUDA error {rc}")


def _wide_bwd(lib, q, k, v, o, lse, do, dsum, grads, causal, window):
    import torch
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rc = _entry(lib, "flash_attention_bwd_launch", 12, 9)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
        *[g.data_ptr() for g in grads], None, None, b, sq, sk, h, kvh, hd,
        int(causal), window, 1, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash backward: CUDA error {rc}")


def wide_main(table, libs, times):
    """Hold each wide variant's hd 112 and 192 bf16 kernels against the
    twins (forward at 2e-2, backward at 2e-2 of each output's scale, both
    bitwise repeatable) at WIDE_EDGES and the serving shape, and time the
    forward and the backward at WIDE_SERVING from CUDA graphs, in turns."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels.ref import attention_bwd_ref, attention_ref
    names = [n for n, (_, k) in table.items() if k == "flashwide"]
    if not names:
        return
    rng = np.random.RandomState(0)

    def inputs(b, sq, sk, h, kvh, hd):
        return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
                .to("cuda", torch.bfloat16)
                for shape in ((b, sq, h, hd), (b, sk, kvh, hd),
                              (b, sk, kvh, hd), (b, sq, h, hd))]

    def run(lib, q, k, v, do, causal, window):
        b, sq, h, _ = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
        dsum = torch.empty_like(lse)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        _wide_fwd(lib, q, k, v, o, lse, causal, window)
        _wide_bwd(lib, q, k, v, o, lse, do, dsum, grads, causal, window)
        return o, lse, grads

    serving = {}
    for hd, (b, s, h, kvh) in WIDE_SERVING.items():
        shapes = [(bb, sq, sk, hh, kk, c, w)
                  for bb, sq, sk, hh, kk, c, w in WIDE_EDGES] + [
            (b, s, s, h, kvh, True, 0)]
        for shape in shapes:
            q, k, v, do = inputs(*shape[:5], hd)
            causal, window = shape[5:]
            want_o, want_lse = attention_ref(q, k, v, causal=causal,
                                             window=window, return_lse=True)
            want = attention_bwd_ref(q, k, v, want_o, want_lse, do,
                                     causal=causal, window=window)
            for name in names:
                o, _, grads = run(libs[name], q, k, v, do, causal, window)
                o2, _, again = run(libs[name], q, k, v, do, causal, window)
                torch.cuda.synchronize()
                where = f"{name} hd={hd} at {shape}"
                err = float((o.float() - want_o.float()).abs().max())
                if not err <= 2e-2 or not torch.equal(o, o2):
                    raise AssertionError(f"{where}: forward max abs err "
                                         f"{err:.3e} or not repeatable")
                for g, w in zip(grads, want):
                    chip_smoke._scaled_err(g, w, f"{where} backward", 2e-2)
                if not all(torch.equal(a, c) for a, c in zip(grads, again)):
                    raise AssertionError(f"{where}: backward not "
                                         f"repeatable")
        serving[hd] = (q, k, v, do)
    print(f"flash wide: every variant's hd 112 and 192 kernels match the "
          f"twins at {len(WIDE_EDGES)} edge shapes and the serving shapes "
          f"{WIDE_SERVING}, bitwise repeatable", flush=True)
    for rnd in range(2):
        for hd, (q, k, v, do) in serving.items():
            b, s, h, _ = q.shape
            pairs = s * (s + 1) / 2
            for name in names if rnd == 0 else names[::-1]:
                i = int(name.rsplit("v", 1)[1])
                lib = libs[name]
                o = torch.empty_like(q)
                lse = torch.empty((b, h, s), dtype=torch.float32,
                                  device="cuda")
                dsum = torch.empty_like(lse)
                grads = [torch.empty_like(t) for t in (q, k, v)]
                fwd = chip_smoke.graph_ms(lambda: _wide_fwd(
                    lib, q, k, v, o, None, True, 0), 20)
                _wide_fwd(lib, q, k, v, o, lse, True, 0)
                bwd = chip_smoke.graph_ms(lambda: _wide_bwd(
                    lib, q, k, v, o, lse, do, dsum, grads, True, 0), 5)
                for key, ms, n_prod in (
                        (f"fwd hd{hd} {WIDE_FWD[hd][i]}", fwd, 4.0),
                        (f"bwd hd{hd} {WIDE_BWD[hd][i]}", bwd, 10.0)):
                    times.setdefault(key, []).append(ms)
                    tflops = n_prod * b * h * hd * pairs / (ms * 1e-3) / 1e12
                    print(f"round {rnd} {name} {key}: {ms:.4f} ms/call, "
                          f"{tflops:.1f} TFLOP/s", flush=True)


def rglru_bwd_main(table, libs, times):
    """The rglru_scan backward variants and the earlier design: bitwise
    the twin's at TRAIN_RGLRU and a ragged s, in float32 and bfloat16;
    timed from CUDA graphs at TRAIN_RGLRU, in turns."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref
    names = [n for n, (_, k) in table.items() if k == "rglrubwd"]
    if not names:
        return
    gen = torch.Generator(device="cuda").manual_seed(4)
    timed = {}
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for shape in (chip_smoke.RGLRU_BWD_RAGGED, chip_smoke.TRAIN_RGLRU):
            a = (0.8 + 0.2 * torch.rand(shape, generator=gen,
                                        device="cuda")).to(dtype)
            bx = (0.1 * torch.randn(shape, generator=gen,
                                    device="cuda")).to(dtype)
            h = rglru_scan_ref(a, bx)
            gh = torch.randn(shape, generator=gen, device="cuda")
            want = rglru_scan_bwd_ref(a, h, gh)
            outs = [torch.empty_like(a), torch.empty_like(a)]

            def call(name, a=a, h=h, gh=gh, outs=outs, code=code):
                rc = _entry(libs[name], "rglru_scan_bwd_launch", 5, 4)(
                    a.data_ptr(), h.data_ptr(), gh.data_ptr(),
                    outs[0].data_ptr(), outs[1].data_ptr(), *a.shape, code,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            for name in names:
                call(name)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(outs, want)):
                    raise AssertionError(f"{name} {shape} {dtype}: not "
                                         f"bitwise the twin's")
            timed[dtype] = (call, 20 * a.numel())
    print(f"rglru bwd: every variant equals the twin bitwise at "
          f"{chip_smoke.RGLRU_BWD_RAGGED} and {chip_smoke.TRAIN_RGLRU}",
          flush=True)
    for rnd in range(2):
        for dtype, (call, nbytes) in timed.items():
            for name in names if rnd == 0 else names[::-1]:
                ms = chip_smoke.graph_ms(lambda: call(name), 10)
                key = f"{name} {str(dtype).split('.')[1]}"
                times.setdefault(key, []).append(ms)
                print(f"round {rnd} {key}: {ms:.5f} ms/call, "
                      f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s of the "
                      f"float32 bound's bytes", flush=True)


def route_bwd_main(table, libs, times):
    """The gate backward variants and the earlier design against the twin
    (1e-4 of the scale; the new ones bitwise repeatable) at the routing
    test shapes and kimi-k2's / the widest routing; timed from CUDA graphs
    at TRAIN_ROUTE and kimi-k2's (1, 4096, 384, 8), in turns."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels.moe_route import moe_route_cuda
    from repro_torch.kernels.ref import moe_route_bwd_ref
    names = [n for n, (_, k) in table.items() if k == "routebwd"]
    if not names:
        return
    rng = np.random.RandomState(5)

    def call(name, logits, eid, g_gate, out):
        G, gs, E = logits.shape
        rc = _entry(libs[name], "moe_route_bwd_launch", 4, 4)(
            logits.data_ptr(), eid.data_ptr(), g_gate.data_ptr(),
            out.data_ptr(), G, gs, E, eid.shape[-1],
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    cases = {}
    for G, gs, E, k in chip_smoke.MOE_ROUTE_CASES + \
            chip_smoke.ROUTE_BWD_WIDE + [chip_smoke.TRAIN_ROUTE,
                                         (1, 4096, 384, 8)]:
        logits = chip_smoke._route_logits(rng, G, gs, E)
        eid = moe_route_cuda(logits, k)[0]
        g_gate = torch.from_numpy(rng.randn(G, gs, k)).float().cuda()
        want = moe_route_bwd_ref(logits, eid, g_gate)
        for name in names:
            out, again = torch.empty_like(want), torch.empty_like(want)
            call(name, logits, eid, g_gate, out)
            call(name, logits, eid, g_gate, again)
            torch.cuda.synchronize()
            chip_smoke._scaled_err(out, want, f"{name} {(G, gs, E, k)}",
                                   1e-4)
            if not torch.equal(out, again):
                raise AssertionError(f"{name} {(G, gs, E, k)}: two runs "
                                     f"differ")
        cases[(G, gs, E, k)] = (logits, eid, g_gate, want)
    print(f"route bwd: every variant matches the twin at {len(cases)} "
          f"shapes, bitwise repeatable", flush=True)
    for rnd in range(2):
        for shape in (chip_smoke.TRAIN_ROUTE, (1, 4096, 384, 8)):
            logits, eid, g_gate, want = cases[shape]
            out = torch.empty_like(want)
            for name in names if rnd == 0 else names[::-1]:
                ms = chip_smoke.graph_ms(
                    lambda: call(name, logits, eid, g_gate, out), 50)
                key = f"{name} {shape}"
                times.setdefault(key, []).append(ms)
                print(f"round {rnd} {key}: {ms:.5f} ms/call", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    only = sys.argv[1] if len(sys.argv) > 1 else None
    only = None if only == "all" else only
    if only not in (None, "flash", "rglru", "sim", "bestfit", "route"):
        print(f"kernel_variants: unknown kernel {only!r}", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import BUILD_DIR, CSRC
    from repro_torch.kernels.ref import attention_ref, rglru_scan_ref
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    names = sys.argv[2:]
    table = {n: sk for n, sk in variants(CSRC).items()
             if (only is None or sk[1].startswith(only))
             and (not names or any(part in n for part in names))}
    libs = build({n: src for n, (src, _) in table.items()},
                 str(BUILD_DIR / "variants"))
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    sim_main(table, libs, times)
    bestfit_main(table, libs, times)
    route_main(table, libs, times)
    route_bwd_main(table, libs, times)
    rglru_bwd_main(table, libs, times)
    wide_main(table, libs, times)

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (4, 1024, 4096)
    rglru = [n for n, (_, k) in table.items() if k == "rglru"]
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        if not rglru:
            break
        a = (0.8 + 0.2 * torch.rand(shape, generator=gen, device="cuda")
             ).to(dtype)
        bx = (0.1 * torch.randn(shape, generator=gen, device="cuda")
              ).to(dtype)
        want = rglru_scan_ref(a, bx)
        h = torch.empty(shape, device="cuda")
        for rnd in range(2):
            for name in rglru:
                fn = libs[name].rglru_scan_launch
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
                    + [ctypes.c_void_p]

                def call():
                    rc = fn(a.data_ptr(), bx.data_ptr(), h.data_ptr(),
                            *shape, code, stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                ms = cuda_ms(call, 50)
                if not torch.equal(h, want):
                    raise AssertionError(f"{name} {dtype}: differs from "
                                         f"the twin")
                key = f"{name} {str(dtype).split('.')[1]}"
                times.setdefault(key, []).append(ms)
                nbytes = 2 * a.numel() * a.element_size() + h.numel() * 4
                print(f"round {rnd} {key}: {ms:.5f} ms/call, "
                      f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, equal to "
                      f"the twin", flush=True)

    rng = np.random.RandomState(0)

    def inputs(b, sq, sk, h_, kvh, hd):
        return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
                .to("cuda", torch.bfloat16)
                for shape in ((b, sq, h_, hd), (b, sk, kvh, hd),
                              (b, sk, kvh, hd))]

    for hd, (b, s, h_, kvh, window) in FLASH_SERVING.items():
        names = [n for n, (_, kind) in table.items()
                 if kind == f"flash{hd}"]
        for name in names:
            fn = _flash_launcher(libs[name])
            for bb, sq, sk, hh, kk, causal, w in FLASH_EDGES:
                q, k, v = inputs(bb, sq, sk, hh, kk, hd)
                o, again = torch.empty_like(q), torch.empty_like(q)
                _flash_call(fn, name, q, k, v, o, causal, w, stream)
                _flash_call(fn, name, q, k, v, again, causal, w, stream)
                want = attention_ref(q, k, v, causal=causal, window=w)
                err = float((o.float() - want.float()).abs().max())
                if not err <= 2e-2 or not torch.equal(o, again):
                    raise AssertionError(
                        f"{name} at {(bb, sq, sk, hh, kk, causal, w)}: max "
                        f"abs err {err:.3e}, repeatable "
                        f"{torch.equal(o, again)}")
        q, k, v = inputs(b, s, s, h_, kvh, hd)
        want = attention_ref(q, k, v, window=window).float()
        o = torch.empty_like(q)
        pairs = s * (s + 1) / 2 if not window or window >= s else \
            window * (window + 1) / 2 + (s - window) * window
        for rnd in range(2):
            for name in names:
                fn = _flash_launcher(libs[name])
                ms = cuda_ms(lambda: _flash_call(fn, name, q, k, v, o, True,
                                                 window, stream), 20)
                err = float((o.float() - want).abs().max())
                if not err <= 2e-2:
                    raise AssertionError(f"{name}: max abs err {err:.3e}")
                times.setdefault(name, []).append(ms)
                tflops = 4.0 * b * h_ * hd * pairs / (ms * 1e-3) / 1e12
                print(f"round {rnd} {name}: {ms:.4f} ms/call, "
                      f"{tflops:.1f} TFLOP/s, max abs err {err:.3e}",
                      flush=True)
    print(f"card: {card}")
    print(json.dumps({"median_ms": {n: float(np.median(t))
                                    for n, t in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
