"""One run of one cell: set-up, the measured window, the check, the result.

Set-up makes the weights, the traffic's patch embeddings and the engine
from ``--seed``, runs the engine's own warm-up and then the mix's warm-up
requests through ``serve`` (so that the MAB, DASO's ascent and its
training have all run once), and makes the check's buffers.  The window is
one client, closed loop: it sends request i + 1 when ``serve`` has returned
request i, from the first timed request until the first one that returns
after ``--seconds``; all of them count, and the window ends when the device
has finished their work.  With ``--trace 1`` the taps time the plan and the
monolithic forward of every request, ``torch.profiler`` records the device
over the mix's trace requests right after the window, and the per-layer
readers (``perfbench/metrics``) read the run.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import torch
from repro_torch.serving.engine import Request

from perfbench.harness import check as chk
from perfbench.harness.flops import request_flops
from perfbench.harness.program import RouteTap, Tap, make_engine
from perfbench.harness.spec import BENCH
from perfbench.harness.trace import digest
from perfbench.harness.traffic import Traffic
from perfbench.harness.weights import make_weights

FENCED = ("jax", "jaxlib", "flax", "repro")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Run:
    """What the readers of per-layer metrics read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def fenced_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FENCED))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None,
             fault=None, control=False):
    """Set-up, window and check of ``cell``; returns (result dict, Run)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, mix = cell.config, cell.traffic
    b, s, branches = mix["batch"], mix["seq"], mix["branches"]
    stamps = [("start", time.perf_counter())]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    weights = make_weights(cfg, gen, device)
    traffic = Traffic(mix, cfg, seed, gen, device)
    _sync(device)
    stamps.append(("weights and inputs", time.perf_counter()))
    engine = make_engine(weights, cfg, mix, seed, device)
    moe = bool(cfg.get("num_experts"))
    tap = Tap(engine, timed=bool(trace), fault=fault,
              routes=RouteTap() if moe else None)
    tokens, extras, _ = traffic.request(0)
    engine.warmup(tokens, extras)
    stamps.append(("engine and its warm-up", time.perf_counter()))
    warm = mix["warmup_requests"]
    warmed = []
    for i in range(warm):
        tokens, extras, deadline = traffic.request(i)
        warmed.append(engine.serve(Request(tokens, deadline, extras=extras)))
        tap.take()
    cuda = device.type == "cuda"
    peak_before = torch.cuda.max_memory_allocated(device) if cuda else 0
    sample = chk.Sample(mix["check_sample"], seed,
                        (b, s, cfg["vocab_size"]), device,
                        _route_shape(cfg, b, s, branches) if moe else None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    stamps.append((f"{warm} warm-up requests", time.perf_counter()))
    log("set-up: warm-up requests (plan, modelled ms): " + ", ".join(
        f"{r.plan}:{r.latency_s * 1e3:.1f}" for r in warmed))
    log("set-up s: before the harness "
        f"{stamps[0][1] - t_start:.3f}; " + "; ".join(
            f"{name} {t - stamps[k][1]:.3f}"
            for k, (name, t) in enumerate(stamps[1:])))

    records = []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    end = t0 + seconds
    i = warm
    while True:
        rec, outs = _serve(engine, tap, traffic, i)
        records.append(rec)
        if rec["error"] is None:
            sample.offer(i, rec["plan"], outs)
        del outs
        i += 1
        if rec["start"] + rec["latency_s"] >= end:
            break
    _sync(device)
    t_end = time.perf_counter()
    # the check's buffers stay allocated from set-up to here: the peak
    # leaves them out
    peak = max(peak_before, torch.cuda.max_memory_allocated(device)
               - sample.nbytes) if cuda else 0
    traced, prof = [], None
    if trace:
        # the traced sub-window: the mix's trace requests right after the
        # window, with the profiler recording the device only
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[
            act.CUDA if device.type == "cuda" else act.CPU])
        tap.marks = []
        with prof:
            _sync(device)
            anchor = time.perf_counter()
            torch.zeros(1, device=device)
            for j in range(mix["trace_requests"]):
                rec, outs = _serve(engine, tap, traffic, i + j)
                del outs
                traced.append(rec)
                tap.marks.append(("serve", rec["start"],
                                  rec["start"] + rec["latency_s"]))
            _sync(device)
            t_stop = time.perf_counter()
        prof = (prof, anchor, tap.marks, traced[0]["start"], t_stop)
    fenced = fenced_modules()
    tap.close()
    del engine, tap
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ok = [r for r in records if r["error"] is None]
    failed = len(records) - len(ok)
    for r in ok:
        r["flops"] = request_flops(cfg, r["plan"], branches, b, s)
    run = Run(config=cfg, mix=mix, records=records, ok=ok,
              window_s=t_end - t0, setup_s=setup_s, b=b, s=s,
              branches=branches, digest=digest(*prof) if prof else None,
              traced=[r for r in traced if r["error"] is None],
              device=device)
    _describe(run)

    t_check = time.perf_counter()
    kept = sample.kept()
    nums, readings = chk.judge(cfg, weights, traffic, kept, branches, device,
                                control)
    for r in readings:
        log("check request", json.dumps(r))
    compared, within = chk.compare(nums, cell.limits)
    log(f"check of {len(kept)} requests took "
        f"{time.perf_counter() - t_check:.2f} s; numbers {json.dumps(nums)}")
    correct = within and failed == 0 and len(kept) > 0

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = _reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"serve_tokens_per_s": len(ok) * b * s / run.window_s,
                  "serve_p90_ms": float(np.percentile(
                      [r["latency_s"] for r in ok], 90)) * 1e3
                  if ok else float("nan"),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": dev}
    if run.digest is not None:
        dev["busy_s"] = run.digest.busy_s
        dev["window_s"] = run.digest.window_s
        result["breakdown"] = {"device_ops": run.digest.top_ops(),
                               "idle_gaps": run.digest.idle_gaps()}
    if ok:
        result["plans"] = {
            "semantic_share": float(np.mean([r["plan"] for r in ok])),
            "deadline_met_share": float(np.mean([r["met"] for r in ok]))}
    result["compared"] = compared
    run.fenced = fenced
    run.readings = readings
    return result, run


def _serve(engine, tap, traffic, i):
    """Request i through ``serve``: its record and the tap's outputs."""
    tokens, extras, deadline = traffic.request(i)
    req = Request(tokens, deadline, extras=extras)
    ts = time.perf_counter()
    try:
        res, err = engine.serve(req), None
    except Exception as e:              # counted as failed, and not correct
        res, err = None, repr(e)
    te = time.perf_counter()
    outs = tap.take()
    rec = {"index": i, "start": ts, "latency_s": te - ts, "error": err,
           "deadline_s": deadline}
    if res is not None:
        rec.update(plan=res.plan, met=res.met_deadline,
                   modelled_s=res.latency_s, fidelity=res.fidelity,
                   plan_s=tap.plan_s, mono_s=tap.mono_s)
    return rec, outs


def _route_shape(cfg, b, s, branches):
    """(routing calls of the plan at most, of the monolithic forward, G,
    gs, E, k) of an MoE model: one call per MoE layer and forward."""
    t = b * s
    gs = min(cfg["moe_group_size"], t)
    layers = cfg["num_hidden_layers"]
    return (branches * layers, layers, -(-t // gs), gs, cfg["num_experts"],
            cfg["num_experts_per_tok"])


def _reader(name):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _describe(run):
    ok = run.ok
    errors = [r["error"] for r in run.records if r["error"] is not None]
    if errors:
        log(f"window: {len(errors)} requests failed; the first: {errors[0]}")
    if not ok:
        log("window: no request finished")
        return
    lat = np.array([r["latency_s"] for r in ok]) * 1e3
    plans = np.array([r["plan"] for r in ok])
    model = np.array([r["modelled_s"] for r in ok]) * 1e3
    log(f"window: {len(run.records)} requests in {run.window_s:.3f} s, "
        f"set-up {run.setup_s:.3f} s; semantic plan share "
        f"{plans.mean():.4f}; deadline met share "
        f"{np.mean([r['met'] for r in ok]):.4f}; fidelity mean "
        f"{np.mean([r['fidelity'] for r in ok]):.4f}; latency ms median "
        f"{np.median(lat):.3f} p90 {np.percentile(lat, 90):.3f} max "
        f"{lat.max():.3f}")
    for p, name in ((0, "layer"), (1, "semantic")):
        m = model[plans == p]
        if len(m):
            log(f"window: {name} plan x{len(m)}: the engine's modelled "
                f"latency ms p10 {np.percentile(m, 10):.3f} median "
                f"{np.median(m):.3f} p90 {np.percentile(m, 90):.3f}; "
                f"serve() ms median {np.median(lat[plans == p]):.3f}")


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv, t_start):
    import argparse
    from perfbench.harness.spec import Cell
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " visible")
        return 2
    result, run = run_cell(cell, args.seed, args.seconds, args.trace,
                           "cuda", t_start)
    fenced = sorted(set(run.fenced) | set(fenced_modules()))
    if fenced:
        log(f"fenced modules loaded in this process: {fenced}")
        return 3
    log(f"card: {card_line()}; peaks: bf16 989e12 FLOP/s, HBM 3.35e12 B/s")
    for name, c in result["compared"].items():
        log(f"compared {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
