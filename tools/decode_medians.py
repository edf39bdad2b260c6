"""Decode-step and serving-forward times of the four served families at
full width on one CUDA card, for comparing two trees of the port in one
call (say a parent commit unpacked beside the working tree).

For each architecture: seeded random weights (bf16), a prefill of
``--batch`` x ``--seq`` tokens, ``--steps`` one-token decode steps (each
timed on the host clock around a synchronized call), then ``--forwards``
full-sequence forwards of the same batch (the serving path's model call),
each timed the same way.  Prints one JSON object: per architecture the
decode and forward milliseconds, their medians, and the card's name and
power limit.  With ``--op-overhead`` it also times, in one process, the
host time per call of each kernel through its dispatcher (the
``repro_torch::`` operator, where the tree has one) against its launch
function called directly, at a small shape, ``--calls`` calls each in
turns (dispatcher, launch, launch, dispatcher).

    PYTHONPATH=src python tools/decode_medians.py [--src DIR] [--archs ...]

``--src`` puts another tree's ``src`` first on the import path.  Run the
two trees in turns (a, b, b, a) in one call: host-bound steps vary
between calls.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
         "recurrentgemma-9b")


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def run_arch(arch, batch, seq, steps, forwards):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import forward, init_params
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    tokens = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32), device="cuda")
    prefill = make_prefill_step(cfg, max_ctx=seq + steps + 1)
    serve = make_serve_step(cfg)
    dec, fwd = [], []
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": tokens})
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = serve(params, tok, cache, seq + i)
            torch.cuda.synchronize()
            dec.append((time.perf_counter() - t0) * 1e3)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
        del cache
        for _ in range(forwards):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(params, {"tokens": tokens}, cfg)
            torch.cuda.synchronize()
            fwd.append((time.perf_counter() - t0) * 1e3)
    del params
    torch.cuda.empty_cache()
    # the first decode step loads the kernel libraries and warms the
    # allocator: left out of the median
    return {"decode_ms": dec, "decode_median_ms": _median(dec[1:]),
            "forward_ms": fwd, "forward_median_ms": _median(fwd[1:])}


def op_overhead(calls):
    """Host µs per call: each kernel's dispatcher against its launch
    function, on small CUDA tensors, no gradient."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_route as mr
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import selective_scan as ss
    dev = "cuda"
    q = torch.randn(1, 1, 8, 64, device=dev, dtype=torch.bfloat16)
    kv = torch.randn(1, 64, 2, 64, device=dev, dtype=torch.bfloat16)
    a = torch.rand(1, 8, 64, device=dev)
    dA = torch.rand(1, 8, 64, 16, device=dev)
    C = torch.rand(1, 8, 16, device=dev)
    lg = torch.randn(1, 4, 60, device=dev)
    pairs = {
        "flash_attention": (lambda: fa.flash_attention(q, kv, kv),
                            lambda: fa.flash_attention_cuda(q, kv, kv)),
        "selective_scan": (lambda: ss.selective_scan(dA, dA, C),
                           lambda: ss.selective_scan_cuda(dA, dA, C)),
        "rglru_scan": (lambda: rs.rglru_scan(a, a),
                       lambda: rs.rglru_scan_cuda(a, a)),
        "moe_route": (lambda: mr.moe_route(lg, 4),
                      lambda: mr.moe_route_cuda(lg, 4)),
    }

    def per_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / calls * 1e6

    out = {}
    with torch.no_grad():
        for name, (disp, launch) in pairs.items():
            per_call(disp), per_call(launch)             # warm
            d1, l1, l2, d2 = (per_call(disp), per_call(launch),
                              per_call(launch), per_call(disp))
            out[name] = {"dispatcher_us": [d1, d2], "launch_us": [l1, l2]}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None)
    ap.add_argument("--archs", nargs="*", default=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=21)
    ap.add_argument("--forwards", type=int, default=6)
    ap.add_argument("--op-overhead", action="store_true")
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("decode_medians: needs a CUDA device")
    from repro_torch.kernels.build import LIBRARIES
    LIBRARIES.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "src": args.src or "src"}
    if args.op_overhead:
        out["op_overhead"] = op_overhead(args.calls)
    for arch in args.archs:
        out[arch] = run_arch(arch, args.batch, args.seq, args.steps,
                             args.forwards)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
