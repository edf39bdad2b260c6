"""Serving driver: SLA-aware SplitPlace plan selection over batched model
requests, the port of ``repro.launch.serve``'s default (plan) mode.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 20 \\
        --batch 4 --seq 1024

serves the full-width model on the card, with random weights from
``--seed``.  ``--arch`` names any registered model whose blocks the port
runs: dense attention (``tinyllama-1.1b``, the default), MoE
(``qwen2-moe-a2.7b``), Mamba (``falcon-mamba-7b``) or the RG-LRU hybrid
with local attention (``recurrentgemma-9b``).  ``--device cpu``
runs the eager path on the model cut to the reference's CPU size
(``reduced(max_d_model=256, max_layers=4)``, as its ``_plan_main``
always serves).  The reference's ``--stream`` mode (the edge-simulator
serving loop) is not ported yet.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models.model import init_params
from repro_torch.serving.engine import Request, SplitPlaceEngine


def serve_requests(params, cfg, *, requests=20, batch=2, seq=64, stages=2,
                   branches=2, device="cuda", log=print):
    """The reference's request loop: warm up, time each plan once, then
    serve ``requests`` requests of one seeded (batch, seq) token block,
    each with a tight (2.5 × semantic latency) or loose (4 × layer
    latency) deadline by a fair coin.  Returns the engine, the two
    measured plan latencies, the deadlines' kinds and the results."""
    eng = SplitPlaceEngine(params, cfg, num_stages=stages,
                           num_branches=branches, device=device)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    eng.warmup(tok)
    tokens = {"tokens": torch.as_tensor(tok, device=eng.device)}
    _, t_layer = eng._run(0, tokens)
    _, t_sem = eng._run(1, tokens)
    log(f"plan latencies: layer-pipeline {t_layer*1e3:.1f}ms, "
        f"semantic-branch {t_sem*1e3:.1f}ms")
    tight, results = [], []
    for i in range(requests):
        tight.append(bool(rng.rand() < 0.5))
        ddl = t_sem * 2.5 if tight[-1] else t_layer * 4.0
        r = eng.serve(Request(tokens=tok, deadline_s=float(ddl)))
        results.append(r)
        log(f"req {i:3d} deadline={'tight' if tight[-1] else 'loose'} -> "
            f"plan={'layer' if r.plan == 0 else 'semantic'} "
            f"lat={r.latency_s*1e3:.1f}ms fid={r.fidelity:.3f} "
            f"met={r.met_deadline} reward={r.reward:.3f}")
    log(f"final MAB Q:\n{eng.state.Q[0].cpu().numpy().round(3)}")
    return {"engine": eng, "t_layer": t_layer, "t_sem": t_sem,
            "tight": tight, "results": results}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--branches", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--device", default="cuda",
                    help="cuda: full width; cpu: the reference's CPU size")
    ap.add_argument("--stream", action="store_true",
                    help="the edge-simulator serving loop (not ported)")
    args = ap.parse_args(argv)
    if args.stream:
        raise NotImplementedError(
            "--stream (the edge-simulator serving loop) is not ported yet "
            "(ROADMAP queue 1 item 9: streaming)")
    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if dev.type == "cpu":
        cfg = cfg.reduced(max_d_model=256, max_layers=4)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    serve_requests(params, cfg, requests=args.requests, batch=args.batch,
                   seq=args.seq, stages=args.stages, branches=args.branches,
                   device=dev)


if __name__ == "__main__":
    main()
