"""Serving drivers, the port of ``repro.launch.serve``.  Two modes share
this entry point:

  * default: SLA-aware SplitPlace plan selection over batched model
    requests,

        PYTHONPATH=src python -m repro_torch.launch.serve --requests 20 \\
            --batch 4 --seq 1024

  * ``--stream``: the always-on edge-simulator serving loop
    (``repro_torch.env.torchsim.stream``): a host feeder thread streams
    Poisson task arrivals into the fixed ring of device slots while the
    interval program runs chunk after chunk, printing rolling QPS,
    p50/p99 response and deadline-violation metrics,

        PYTHONPATH=src python -m repro_torch.launch.serve --stream \\
            --policy mc --tasks 100000 --chunk 64

    (the Table-3 fleet, λ=6, 30 substeps of 300 s intervals, 512 slots;
    ``--device cpu`` runs the same loop on the CPU).

In plan mode the script serves the full-width model on the card, with
random weights from ``--seed``.  ``--arch`` names any registered model:
dense attention (``tinyllama-1.1b``, the default), MoE
(``qwen2-moe-a2.7b``), Mamba (``falcon-mamba-7b``), the RG-LRU hybrid
with local attention (``recurrentgemma-9b``), M-RoPE with visual embeds
(``qwen2-vl-7b``) or cross attention over codebooks
(``musicgen-medium``), the last two with ``request_extras``' seeded
inputs (a 16 × 16 patch block; at the CPU size one of 2 × 2).  ``--device cpu``
runs the eager path on the model cut to the reference's CPU size
(``reduced(max_d_model=256, max_layers=4)``, as its ``_plan_main``
always serves).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models.model import init_params
from repro_torch.serving.engine import Request, SplitPlaceEngine


def request_extras(cfg, batch, seq, seed=0, grid=16):
    """Seeded inputs beside the tokens that make a family's extra paths
    compute something (NumPy arrays; ``{}`` for the other families):

    * cross attention (musicgen): ``cond`` (batch, cond_len, d), standard
      normal.  Zeros, the model's default, make the cross attention
      exactly 0, since its projections have no bias.
    * a visual front end (qwen2-vl): ``visual_embeds`` (batch, seq, d),
      normal × d^-½ like the token embeddings, under a ``visual_mask``
      over a block of grid × grid positions starting at seq / 8, and
      ``positions3`` (batch, 3, seq), Qwen2-VL's M-RoPE ids: text before
      the block at (i, i, i); the block's patch (r, c) at (st, st + r,
      st + c), st its first position; text after it continuing from the
      block's largest id + 1.  Equal streams would make M-RoPE plain
      rope."""
    rng = np.random.RandomState(seed)
    d = cfg.d_model
    out = {}
    if cfg.cross_attention:
        out["cond"] = rng.randn(batch, cfg.cond_len, d).astype(np.float32)
    if cfg.visual_frontend:
        n = grid * grid
        st = seq // 8
        if st + n > seq:
            raise ValueError(f"a {grid} x {grid} patch block does not fit "
                             f"{seq} positions from {st}")
        mask = np.zeros((batch, seq), bool)
        mask[:, st:st + n] = True
        out["visual_embeds"] = (rng.randn(batch, seq, d) * d ** -0.5
                                ).astype(np.float32)
        out["visual_mask"] = mask
        p3 = np.broadcast_to(np.arange(seq), (3, seq)).copy()
        r, c = np.divmod(np.arange(n), grid)
        p3[:, st:st + n] = [np.full(n, st), st + r, st + c]
        p3[:, st + n:] = st + grid + np.arange(seq - st - n)
        out["positions3"] = np.broadcast_to(p3, (batch, 3, seq)).astype(
            np.int32)
    return out


def serve_requests(params, cfg, *, requests=20, batch=2, seq=64, stages=2,
                   branches=2, device="cuda", log=print, extras=None):
    """The reference's request loop: warm up, time each plan once, then
    serve ``requests`` requests of one seeded (batch, seq) token block
    ((batch, seq, cb) under codebooks) and the batch entries ``extras``
    (``request_extras``), each with a tight (2.5 × semantic latency) or
    loose (4 × layer latency) deadline by a fair coin.  Returns the
    engine, the two measured plan latencies, the deadlines' kinds and
    the results."""
    eng = SplitPlaceEngine(params, cfg, num_stages=stages,
                           num_branches=branches, device=device)
    rng = np.random.RandomState(0)
    shape = (batch, seq) + ((cfg.num_codebooks,) if cfg.num_codebooks
                            else ())
    tok = rng.randint(0, cfg.vocab_size, shape).astype(np.int32)
    eng.warmup(tok, extras)
    tokens = eng.batch(tok, extras)
    _, t_layer = eng._run(0, tokens)
    _, t_sem = eng._run(1, tokens)
    log(f"plan latencies: layer-pipeline {t_layer*1e3:.1f}ms, "
        f"semantic-branch {t_sem*1e3:.1f}ms")
    tight, results = [], []
    for i in range(requests):
        tight.append(bool(rng.rand() < 0.5))
        ddl = t_sem * 2.5 if tight[-1] else t_layer * 4.0
        r = eng.serve(Request(tokens=tok, deadline_s=float(ddl),
                              extras=extras))
        results.append(r)
        log(f"req {i:3d} deadline={'tight' if tight[-1] else 'loose'} -> "
            f"plan={'layer' if r.plan == 0 else 'semantic'} "
            f"lat={r.latency_s*1e3:.1f}ms fid={r.fidelity:.3f} "
            f"met={r.met_deadline} reward={r.reward:.3f}")
    log(f"final MAB Q:\n{eng.state.Q[0].cpu().numpy().round(3)}")
    return {"engine": eng, "t_layer": t_layer, "t_sem": t_sem,
            "tight": tight, "results": results}


def _stream_main(args):
    """``--stream``: ``experiments.run_stream`` with progress lines every
    ``--report-every`` chunks and the reference's closing lines."""
    from repro_torch.launch import experiments

    dev = resolve(args.device)
    pretrain_state = None
    if args.pretrain > 0:
        print(f"pretraining ({args.pretrain} intervals)...")
        wants = ("splitplace",) if args.policy != "gillis" else ("gillis",)
        pretrain_state = experiments.pretrain(args.pretrain, lam=args.lam,
                                              policies=wants, device=dev)

    def progress(i, runner, rolling):
        if i % args.report_every:
            return
        s = rolling.snapshot()
        print(f"chunk {i:5d}  intervals={runner.t0:7d}  "
              f"qps={s['qps']:.4f}/s  "
              f"p50={s.get('p50_response_s', 0):.0f}s "
              f"p99={s.get('p99_response_s', 0):.0f}s  "
              f"viol={s['violation_rate']:.3f}  "
              f"occ={s['occupancy_mean']:.1f}", flush=True)

    rep = experiments.run_stream(
        policy=args.policy, lam=args.lam, seed=args.seed,
        target_tasks=args.tasks, chunk_intervals=args.chunk,
        max_active=args.capacity, interval_s=args.interval,
        substeps=args.substeps, window_intervals=args.window,
        pretrain_state=pretrain_state, on_chunk=progress, device=dev)
    s = rep["summary"]
    print(f"\nserved {rep['finished']} tasks over {rep['n_intervals']} "
          f"intervals ({rep['n_chunks']} chunks of {args.chunk}); "
          f"{rep['live']} still live")
    print(f"admission: offered={rep['offered']} "
          f"feeder_overflow={rep['feeder_overflow']} "
          f"ring_dropped={rep['dropped']}")
    print(f"occupancy: max={rep['max_occupancy']:.0f}/{args.capacity}, "
          f"halves {rep['occupancy_mean_first_half']:.1f} / "
          f"{rep['occupancy_mean_second_half']:.1f}")
    print(f"summary: reward={s['reward']:.3f} "
          f"sla_violations={s['sla_violations']:.3f} "
          f"accuracy={s['accuracy']:.3f} "
          f"energy_mwhr={s['energy_mwhr']:.3f}")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--branches", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights; stream mode: of the "
                         "workload")
    ap.add_argument("--device", default="cuda",
                    help="cuda: full width; cpu: the reference's CPU size "
                         "(stream mode: the same loop on the CPU)")
    ap.add_argument("--stream", action="store_true",
                    help="run the always-on edge-simulator serving loop "
                         "instead of model-plan selection")
    ap.add_argument("--policy", default="mc",
                    help="stream mode: policy name (static BestFit or "
                         "mab/splitplace/mab+gobi/gillis)")
    ap.add_argument("--lam", type=float, default=6.0)
    ap.add_argument("--tasks", type=int, default=10_000,
                    help="stream mode: stop after offering this many")
    ap.add_argument("--chunk", type=int, default=64,
                    help="stream mode: intervals per chunk")
    ap.add_argument("--capacity", type=int, default=512,
                    help="stream mode: device ring slot capacity")
    ap.add_argument("--interval", type=float, default=300.0)
    ap.add_argument("--substeps", type=int, default=30)
    ap.add_argument("--window", type=int, default=256,
                    help="stream mode: rolling-metrics window intervals")
    ap.add_argument("--report-every", type=int, default=10,
                    help="stream mode: print rolling metrics every N "
                         "chunks")
    ap.add_argument("--pretrain", type=int, default=0,
                    help="stream mode: §6.3 pretraining intervals for "
                         "learned policies (0 = cold start)")
    args = ap.parse_args(argv)
    if args.stream:
        return _stream_main(args)
    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if dev.type == "cpu":
        cfg = cfg.reduced(max_d_model=256, max_layers=4)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    extras = request_extras(cfg, args.batch, args.seq, seed=args.seed,
                            grid=16 if dev.type == "cuda" else 2)
    serve_requests(params, cfg, requests=args.requests, batch=args.batch,
                   seq=args.seq, stages=args.stages, branches=args.branches,
                   device=dev, extras=extras)


if __name__ == "__main__":
    main()
