"""Training driver, the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 100 --batch 8 --seq 256 --ckpt /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced

Uses the deterministic ``TokenPipeline``, the arch's optimizer, global-norm
clipping and the warmup-cosine learning rate (warmup 20 steps), and
checkpoints through ``repro_torch.ckpt``: with ``--ckpt`` it restores the
directory's parameters and optimizer state when it holds a checkpoint and
continues from its step (the pipeline restarts at its seed, as the
reference's does), saves every ``--ckpt-every`` steps and at the end.  It
runs on the card unless ``--device cpu`` is given; the parameters are
random, from a generator seeded 0 on that device.  ``main`` returns the
per-step losses; ``on_step(step, params, opt_state, metrics)``, if given,
is called after each step.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import init_params, stack_groups
from repro_torch.optim.optimizers import make_optimizer, warmup_cosine
from repro_torch.tree import tree_leaves


def main(argv=None, on_step=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override reduced d_model")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(max_d_model=args.d_model or 256,
                          max_layers=args.layers or 2, vocab=2048)
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"params={cfg.param_count()/1e6:.1f}M opt={cfg.optimizer}")

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    init_opt, _ = make_optimizer(cfg.optimizer, stack_groups(params, cfg))
    opt_state = init_opt(tree_leaves(params))
    start = 0
    if args.ckpt:
        try:
            (params, opt_state), start = restore_checkpoint(
                args.ckpt, (params, opt_state))
            print(f"restored step {start} from {args.ckpt}")
        except FileNotFoundError:
            pass

    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=0,
                         num_codebooks=cfg.num_codebooks)
    step_fn = make_train_step(cfg, mesh=None, lr=args.lr, device=dev)
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        lr = warmup_cosine(step, args.lr, warmup_steps=20,
                           total_steps=args.steps)
        params, opt_state, metrics = step_fn(params, opt_state,
                                             pipe.next_batch(), lr)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(step, params, opt_state, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = (time.time() - t0) / max(1, step - start + 1)
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({dt:.2f}s/step)", flush=True)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, (params, opt_state), step + 1)
    if args.ckpt:
        save_checkpoint(args.ckpt, (params, opt_state), args.steps)
    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
