"""How far the train path's finetuned θ follows its host oracle.

    PYTHONPATH=src python3 tools/finetune_horizon.py [--device cuda]
        [--horizons 10 11 40 100] [--perturb 1e-7]

Runs ``splitplace`` in train mode (the main grid's cell 0: λ=6, seed 0, 30
substeps; the DASO stage at ``SurrogatePlacer``'s widths, θ0 from a
``torch.Generator`` seeded 0 on the device; the default ``TRAIN_HP``) for
each horizon T through the interval program on ``--device`` and through
the host oracle ``replay_trace_edgesim_trained``, and prints, per T: θ's
largest difference over each leaf's largest entry, the margin of
``tests/test_differential.py``'s rule (the largest |d| / (1e-9 + 1e-4
|θ|); the rule holds below 1), whether two runs on the device are bitwise
equal, and the window-loss column's largest relative difference.

``--perturb EPS`` runs the oracle a second time from θ0 scaled by (1 +
EPS·N(0, 1)) at the largest horizon and prints how far the window loss
and θ move, interval by interval: the sensitivity of the finetune itself,
on one device.
"""
from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from repro_torch.core.daso import DASOConfig, init_surrogate
from repro_torch.env import torchsim

MAB_LITERAL = {"R": np.array([700.0, 1800.0, 3500.0]),
               "Q": np.array([[0.8, 0.6], [0.3, 0.7]]),
               "N": np.array([[20.0, 10.0], [5.0, 25.0]]),
               "eps": 0.4, "rho": 0.06, "t": 40}
CFG = DASOConfig(num_workers=50, max_containers=64, state_features=4)


def _theta_gap(ref, got):
    """(largest |d| / the leaf's largest entry, the rule's margin)."""
    scaled = margin = 0.0
    for a, b in zip(ref, got):
        for k in ("w", "b"):
            a_, b_ = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
            d = np.abs(a_ - b_)
            scaled = max(scaled, float(d.max() / np.abs(a_).max()))
            margin = max(margin, float(np.max(d / (1e-9 + 1e-4 * np.abs(a_)))))
    return scaled, margin


def _loss(out):
    cols = out["telemetry"]["cols"]
    return out["telemetry"]["series"][:, cols.index("daso_last_loss")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--horizons", type=int, nargs="+",
                    default=[10, 11, 12, 16, 24, 40, 100])
    ap.add_argument("--perturb", type=float, default=0.0)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    theta = init_surrogate(CFG, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    kw = dict(daso_theta=theta, daso_cfg=CFG, telemetry="interval")
    for T in args.horizons:
        tr = torchsim.compile_trace_dual(lam=6.0, seed=0, n_intervals=T,
                                         substeps=30)
        one = torchsim.run_trace_arrays_trained(tr, MAB_LITERAL, device=dev,
                                                **kw)
        two = torchsim.run_trace_arrays_trained(tr, MAB_LITERAL, device=dev,
                                                **kw)
        ref = torchsim.replay_trace_edgesim_trained(tr, MAB_LITERAL, **kw)
        scaled, margin = _theta_gap(ref["daso_theta"], one["daso_theta"])
        same = all(np.array_equal(a[k], b[k]) for a, b in
                   zip(one["daso_theta"], two["daso_theta"])
                   for k in ("w", "b"))
        lr, lo = _loss(ref), _loss(one)
        print(f"T={T}: θ {scaled:.3e} of a leaf's largest entry from the "
              f"oracle's, rule margin {margin:.3f}; two {dev.type} runs "
              f"bitwise equal: {same}; window loss within "
              f"{np.max(np.abs(lr - lo) / np.abs(lr)):.3e}", flush=True)
    if args.perturb:
        g = torch.Generator().manual_seed(1)
        theta_cpu = [{k: v.cpu() for k, v in layer.items()}
                     for layer in theta]
        moved = [{k: v * (1 + args.perturb * torch.randn(v.shape,
                                                         generator=g))
                  for k, v in layer.items()} for layer in theta_cpu]
        T = max(args.horizons)
        tr = torchsim.compile_trace_dual(lam=6.0, seed=0, n_intervals=T,
                                         substeps=30)
        a = torchsim.replay_trace_edgesim_trained(
            tr, MAB_LITERAL, daso_theta=theta_cpu, daso_cfg=CFG,
            telemetry="interval")
        b = torchsim.replay_trace_edgesim_trained(
            tr, MAB_LITERAL, daso_theta=moved, daso_cfg=CFG,
            telemetry="interval")
        la, lb = _loss(a), _loss(b)
        rel = np.abs(la - lb) / np.abs(la)
        print(f"θ0 perturbed by {args.perturb:g}: window loss moved by "
              + ", ".join(f"{rel[t]:.1e} at t={t}"
                          for t in range(0, T, max(1, T // 10)))
              + f"; θ at T={T} by "
              f"{_theta_gap(a['daso_theta'], b['daso_theta'])[0]:.3e} of a "
              "leaf's largest entry", flush=True)


if __name__ == "__main__":
    main()
