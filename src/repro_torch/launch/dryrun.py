"""Dry-run of every (arch × input shape) on the production mesh: the step
run once on fake DTensors, its memory per card, and its roofline terms.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each step for 256 or 512 TPU chips; here ``lower_one`` builds the step's
parameters, optimizer state, batch and cache as fake tensors
(``FakeTensorMode``: shapes only, nothing allocated), places them as
DTensors on ``launch.mesh.make_production_mesh`` by ``launch.sharding``,
and runs the step once.  The report keeps the reference's JSON keys:

  * ``flops_per_device`` / ``bytes_per_device``: ``launch.flopcount`` on
    rank 0's shards;
  * ``counted_flops_global`` / ``counted_bytes_global``: the same step
    unsharded, counted on the meta device (``count_fn``, with the
    reference's I/O term);
  * ``collective_bytes_per_device`` with ``collective_breakdown`` and
    ``collective_counts``: the result bytes of every functional collective
    DTensor issued on rank 0, by kind (the reference sums the HLO's);
  * ``memory``: ``argument_gb`` the rank's shards of the step's inputs,
    ``output_gb`` of its outputs, ``peak_gb`` the most bytes of the rank's
    tensors alive at once (``PeakBytes``, the inputs included),
    ``temp_gb`` peak less the inputs; ``code_mb`` is None (no program is
    compiled);
  * ``roofline``: compute, memory and collective seconds at the H100
    constants of ``launch.mesh`` (computed, not measured), and the largest
    of the three;
  * ``model_flops``, ``useful_flops_ratio``, ``params``, ``active_params``.

``lower_s`` is the time to build the inputs and count the global step,
``compile_s`` the fake sharded run's.  One combination:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single --out out.json

Every combination, one subprocess each, into ``dryrun_out/``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

``launch.roofline`` tabulates the results.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import weakref

from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.flopcount import _tensors

ALL_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
OUT_DIR = "dryrun_out"


def _parse_val(v):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return v == "True"
    return v


def apply_overrides(cfg, sets):
    """``--set moe.dispatch=gather --set attn_causal_skip=True ...``"""
    for kv in sets or []:
        key, val = kv.split("=", 1)
        val = _parse_val(val)
        if "." in key:
            sub, field = key.split(".", 1)
            subcfg = dataclasses.replace(getattr(cfg, sub), **{field: val})
            cfg = dataclasses.replace(cfg, **{sub: subcfg})
        else:
            cfg = dataclasses.replace(cfg, **{key: val})
    return cfg


def step_and_inputs(cfg, shape_name, device="meta", mesh=None):
    """(step, its inputs) of one input shape, the inputs on ``device`` (the
    optimizer state made from the parameters for a training step)."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import specs, steps
    from repro_torch.models.model import stack_groups
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.tree import tree_leaves
    kind = INPUT_SHAPES[shape_name]["kind"]
    params = specs.params_specs(cfg, device=device)
    sp = specs.input_specs(cfg, shape_name, device=device)
    if kind == "train":
        init, _ = make_optimizer(cfg.optimizer, stack_groups(params, cfg))
        step = steps.make_train_step(cfg, mesh, device=device)
        return step, (params, init(tree_leaves(params)), sp["batch"])
    if kind == "prefill":
        return (steps.make_prefill_step(cfg, mesh, device=device),
                (params, sp["batch"]))
    return (steps.make_serve_step(cfg, mesh, device=device),
            (params, sp["tokens"], sp["cache"], sp["pos"], sp["extras"]))


def count_step(cfg, shape_name, device="meta"):
    """The unsharded step of one input shape counted on ``device``
    (``flopcount.count_fn``, the reference's I/O term included)."""
    from repro_torch.launch.flopcount import count_fn
    step, args = step_and_inputs(cfg, shape_name, device)
    return count_fn(step, *args, attn_causal_skip=cfg.attn_causal_skip)


def _fake_like(tree, fake_mode):
    """Fake CPU tensors of ``tree``'s meta tensors' shapes and dtypes (the
    tree's Python values kept)."""
    import torch

    from repro_torch.tree import tree_flatten, tree_unflatten
    out = []
    with fake_mode:
        for _, t in tree_flatten(tree):
            out.append(torch.empty(t.shape, dtype=t.dtype, device="cpu")
                       if isinstance(t, torch.Tensor) else t)
    return tree_unflatten(tree, out)


def _placed_inputs(cfg, shape_name, mesh, fake_mode):
    """The sharded step and its inputs as fake DTensors on ``mesh``."""
    from repro_torch.launch import sharding
    step, args = step_and_inputs(cfg, shape_name, "meta", mesh=mesh)
    params = args[0]
    placed = [sharding.distribute(_fake_like(params, fake_mode),
                                  sharding.params_shardings(mesh, cfg,
                                                            params), mesh)]
    rest = args[1:]
    if isinstance(rest[0], tuple):                     # optimizer state
        state = rest[0]
        placed.append(sharding.distribute(
            _fake_like(state, fake_mode),
            sharding.opt_state_shardings(mesh, cfg, state, params), mesh))
        rest = rest[1:]
    for item in rest:
        if isinstance(item, dict):                     # batch, extras
            placed.append(sharding.distribute(
                _fake_like(item, fake_mode),
                sharding.batch_shardings(mesh, item), mesh))
        elif isinstance(item, list):                   # decode cache
            placed.append(sharding.distribute(
                _fake_like(item, fake_mode),
                sharding.cache_shardings(mesh, cfg, item), mesh))
        elif hasattr(item, "shape"):                   # decode tokens
            placed.append(sharding.distribute(
                _fake_like([item], fake_mode),
                [sharding.placements(mesh, sharding.batch_pspec(
                    mesh, item.shape))], mesh)[0])
        else:                                          # decode position
            placed.append(item)
    return step, placed


class PeakBytes(TorchDispatchMode):
    """The most bytes of local tensors alive at once while a step runs:
    the rank's shards of the step's inputs (``add``), then every tensor an
    operator makes, each storage counted once from its making until it is
    freed.  DTensor operands step aside (its local operators and
    collectives come back here), and operators run under another fake mode
    than the one active on entry (DTensor's sharding propagation) are not
    the step's.  (``MemTracker`` of torch 2.11 counts those too: 386 GB
    for TinyLlama's ``train_4k`` under torch 2.11, against 25 GB under
    2.13.)"""

    def __init__(self):
        super().__init__()
        self.now = self.peak = 0
        self._live = {}
        self._entry = None

    def __enter__(self):
        self._entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if active_fake_mode() is self._entry:
            self.add(out)
        return out

    def add(self, tree):
        """Count the storages of ``tree``'s (local) tensors not yet live."""
        for t in _tensors(tree):
            if hasattr(t, "to_local"):
                t = t.to_local()
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.now += self._live[key]
            self.peak = max(self.peak, self.now)
            weakref.finalize(st, self._drop, key)

    def _drop(self, key):
        self.now -= self._live.pop(key, 0)


def _local_bytes(tree):
    import torch
    from torch.utils._pytree import tree_flatten
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
    return total


def lower_one(arch: str, shape_name: str, multi_pod: bool, sets=None):
    """The dry-run report of one (arch, input shape, mesh)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.flopcount import FlopCounter
    from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,
                                         make_production_mesh, num_chips)
    from repro_torch.tree import tree_leaves

    cfg = apply_overrides(get_config(arch), sets)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = num_chips(mesh)
    info = INPUT_SHAPES[shape_name]
    kind, seq, gbatch = info["kind"], info["seq_len"], info["global_batch"]

    t0 = time.time()
    glob = count_step(cfg, shape_name)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    step, args = _placed_inputs(cfg, shape_name, mesh, fake_mode)
    lower_s = time.time() - t0

    t0 = time.time()
    counter = FlopCounter(attn_causal_skip=cfg.attn_causal_skip)
    tracker = PeakBytes()
    tracker.add(list(args))
    with tracker, counter:
        out = step(*args)
    compile_s = time.time() - t0
    peak = tracker.peak
    arg_bytes = _local_bytes(args)
    out_bytes = _local_bytes(out)

    tokens = gbatch * seq if kind in ("train", "prefill") else gbatch
    mf_factor = 6.0 if kind == "train" else 2.0
    n_active = cfg.active_param_count()
    model_flops = mf_factor * n_active * tokens
    flops_g, bytes_g = glob.flops, glob.hbm_bytes
    coll_dev = float(sum(counter.collective_bytes.values()))
    compute_s = flops_g / (chips * PEAK_FLOPS_BF16)
    memory_s = bytes_g / (chips * HBM_BW)
    collective_s = coll_dev / LINK_BW
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "kind": kind, "seq": seq, "global_batch": gbatch,
        "lower_s": round(lower_s, 1), "compile_s": round(compile_s, 1),
        "flops_per_device": counter.flops,
        "bytes_per_device": counter.hbm_bytes,
        "collective_bytes_per_device": coll_dev,
        "collective_breakdown": dict(counter.collective_bytes),
        "collective_counts": dict(counter.collective_counts),
        "memory": {
            "argument_gb": arg_bytes / 2**30,
            "output_gb": out_bytes / 2**30,
            "temp_gb": max(peak - arg_bytes, 0) / 2**30,
            "code_mb": None,
            "peak_gb": max(peak, arg_bytes) / 2**30,
        },
        "roofline": {
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s,
            "bottleneck": max(
                [("compute", compute_s), ("memory", memory_s),
                 ("collective", collective_s)], key=lambda kv: kv[1])[0],
            "constants": "NVIDIA H100 80GB HBM3 at 700 W (data sheet; "
                         "computed, not measured)",
        },
        "model_flops": model_flops,
        "counted_flops_global": flops_g,
        "counted_bytes_global": bytes_g,
        "counted_dot_flops_global": glob.dot_flops,
        "useful_flops_ratio": model_flops / max(flops_g, 1.0),
        "params": cfg.param_count(),
        "active_params": n_active,
    }


def run_all(archs=None, shapes=None, meshes=("single", "multi"),
            out_dir=OUT_DIR, timeout=3600):
    """One subprocess per combination, each writing ``<out_dir>/<arch>_
    <shape>_<mesh>.json`` (a combination already written is skipped).
    Returns the failed combinations."""
    from repro_torch.configs import ASSIGNED_ARCHS
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": src}
    failures = []
    for arch in archs or ASSIGNED_ARCHS:
        for shape in shapes or ALL_SHAPES:
            for mesh in meshes:
                tag = f"{arch}_{shape}_{mesh}".replace("/", "-")
                out = os.path.join(out_dir, tag + ".json")
                if os.path.exists(out):
                    print(f"skip {tag} (cached)")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh,
                       "--out", out]
                print(f"== {tag}", flush=True)
                t0 = time.time()
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=timeout, env=env)
                if r.returncode != 0:
                    failures.append(tag)
                    print(f"FAIL {tag}\n{r.stdout[-2000:]}\n"
                          f"{r.stderr[-4000:]}")
                else:
                    print(f"ok {tag} ({time.time() - t0:.0f}s)")
    print(f"done; {len(failures)} failures: {failures}")
    return failures


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=ALL_SHAPES)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", nargs="*")
    ap.add_argument("--shapes", nargs="*")
    ap.add_argument("--meshes", nargs="*", default=["single", "multi"])
    ap.add_argument("--set", action="append", default=None,
                    help="config overrides, e.g. --set attn_causal_skip=True")
    args = ap.parse_args()
    if args.all:
        fails = run_all(args.archs or None, args.shapes or None,
                        tuple(args.meshes))
        sys.exit(1 if fails else 0)
    res = lower_one(args.arch, args.shape, args.mesh == "multi",
                    sets=args.set)
    print(json.dumps(res, indent=2, default=float))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2, default=float)


if __name__ == "__main__":
    main()
