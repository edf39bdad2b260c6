"""Fences around the PyTorch port.

  * ``repro_torch`` imports neither JAX nor anything of the JAX package
    ``repro`` (checked in a fresh interpreter, after importing every
    module of the port, and in the sources);
  * its entry points default to CUDA and raise on a machine without it
    instead of falling back to the CPU.
"""
from __future__ import annotations

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_ref import ROOT

SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _port_modules()
    for m in ("repro_torch.kernels.edge_substep",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.moe_route",
              "repro_torch.kernels.selective_scan",
              "repro_torch.kernels.rglru_scan",
              "repro_torch.models.moe", "repro_torch.models.ssm",
              "repro_torch.models.rglru",
              "repro_torch.configs.tinyllama_1_1b",
              "repro_torch.models.model", "repro_torch.serving.engine",
              "repro_torch.core.daso", "repro_torch.launch.serve",
              "repro_torch.env.torchsim.reference", "repro_torch.obs",
              "repro_torch.obs.ledger", "repro_torch.env.legacy_sim",
              "repro_torch.env.torchsim.stream",
              "repro_torch.launch.steps", "repro_torch.launch.train",
              "repro_torch.optim.optimizers", "repro_torch.ckpt.checkpoint",
              "repro_torch.data.pipeline", "repro_torch.tree",
              "repro_torch.serving.pipeline_smap",
              "repro_torch.launch.mesh"):
        assert m in mods
    code = ("import importlib, sys\n"
            f"mods = {mods!r}\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(mods), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    offenders = []
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    if pat.search(f.read()):
                        offenders.append(os.path.relpath(path, ROOT))
    assert not offenders


def _entry_points():
    from repro_torch.core import mab
    from repro_torch.env.torchsim import (compile_trace, compile_trace_dual,
                                          make_static_decider,
                                          run_grid_arrays,
                                          run_grid_arrays_learned,
                                          run_trace_arrays)
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.env.torchsim import stream
    from repro_torch.launch import steps, train
    from repro_torch.launch.experiments import run_grid_batched, run_stream
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.core import splitnets
    from repro_torch.serving.engine import SplitPlaceEngine
    from repro_torch.serving.pipeline_smap import pipeline_shard_map
    cfg = get_config("tinyllama-1.1b").reduced()
    clf = splitnets.ClassifierConfig(input_dim=4, num_classes=2, hidden=4,
                                     depth=1)
    lit = {"Q": np.zeros((2, 2)), "N": np.zeros((2, 2)),
           "R": np.zeros(3), "eps": 0.5, "rho": 0.1, "t": 1}
    tr = compile_trace(make_static_decider("mc"), lam=2.0, seed=0,
                       n_intervals=2, substeps=2)
    dual = compile_trace_dual(lam=2.0, seed=0, n_intervals=2, substeps=2)
    eng, es0, feeder_kw = stream.make_stream_policy("mc")
    feeder = stream.StreamFeeder(lam=2.0, substeps=2, **feeder_kw)
    return {
        "run_grid_batched": lambda: run_grid_batched("mc", n_intervals=2,
                                                     substeps=2),
        "run_trace_arrays": lambda: run_trace_arrays(tr),
        "run_grid_arrays": lambda: run_grid_arrays([tr]),
        "run_grid_arrays_learned": lambda: run_grid_arrays_learned(
            [dual], lit),
        "mab_state_from_numpy": lambda: mab.mab_state_from_numpy(lit),
        "mab_init_state": lambda: mab.init_state(3),
        "init_params": lambda: init_params(cfg),
        "SplitPlaceEngine": lambda: SplitPlaceEngine(
            init_params(cfg, device="cpu"), cfg),
        "serve_main": lambda: serve.main(["--requests", "1"]),
        "run_stream": lambda: run_stream("mc", target_tasks=4),
        "StreamRunner": lambda: stream.StreamRunner(
            eng, es0, interval_s=300.0, substeps=2, max_active=8),
        "serve": lambda: stream.serve(eng, es0, feeder, target_tasks=4),
        "serve_stream_main": lambda: serve.main(["--stream", "--tasks",
                                                 "4"]),
        "init_cache": lambda: init_cache(cfg, 1, ctx_len=4),
        "make_prefill_step": lambda: steps.make_prefill_step(cfg),
        "make_serve_step": lambda: steps.make_serve_step(cfg),
        "make_eval_step": lambda: steps.make_eval_step(cfg),
        "make_train_step": lambda: steps.make_train_step(cfg),
        "train_main": lambda: train.main(["--reduced", "--steps", "1"]),
        "init_mlp": lambda: splitnets.init_mlp(torch.Generator(), [4, 2]),
        "classifier_from_numpy": lambda: splitnets.classifier_from_numpy(
            [{"w": np.zeros((4, 2)), "b": np.zeros(2)}]),
        "train_classifier": lambda: splitnets.train_classifier(
            torch.Generator(), clf, np.zeros((4, 4), np.float32),
            np.zeros(4, np.int32), steps=1),
        "pipeline_shard_map": lambda: pipeline_shard_map(
            None, {"tokens": torch.zeros((2, 4), dtype=torch.int32)}, cfg,
            ["cuda"], 1),
        "run_grid_arrays_sharded": lambda: run_grid_arrays(
            [tr], devices=["cuda"]),
    }


@pytest.mark.parametrize("name", ["run_grid_batched", "run_trace_arrays",
                                  "run_grid_arrays",
                                  "run_grid_arrays_learned",
                                  "mab_state_from_numpy", "mab_init_state",
                                  "init_params", "SplitPlaceEngine",
                                  "serve_main", "run_stream",
                                  "StreamRunner", "serve",
                                  "serve_stream_main", "init_cache",
                                  "make_prefill_step", "make_serve_step",
                                  "make_eval_step", "make_train_step",
                                  "train_main", "init_mlp",
                                  "classifier_from_numpy",
                                  "train_classifier", "pipeline_shard_map",
                                  "run_grid_arrays_sharded"])
def test_entry_points_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


def test_serve_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "2",
                "--batch", "1", "--seq", "8"])
    out = capsys.readouterr().out
    assert "plan latencies" in out and "req   1" in out


def test_serve_stream_names_its_roadmap_item(capsys):
    # item 9 (streaming) is ported: --stream serves on the CPU when asked
    from repro_torch.launch import serve
    serve.main(["--stream", "--device", "cpu", "--tasks", "20", "--chunk",
                "2", "--substeps", "2", "--capacity", "64"])
    out = capsys.readouterr().out
    assert "served " in out and "admission: offered=" in out
