"""The grid's thread-chunk and device-shard dispatch against the one call.

The counterpart of ``tests/test_grid_sharded.py``: an uneven grid of 5
traces sharded over ``devices=["cpu"] * 8`` (three dead padded cells) and
cut into ``threads=2`` chunks must give every cell the summary of the
default single call, within the reference's contract (rtol 1e-4 / atol
1e-9 on every scalar metric), for the static ``mc`` policy, ``splitplace``
in deploy and train mode, ``random+daso`` and Gillis (whose per-cell seed
keys have to follow their cells into chunks and shards).  Also:
``make_grid_mesh``'s refusals, ``phase_s`` with several parts, a per-cell
MAB state in chunks, and ``run_grid_batched`` passing ``threads`` /
``devices`` through.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_ref import MAB_LITERAL
from repro_torch.core import daso, mab
from repro_torch.env import torchsim
from repro_torch.env.torchsim import driver
from repro_torch.env.workload import COMPRESSED, LAYER
from repro_torch.launch import experiments
from repro_torch.launch.mesh import make_grid_mesh

SHAPE = dict(n_intervals=4, substeps=4)
CELLS = [(lam, s) for lam in (3.0, 6.0) for s in (0, 1, 2)][:5]
DASO_CFG = dict(num_workers=50, max_containers=16, state_features=4,
                hidden=32, depth=2, place_iters=12)
SHARDS = ["cpu"] * 8


def _close(name, base, got):
    assert len(base) == len(got) == len(CELLS), (name, len(base), len(got))
    for i, (a, b) in enumerate(zip(base, got)):
        assert set(a) == set(b), (name, i)
        for k, v in a.items():
            if isinstance(v, (int, float)):
                assert np.isclose(v, b[k], rtol=1e-4, atol=1e-9), \
                    (name, i, k, v, b[k])


def _traces(kind):
    if kind == "static":
        dec = torchsim.make_static_decider("mc")
        return [torchsim.compile_trace(dec, lam=lam, seed=s, **SHAPE)
                for lam, s in CELLS]
    variants = (LAYER, COMPRESSED) if kind == "gillis" else (0, 1)
    return [torchsim.compile_trace_dual(lam=lam, seed=s, variants=variants,
                                        **SHAPE) for lam, s in CELLS]


def _runner(name):
    """(traces, run(traces, **dispatch)) of one engine on the CPU."""
    cfg = daso.DASOConfig(**DASO_CFG)
    theta = daso.init_surrogate(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    kw = dict(device="cpu")
    learned = dict(daso_theta=theta, daso_cfg=cfg, **kw)
    runs = {
        "static": lambda tr, **d: torchsim.run_grid_arrays(tr, **kw, **d),
        "splitplace deploy": lambda tr, **d: torchsim.run_grid_arrays_learned(
            tr, MAB_LITERAL, **learned, **d),
        "splitplace train": lambda tr, **d: torchsim.run_grid_arrays_trained(
            tr, MAB_LITERAL, **learned, **d),
        "random+daso": lambda tr, **d: torchsim.run_grid_arrays_static_daso(
            tr, "random+daso", **learned, **d),
        "gillis": lambda tr, **d: torchsim.run_grid_arrays_gillis(
            tr, **kw, **d),
    }
    kind = {"static": "static", "gillis": "gillis"}.get(name, "dual")
    return _traces(kind), runs[name]


@pytest.mark.parametrize("name", ["static", "splitplace deploy",
                                  "splitplace train", "random+daso",
                                  "gillis"])
def test_chunks_and_shards_match_the_single_call(name):
    traces, run = _runner(name)
    one = run(traces)
    assert sum(r["tasks_completed"] for r in one) > 0
    _close(f"{name} threads=2", one, run(traces, threads=2))
    _close(f"{name} 8 shards (3 dead cells)", one,
           run(traces, devices=SHARDS))


def test_static_shards_are_bitwise_the_single_call():
    """On one device kind, a cell's launches do not depend on its
    neighbours: the static engine's summaries are equal to every digit."""
    traces, run = _runner("static")
    assert run(traces, devices=SHARDS) == run(traces)


def test_make_grid_mesh_refuses_what_it_cannot_build(monkeypatch):
    n = torch.cuda.device_count()
    for bad in (0, n + 1, 9 + n):
        with pytest.raises(ValueError, match="need 1.."):
            make_grid_mesh(bad)
    with pytest.raises(ValueError, match="empty"):
        make_grid_mesh([])
    assert make_grid_mesh(["cpu", torch.device("cpu")]) == \
        [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for auto in ("auto", None):
        with pytest.raises(ValueError, match="no CUDA device"):
            make_grid_mesh(auto)
    with pytest.raises(ValueError, match="need 1..0"):
        torchsim.run_grid_arrays(_traces("static"), device="cpu", devices=1)


def test_threads_are_slices_on_one_device():
    """``threads=n`` is ``devices=[device] * n``: the same contiguous
    slices with the same dead padded cells, so the same summaries."""
    traces, run = _runner("static")
    assert run(traces, threads=3) == run(traces, devices=["cpu"] * 3)
    assert run(traces, threads=99) == run(traces)   # capped at G slices


def test_devices_of_another_type_than_device_raise():
    traces = _traces("static")
    with pytest.raises(ValueError, match="not all of device='cuda'"):
        torchsim.run_grid_arrays(traces, device="cuda", devices=["cpu"] * 2)


def test_phase_s_times_one_call_only():
    traces = _traces("static")
    phase_s = {}
    torchsim.run_grid_arrays(traces, device="cpu", phase_s=phase_s,
                             threads=1, devices=None)
    assert phase_s["physics"] > 0
    for dispatch in (dict(threads=2), dict(devices=["cpu"] * 2)):
        with pytest.raises(ValueError, match="phase_s times one call"):
            torchsim.run_grid_arrays(traces, device="cpu", phase_s={},
                                     **dispatch)


def test_per_cell_mab_state_runs_as_one_part():
    traces = _traces("dual")
    per_cell = mab.mab_state_from_numpy(MAB_LITERAL, grid=len(traces),
                                        device="cpu")
    one = torchsim.run_grid_arrays_learned(traces, per_cell, device="cpu")
    _close("per-cell state", one, torchsim.run_grid_arrays_learned(
        traces, MAB_LITERAL, device="cpu"))
    with pytest.raises(ValueError, match="grid axis of 5"):
        torchsim.run_grid_arrays_learned(traces, per_cell, device="cpu",
                                         threads=2)


def test_run_grid_batched_passes_dispatch_through(monkeypatch):
    seen = []
    engine = driver.run_grid_engine

    def spy(*a, **kw):
        seen.append((kw["threads"], kw["devices"]))
        return engine(*a, **kw)

    monkeypatch.setattr(driver, "run_grid_engine", spy)
    kw = dict(seeds=(0, 1, 2), lams=(3.0, 6.0), device="cpu", **SHAPE)
    one = experiments.run_grid_batched("mc", **kw)
    got = experiments.run_grid_batched("mc", threads=2, **kw)
    shards = experiments.run_grid_batched("mc", devices=["cpu"] * 4, **kw)
    assert seen == [(None, None), (2, None), (None, ["cpu"] * 4)]
    assert got == one and shards == one
    assert [(r["lam"], r["seed"]) for r in shards] == \
        [(lam, s) for lam in (3.0, 6.0) for s in (0, 1, 2)]
