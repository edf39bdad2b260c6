"""The port's DASO placement stage on the simulator's main path, on the CPU.

The reference runs in a child interpreter (``_torch_ref``); θ crosses over
as NumPy.  Held against it:

  * ``state_features_k``, ``_daso_rows`` and ``daso_requests`` on fuzzed
    slot states (live and dead slots, chains, cells with fewer live
    fragments than ``max_containers``, more, and none), cell by cell:
    features at rtol 1e-12, rows and requests exactly;
  * the grid-batched ascent against the reference's ``optimize_placement``
    one cell at a time, over cells that stop at different steps: steps and
    argmax exactly, logits and scores at rtol 1e-10;
  * ``splitplace``, ``mab+gobi``, ``layer+gobi`` and ``semantic+gobi``
    grids (G=3, λ=5, T=8, substeps 4) against the live JAX driver at rtol
    1e-9, at the golden DASO configuration and at ``lr_place`` 20, where
    the ascent moves placements: there the summaries differ from BestFit's;
  * ``tests/data/golden_mab_gobi.json`` at rtol 1e-6 / atol 1e-12;
  * single traces against the EdgeSim oracles
    (``replay_trace_edgesim_learned`` / ``_static_daso``) at rtol 1e-4 /
    atol 1e-9 (λ=5, seed 1, T=10, substeps 6, ``lr_place`` 20);
  * a grid equals its cells run one by one; the serving engine's float32
    ascent still gives what the grid ascent gives on one cell.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from _torch_ref import MAB_LITERAL, MAB_LITERAL_JAX, ROOT, run_reference
from repro_torch.core import daso
from repro_torch.env.torchsim import (compile_trace_dual, kernels,
                                      run_grid_arrays_learned,
                                      run_grid_arrays_static_daso,
                                      run_trace_arrays_learned,
                                      run_trace_arrays_static_daso)

FIXTURE = os.path.join(ROOT, "tests", "data", "golden_mab_gobi.json")
#: the DASO configuration of tools/regen_golden.py (θ from PRNGKey(0))
GOLDEN_CFG = dict(num_workers=50, max_containers=16, state_features=4,
                  hidden=32, depth=2, place_iters=12)
#: a learning rate at which the ascent moves placements off BestFit's
LR_MOVES = 20.0
LRS = (0.1, LR_MOVES)
GRID = dict(lam=5.0, seeds=(0, 1, 2), n_intervals=8, substeps=4)
MAB_POLICIES = ("splitplace", "mab+gobi")
POLICIES = MAB_POLICIES + ("layer+gobi", "semantic+gobi")
ORACLE = dict(lam=5.0, seed=1, n_intervals=10, substeps=6)
ORACLE_RTOL, ORACLE_ATOL = 1e-4, 1e-9

#: fuzzed slot states: cells with few live slots, many, none, half
FUZZ = dict(G=4, K=24, F=4, n=6, alive=(0.15, 0.9, 0.0, 0.5))
FUZZ_CFG = dict(num_workers=6, max_containers=10, state_features=4,
                hidden=16, depth=2, place_iters=15, lr_place=LR_MOVES)
#: the per-cell ascent: a tolerance its four cells reach at different steps
ASCENT_CFG = dict(num_workers=6, max_containers=8, state_features=4,
                  hidden=16, depth=3, place_iters=60, lr_place=LR_MOVES,
                  momentum=0.5, tol=0.3)
ASCENT_VALID = (8, 5, 2, 0)
INTERVAL_S = 300.0
STATE_KEYS = ("worker", "done", "instr", "ram", "stage", "chain", "alive",
              "seq", "decision")


def _theta(rng, cfg):
    dims = [daso.feature_size(cfg)] + [cfg.hidden] * cfg.depth + [1]
    return [{"w": (rng.randn(a, b) / np.sqrt(a)).astype(np.float32),
             "b": (0.1 * rng.randn(b)).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def _fuzz():
    """Slot states for G cells: per-cell live-slot rates, padding columns
    done, some live fragments new (worker −1), stages in [0, F], BestFit
    requests in [−1, n)."""
    rng = np.random.RandomState(7)
    G, K, F, n = FUZZ["G"], FUZZ["K"], FUZZ["F"], FUZZ["n"]
    alive = rng.rand(G, K) < np.asarray(FUZZ["alive"])[:, None]
    nfrag = rng.randint(1, F + 1, (G, K))
    colpad = np.arange(F) >= nfrag[..., None]
    done = (rng.rand(G, K, F) < 0.3) | colpad | ~alive[..., None]
    worker = rng.randint(0, n, (G, K, F)).astype(np.int32)
    worker[(rng.rand(G, K, F) < 0.3) | colpad] = -1
    state = dict(
        worker=worker, done=done,
        instr=rng.uniform(1e3, 5e4, (G, K, F)),
        ram=rng.uniform(0.1, 4.0, (G, K, F)),
        stage=rng.randint(0, F + 1, (G, K)).astype(np.int32),
        chain=rng.rand(G, K) < 0.5, alive=alive,
        seq=np.stack([rng.permutation(K) for _ in range(G)]).astype(np.int64),
        decision=rng.randint(0, 3, (G, K)).astype(np.int32))
    cfg = daso.DASOConfig(**FUZZ_CFG)
    return dict(state=state,
                req=rng.randint(-1, n, (G, K, F)).astype(np.int32),
                lat=rng.uniform(1.0, 3.0, (G, n)),
                mips=rng.uniform(2e3, 8e3, n), cap=rng.uniform(4.0, 16.0, n),
                theta=_theta(rng, cfg))


def _ascent_inputs():
    """G=4 cells of the per-cell ascent: features, warm-start logits with
    8, 5, 2 and 0 valid rows, decisions."""
    rng = np.random.RandomState(0)
    cfg = daso.DASOConfig(**ASCENT_CFG)
    theta = _theta(rng, cfg)
    G, n, C = len(ASCENT_VALID), cfg.num_workers, cfg.max_containers
    feat = rng.rand(G, n, 4)
    valid = np.arange(C) < np.asarray(ASCENT_VALID)[:, None]
    warm = rng.randint(0, n, (G, C))
    logits = daso.warm_start_logits(cfg, torch.from_numpy(warm),
                                    torch.from_numpy(valid)).numpy()
    dec = rng.randint(0, 2, (G, C)).astype(np.int32)
    return dict(theta=theta, feat=feat, logits=logits, dec=dec,
                mask=valid.astype(np.float64), warm=warm, valid=valid)


def _flat(prefix, theta):
    return {f"{prefix}{k}{i}": layer[k] for i, layer in enumerate(theta)
            for k in ("w", "b")}


def _unflat(arrs, prefix):
    n = sum(1 for k in arrs if k.startswith(prefix + "w"))
    return [{k: arrs[f"{prefix}{k}{i}"] for k in ("w", "b")}
            for i in range(n)]


REF_CODE = """
import json
import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import enable_x64
from repro.core import daso
from repro.env import jaxsim
from repro.env.jaxsim import kernels

inp = dict(np.load(INP))
out = {}

def theta_of(prefix):
    n = sum(1 for k in inp if k.startswith(prefix + "w"))
    return [{k: jnp.asarray(inp[f"{prefix}{k}{i}"]) for k in ("w", "b")}
            for i in range(n)]

with enable_x64():
    cfg = daso.DASOConfig(**FUZZ_CFG)
    theta = theta_of("fz_")
    cl = {"mips": jnp.asarray(inp["mips"]), "ram": jnp.asarray(inp["cap"])}
    rows = {k: [] for k in ("feat", "slot", "f", "valid", "warm", "dec",
                            "req")}
    for g in range(inp["req"].shape[0]):
        st = {k: jnp.asarray(inp["st_" + k][g]) for k in STATE_KEYS}
        req = jnp.asarray(inp["req"][g])
        feat = kernels.state_features_k(st, cl, jnp.asarray(inp["lat"][g]),
                                        INTERVAL_S)
        r = kernels._daso_rows(cfg, st, req)
        rows["feat"].append(np.asarray(feat))
        for k, v in zip(("slot", "f", "valid", "warm", "dec"), r):
            rows[k].append(np.asarray(v))
        rows["req"].append(np.asarray(
            kernels.daso_requests(cfg, theta, st, feat, req)))
    for k, v in rows.items():
        out["fz_out_" + k] = np.stack(v)

    cfg = daso.DASOConfig(**ASCENT_CFG)
    theta = theta_of("as_")
    ps, scores, steps = [], [], []
    for g in range(inp["as_feat"].shape[0]):
        p, s, i = daso.optimize_placement(
            cfg, theta, *[jnp.asarray(inp[k][g]) for k in
                          ("as_feat", "as_logits", "as_dec", "as_mask")])
        ps.append(np.asarray(p))
        scores.append(float(s))
        steps.append(int(i))
    out["as_p"], out["as_score"] = np.stack(ps), np.asarray(scores)
    out["as_steps"] = np.asarray(steps)

cfg0 = daso.DASOConfig(**GOLDEN_CFG)
theta0 = daso.init_surrogate(jax.random.PRNGKey(0), cfg0)
for i, layer in enumerate(theta0):
    for k in ("w", "b"):
        out[f"g_{k}{i}"] = np.asarray(layer[k])
summ = {}
for lr in LRS:
    cfg = cfg0._replace(lr_place=lr)
    traces = [jaxsim.compile_trace_dual(lam=GRID["lam"], seed=s,
                                        n_intervals=GRID["n_intervals"],
                                        substeps=GRID["substeps"])
              for s in GRID["seeds"]]
    summ[f"splitplace/{lr}"] = jaxsim.run_grid_arrays_learned(
        traces, MAB_STATE, daso_theta=theta0, daso_cfg=cfg)
    summ[f"mab+gobi/{lr}"] = jaxsim.run_grid_arrays_learned(
        traces, MAB_STATE, daso_theta=theta0,
        daso_cfg=cfg._replace(decision_aware=False))
    for pol in ("layer+gobi", "semantic+gobi"):
        summ[f"{pol}/{lr}"] = jaxsim.run_grid_arrays_static_daso(
            traces, pol, daso_theta=theta0, daso_cfg=cfg)
cfg = cfg0._replace(lr_place=LR_MOVES)
tr = jaxsim.compile_trace_dual(**ORACLE)
summ["oracle/splitplace"] = jaxsim.replay_trace_edgesim_learned(
    tr, MAB_STATE, daso_theta=theta0, daso_cfg=cfg)
summ["oracle/mab+gobi"] = jaxsim.replay_trace_edgesim_learned(
    tr, MAB_STATE, daso_theta=theta0,
    daso_cfg=cfg._replace(decision_aware=False))
for pol in ("layer+gobi", "semantic+gobi"):
    summ[f"oracle/{pol}"] = jaxsim.replay_trace_edgesim_static_daso(
        tr, pol, daso_theta=theta0, daso_cfg=cfg)
np.savez(OUT + ".npz", **out)
with open(OUT, "w") as f:
    json.dump(summ, f, default=float)
"""


@pytest.fixture(scope="module")
def fuzz():
    return _fuzz()


@pytest.fixture(scope="module")
def ascent():
    return _ascent_inputs()


@pytest.fixture(scope="module")
def ref(tmp_path_factory, fuzz, ascent):
    d = tmp_path_factory.mktemp("ref_daso")
    inp = d / "inputs.npz"
    arrs = {"st_" + k: v for k, v in fuzz["state"].items()}
    arrs.update(req=fuzz["req"], lat=fuzz["lat"], mips=fuzz["mips"],
                cap=fuzz["cap"], **_flat("fz_", fuzz["theta"]),
                **_flat("as_", ascent["theta"]),
                **{"as_" + k: ascent[k]
                   for k in ("feat", "logits", "dec", "mask")})
    np.savez(inp, **arrs)
    out = d / "ref.json"
    consts = "".join(f"{k} = {v!r}\n" for k, v in dict(
        INP=str(inp), FUZZ_CFG=FUZZ_CFG, ASCENT_CFG=ASCENT_CFG,
        GOLDEN_CFG=GOLDEN_CFG, LRS=LRS, LR_MOVES=LR_MOVES, GRID=GRID,
        ORACLE=ORACLE, STATE_KEYS=STATE_KEYS,
        INTERVAL_S=INTERVAL_S).items())
    run_reference(MAB_LITERAL_JAX + consts + REF_CODE, out, timeout=900)
    with open(out) as f:
        summ = json.load(f)
    arrs = dict(np.load(str(out) + ".npz"))
    return summ, arrs


@pytest.fixture(scope="module")
def theta0(ref):
    return _unflat(ref[1], "g_")


def _cfg(lr=0.1, **kw):
    return daso.DASOConfig(**{**GOLDEN_CFG, "lr_place": lr, **kw})


def _traces():
    return [compile_trace_dual(lam=GRID["lam"], seed=s,
                               n_intervals=GRID["n_intervals"],
                               substeps=GRID["substeps"])
            for s in GRID["seeds"]]


def _run(policy, traces, theta, cfg):
    if policy in MAB_POLICIES:
        if policy == "mab+gobi":
            cfg = cfg._replace(decision_aware=False)
        return run_grid_arrays_learned(traces, MAB_LITERAL,
                                       daso_theta=theta, daso_cfg=cfg,
                                       device="cpu")
    return run_grid_arrays_static_daso(traces, policy, daso_theta=theta,
                                       daso_cfg=cfg, device="cpu")


def _port_fuzz(fuzz):
    st = {k: torch.from_numpy(v) for k, v in fuzz["state"].items()}
    cl = {"mips": torch.from_numpy(fuzz["mips"]),
          "ram": torch.from_numpy(fuzz["cap"])}
    return st, cl, torch.from_numpy(fuzz["req"])


def test_state_features_match_reference(fuzz, ref):
    st, cl, _ = _port_fuzz(fuzz)
    feat = kernels.state_features_k(st, cl, torch.from_numpy(fuzz["lat"]),
                                    INTERVAL_S)
    want = ref[1]["fz_out_feat"]
    assert feat.dtype == torch.float64 and feat.shape == want.shape
    np.testing.assert_allclose(feat.numpy(), want, rtol=1e-12, atol=1e-15)
    assert (want[..., 3] > 0).any() and (want[..., 1] > 0).any()


def test_daso_rows_match_reference(fuzz, ref):
    st, _, req = _port_fuzz(fuzz)
    cfg = daso.DASOConfig(**FUZZ_CFG)
    got = kernels._daso_rows(cfg, st, req)
    for name, g in zip(("slot", "f", "valid", "warm", "dec"), got):
        np.testing.assert_array_equal(g.numpy(), ref[1]["fz_out_" + name],
                                      err_msg=name)
    # the cells cover fewer live fragments than C, more, and none
    n_live = (~fuzz["state"]["done"]).reshape(FUZZ["G"], -1).sum(axis=1)
    C = cfg.max_containers
    assert (n_live == 0).any() and ((n_live > 0) & (n_live < C)).any() \
        and (n_live > C).any()
    assert fuzz["state"]["chain"].any()


def test_daso_requests_match_reference(fuzz, ref):
    st, cl, req = _port_fuzz(fuzz)
    cfg = daso.DASOConfig(**FUZZ_CFG)
    feat = torch.from_numpy(ref[1]["fz_out_feat"])
    theta = [{k: torch.from_numpy(v).double() for k, v in layer.items()}
             for layer in fuzz["theta"]]
    got = kernels.daso_requests(cfg, theta, st, feat, req)
    assert got.dtype == req.dtype
    np.testing.assert_array_equal(got.numpy(), ref[1]["fz_out_req"])
    # the ascent moved rows off their warm start, and only live rows
    # changed
    assert (got != req).any()
    assert not ((got != req) & torch.from_numpy(fuzz["state"]["done"])).any()


def test_batched_ascent_matches_reference_per_cell(ascent, ref):
    cfg = daso.DASOConfig(**ASCENT_CFG)
    theta = [{k: torch.from_numpy(v) for k, v in layer.items()}
             for layer in ascent["theta"]]
    p, score, steps = daso.optimize_placement_grid(
        cfg, theta, *[torch.from_numpy(ascent[k])
                      for k in ("feat", "logits", "dec", "mask")])
    want_steps = ref[1]["as_steps"]
    # the cells stop at different steps, all before place_iters
    assert len(set(want_steps.tolist())) == len(ASCENT_VALID)
    assert want_steps.max() < cfg.place_iters
    np.testing.assert_array_equal(steps.numpy(), want_steps)
    np.testing.assert_array_equal(p.argmax(-1).numpy(),
                                  ref[1]["as_p"].argmax(-1))
    np.testing.assert_allclose(p.numpy(), ref[1]["as_p"], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(score.numpy(), ref[1]["as_score"],
                               rtol=1e-10)
    moved = (p.argmax(-1).numpy() != ascent["warm"]) & ascent["valid"]
    assert moved.any()


def _assert_summaries(got, want, where, rtol=1e-9, atol=1e-12):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), f"{where} cell {i}: {set(g) ^ set(w)}"
        for k, v in w.items():
            assert np.isclose(g[k], v, rtol=rtol, atol=atol), \
                f"{where} cell {i} {k}: jax={v!r} port={g[k]!r}"
        assert g["dropped_tasks"] == 0 and g["tasks_completed"] > 0


@pytest.mark.parametrize("lr", LRS)
@pytest.mark.parametrize("policy", POLICIES)
def test_grid_matches_jax_driver(ref, theta0, policy, lr):
    got = _run(policy, _traces(), theta0, _cfg(lr))
    _assert_summaries(got, ref[0][f"{policy}/{lr}"], f"{policy} lr={lr}")
    if policy in MAB_POLICIES:
        assert all(g["mab_t"] == 40 + GRID["n_intervals"] for g in got)


@pytest.mark.parametrize("policy", POLICIES)
def test_ascent_moves_summaries_off_bestfit(theta0, policy):
    """With no ascent step the DASO stage places as BestFit does (for the
    MAB policies: exactly the BestFit ``mab`` run).  At the golden
    ``lr_place`` the reference's ascent moves no placement, so the
    summaries equal BestFit's; at ``lr_place`` 20 they differ."""
    traces = _traces()
    bestfit = _run(policy, traces, theta0, _cfg(place_iters=0))
    if policy in MAB_POLICIES:
        assert bestfit == run_grid_arrays_learned(traces, MAB_LITERAL,
                                                  device="cpu")
    assert _run(policy, traces, theta0, _cfg()) == bestfit
    moved = _run(policy, traces, theta0, _cfg(LR_MOVES))
    keys = ("accuracy", "energy_mwhr", "fairness", "response_intervals",
            "layer_fraction")
    assert any(m[k] != b[k] for m, b in zip(moved, bestfit) for k in keys)


def test_golden_mab_gobi_fixture(theta0):
    with open(FIXTURE) as f:
        golden = json.load(f)
    assert golden["case"] == "deploy mab+gobi lam=5 seed=4 T=10 substeps=4"
    tr = compile_trace_dual(lam=5.0, seed=4, n_intervals=10, substeps=4)
    got = run_trace_arrays_learned(
        tr, MAB_LITERAL, daso_theta=theta0,
        daso_cfg=_cfg(decision_aware=False), device="cpu")
    assert set(golden["summary"]) == set(got)
    for k, v in golden["summary"].items():
        assert np.isclose(got[k], v, rtol=1e-6, atol=1e-12), \
            f"{k}: fixture={v!r} port={got[k]!r}"


@pytest.mark.parametrize("policy", POLICIES)
def test_trace_matches_edgesim_oracle(ref, theta0, policy):
    tr = compile_trace_dual(**ORACLE)
    cfg = _cfg(LR_MOVES)
    if policy in MAB_POLICIES:
        if policy == "mab+gobi":
            cfg = cfg._replace(decision_aware=False)
        got = run_trace_arrays_learned(tr, MAB_LITERAL, daso_theta=theta0,
                                       daso_cfg=cfg, device="cpu")
    else:
        got = run_trace_arrays_static_daso(tr, policy, daso_theta=theta0,
                                           daso_cfg=cfg, device="cpu")
    want = ref[0][f"oracle/{policy}"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.isclose(got[k], v, rtol=ORACLE_RTOL, atol=ORACLE_ATOL), \
            f"{policy} {k}: edgesim={v!r} port={got[k]!r}"
    assert got["tasks_completed"] > 0 and got["dropped_tasks"] == 0


@pytest.mark.parametrize("policy", ("splitplace", "layer+gobi"))
def test_grid_equals_single_trace_runs(theta0, policy):
    traces = _traces()
    cfg = _cfg(LR_MOVES)
    grid = _run(policy, traces, theta0, cfg)
    for tr, g in zip(traces, grid):
        assert _run(policy, [tr], theta0, cfg)[0] == g


def test_serving_ascent_unchanged():
    """The serving engine's float32 ``optimize_placement`` (host-read stop
    rule, autograd) and the grid ascent in float32 on one cell take the
    same steps to the same argmax, and the serving form still returns
    float32 logits and a Python step count."""
    cfg = daso.DASOConfig(num_workers=4, max_containers=3, state_features=2,
                          hidden=32, depth=2, place_iters=60, lr_place=0.3)
    rng = np.random.RandomState(4)
    theta = [{k: torch.from_numpy(v) for k, v in layer.items()}
             for layer in _theta(rng, cfg)]
    state = torch.from_numpy(rng.rand(4, 2).astype(np.float32))
    p0 = torch.from_numpy(rng.randn(3, 4).astype(np.float32))
    dec = torch.from_numpy(rng.randint(0, 2, 3).astype(np.int32))
    mask = torch.tensor([1.0, 1.0, 0.0])
    p, s, i = daso.optimize_placement(cfg, theta, state, p0, dec, mask)
    assert p.dtype == torch.float32 and isinstance(i, int) and 0 < i
    gp, gs, gi = daso.optimize_placement_grid(
        cfg, theta, state[None], p0[None], dec[None], mask[None])
    assert gp.dtype == torch.float32 and int(gi[0]) == i
    np.testing.assert_array_equal(gp[0].argmax(-1).numpy(),
                                  p.argmax(-1).numpy())
    np.testing.assert_allclose(gp[0].numpy(), p.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(gs[0]), float(s), rtol=1e-5)
