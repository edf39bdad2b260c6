"""The simulator's training loop and its randomness, on the CPU.

The reference runs once, in one child interpreter (``_torch_ref``), in
JAX's non-partitionable threefry mode (``jax_threefry_partitionable``
False: the mode that reproduces its golden fixtures), under
``enable_x64`` as its driver runs.  Held against it:

  * the three draw sites of the ``threefry_rows`` kernel's twin — the
    ε-greedy MAB train draw (``mab.decide_train_rows``: float32 ε, and the
    one-key ``decide_train``), the
    Gillis draw (``mab.gillis_decide_rows``: float64 ε) and the
    ``random+daso`` engine's ``decide`` — exactly, over keys near 2**32,
    t up to 10**4 and ε of 0, 1 and in between;
  * ``window_append`` (through a full window's roll) and
    ``op_objective`` exactly; ``train_epoch_weighted`` and
    ``finetune_window`` (both sides of its gate, fresh and carried AdamW
    moments) at rtol 1e-6, θ and the optimizer state carried across as
    NumPy; ``gillis_update_masked`` exactly (its TD step is one fused
    multiply-add in the reference);
  * the (LAYER, COMPRESSED) dual trace the Gillis path compiles, leaf by
    leaf, byte for byte;
  * ``golden_train_splitplace.json`` (θ fingerprint included, θ drawn in
    the child) and ``golden_gillis.json`` (Q-table included) at the
    fixtures' rtol 1e-6 / atol 1e-12;
  * grids of ``mab``, ``splitplace`` and ``mab+gobi`` in train mode (the
    surrogate placers with the gates lowered to ``TRAIN_HP_LOW`` and
    ``lr_place`` 20, so the finetuned ascent runs and moves placements),
    ``gillis`` and ``random+daso`` against the live JAX driver: summaries
    at rtol 1e-9, the finetuned θ at rtol 1e-6, Q-tables exactly;
  * a grid equals its cells run one by one, a Gillis run starts from the
    state it is given, and ``run_grid_batched`` routes every new policy to
    those drivers.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _torch_ref import MAB_LITERAL, MAB_LITERAL_JAX, ROOT, run_reference
from repro_torch.core import daso, mab
from repro_torch.env.torchsim import (GILLIS_HP, compile_trace_dual, engines,
                                      gillis_init_state,
                                      run_grid_arrays_gillis,
                                      run_grid_arrays_static_daso,
                                      run_grid_arrays_trained,
                                      run_trace_arrays_gillis,
                                      run_trace_arrays_trained,
                                      stack_traces, to_device,
                                      trace_train_key)
from repro_torch.env.torchsim.driver import gillis_layer_ref
from repro_torch.env.workload import COMPRESSED, LAYER
from repro_torch.launch.experiments import run_grid_batched

FIXTURES = os.path.join(ROOT, "tests", "data")
GOLDEN_RTOL, GOLDEN_ATOL = 1e-6, 1e-12
#: tools/regen_golden.py's DASO configuration (θ from PRNGKey(0))
GOLDEN_CFG = dict(num_workers=50, max_containers=16, state_features=4,
                  hidden=32, depth=2, place_iters=12)
#: a placement learning rate at which the ascent moves rows
LR_MOVES = 20.0
#: train_hp with the gates lowered: ascend from interval 4, train from 2
#: records, so the finetuned ascent runs within a short trace
TRAIN_HP_LOW = (0.5, 0.5, 4, 4, 2)
GRID = dict(lam=5.0, seeds=(0, 1, 2), n_intervals=10, substeps=4)
TRAIN_POLICIES = ("mab", "splitplace", "mab+gobi")
POLICIES = TRAIN_POLICIES + ("gillis", "random+daso")

#: draw-site fuzz: intervals, per-cell seeds (keys near 2**32 too) and
#: rows per interval
DRAW_TS = (0, 7, 9999)
DRAW_SEEDS = (0, 3, 2 ** 31 + 1, 2 ** 32 - 1)
DRAW_ROWS = 40
#: the DASO carry fuzz: a small surrogate
CARRY_CFG = dict(num_workers=6, max_containers=4, state_features=4,
                 hidden=16, depth=2)
CARRY_APPENDS = 70
CARRY_SNAP = 5
INTERVAL_S = 300.0


def _draw_inputs():
    """Per draw case: MAB states (Q, R, float32 ε of 0, 1 and between),
    normalized float32 SLAs and apps, Gillis Q-tables, float64 ε, raw
    SLAs and batches."""
    rng = np.random.RandomState(11)
    G, A = len(DRAW_SEEDS), DRAW_ROWS
    return dict(
        Q=rng.rand(G, 2, 2).astype(np.float32),
        R=rng.uniform(300, 4000, (G, 3)).astype(np.float32),
        eps32=np.array([0.0, 1.0, 0.4, 0.125], np.float32),
        sla32=rng.uniform(200, 5000, (G, A)).astype(np.float32),
        app=rng.randint(0, 3, (G, A)).astype(np.int32),
        gq=rng.rand(G, 3, 2, 2).round(1),        # ties in the Q rows
        eps64=np.array([0.0, 1.0, 0.5 * 0.995 ** 7, 0.3]),
        sla=rng.uniform(1.0, 400.0, (G, A)),
        batch=rng.randint(1, 60000, (G, A)).astype(np.float64))


def _carry_inputs():
    rng = np.random.RandomState(5)
    cfg = daso.DASOConfig(**CARRY_CFG)
    F = daso.feature_size(cfg)
    dims = [F] + [cfg.hidden] * cfg.depth + [1]
    theta = [{"w": (rng.randn(a, b) / np.sqrt(a)).astype(np.float32),
              "b": (0.1 * rng.randn(b)).astype(np.float32)}
             for a, b in zip(dims[:-1], dims[1:])]
    G, K, n = 3, 30, 6
    fin = rng.rand(G, K) < 0.4
    fin[2] = False                                   # an empty interval
    return dict(
        theta=theta, xs=rng.rand(CARRY_APPENDS, F),
        ys=rng.randn(CARRY_APPENDS) * 0.3,
        resp=rng.uniform(1.0, 900.0, (G, K)), sla=rng.uniform(1.0, 900.0,
                                                             (G, K)),
        acc=rng.uniform(0.5, 1.0, (G, K)), fin=fin,
        util=rng.uniform(0.0, 1.5, (G, n)),
        gq=rng.rand(3, 2, 2), g_app=rng.randint(0, 3, 300),
        g_bucket=rng.randint(0, 2, 300), g_arm=rng.randint(0, 2, 300),
        g_reward=rng.rand(300), g_mask=rng.rand(300) < 0.8)


def _flat(prefix, theta):
    return {f"{prefix}{k}{i}": layer[k] for i, layer in enumerate(theta)
            for k in ("w", "b")}


def _unflat(arrs, prefix):
    n = sum(1 for k in arrs if k.startswith(prefix + "w"))
    return [{k: arrs[f"{prefix}{k}{i}"] for k in ("w", "b")}
            for i in range(n)]


REF_CODE = """
import dataclasses
import json
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_threefry_partitionable", False)
from jax.experimental import enable_x64
from repro.core import daso, mab
from repro.env import jaxsim
from repro.env.jaxsim import engines
from repro.env.jaxsim.driver import gillis_layer_ref
from repro.env.workload import COMPRESSED, LAYER
from repro.optim.optimizers import adamw_init

inp = dict(np.load(INP))
out = {}
summ = {}

def theta_of(prefix):
    n = sum(1 for k in inp if k.startswith(prefix + "w"))
    return [{k: jnp.asarray(inp[f"{prefix}{k}{i}"]) for k in ("w", "b")}
            for i in range(n)]

def put_theta(prefix, theta):
    for i, layer in enumerate(theta):
        for k in ("w", "b"):
            out[f"{prefix}{k}{i}"] = np.asarray(layer[k])

def put_opt(prefix, opt):
    out[prefix + "step"] = np.asarray(opt.step)
    put_theta(prefix + "m", opt.m)
    put_theta(prefix + "v", opt.v)

with enable_x64():
    layer_ref = jnp.asarray(gillis_layer_ref(3))
    for t in DRAW_TS:
        tr_, gi_, one_ = [], [], []
        for g, seed in enumerate(DRAW_SEEDS):
            key_t = jax.random.fold_in(jax.random.PRNGKey(seed), t)
            st = mab.init_state(3)._replace(
                Q=jnp.asarray(inp["dr_Q"][g]), R=jnp.asarray(inp["dr_R"][g]),
                eps=jnp.asarray(inp["dr_eps32"][g]))
            d, _ = mab.decide_train_rows(st, key_t,
                                         jnp.asarray(inp["dr_sla32"][g]),
                                         jnp.asarray(inp["dr_app"][g]))
            tr_.append(np.asarray(d))
            one_.append(int(mab.decide_train(
                st, jax.random.fold_in(key_t, 5),
                jnp.asarray(inp["dr_sla32"][g][5]),
                jnp.asarray(inp["dr_app"][g][5]))[0]))
            a, _ = mab.gillis_decide_rows(
                jnp.asarray(inp["dr_gq"][g]), jnp.asarray(inp["dr_eps64"][g]),
                key_t, jnp.asarray(inp["dr_sla"][g]),
                jnp.asarray(inp["dr_batch"][g]), jnp.asarray(inp["dr_app"][g]),
                layer_ref)
            gi_.append(np.asarray(a))
        out[f"draw_train_{t}"] = np.stack(tr_)
        out[f"draw_gillis_{t}"] = np.stack(gi_)
        out[f"draw_one_{t}"] = np.asarray(one_)
    tr = jaxsim.compile_trace_dual(lam=40.0, seed=1, n_intervals=3,
                                   substeps=2)
    trace = {k: jnp.asarray(v) for k, v in tr.kernel_dict().items()}
    cfg0 = daso.DASOConfig(**GOLDEN_CFG)
    eng = engines.StaticDeciderDASOEngine(arm=-1, daso_cfg=cfg0)
    for t in range(3):
        rows = []
        for seed in DRAW_SEEDS:
            arr, _ = eng.decide({"theta": (), "key": jax.random.PRNGKey(seed)},
                                trace, t)
            rows.append(np.asarray(arr["decision"]))
        out[f"draw_random_{t}"] = np.stack(rows)

    cfg = daso.DASOConfig(**CARRY_CFG)
    win = daso.window_init(cfg)
    for i in range(CARRY_APPENDS):
        win = daso.window_append(win, jnp.asarray(inp["c_xs"][i]),
                                 jnp.asarray(inp["c_ys"][i]))
        if i + 1 == CARRY_SNAP:
            win5 = win
            out["win5_xs"], out["win5_ys"] = (np.asarray(win["xs"]),
                                              np.asarray(win["ys"]))
    out["win_xs"], out["win_ys"] = np.asarray(win["xs"]), np.asarray(win["ys"])
    out["win_count"] = np.asarray(win["count"])
    out["op_y"] = np.stack([np.asarray(daso.op_objective(
        jnp.asarray(inp["c_resp"][g]), jnp.asarray(inp["c_sla"][g]),
        jnp.asarray(inp["c_acc"][g]), jnp.asarray(inp["c_fin"][g]),
        jnp.asarray(inp["c_util"][g]), INTERVAL_S, 0.5, 0.5))
        for g in range(inp["c_resp"].shape[0])])
    theta = theta_of("c_")
    opt = adamw_init(theta)
    for name, w_ in (("w5", win5), ("w64", win)):
        wt = (jnp.arange(daso.REPLAY_WINDOW) < w_["count"]).astype(
            w_["ys"].dtype)
        th1, op1, loss = daso.train_epoch_weighted(
            cfg, theta, opt, w_["xs"], w_["ys"], wt)
        put_theta(f"ep_{name}_", th1)
        put_opt(f"epo_{name}_", op1)
        out[f"ep_{name}_loss"] = np.asarray(loss)
        out[f"wl_{name}"] = np.asarray(daso.window_loss(cfg, th1, w_))
        th2, op2 = daso.finetune_window(cfg, th1, op1, w_, 3, 8)
        put_theta(f"ft_{name}_", th2)
        put_opt(f"fto_{name}_", op2)
    out["gq"] = np.asarray(mab.gillis_update_masked(
        jnp.asarray(inp["c_gq"]), jnp.asarray(inp["c_g_app"]),
        jnp.asarray(inp["c_g_bucket"]), jnp.asarray(inp["c_g_arm"]),
        jnp.asarray(inp["c_g_reward"]), jnp.asarray(inp["c_g_mask"]), 0.3))

tr = jaxsim.compile_trace_dual(lam=5.0, seed=2, n_intervals=12, substeps=4,
                               variants=(LAYER, COMPRESSED))
for f in dataclasses.fields(tr):
    v = getattr(tr, f.name)
    if isinstance(v, np.ndarray):
        out["dual_" + f.name] = v
out["dual_variants"] = np.asarray(tr.variants)

theta0 = daso.init_surrogate(jax.random.PRNGKey(0),
                             daso.DASOConfig(**GOLDEN_CFG))
put_theta("g_", theta0)
cfg = daso.DASOConfig(**GOLDEN_CFG)._replace(lr_place=LR_MOVES)
traces = [jaxsim.compile_trace_dual(lam=GRID["lam"], seed=s,
                                    n_intervals=GRID["n_intervals"],
                                    substeps=GRID["substeps"])
          for s in GRID["seeds"]]
runs = {
    "mab": dict(),
    "splitplace": dict(daso_theta=theta0, daso_cfg=cfg,
                       train_hp=TRAIN_HP_LOW),
    "mab+gobi": dict(daso_theta=theta0,
                     daso_cfg=cfg._replace(decision_aware=False),
                     train_hp=TRAIN_HP_LOW),
}
for pol, kw in runs.items():
    res = jaxsim.run_grid_arrays_trained(traces, MAB_STATE, **kw)
    for i, r in enumerate(res):
        if "daso_theta" in r:
            put_theta(f"th_{pol}_{i}_", r.pop("daso_theta"))
    summ[pol] = res
summ["random+daso"] = jaxsim.run_grid_arrays_static_daso(
    traces, "random+daso", daso_theta=theta0, daso_cfg=cfg)
gtraces = [jaxsim.compile_trace_dual(lam=GRID["lam"], seed=s,
                                     n_intervals=GRID["n_intervals"],
                                     substeps=GRID["substeps"],
                                     variants=(LAYER, COMPRESSED))
           for s in GRID["seeds"]]
res = jaxsim.run_grid_arrays_gillis(gtraces)
for i, r in enumerate(res):
    out[f"gillis_q_{i}"] = np.asarray(r.pop("gillis_q"))
summ["gillis"] = res
np.savez(OUT + ".npz", **out)
with open(OUT, "w") as f:
    json.dump(summ, f, default=float)
"""


@pytest.fixture(scope="module")
def draws():
    return _draw_inputs()


@pytest.fixture(scope="module")
def carry():
    return _carry_inputs()


@pytest.fixture(scope="module")
def ref(tmp_path_factory, draws, carry):
    d = tmp_path_factory.mktemp("ref_train")
    inp = d / "inputs.npz"
    arrs = {"dr_" + k: v for k, v in draws.items()}
    arrs.update({"c_" + k: v for k, v in carry.items() if k != "theta"})
    arrs.update(_flat("c_", carry["theta"]))
    np.savez(inp, **arrs)
    out = d / "ref.json"
    consts = "".join(f"{k} = {v!r}\n" for k, v in dict(
        INP=str(inp), DRAW_TS=DRAW_TS, DRAW_SEEDS=DRAW_SEEDS,
        CARRY_CFG=CARRY_CFG, CARRY_APPENDS=CARRY_APPENDS,
        CARRY_SNAP=CARRY_SNAP, INTERVAL_S=INTERVAL_S,
        GOLDEN_CFG=GOLDEN_CFG, LR_MOVES=LR_MOVES,
        TRAIN_HP_LOW=TRAIN_HP_LOW, GRID=GRID).items())
    run_reference(MAB_LITERAL_JAX + consts + REF_CODE, out, timeout=900)
    with open(out) as f:
        summ = json.load(f)
    return summ, dict(np.load(str(out) + ".npz"))


@pytest.fixture(scope="module")
def theta0(ref):
    return _unflat(ref[1], "g_")


def _keys():
    return torch.stack([trace_train_key(s) for s in DRAW_SEEDS])


def _mab_state(draws):
    st = mab.init_state(3, grid=len(DRAW_SEEDS), device="cpu")
    return st._replace(Q=torch.from_numpy(draws["Q"]),
                       R=torch.from_numpy(draws["R"]),
                       eps=torch.from_numpy(draws["eps32"]))


# ----------------------------------------------------------- draw sites


@pytest.mark.parametrize("t", DRAW_TS)
def test_train_draw_matches_reference(draws, ref, t):
    d, _ = mab.decide_train_rows(_mab_state(draws), _keys(), t,
                                 torch.from_numpy(draws["sla32"]),
                                 torch.from_numpy(draws["app"]))
    want = ref[1][f"draw_train_{t}"]
    np.testing.assert_array_equal(d.numpy(), want)
    # ε = 0 never explores (greedy only); ε = 1 always flips a coin
    assert 0 < want[1].sum() < DRAW_ROWS


@pytest.mark.parametrize("t", DRAW_TS)
def test_single_train_decision_matches_reference(draws, ref, t):
    """``decide_train``: one decision per cell from its own key (here row
    5's key of interval t)."""
    from repro_torch.core import prng
    key = prng.fold_in(prng.fold_in(_keys(), t), 5)
    d, _ = mab.decide_train(_mab_state(draws), key,
                            torch.from_numpy(draws["sla32"][:, 5]),
                            torch.from_numpy(draws["app"][:, 5]))
    np.testing.assert_array_equal(d.numpy(), ref[1][f"draw_one_{t}"])


@pytest.mark.parametrize("t", DRAW_TS)
def test_gillis_draw_matches_reference(draws, ref, t):
    arms, bucket = mab.gillis_decide_rows(
        torch.from_numpy(draws["gq"]), torch.from_numpy(draws["eps64"]),
        _keys(), t, torch.from_numpy(draws["sla"]),
        torch.from_numpy(draws["batch"]), torch.from_numpy(draws["app"]),
        torch.from_numpy(gillis_layer_ref(3)))
    np.testing.assert_array_equal(arms.numpy(), ref[1][f"draw_gillis_{t}"])
    assert 0 < bucket.sum() < bucket.numel()


def test_random_arm_draw_matches_reference(ref):
    tr = compile_trace_dual(lam=40.0, seed=1, n_intervals=3, substeps=2)
    trace = to_device(stack_traces([tr] * len(DRAW_SEEDS)), "cpu")
    eng = engines.StaticDeciderDASOEngine(
        arm=-1, daso_cfg=daso.DASOConfig(**GOLDEN_CFG))
    for t in range(3):
        arr, _ = eng.decide({"theta": (), "key": _keys()}, trace, t)
        want = ref[1][f"draw_random_{t}"]
        np.testing.assert_array_equal(arr["decision"].numpy(), want)
        assert 0 < want.sum() < want.size


# ------------------------------------------------------------ DASO carry


def _window(carry, appends):
    cfg = daso.DASOConfig(**CARRY_CFG)
    win = daso.window_init(cfg, 1, "cpu")
    for i in range(appends):
        win = daso.window_append(win, torch.from_numpy(carry["xs"][i])[None],
                                 torch.from_numpy(carry["ys"][i:i + 1]))
    return win


def test_window_append_exact(carry, ref):
    for appends, name in ((CARRY_SNAP, "win5"), (CARRY_APPENDS, "win")):
        win = _window(carry, appends)
        assert win["count"] == min(appends, daso.REPLAY_WINDOW)
        np.testing.assert_array_equal(win["xs"][0].numpy(),
                                      ref[1][name + "_xs"])
        np.testing.assert_array_equal(win["ys"][0].numpy(),
                                      ref[1][name + "_ys"])
    assert int(ref[1]["win_count"]) == daso.REPLAY_WINDOW


def test_op_objective_exact(carry, ref):
    y = daso.op_objective(*[torch.from_numpy(carry[k]) for k in
                            ("resp", "sla", "acc", "fin", "util")],
                          INTERVAL_S, 0.5, 0.5)
    np.testing.assert_array_equal(y.numpy(), ref[1]["op_y"])


def _theta1(arrs, prefix):
    return daso.theta_cells(_unflat(arrs, prefix), 1, "cpu")


def _opt_np(arrs, prefix):
    return (arrs[prefix + "step"], _unflat(arrs, prefix + "m"),
            _unflat(arrs, prefix + "v"))


def _assert_theta(got, want, rtol=1e-6):
    """θ leaf by leaf at ``rtol``, with an absolute floor of ``rtol`` times
    the leaf's largest entry: AdamW's step is about ``lr_train`` whatever
    a gradient's size, so an entry near 0 moves by a difference of
    float64 sums taken in another order."""
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("w", "b"):
            np.testing.assert_allclose(
                np.asarray(g[k]), w[k], rtol=rtol,
                atol=rtol * np.abs(w[k]).max(), err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("appends,name", ((CARRY_SNAP, "w5"),
                                          (CARRY_APPENDS, "w64")))
def test_train_epoch_and_finetune_match_reference(carry, ref, appends,
                                                  name):
    cfg = daso.DASOConfig(**CARRY_CFG)
    win = _window(carry, appends)
    theta = daso.theta_cells(carry["theta"], 1, "cpu")
    opt = daso.opt_state_cells(None, theta, 1, "cpu")
    w = (torch.arange(daso.REPLAY_WINDOW) < win["count"]).double()[None]
    th1, op1, loss = daso.train_epoch_weighted(cfg, theta, opt, win["xs"],
                                               win["ys"], w)
    arrs = ref[1]
    assert all(v["w"].dtype == torch.float32 for v in th1)
    _assert_theta([{k: v[0] for k, v in layer.items()} for layer in th1],
                  _unflat(arrs, f"ep_{name}_"))
    np.testing.assert_allclose(loss.numpy()[0], arrs[f"ep_{name}_loss"],
                               rtol=1e-12)
    assert int(op1.step) == int(arrs[f"epo_{name}_step"]) == 1
    np.testing.assert_allclose(
        daso.window_loss(cfg, th1, win).numpy()[0], arrs[f"wl_{name}"],
        rtol=1e-6)
    # finetune from the reference's epoch, its AdamW state carried as NumPy
    th_r = _theta1(arrs, f"ep_{name}_")
    op_r = daso.opt_state_cells(_opt_np(arrs, f"epo_{name}_"), th_r, 1,
                                "cpu")
    th2, op2 = daso.finetune_window(cfg, th_r, op_r, win, 3, 8)
    want = _unflat(arrs, f"ft_{name}_")
    _assert_theta([{k: v[0] for k, v in layer.items()} for layer in th2],
                  want)
    assert int(op2.step) == int(arrs[f"fto_{name}_step"])
    # the moments at 1e-6 of each leaf's largest entry: an entry near 0
    # is a difference of float64 sums taken in another order
    for m, mw in zip(op2.m, daso._flat(_unflat(arrs, f"fto_{name}_m"))):
        np.testing.assert_allclose(m[0].numpy(), mw, rtol=0,
                                   atol=1e-6 * np.abs(mw).max())
    if appends < 8:                 # below train_min: θ passes unchanged
        assert th2 is th_r and int(op2.step) == 1
    else:
        assert int(op2.step) == 4


def test_gillis_update_masked_exact(carry, ref):
    q = mab.gillis_update_masked(
        torch.from_numpy(carry["gq"])[None],
        *[torch.from_numpy(carry[k])[None] for k in
          ("g_app", "g_bucket", "g_arm", "g_reward", "g_mask")], 0.3)
    np.testing.assert_array_equal(q[0].numpy(), ref[1]["gq"])


def test_dual_trace_layer_compressed_matches_reference(ref):
    tr = compile_trace_dual(lam=5.0, seed=2, n_intervals=12, substeps=4,
                            variants=(LAYER, COMPRESSED))
    want = {k[len("dual_"):]: v for k, v in ref[1].items()
            if k.startswith("dual_")}
    assert tuple(want.pop("variants")) == tr.variants == (LAYER, COMPRESSED)
    got = {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr)
           if isinstance(getattr(tr, f.name), np.ndarray)}
    assert set(got) == set(want)
    for name, v in got.items():
        w = want[name]
        assert v.dtype == w.dtype and v.shape == w.shape, name
        assert v.tobytes() == w.tobytes(), f"{name}: bytes differ"


# -------------------------------------------------------------- fixtures


def _fingerprint(theta):
    """tools/regen_golden.py's per-layer (L2 norm, abs-sum) pairs."""
    out = []
    for layer in theta:
        for k in ("w", "b"):
            a = np.asarray(layer[k], np.float64)
            out.append([float(np.sqrt(np.sum(a * a))),
                        float(np.sum(np.abs(a)))])
    return out


def _assert_fixture(got, golden):
    assert set(golden) == set(got)
    for k, v in golden.items():
        assert np.isclose(got[k], v, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL), \
            f"{k}: fixture={v!r} port={got[k]!r}"


def test_golden_train_splitplace_fixture(theta0):
    with open(os.path.join(FIXTURES, "golden_train_splitplace.json")) as f:
        golden = json.load(f)
    assert golden["case"] == "train splitplace lam=5 seed=3 T=12 substeps=4"
    tr = compile_trace_dual(lam=5.0, seed=3, n_intervals=12, substeps=4)
    got = run_trace_arrays_trained(tr, MAB_LITERAL, daso_theta=theta0,
                                   daso_cfg=daso.DASOConfig(**GOLDEN_CFG),
                                   device="cpu")
    theta = got.pop("daso_theta")
    _assert_fixture(got, golden["summary"])
    np.testing.assert_allclose(_fingerprint(theta),
                               golden["theta_fingerprint"],
                               rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
    # the finetune ran: θ moved off its start
    assert not np.array_equal(theta[0]["w"], theta0[0]["w"])


def test_golden_gillis_fixture():
    with open(os.path.join(FIXTURES, "golden_gillis.json")) as f:
        golden = json.load(f)
    assert golden["case"] == "gillis lam=5 seed=2 T=12 substeps=4"
    tr = compile_trace_dual(lam=5.0, seed=2, n_intervals=12, substeps=4,
                            variants=(LAYER, COMPRESSED))
    got = run_trace_arrays_gillis(tr, device="cpu")
    q = got.pop("gillis_q")
    _assert_fixture(got, golden["summary"])
    np.testing.assert_allclose(q, golden["gillis_q"], rtol=GOLDEN_RTOL,
                               atol=GOLDEN_ATOL)


# ------------------------------------------------------- the live driver


def _cfg(**kw):
    return daso.DASOConfig(**{**GOLDEN_CFG, "lr_place": LR_MOVES, **kw})


def _traces(**kw):
    return [compile_trace_dual(lam=GRID["lam"], seed=s,
                               n_intervals=GRID["n_intervals"],
                               substeps=GRID["substeps"], **kw)
            for s in GRID["seeds"]]


def _run(policy, traces, theta0, train_hp=TRAIN_HP_LOW):
    if policy == "gillis":
        return run_grid_arrays_gillis(traces, device="cpu")
    if policy == "random+daso":
        return run_grid_arrays_static_daso(traces, policy, daso_theta=theta0,
                                           daso_cfg=_cfg(), device="cpu")
    if policy == "mab":
        return run_grid_arrays_trained(traces, MAB_LITERAL, device="cpu")
    cfg = _cfg(decision_aware=policy != "mab+gobi")
    return run_grid_arrays_trained(traces, MAB_LITERAL, daso_theta=theta0,
                                   daso_cfg=cfg, train_hp=train_hp,
                                   device="cpu")


def _policy_traces(policy):
    if policy == "gillis":
        return _traces(variants=(LAYER, COMPRESSED))
    return _traces()


@pytest.mark.parametrize("policy", POLICIES)
def test_grid_matches_jax_driver(ref, theta0, policy):
    got = _run(policy, _policy_traces(policy), theta0)
    want = ref[0][policy]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = dict(g)
        if policy == "gillis":
            np.testing.assert_array_equal(g.pop("gillis_q"),
                                          ref[1][f"gillis_q_{i}"])
        if "daso_theta" in g:
            _assert_theta(g.pop("daso_theta"),
                          _unflat(ref[1], f"th_{policy}_{i}_"))
        assert set(g) == set(w), f"cell {i}: {set(g) ^ set(w)}"
        for k, v in w.items():
            assert np.isclose(g[k], v, rtol=1e-9, atol=1e-12), \
                f"{policy} cell {i} {k}: jax={v!r} port={g[k]!r}"
        assert g["dropped_tasks"] == 0 and g["tasks_completed"] > 0
    if policy in TRAIN_POLICIES:
        assert all(g["mab_t"] == 40 + GRID["n_intervals"] for g in got)


@pytest.mark.parametrize("policy", ("splitplace", "mab+gobi"))
def test_finetuned_ascent_is_exercised(theta0, policy):
    """With the lowered gates the finetuned θ is ascended and placements
    move: the summaries differ from a run whose ascent gate is never
    reached."""
    traces = _traces()
    low = _run(policy, traces, theta0)
    never = _run(policy, traces, theta0,
                 train_hp=TRAIN_HP_LOW[:3] + (GRID["n_intervals"], 2))
    keys = ("accuracy", "energy_mwhr", "fairness", "response_intervals",
            "layer_fraction")
    assert any(a[k] != b[k] for a, b in zip(low, never) for k in keys)


def test_gillis_state_fresh_equals_explicit_init():
    """``gillis_state=None`` starts each cell from zeros and ε₀, as
    ``gillis_init_state()`` given explicitly does; a run continued from a
    summary's (Q, ε) starts from that state."""
    traces = _policy_traces("gillis")[:2]
    fresh = run_grid_arrays_gillis(traces, device="cpu")
    explicit = run_grid_arrays_gillis(traces, gillis_init_state(),
                                      device="cpu")
    for a, b in zip(fresh, explicit):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    st = {"Q": fresh[0]["gillis_q"], "eps": 0.25}
    cont = run_grid_arrays_gillis(traces[:1], st, device="cpu")[0]
    eps = 0.25
    for _ in range(GRID["n_intervals"]):
        eps *= GILLIS_HP[2]
    assert cont["gillis_eps"] == eps
    assert not np.array_equal(cont["gillis_q"], fresh[0]["gillis_q"])


def test_trained_opt_state_is_carried(theta0):
    """``daso_opt_state`` seeds every cell's AdamW state: zero moments at
    step 0 (the reference's ``{"w", "b"}`` form, NumPy) give the fresh
    run; moments from an earlier run give another θ."""
    tr = _traces()[:1]
    zeros = [{k: np.zeros_like(v) for k, v in layer.items()}
             for layer in theta0]
    kw = dict(daso_theta=theta0, daso_cfg=_cfg(), train_hp=TRAIN_HP_LOW,
              device="cpu")
    fresh = run_grid_arrays_trained(tr, MAB_LITERAL, **kw)[0]
    given = run_grid_arrays_trained(
        tr, MAB_LITERAL, daso_opt_state=(np.int32(0), zeros, zeros),
        **kw)[0]
    for a, b in zip(fresh.pop("daso_theta"), given.pop("daso_theta")):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert fresh == given
    ones = [{k: np.full_like(v, 1e-4) for k, v in layer.items()}
            for layer in theta0]
    other = run_grid_arrays_trained(
        tr, MAB_LITERAL, daso_opt_state=(np.int32(3), ones, ones), **kw)[0]
    assert not np.array_equal(other["daso_theta"][0]["w"],
                              run_grid_arrays_trained(tr, MAB_LITERAL, **kw)
                              [0]["daso_theta"][0]["w"])


@pytest.mark.parametrize("policy", ("splitplace", "gillis", "random+daso"))
def test_grid_equals_single_trace_runs(theta0, policy):
    traces = _policy_traces(policy)
    grid = _run(policy, traces, theta0)
    for tr, g in zip(traces, grid):
        one = _run(policy, [tr], theta0)[0]
        assert set(one) == set(g)
        for k, v in g.items():
            if k == "daso_theta":
                for a, b in zip(one[k], v):
                    assert all(np.array_equal(a[x], b[x]) for x in a)
            else:
                np.testing.assert_array_equal(one[k], v, err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_run_grid_batched_routes_new_policies(theta0, policy):
    """``run_grid_batched`` (train mode for the MAB policies) gives each
    cell the scalar summary of the driver it routes to."""
    kw = dict(seeds=GRID["seeds"], lams=(GRID["lam"],),
              n_intervals=GRID["n_intervals"], substeps=GRID["substeps"],
              device="cpu", mab_state=MAB_LITERAL, daso_theta=theta0,
              daso_cfg=_cfg(), mode="train", train_hp=TRAIN_HP_LOW)
    recs = run_grid_batched(policy, **kw)
    want = _run(policy, _policy_traces(policy), theta0)
    for r, w in zip(recs, want):
        for k, v in w.items():
            if k not in ("daso_theta", "gillis_q"):
                assert r[k] == float(v), f"{policy} {k}"
