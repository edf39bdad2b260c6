"""The port's EdgeSim replay oracles (``repro_torch.env.torchsim.reference``)
against the JAX reference's own (``repro.env.jaxsim.reference``).

Both sides replay the same compiled traces (the port's compiler is
byte-equal to the reference's, ``test_torch_arrays.py``) through their
host ``EdgeSim`` with the same MAB state, θ and hyperparameters.  The
reference runs once, in a child interpreter (``_torch_ref``), in JAX's
non-partitionable threefry mode; it records each interval's split
decisions by wrapping its ``_tasks_of_interval``, as the port's side does.

  * static (``replay_trace_edgesim``): both sides are a NumPy ``EdgeSim``
    with the same BestFit, so summaries, percentiles and series are equal
    to every digit;
  * learned (UCB MAB, ± the DASO stage, GOBI), the static-decider DASO
    arms and Gillis: decisions equal, summaries and series at rtol 1e-9,
    the Gillis Q-table equal;
  * trained (ε-greedy MAB, ± online DASO finetuning): decisions equal,
    summaries and series at rtol 1e-9, the finetuned θ at rtol 1e-6 of
    each leaf's largest entry (``test_torch_train_sim._assert_theta``'s
    rule) and the series' window loss, a forward of that θ, at rtol 1e-6.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from _torch_ref import MAB_LITERAL, MAB_LITERAL_JAX, run_reference
from repro_torch.core import daso
from repro_torch.env import torchsim
from repro_torch.env.cluster import make_cluster
from repro_torch.env.torchsim import reference
from repro_torch.env.workload import COMPRESSED, LAYER

#: name -> (oracle, trace kind, λ, seed, ram_scale, T, substeps, options);
#: every learned case records the series
CASES = {
    "static-bestfit": ("static", "bestfit-rr", 5.0, 0, 1.0, 8, 4, {}),
    "static-ram": ("static", "mc", 14.0, 2, 0.35, 12, 8, {}),
    "static-layer": ("static", "bestfit-layer", 8.0, 3, 1.0, 10, 6, {}),
    "learned-mab": ("learned", "mab", 5.0, 3, 1.0, 6, 3, {}),
    "learned-daso": ("learned", "mab", 6.0, 1, 1.0, 6, 3,
                     {"daso": True}),
    "learned-gobi": ("learned", "mab", 6.0, 4, 0.45, 6, 3,
                     {"daso": True, "gobi": True}),
    "layer+gobi": ("static_daso", "mab", 6.0, 2, 1.0, 6, 3, {}),
    "semantic+gobi": ("static_daso", "mab", 6.0, 2, 1.0, 6, 3, {}),
    "random+daso": ("static_daso", "mab", 7.0, 5, 1.0, 6, 3, {}),
    "trained-mab": ("trained", "mab", 5.0, 3, 1.0, 8, 3, {}),
    "trained-daso": ("trained", "mab", 6.0, 2, 1.0, 8, 3, {"daso": True}),
    "trained-daso-ram": ("trained", "mab", 11.0, 5, 0.45, 8, 4,
                         {"daso": True}),
    "gillis": ("gillis", "gillis", 5.0, 2, 1.0, 8, 3, {}),
    "gillis-state": ("gillis", "gillis", 11.0, 5, 0.4, 8, 4,
                     {"state": True}),
}
#: the static cases also run in summary mode (the key sets must agree)
SUMMARY_CASES = ("static-ram",)
#: the surrogate: the regen_golden shape at a step size where the ascent
#: moves placements off BestFit's warm start
DASO_CFG = dict(max_containers=8, state_features=4, hidden=16, depth=2,
                place_iters=8, lr_place=20.0)
TRAIN_HP = (0.5, 0.5, 2, 2, 1)               # gates open on short traces
GILLIS_STATE = {"Q": np.random.RandomState(7).uniform(0.0, 1.0, (3, 2, 2)),
                "eps": 0.6}
RTOL, THETA_RTOL = 1e-9, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These cases are many small CPU ops: one intra-op thread runs them
    about as fast and leaves the other cores to parallel test workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _theta_np(cfg):
    """θ as NumPy float32 ``{"w", "b"}`` layers from a fixed seed (both
    sides read the same values)."""
    rng = np.random.RandomState(21)
    dims = [daso.feature_size(cfg)] + [cfg.hidden] * cfg.depth + [1]
    return [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
                np.float32),
             "b": (0.01 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def _cfg(ram_scale, gobi=False):
    cfg = daso.DASOConfig(num_workers=make_cluster(ram_scale=ram_scale).n,
                          **DASO_CFG)
    return cfg._replace(decision_aware=False) if gobi else cfg


def _trace(kind, lam, seed, scale, T, S, compile_trace, compile_dual,
           decider):
    cl = make_cluster(ram_scale=scale)
    if kind == "mab":
        return compile_dual(lam=lam, seed=seed, n_intervals=T, substeps=S,
                            cluster=cl)
    if kind == "gillis":
        return compile_dual(lam=lam, seed=seed, n_intervals=T, substeps=S,
                            cluster=cl, variants=(LAYER, COMPRESSED))
    return compile_trace(decider(kind), lam=lam, seed=seed, n_intervals=T,
                         substeps=S, cluster=cl)


REF_CODE = """
import json
import numpy as np
jax.config.update("jax_threefry_partitionable", False)
from repro.core import daso
from repro.env import jaxsim
from repro.env.cluster import make_cluster
from repro.env.jaxsim import reference as R
from repro.env.workload import COMPRESSED, LAYER

DEC = []
_orig = R._tasks_of_interval
def _tap(trace, t, decisions, acc_map):
    DEC.append([int(d) for d in np.asarray(decisions)])
    return _orig(trace, t, decisions, acc_map)
R._tasks_of_interval = _tap

def enc(x):
    if isinstance(x, dict):
        return {k: enc(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [enc(v) for v in x]
    if hasattr(x, "shape"):
        return np.asarray(x, np.float64).tolist()
    return x

arrs = np.load(OUT + ".theta.npz")
res = {}
for name, (oracle, kind, lam, seed, scale, T, S, opt) in CASES.items():
    cl = make_cluster(ram_scale=scale)
    tr = _trace(kind, lam, seed, scale, T, S, jaxsim.compile_trace,
                jaxsim.compile_trace_dual, jaxsim.make_static_decider)
    cfg = daso.DASOConfig(num_workers=cl.n, **DASO_CFG)
    if opt.get("gobi"):
        cfg = cfg._replace(decision_aware=False)
    pre = f"{scale}/"
    theta = [{"w": arrs[pre + f"w{i}"], "b": arrs[pre + f"b{i}"]}
             for i in range(cfg.depth + 1)]
    daso_kw = dict(daso_theta=theta, daso_cfg=cfg) if opt.get("daso") \\
        else {}
    tels = ("interval", "summary") if name in SUMMARY_CASES \\
        else ("interval",)
    for tel in tels:
        DEC.clear()
        if oracle == "static":
            out = R.replay_trace_edgesim(tr, cluster=cl, telemetry=tel)
        elif oracle == "learned":
            out = R.replay_trace_edgesim_learned(
                tr, MAB_STATE, cluster=cl, telemetry=tel, **daso_kw)
        elif oracle == "static_daso":
            out = R.replay_trace_edgesim_static_daso(
                tr, name, daso_theta=theta, daso_cfg=cfg, cluster=cl,
                telemetry=tel)
        elif oracle == "trained":
            out = R.replay_trace_edgesim_trained(
                tr, MAB_STATE, cluster=cl, train_hp=TRAIN_HP,
                telemetry=tel, **daso_kw)
        else:
            st = GILLIS_STATE if opt.get("state") else None
            out = R.replay_trace_edgesim_gillis(tr, gillis_state=st,
                                                cluster=cl, telemetry=tel)
        out["decisions"] = list(DEC)
        res[f"{name}/{tel}"] = enc(out)
with open(OUT, "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_oracles") / "oracles.json"
    thetas = {}
    for scale in sorted({c[4] for c in CASES.values()}):
        for i, layer in enumerate(_theta_np(_cfg(scale))):
            thetas[f"{scale}/w{i}"] = layer["w"]
            thetas[f"{scale}/b{i}"] = layer["b"]
    np.savez(str(out) + ".theta.npz", **thetas)
    consts = (f"CASES = {CASES!r}\nSUMMARY_CASES = {SUMMARY_CASES!r}\n"
              f"DASO_CFG = {DASO_CFG!r}\nTRAIN_HP = {TRAIN_HP!r}\n"
              f"GILLIS_STATE = {{'Q': np.array({GILLIS_STATE['Q'].tolist()!r}),"
              f" 'eps': {GILLIS_STATE['eps']!r}}}\n")
    import inspect
    run_reference(MAB_LITERAL_JAX + "import numpy as np\n"
                  + inspect.getsource(_trace) + consts + REF_CODE, out)
    with open(out) as f:
        return json.load(f)


def _port(name, telemetry, monkeypatch):
    """The port's oracle of case ``name``, and the decisions it took."""
    oracle, kind, lam, seed, scale, T, S, opt = CASES[name]
    cl = make_cluster(ram_scale=scale)
    tr = _trace(kind, lam, seed, scale, T, S, torchsim.compile_trace,
                torchsim.compile_trace_dual, torchsim.make_static_decider)
    cfg = _cfg(scale, opt.get("gobi", False))
    theta = _theta_np(_cfg(scale))
    daso_kw = dict(daso_theta=theta, daso_cfg=cfg) if opt.get("daso") \
        else {}
    decisions = []
    orig = reference._tasks_of_interval

    def tap(trace, t, dec, acc_map):
        decisions.append([int(d) for d in np.asarray(dec)])
        return orig(trace, t, dec, acc_map)

    monkeypatch.setattr(reference, "_tasks_of_interval", tap)
    kw = dict(cluster=cl, telemetry=telemetry)
    if oracle == "static":
        out = torchsim.replay_trace_edgesim(tr, **kw)
    elif oracle == "learned":
        out = torchsim.replay_trace_edgesim_learned(tr, MAB_LITERAL,
                                                    **daso_kw, **kw)
    elif oracle == "static_daso":
        out = torchsim.replay_trace_edgesim_static_daso(
            tr, name, daso_theta=theta, daso_cfg=cfg, **kw)
    elif oracle == "trained":
        out = torchsim.replay_trace_edgesim_trained(
            tr, MAB_LITERAL, train_hp=TRAIN_HP, **daso_kw, **kw)
    else:
        st = GILLIS_STATE if opt.get("state") else None
        out = torchsim.replay_trace_edgesim_gillis(tr, gillis_state=st,
                                                   **kw)
    return out, decisions


def _assert_theta(got, want, rtol=THETA_RTOL):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("w", "b"):
            w_k = np.asarray(w[k], np.float64)
            np.testing.assert_allclose(
                np.asarray(g[k], np.float64), w_k, rtol=rtol,
                atol=rtol * np.abs(w_k).max(), err_msg=f"layer {i} {k}")


def _compare(got, want, exact, ctx):
    assert set(got) == set(want) - {"decisions"}, ctx
    for k, w in want.items():
        if k in ("decisions", "daso_theta"):
            continue
        if k == "telemetry":
            assert got[k]["cols"] == w["cols"], ctx
            g_s, w_s = np.asarray(got[k]["series"]), np.asarray(w["series"])
            assert g_s.shape == w_s.shape, ctx
            if exact:
                np.testing.assert_array_equal(g_s, w_s, err_msg=ctx)
            else:
                for i, col in enumerate(w["cols"]):
                    # the window loss is a forward of the finetuned θ, so
                    # it is held at θ's rule
                    rtol = THETA_RTOL if col == "daso_last_loss" else RTOL
                    np.testing.assert_allclose(
                        g_s[:, i], w_s[:, i], rtol=rtol, atol=0.0,
                        err_msg=f"{ctx}: {col}")
        elif k == "gillis_q":
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                          err_msg=ctx)
        elif exact:
            assert got[k] == w, f"{ctx} {k}: port {got[k]!r} ref {w!r}"
        else:
            assert np.isclose(got[k], w, rtol=RTOL, atol=0.0), \
                f"{ctx} {k}: port {got[k]!r} ref {w!r}"


@pytest.mark.parametrize("case", [f"{n}/interval" for n in CASES]
                         + [f"{n}/summary" for n in SUMMARY_CASES])
def test_oracle_matches_reference(ref, case, monkeypatch):
    name, tel = case.split("/")
    want = ref[case]
    got, decisions = _port(name, tel, monkeypatch)
    exact = CASES[name][0] == "static"
    if not exact:
        assert decisions == want["decisions"], f"{case}: decisions differ"
        assert sum(map(len, decisions)) > 0
    _compare(got, want, exact, case)
    if "daso_theta" in want:
        _assert_theta(got["daso_theta"], want["daso_theta"])


def test_learned_cases_exercise_their_paths(ref):
    """The cases reach what they are meant to pin: the ascent moves
    placements (the DASO case's summary differs from the MAB-only replay
    of its trace), the finetune runs (the window fills and θ moves),
    random+daso takes both arms, and the RAM cases wait."""
    _, kind, lam, seed, scale, T, S, _ = CASES["learned-daso"]
    tr = torchsim.compile_trace_dual(lam=lam, seed=seed, n_intervals=T,
                                     substeps=S)
    bestfit = torchsim.replay_trace_edgesim_learned(tr, MAB_LITERAL)
    moved = ref["learned-daso/interval"]
    assert any(bestfit[k] != moved[k] for k in ("response_intervals",
                                                "fairness", "reward"))
    s = ref["trained-daso/interval"]
    cols = s["telemetry"]["cols"]
    fill = np.asarray(s["telemetry"]["series"])[:, cols.index(
        "daso_win_fill")]
    assert fill[-1] == CASES["trained-daso"][5] and np.all(np.diff(fill) > 0)
    theta0 = _theta_np(_cfg(1.0))
    assert any(not np.allclose(np.asarray(g["w"]), w["w"])
               for g, w in zip(s["daso_theta"], theta0))
    flat = [d for row in ref["random+daso/interval"]["decisions"]
            for d in row]
    assert 0 < sum(flat) < len(flat)
    assert ref["static-ram/interval"]["wait_intervals"] > 0
    assert ref["gillis-state/interval"]["wait_intervals"] > 0 or \
        ref["gillis-state/interval"]["response_intervals"] > 1.0
