"""The port's streaming serve driver (``repro_torch.env.torchsim.stream``)
on the CPU.

The JAX reference runs once, in one child interpreter (``_torch_ref``,
JAX's non-partitionable threefry), and writes every result these tests
hold the port against:

  * ``chunk_tapes`` of one compiled trace equal the reference's byte for
    byte, remainder chunk included; a chunk length below 1 raises;
  * ``StreamFeeder``: three consecutive ``next_chunk`` tapes equal the
    reference feeder's byte for byte, static (``mc``) and dual (the MAB's
    and Gillis's variants), with the admission counters; a narrow tape
    overflows and counts as the reference counts; "exactly one of
    ``decider=`` / ``variants=``" raises;
  * chunked replay (12 intervals in chunks of 5) equals the port's
    one-shot ``run_trace_engine`` exactly (bitwise on the CPU), summary
    and interval series, for the static, MAB deploy, ``splitplace`` (θ
    given to both sides as NumPy, ``lr_place`` 20, where rows move) and
    Gillis engines; and the reference's ``replay_stream`` at rtol 1e-9 /
    atol 1e-9 (the hooks see the absolute interval index, or the Gillis
    draws would differ);
  * ``serve``: the reference's three admission cases (balanced, a narrow
    tape, a ring of 8 slots) and Gillis equal the reference's reports on
    every counter and within rtol 1e-9 on the summary and the rolling
    snapshot, every admission identity holding; a feeder that raises is
    re-raised in the caller;
  * the carry stays on the runner's device and keeps its shapes, and
    ``run_chunk`` refuses a carry that does not; ``RollingMetrics`` on a
    fixed series equals the reference's snapshot;
  * the entry points: ``run_stream`` for every streamed policy and
    ``python -m repro_torch.launch.serve --stream`` on the CPU, and the
    default ``device="cuda"`` raising without a card.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from _torch_ref import MAB_LITERAL, MAB_LITERAL_JAX, run_reference
from repro_torch.core import daso
from repro_torch.env import torchsim
from repro_torch.env.metrics import TELEMETRY_COLS
from repro_torch.env.torchsim import driver, engines, stream
from repro_torch.env.workload import COMPRESSED, LAYER

RTOL, ATOL = 1e-9, 1e-9
#: the reference's own chunked-replay rule (tests/test_stream.py)
REF_RTOL = 1e-4
#: replay cases: (λ, seed, T, substeps), in chunks of CHUNK
REPLAY = {"static": (4.0, 0, 12, 4), "mab": (4.0, 3, 12, 4),
          "splitplace": (4.0, 1, 12, 4), "gillis": (4.0, 2, 12, 4)}
CHUNK = 5
DASO_CFG = dict(num_workers=50, max_containers=16, state_features=4,
                hidden=32, depth=2, place_iters=12, lr_place=20.0)
#: feeder cases: the policy whose feeder keywords each uses
FEEDERS = ("mc", "mab", "gillis")
FEED = dict(lam=4.0, seed=0, interval_s=300.0, substeps=4)
FEED_CHUNKS, FEED_T = 3, 5
#: serve cases: (policy, serve keywords, feeder keywords)
SERVE = {"balanced": ("mc", dict(max_active=128), {}),
         "narrow_tape": ("mc", dict(max_active=128), dict(max_arrivals=3)),
         "small_ring": ("mc", dict(max_active=8), {}),
         "gillis": ("gillis", dict(max_active=128), {})}
SERVE_KW = dict(chunk_intervals=6, target_tasks=150, window_intervals=24)
SERVE_FEED = dict(lam=6.0, seed=0, interval_s=300.0, substeps=3)
ROLLING = dict(T=30, window=16, seed=11)
COUNTERS = ("n_chunks", "n_intervals", "offered", "fed", "feeder_overflow",
            "dropped", "admitted", "finished", "live", "capacity",
            "chunk_intervals", "window_intervals")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small CPU ops: one intra-op thread runs them about as fast and
    leaves the other cores to parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _theta_np():
    rng = np.random.RandomState(0)
    cfg = daso.DASOConfig(**DASO_CFG)
    dims = [daso.feature_size(cfg)] + [cfg.hidden] * cfg.depth + [1]
    return [{"w": (rng.randn(a, b) / np.sqrt(a)).astype(np.float32),
             "b": (0.1 * rng.randn(b)).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def _rolling_series():
    """A fixed (T, 21) series in the Gillis engine's column layout."""
    rng = np.random.RandomState(ROLLING["seed"])
    s = rng.uniform(0.0, 50.0, (ROLLING["T"], len(TELEMETRY_COLS) + 3))
    s[:, 0] = rng.randint(0, 6, ROLLING["T"])
    s[:3, 0] = 0.0
    return s


REF_CODE = """
import json
import numpy as np
jax.config.update("jax_threefry_partitionable", False)
from repro.core import daso
from repro.env import jaxsim
from repro.env.jaxsim import arrays, driver, engines, stream
from repro.env.metrics import TELEMETRY_COLS
from repro.env.workload import COMPRESSED, LAYER

def plain(x):
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x

res, arrs = {}, {}
lam, seed, T, S = REPLAY["static"]
tr = jaxsim.compile_trace(jaxsim.make_static_decider("bestfit-rr"), lam=lam,
                          seed=seed, n_intervals=T, substeps=S)
for t0, leaves in arrays.chunk_tapes(tr, CHUNK):
    for k, v in leaves.items():
        arrs[f"chunk/{t0}/{k}"] = v
for label in FEEDERS:
    for kw in ({}, {"max_arrivals": 3}):
        tag = label + ("/narrow" if kw else "")
        f = stream.StreamFeeder(**FEED, **kw,
                                **stream.make_stream_policy(label)[2])
        for i in range(FEED_CHUNKS):
            for k, v in f.next_chunk(FEED_T).items():
                arrs[f"feed/{tag}/{i}/{k}"] = v
        res[f"feed/{tag}"] = [f.offered, f.fed, f.overflow]

cfg = daso.DASOConfig(**DASO_CFG)
theta = _theta_np()
for name, (lam, seed, T, S) in REPLAY.items():
    kw = dict(lam=lam, seed=seed, n_intervals=T, substeps=S)
    if name == "static":
        tr = jaxsim.compile_trace(jaxsim.make_static_decider("bestfit-rr"),
                                  **kw)
        eng, es0 = engines.StaticEngine(), ()
    elif name == "gillis":
        tr = jaxsim.compile_trace_dual(variants=(LAYER, COMPRESSED), **kw)
        eng = engines.GillisEngine(gillis_hp=tuple(driver.GILLIS_HP))
        es0 = driver._gillis_es(None, driver.trace_train_key(seed), 3,
                                driver.GILLIS_HP[0])
    else:
        tr = jaxsim.compile_trace_dual(**kw)
        c = cfg if name == "splitplace" else None
        eng = engines.MABDeployEngine(mab_hp=tuple(driver.MAB_HP),
                                      daso_cfg=c)
        # the reference donates the carry: each run gets its own copy
        es0 = driver._deploy_es(jax.tree_util.tree_map(jnp.copy, MAB_STATE),
                                theta if c else ())
    res[f"replay/{name}"] = plain(stream.replay_stream(
        eng, tr, es0, chunk_intervals=CHUNK, collect_series=True))

for name, (policy, skw, fkw) in SERVE.items():
    eng, es0, pkw = stream.make_stream_policy(policy)
    feeder = stream.StreamFeeder(**SERVE_FEED, **fkw, **pkw)
    res[f"serve/{name}"] = plain(stream.serve(eng, es0, feeder, **SERVE_KW,
                                              **skw))

cols = tuple(TELEMETRY_COLS) + tuple(engines.GillisEngine(
    gillis_hp=tuple(driver.GILLIS_HP)).telemetry_cols())
rm = stream.RollingMetrics(cols, ROLLING["window"], 300.0)
series = _rolling_series()
rm.update(series[:7])
res["rolling/part"] = plain(rm.snapshot())
rm.update(series[7:])
res["rolling/full"] = plain(rm.snapshot())
res["rolling/empty"] = plain(stream.RollingMetrics(cols, 4, 300.0)
                             .snapshot())
np.savez(OUT + ".npz", **arrs)
with open(OUT, "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import inspect
    out = tmp_path_factory.mktemp("ref_stream") / "stream.json"
    consts = "".join(f"{k} = {v!r}\n" for k, v in dict(
        REPLAY=REPLAY, CHUNK=CHUNK, DASO_CFG=DASO_CFG, FEEDERS=FEEDERS,
        FEED=FEED, FEED_CHUNKS=FEED_CHUNKS, FEED_T=FEED_T, SERVE=SERVE,
        SERVE_KW=SERVE_KW, SERVE_FEED=SERVE_FEED, ROLLING=ROLLING).items())
    run_reference(MAB_LITERAL_JAX + "import numpy as np\n"
                  + "from repro.core import daso\n"
                  + "from repro.env.metrics import TELEMETRY_COLS\n" + consts
                  + inspect.getsource(_theta_np)
                  + inspect.getsource(_rolling_series) + REF_CODE, out)
    with open(out) as f:
        res = json.load(f)
    with np.load(str(out) + ".npz") as z:
        res["arrays"] = {k: z[k] for k in z.files}
    return res


def _close(got, want, ctx, rtol=RTOL, atol=ATOL):
    """Every key of the reference's summary (or snapshot): ints and bools
    equal, floats and arrays within rtol / atol, the series too."""
    assert set(got) == set(want), (ctx, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if k == "telemetry":
            assert g["cols"] == w["cols"], ctx
            np.testing.assert_allclose(g["series"], np.asarray(w["series"]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{ctx}: series")
        elif isinstance(w, list):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), rtol=rtol,
                                       atol=atol, err_msg=f"{ctx}: {k}")
        elif isinstance(w, float):
            assert np.isclose(g, w, rtol=rtol, atol=atol), \
                f"{ctx}: {k} port {g!r} reference {w!r}"
        else:
            assert g == w, f"{ctx}: {k} port {g!r} reference {w!r}"


def _replay_case(name):
    """The port's (engine, es0, trace) of a replay case."""
    lam, seed, T, S = REPLAY[name]
    kw = dict(lam=lam, seed=seed, n_intervals=T, substeps=S)
    if name == "static":
        tr = torchsim.compile_trace(
            torchsim.make_static_decider("bestfit-rr"), **kw)
        return engines.StaticEngine(), (lambda G, dev: {}), tr
    if name == "gillis":
        tr = torchsim.compile_trace_dual(variants=(LAYER, COMPRESSED), **kw)
        return (engines.GillisEngine(gillis_hp=tuple(driver.GILLIS_HP)),
                driver._gillis_es([seed], None, 3, driver.GILLIS_HP[0]), tr)
    tr = torchsim.compile_trace_dual(**kw)
    cfg = daso.DASOConfig(**DASO_CFG) if name == "splitplace" else None
    return (engines.MABDeployEngine(mab_hp=tuple(driver.MAB_HP),
                                    daso_cfg=cfg),
            driver._deploy_es(MAB_LITERAL, _theta_np() if cfg else ()), tr)


def _replay(name):
    eng, es0, tr = _replay_case(name)
    return stream.replay_stream(eng, tr, es0, chunk_intervals=CHUNK,
                                collect_series=True, device="cpu")


def _check_ledger(rep):
    assert rep["offered"] == rep["fed"] + rep["feeder_overflow"], rep
    assert rep["admitted"] == rep["fed"] - rep["dropped"], rep
    assert rep["admitted"] == rep["finished"] + rep["live"], rep


def _serve(name, feeder=None):
    policy, skw, fkw = SERVE[name]
    eng, es0, pkw = stream.make_stream_policy(policy)
    feeder = feeder or stream.StreamFeeder(**SERVE_FEED, **fkw, **pkw)
    return stream.serve(eng, es0, feeder, device="cpu", **SERVE_KW, **skw)


# ------------------------------------------------------------ chunk tapes


def test_chunk_tapes_equal_reference(ref):
    lam, seed, T, S = REPLAY["static"]
    tr = torchsim.compile_trace(torchsim.make_static_decider("bestfit-rr"),
                                lam=lam, seed=seed, n_intervals=T,
                                substeps=S)
    got = list(torchsim.chunk_tapes(tr, CHUNK))
    assert [t0 for t0, _ in got] == [0, 5, 10]
    assert [int(lv["valid"].shape[0]) for _, lv in got] == [5, 5, 2]
    want = ref["arrays"]
    n = 0
    for t0, leaves in got:
        for k, v in leaves.items():
            w = want[f"chunk/{t0}/{k}"]
            assert v.dtype == w.dtype and v.shape == w.shape, (t0, k)
            assert v.tobytes() == w.tobytes(), (t0, k)
            n += 1
    assert n == sum(1 for k in want if k.startswith("chunk/"))


def test_chunk_tapes_validation():
    tr = torchsim.compile_trace(torchsim.make_static_decider("mc"), lam=3.0,
                                seed=0, n_intervals=4, substeps=2)
    with pytest.raises(ValueError, match="chunk_intervals"):
        list(torchsim.chunk_tapes(tr, 0))
    whole = list(torchsim.chunk_tapes(tr, 10))
    assert len(whole) == 1 and whole[0][0] == 0
    for k, v in tr.kernel_dict().items():
        assert np.array_equal(whole[0][1][k], v), k


# ---------------------------------------------------------------- feeder


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("label", FEEDERS)
def test_feeder_tapes_byte_equal_reference(ref, label, narrow):
    kw = {"max_arrivals": 3} if narrow else {}
    tag = label + ("/narrow" if narrow else "")
    f = stream.StreamFeeder(**FEED, **kw,
                            **stream.make_stream_policy(label)[2])
    want = ref["arrays"]
    for i in range(FEED_CHUNKS):
        tape = f.next_chunk(FEED_T)
        keys = {k.split("/")[-1] for k in want
                if k.startswith(f"feed/{tag}/{i}/")}
        assert set(tape) == keys, (tag, i)
        for k, v in tape.items():
            w = want[f"feed/{tag}/{i}/{k}"]
            assert v.dtype == w.dtype and v.shape == w.shape, (tag, i, k)
            assert v.tobytes() == w.tobytes(), (tag, i, k)
    assert [f.offered, f.fed, f.overflow] == ref[f"feed/{tag}"]
    assert f.offered == f.fed + f.overflow
    assert f.n_intervals == FEED_CHUNKS * FEED_T
    assert (f.overflow > 0) == narrow


def test_feeder_takes_exactly_one_source():
    with pytest.raises(ValueError, match="exactly one"):
        stream.StreamFeeder()
    with pytest.raises(ValueError, match="exactly one"):
        stream.StreamFeeder(decider=torchsim.make_static_decider("mc"),
                            variants=engines.MAB_VARIANTS)


# ---------------------------------------------------------------- replay


@pytest.mark.parametrize("name", sorted(REPLAY))
def test_replay_equals_one_shot_exactly(name):
    """Chunks of 5 over 12 intervals (a remainder chunk of 2) run the
    one-shot program's launches in its order: bitwise equal on the CPU,
    the interval series included."""
    eng, es0, tr = _replay_case(name)
    one = driver.run_trace_engine(eng, tr, es0, device="cpu",
                                  telemetry="interval")
    got = _replay(name)
    assert set(got) == set(one)
    for k, v in one.items():
        if k == "telemetry":
            assert got[k]["cols"] == v["cols"]
            assert got[k]["series"].tobytes() == v["series"].tobytes()
        elif isinstance(v, np.ndarray):
            assert got[k].tobytes() == v.tobytes(), k
        else:
            assert got[k] == v, (k, got[k], v)
    assert one["tasks_completed"] > 0


def test_replay_summary_mode_equals_one_shot():
    """Without ``collect_series`` the replay's summary is the one-shot
    summary run's, key for key."""
    eng, es0, tr = _replay_case("mab")
    one = driver.run_trace_engine(eng, tr, es0, device="cpu")
    got = stream.replay_stream(eng, tr, es0, chunk_intervals=CHUNK,
                               device="cpu")
    assert got == one


def test_splitplace_replay_moves_rows_off_bestfit():
    """At ``lr_place`` 20 the ascent moves placements: the splitplace
    replay differs from the same MAB placed by BestFit."""
    _, es0, tr = _replay_case("splitplace")
    bestfit = stream.replay_stream(
        engines.MABDeployEngine(mab_hp=tuple(driver.MAB_HP)), tr,
        driver._deploy_es(MAB_LITERAL, ()), chunk_intervals=CHUNK,
        device="cpu")
    got = _replay("splitplace")
    assert any(got[k] != bestfit[k] for k in ("reward", "energy_mwhr",
                                              "response_intervals"))


@pytest.mark.parametrize("name", sorted(REPLAY))
def test_replay_matches_reference(ref, name):
    """The port's chunked replay against the reference's, at the port's
    driver contract (rtol 1e-9 / atol 1e-9) and so at the reference's own
    1e-4 rule; Gillis fails both with a chunk-local interval index."""
    got, want = _replay(name), ref[f"replay/{name}"]
    _close(got, want, f"replay {name}")
    _close(got, want, f"replay {name} (1e-4)", rtol=REF_RTOL)


def test_replay_sees_the_absolute_interval():
    """A hook reading the chunk-local index instead desyncs the Gillis
    draws: the replay then differs from the one-shot run."""
    eng, es0, tr = _replay_case("gillis")
    one = driver.run_trace_engine(eng, tr, es0, device="cpu")

    class LocalT(engines.GillisEngine):
        def decide(self, es, trace, t):
            local = {k: _Local(v) for k, v in trace.items()}
            return super().decide(es, local, t % CHUNK)

    class _Local:
        def __init__(self, leaf):
            self.leaf = leaf

        def __getitem__(self, idx):
            return self.leaf.arr[idx]

    wrong = stream.replay_stream(LocalT(gillis_hp=eng.gillis_hp), tr, es0,
                                 chunk_intervals=CHUNK, device="cpu")
    assert np.any(wrong["gillis_q"] != one["gillis_q"]) or \
        wrong["reward"] != one["reward"]


# ----------------------------------------------------------------- serve


@pytest.mark.parametrize("name", sorted(SERVE))
def test_serve_matches_reference(ref, name):
    got, want = _serve(name), ref[f"serve/{name}"]
    _check_ledger(got)
    assert set(got) == set(want)
    for k in COUNTERS:
        assert got[k] == want[k], (name, k, got[k], want[k])
    for k in ("max_occupancy", "occupancy_mean_first_half",
              "occupancy_mean_second_half"):
        assert np.isclose(got[k], want[k], rtol=RTOL, atol=ATOL), k
    assert got["engine"] == want["engine"]
    _close(got["summary"], want["summary"], f"serve {name} summary")
    _close(got["rolling"], want["rolling"], f"serve {name} rolling")


def test_serve_admission_cases():
    """The reference's three admission cases: balanced (nothing dropped),
    a narrow tape (host overflow counted), a ring of 8 slots (device drops
    counted, occupancy capped); the ledger balances in each."""
    bal, narrow, ring = (_serve(n) for n in ("balanced", "narrow_tape",
                                             "small_ring"))
    for rep in (bal, narrow, ring):
        _check_ledger(rep)
    assert bal["feeder_overflow"] == 0 and bal["dropped"] == 0
    assert bal["finished"] > 0 and bal["rolling"]["qps"] > 0
    assert 0 <= bal["rolling"]["violation_rate"] <= 1
    assert narrow["feeder_overflow"] > 0
    assert ring["dropped"] > 0 and ring["max_occupancy"] <= 8
    assert bal["offered"] >= SERVE_KW["target_tasks"]
    assert bal["n_intervals"] == bal["n_chunks"] * SERVE_KW["chunk_intervals"]


def test_serve_is_deterministic():
    """The feeder alone decides when to stop: a run whose threads switch
    every microsecond, with a one-deep queue, gives the same report."""
    import sys
    a = _serve("gillis")
    policy, skw, _ = SERVE["gillis"]
    eng, es0, pkw = stream.make_stream_policy(policy)
    feeder = stream.StreamFeeder(**SERVE_FEED, **pkw)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        b = stream.serve(eng, es0, feeder, device="cpu", prefetch=1,
                         **SERVE_KW, **skw)
    finally:
        sys.setswitchinterval(old)
    assert a["summary"]["gillis_q"].tobytes() == \
        b["summary"]["gillis_q"].tobytes()
    a["summary"].pop("gillis_q"), b["summary"].pop("gillis_q")
    assert a == b


def test_serve_reraises_a_feeder_failure():
    class Boom(RuntimeError):
        pass

    class FailingFeeder(stream.StreamFeeder):
        def next_chunk(self, n_intervals):
            if self.n_intervals >= 2 * n_intervals:
                raise Boom("feeder failed")
            return super().next_chunk(n_intervals)

    policy, skw, fkw = SERVE["balanced"]
    eng, es0, pkw = stream.make_stream_policy(policy)
    feeder = FailingFeeder(**SERVE_FEED, **pkw)
    with pytest.raises(Boom, match="feeder failed"):
        stream.serve(eng, es0, feeder, device="cpu", **SERVE_KW, **skw)


def test_serve_records_its_spans():
    from repro_torch.obs import RunLedger, use_ledger
    led = RunLedger("stream")
    with use_ledger(led):
        rep = _serve("balanced")
    spans = [e for e in led.events if e["kind"] == "span"]
    serving, = [e for e in spans if e["name"] == "serve"]
    feeds = [e for e in spans if e["name"] == "feed"]
    chunks = [e for e in spans if e["name"] == "stream_chunk"]
    assert len(chunks) == rep["n_chunks"] == len(feeds)
    assert all(e["parent"] == serving["id"] for e in feeds + chunks)
    assert [e["attrs"]["t0"] for e in chunks] == [
        i * SERVE_KW["chunk_intervals"] for i in range(rep["n_chunks"])]
    assert all(e["start_s"] >= 0.0 for e in spans)


# ----------------------------------------------------------------- carry


def _runner(**kw):
    eng, es0, pkw = stream.make_stream_policy("gillis")
    feeder = stream.StreamFeeder(**SERVE_FEED, **pkw)
    r = stream.StreamRunner(eng, es0, interval_s=feeder.interval_s,
                            substeps=feeder.substeps, max_active=64,
                            device="cpu", **kw)
    return r, feeder


def test_carry_stays_on_device_with_its_shapes():
    r, feeder = _runner()
    layouts = []
    for _ in range(3):
        series = r.run_chunk(feeder.next_chunk(4))
        assert series.shape == (4, len(r.tcols))
        leaves = list(stream._carry_leaves(r.carry))
        assert leaves and all(v.device == r.device for v in leaves)
        layouts.append([(tuple(v.shape), v.dtype) for v in leaves])
    assert layouts[0] == layouts[1] == layouts[2]
    assert r.t0 == 12 and r.n_chunks == 3


@pytest.mark.parametrize("fault", ["device", "shape"])
def test_run_chunk_refuses_a_moved_or_reshaped_carry(monkeypatch, fault):
    r, feeder = _runner()
    r.run_chunk(feeder.next_chunk(4))
    real = driver.run_chunk

    def faulty(*a, **k):
        (state, acc, es), series = real(*a, **k)
        es = dict(es)
        es["eps"] = es["eps"].to("meta") if fault == "device" else \
            es["eps"].repeat(2)
        return (state, acc, es), series

    monkeypatch.setattr(driver, "run_chunk", faulty)
    with pytest.raises(AssertionError,
                       match="left" if fault == "device" else "shapes"):
        r.run_chunk(feeder.next_chunk(4))


def test_rolling_metrics_match_reference(ref):
    cols = tuple(TELEMETRY_COLS) + engines.GILLIS_TELEMETRY_COLS
    rm = stream.RollingMetrics(cols, ROLLING["window"], 300.0)
    series = _rolling_series()
    rm.update(series[:7])
    _close(rm.snapshot(), ref["rolling/part"], "rolling part")
    rm.update(series[7:])
    assert len(rm.window) == ROLLING["window"]
    _close(rm.snapshot(), ref["rolling/full"], "rolling full")
    _close(stream.RollingMetrics(cols, 4, 300.0).snapshot(),
           ref["rolling/empty"], "rolling empty")


# ----------------------------------------------------------- entry points


STREAM_POLICIES = ("mc", "bestfit-rr", "mab", "splitplace", "mab+gobi",
                   "gillis")


@pytest.mark.parametrize("policy", STREAM_POLICIES)
def test_run_stream_on_the_cpu(policy):
    from repro_torch.launch.experiments import run_stream
    kw = {}
    if policy in ("splitplace", "mab+gobi"):
        kw = dict(mab_state=MAB_LITERAL, daso_theta=_theta_np(),
                  daso_cfg=daso.DASOConfig(**DASO_CFG))
    rep = run_stream(policy, lam=4.0, seed=1, target_tasks=60,
                     chunk_intervals=4, max_active=96, substeps=3,
                     window_intervals=8, device="cpu", **kw)
    _check_ledger(rep)
    assert (rep["policy"], rep["lam"], rep["seed"]) == (policy, 4.0, 1)
    assert rep["offered"] >= 60 and rep["finished"] > 0
    assert rep["summary"]["dropped_tasks"] == rep["dropped"] == 0
    assert 0.0 <= rep["summary"]["reward"] <= 1.0


def test_run_stream_continues_pretrain_state():
    from repro_torch.launch.experiments import PretrainState, run_stream
    st = PretrainState(mab_state=MAB_LITERAL)
    kw = dict(lam=4.0, seed=1, target_tasks=40, chunk_intervals=4,
              max_active=96, substeps=3, device="cpu")
    warm = run_stream("mab", pretrain_state=st, **kw)
    cold = run_stream("mab", **kw)
    assert warm["summary"]["mab_t"] == cold["summary"]["mab_t"] + 39
    with pytest.raises(ValueError, match="unknown streaming policy"):
        run_stream("random+daso", **kw)


def test_serve_stream_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve
    rep = serve.main(["--stream", "--device", "cpu", "--policy", "gillis",
                      "--tasks", "80", "--chunk", "4", "--substeps", "3",
                      "--capacity", "96", "--report-every", "2"])
    out = capsys.readouterr().out
    assert "chunk     2  intervals=      8" in out
    assert f"served {rep['finished']} tasks over {rep['n_intervals']} " \
        f"intervals ({rep['n_chunks']} chunks of 4)" in out
    assert "admission: offered=" in out and "occupancy: max=" in out
    assert "summary: reward=" in out


@pytest.mark.parametrize("entry", ["run_stream", "StreamRunner", "serve",
                                   "replay_stream"])
def test_stream_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.launch.experiments import run_stream
    eng, es0, pkw = stream.make_stream_policy("mc")
    feeder = stream.StreamFeeder(**SERVE_FEED, **pkw)
    calls = {
        "run_stream": lambda: run_stream("mc", target_tasks=10),
        "StreamRunner": lambda: stream.StreamRunner(
            eng, es0, interval_s=300.0, substeps=3, max_active=8),
        "serve": lambda: stream.serve(eng, es0, feeder, target_tasks=10),
        "replay_stream": lambda: stream.replay_stream(
            eng, _replay_case("static")[2], es0, chunk_intervals=4),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
