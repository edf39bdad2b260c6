"""Interval telemetry and the run ledger of the port.

  * **series parity** — the interval program's (G, T, C) series
    (``telemetry="interval"``) matches the live JAX driver's on the same
    grids at rtol 1e-9, column by column, for every engine family
    (static, UCB MAB, UCB MAB + DASO, the random+daso arm, the training
    loop with DASO finetuning, Gillis); the JAX driver runs in a child
    interpreter (``_torch_ref``) in JAX's non-partitionable threefry mode.
    The train family's window loss, a forward of the finetuned float32 θ,
    is held at θ's rtol 1e-6 (``test_torch_train_sim``);
  * **zero perturbation** — an interval run's summary scalars equal the
    summary run's, and its ``n_fin`` / ``energy_j`` columns sum to the
    totals;
  * **percentile bound** — the binned p50/p95/p99 sit within
    ``percentile_err_s`` of the host oracle's exact percentiles;
  * **entry points** — ``run_trace(backend="torch",
    telemetry="interval")`` returns the series, ``run_grid_batched`` keeps
    only the scalar percentile fields, and a bad knob raises;
  * **ledger** — spans nest, the JSONL dump round-trips and
    ``tools/obs_report.py`` renders it; the default ledger records
    nothing; span starts are ``perf_counter`` readings; ``sync=`` runs
    only while recording; the provenance stamp's keys; the kernel
    libraries' build and load counters.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

from _torch_ref import MAB_LITERAL, MAB_LITERAL_JAX, ROOT, run_reference
from repro_torch.core import daso
from repro_torch.env import torchsim
from repro_torch.env.metrics import TELEMETRY_COLS
from repro_torch.env.torchsim import engines
from repro_torch.env.workload import COMPRESSED, LAYER

RTOL, THETA_RTOL = 1e-9, 1e-6
#: family -> (λ, seeds, T, substeps); every family is a G=2 grid
FAMILIES = {"static": (5.0, (0, 1), 8, 4),
            "deploy": (5.0, (3, 4), 6, 3),
            "deploy-daso": (6.0, (1, 2), 6, 3),
            "random+daso": (7.0, (5, 6), 6, 3),
            "trained": (6.0, (2, 3), 8, 3),
            "gillis": (5.0, (2, 3), 8, 3)}
DASO_CFG = dict(num_workers=50, max_containers=8, state_features=4,
                hidden=16, depth=2, place_iters=8, lr_place=20.0)
TRAIN_HP = (0.5, 0.5, 2, 2, 1)
ENGINE_COLS = {"static": (), "deploy": engines.MAB_TELEMETRY_COLS,
               "deploy-daso": engines.MAB_TELEMETRY_COLS,
               "random+daso": (),
               "trained": engines.TRAIN_DASO_TELEMETRY_COLS,
               "gillis": engines.GILLIS_TELEMETRY_COLS}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These cases are many small CPU ops: one intra-op thread runs them
    about as fast and leaves the other cores to parallel test workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _theta_np():
    rng = np.random.RandomState(5)
    cfg = daso.DASOConfig(**DASO_CFG)
    dims = [daso.feature_size(cfg)] + [cfg.hidden] * cfg.depth + [1]
    return [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
                np.float32),
             "b": (0.01 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def _traces(family, ts):
    """The family's grid of compiled traces, from the ``ts`` module
    (``repro.env.jaxsim`` or ``repro_torch.env.torchsim``)."""
    lam, seeds, T, S = FAMILIES[family]
    kw = dict(lam=lam, n_intervals=T, substeps=S)
    if family == "static":
        dec = ts.make_static_decider("bestfit-rr")
        return [ts.compile_trace(dec, seed=s, **kw) for s in seeds]
    if family == "gillis":
        return [ts.compile_trace_dual(seed=s, variants=(LAYER, COMPRESSED),
                                      **kw) for s in seeds]
    return [ts.compile_trace_dual(seed=s, **kw) for s in seeds]


def _run(family, ts, mab_state, theta, cfg, **kw):
    """The family's grid through ``ts``'s interval program."""
    trs = _traces(family, ts)
    daso_kw = dict(daso_theta=theta, daso_cfg=cfg)
    if family == "static":
        return ts.run_grid_arrays(trs, **kw)
    if family == "deploy":
        return ts.run_grid_arrays_learned(trs, mab_state, **kw)
    if family == "deploy-daso":
        return ts.run_grid_arrays_learned(trs, mab_state, **daso_kw, **kw)
    if family == "random+daso":
        return ts.run_grid_arrays_static_daso(trs, "random+daso", **daso_kw,
                                              **kw)
    if family == "trained":
        return ts.run_grid_arrays_trained(trs, mab_state, train_hp=TRAIN_HP,
                                          **daso_kw, **kw)
    return ts.run_grid_arrays_gillis(trs, **kw)


def _port(family, telemetry="interval"):
    return _run(family, torchsim, MAB_LITERAL, _theta_np(),
                daso.DASOConfig(**DASO_CFG), device="cpu",
                telemetry=telemetry)


REF_CODE = """
import json
import numpy as np
jax.config.update("jax_threefry_partitionable", False)
from repro.core import daso
from repro.env import jaxsim
from repro.env.workload import COMPRESSED, LAYER
arrs = np.load(OUT + ".theta.npz")
theta = [{"w": arrs[f"w{i}"], "b": arrs[f"b{i}"]} for i in range(3)]
cfg = daso.DASOConfig(**DASO_CFG)
res = {}
for family in FAMILIES:
    out = _run(family, jaxsim, MAB_STATE, theta, cfg, threads=1,
               telemetry="interval")
    res[family] = [{k: (np.asarray(v["series"]).tolist() if k == "telemetry"
                        else v) for k, v in s.items()
                    if k in ("telemetry",) or isinstance(v, (int, float))}
                   for s in out]
    for r, s in zip(res[family], out):
        r["cols"] = s["telemetry"]["cols"]
with open(OUT, "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import inspect
    out = tmp_path_factory.mktemp("ref_telemetry") / "series.json"
    np.savez(str(out) + ".theta.npz",
             **{f"{k}{i}": layer[k] for i, layer in enumerate(_theta_np())
                for k in ("w", "b")})
    consts = (f"FAMILIES = {FAMILIES!r}\nDASO_CFG = {DASO_CFG!r}\n"
              f"TRAIN_HP = {TRAIN_HP!r}\n")
    run_reference(MAB_LITERAL_JAX + "import numpy as np\n" + consts
                  + inspect.getsource(_traces) + inspect.getsource(_run)
                  + REF_CODE, out)
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_series_matches_jax_driver(ref, family):
    got = _port(family)
    assert len(got) == len(ref[family])
    for g, (mine, want) in enumerate(zip(got, ref[family])):
        ctx = f"{family} cell {g}"
        cols = mine["telemetry"]["cols"]
        assert cols == want["cols"] == list(TELEMETRY_COLS) + list(
            ENGINE_COLS[family]), ctx
        ms, ws = mine["telemetry"]["series"], np.asarray(want["telemetry"])
        assert ms.shape == ws.shape == (FAMILIES[family][2], len(cols)), ctx
        for i, col in enumerate(cols):
            rtol = THETA_RTOL if col == "daso_last_loss" else RTOL
            np.testing.assert_allclose(ms[:, i], ws[:, i], rtol=rtol,
                                       atol=0.0, err_msg=f"{ctx}: {col}")
        for k, v in want.items():
            if k in ("telemetry", "cols"):
                continue
            assert np.isclose(mine[k], v, rtol=RTOL, atol=0.0), \
                f"{ctx} {k}: port {mine[k]!r} jax {v!r}"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_interval_mode_preserves_summary(family):
    """Recording the series moves no summary scalar, and its columns sum
    to the totals."""
    off, on = _port(family, "summary"), _port(family, "interval")
    for g, (s, i) in enumerate(zip(off, on)):
        for k, v in s.items():
            if k == "daso_theta":
                for a, b in zip(v, i[k]):
                    for x in ("w", "b"):
                        np.testing.assert_array_equal(a[x], b[x])
            elif k == "gillis_q":
                np.testing.assert_array_equal(v, i[k])
            else:
                assert i[k] == v, f"{family} cell {g} {k}"
        series, cols = i["telemetry"]["series"], i["telemetry"]["cols"]
        assert np.isfinite(series).all()
        assert series[:, cols.index("n_fin")].sum() == i["tasks_completed"]
        np.testing.assert_allclose(
            series[:, cols.index("energy_j")].sum() / 3.6e9,
            i["energy_mwhr"], rtol=1e-12)
        assert series[:, cols.index("n_dropped")].sum() == i["dropped_tasks"]


@pytest.mark.parametrize("family", ["static", "deploy", "gillis"])
def test_percentiles_within_reported_bound(family):
    """The program's binned percentiles against the host oracle's exact
    ones (``percentile_err_s`` 0)."""
    tr = _traces(family, torchsim)[0]
    if family == "static":
        exact = torchsim.replay_trace_edgesim(tr, telemetry="interval")
    elif family == "deploy":
        exact = torchsim.replay_trace_edgesim_learned(tr, MAB_LITERAL,
                                                      telemetry="interval")
    else:
        exact = torchsim.replay_trace_edgesim_gillis(tr,
                                                     telemetry="interval")
    binned = _port(family)[0]
    assert exact["percentile_err_s"] == 0.0
    assert binned["percentile_err_s"] >= 0.0
    for q in (50, 95, 99):
        for m in ("response", "wait"):
            k = f"p{q}_{m}_s"
            assert abs(exact[k] - binned[k]) <= \
                binned["percentile_err_s"] + 1e-9, (k, exact[k], binned[k])


def test_masked_extremes_are_zero_without_finishers():
    """An interval where a cell finishes nothing logs 0.0 extremes there,
    while the other cell's extremes are its own finishers'."""
    tr = torchsim.compile_trace(torchsim.make_static_decider("bestfit-rr"),
                                lam=0.3, seed=1, n_intervals=6, substeps=3)
    busy = torchsim.compile_trace(torchsim.make_static_decider("bestfit-rr"),
                                  lam=8.0, seed=1, n_intervals=6, substeps=3)
    quiet, loud = torchsim.run_grid_arrays([tr, busy], device="cpu",
                                           telemetry="interval")
    cols = quiet["telemetry"]["cols"]
    for out in (quiet, loud):
        s = out["telemetry"]["series"]
        none = s[:, cols.index("n_fin")] == 0
        for c in ("resp_min", "resp_max", "wait_min", "wait_max"):
            assert np.all(s[none, cols.index(c)] == 0.0), c
        assert np.all(s[~none, cols.index("resp_min")] > 0.0)
    assert (quiet["telemetry"]["series"][:, 0] == 0).any()
    assert (loud["telemetry"]["series"][:, 0] > 0).any()


def test_engines_declare_their_columns():
    cfg = daso.DASOConfig(**DASO_CFG)
    assert engines.StaticEngine().telemetry_cols() == ()
    assert engines.MABTrainEngine((0.5, 0.3, 0.3, 0.1), TRAIN_HP, cfg) \
        .telemetry_cols()[-2:] == ("daso_win_fill", "daso_last_loss")
    assert engines.MABDeployEngine((0.5, 0.3, 0.3, 0.1), cfg) \
        .telemetry_cols() == engines.MAB_TELEMETRY_COLS


def test_run_trace_and_grid_entry_points():
    from repro_torch.launch.experiments import run_grid_batched, run_trace
    kw = dict(n_intervals=4, substeps=2, device="cpu")
    out = run_trace("gillis", backend="torch", telemetry="interval", **kw)
    assert out["telemetry"]["cols"][-3:] == list(
        engines.GILLIS_TELEMETRY_COLS)
    assert out["telemetry"]["series"].shape == (4, 21)
    assert "p99_response_s" in out and out["percentile_err_s"] >= 0.0
    recs = run_grid_batched("mab", seeds=(0, 1), telemetry="interval",
                            mab_state=MAB_LITERAL, **kw)
    base = run_grid_batched("mab", seeds=(0, 1), mab_state=MAB_LITERAL,
                            **kw)
    for r, b in zip(recs, base):
        assert "telemetry" not in r
        assert set(r) - set(b) == {f"p{q}_{m}_s" for q in (50, 95, 99)
                                   for m in ("response", "wait")} \
            | {"percentile_err_s"}
        assert all(r[k] == v for k, v in b.items())


def test_telemetry_knob_validation():
    from repro_torch.launch.experiments import run_grid_batched, run_trace
    tr = torchsim.compile_trace(torchsim.make_static_decider("mc"), lam=3.0,
                                seed=0, n_intervals=4, substeps=3)
    with pytest.raises(ValueError, match="telemetry"):
        torchsim.run_trace_arrays(tr, device="cpu", telemetry="everything")
    with pytest.raises(ValueError, match="telemetry"):
        run_grid_batched("mc", n_intervals=2, substeps=2, device="cpu",
                         telemetry="everything")
    with pytest.raises(ValueError, match="telemetry"):
        run_trace("mc", backend="torch", n_intervals=2, substeps=2,
                  device="cpu", telemetry="everything")


# ------------------------------------------------------------- the ledger


def _obs_report():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import obs_report
    finally:
        sys.path.pop(0)
    return obs_report


def test_ledger_round_trip_and_report(tmp_path):
    from repro_torch.kernels.build import cache_stats
    from repro_torch.obs import RunLedger, load_ledger_lines, use_ledger
    tr = torchsim.compile_trace(torchsim.make_static_decider("mc"), lam=3.0,
                                seed=0, n_intervals=4, substeps=3)
    led = RunLedger("round-trip")
    led.stamp(telemetry="interval")
    with use_ledger(led):
        out = torchsim.run_trace_arrays(tr, device="cpu",
                                        telemetry="interval")
        led.add_series("trace", out["telemetry"]["cols"],
                       out["telemetry"]["series"])
        led.add_cache_stats(cache_stats())
        led.count("unit_runs")
    path = tmp_path / "ledger.jsonl"
    led.dump(str(path))
    lines = load_ledger_lines(str(path))
    assert {"meta", "span", "counters", "cache_stats", "series"} <= \
        {ln["kind"] for ln in lines}
    spans = [ln for ln in lines if ln["kind"] == "span"]
    by_name = {s["name"]: s for s in spans}
    assert {"grid", "upload", "dispatch", "summarize"} <= set(by_name)
    for child in ("upload", "dispatch", "summarize"):
        assert by_name[child]["parent"] == by_name["grid"]["id"]
    ids = {s["id"] for s in spans}
    assert all(s["parent"] in ids for s in spans if s["parent"] is not None)
    text = _obs_report().render(lines)
    for section in ("== Span tree ==", "== Runner cache ==",
                    "== Series: trace ==", "percentiles (binned"):
        assert section in text, text


def test_ledger_scopes_and_default():
    from repro_torch.obs import RunLedger, get_ledger, use_ledger
    default = get_ledger()
    led = RunLedger("scoped")
    with use_ledger(led):
        assert get_ledger() is led
        with led.span("outer") as sid:
            with led.span("inner"):
                pass
    assert get_ledger() is default
    inner = [e for e in led.events if e.get("name") == "inner"][0]
    assert inner["parent"] == sid
    led.warn("careful", where="unit")
    assert led.warnings()[0]["message"] == "careful"
    with pytest.raises(ValueError, match="cols"):
        led.add_series("bad", ["a", "b"], np.zeros((3, 3)))


def test_default_ledger_records_nothing(monkeypatch):
    """The process-global ledger keeps no span, counter or warning, and
    its spans read no clock and yield None."""
    from repro_torch.obs import get_ledger
    from repro_torch.obs import ledger as ledger_mod
    led = get_ledger()
    assert not led.recording

    def no_clock():
        raise AssertionError("an off span read the clock")

    monkeypatch.setattr(ledger_mod.time, "perf_counter", no_clock)
    with led.span("outer", sync=None, where="unit") as sid:
        assert sid is None
        with led.span("inner"):
            led.count("calls")
            led.count("bytes", 64)
        led.warn("unheard")
    assert led.events == [] and led.counters == {}
    assert led.current_span() is None


def test_span_starts_on_the_perf_counter():
    """A scoped ledger's span starts are ``time.perf_counter`` readings:
    a reading taken inside a span lies within its [start, start + dur]."""
    import time

    from repro_torch.obs import RunLedger, use_ledger
    led = RunLedger("clock")
    inside = []
    with use_ledger(led):
        with led.span("outer"):
            inside.append(time.perf_counter())
            with led.span("inner"):
                inside.append(time.perf_counter())
    spans = {e["name"]: e for e in led.events}
    for name, t in zip(("outer", "inner"), inside):
        e = spans[name]
        assert e["start_s"] <= t <= e["start_s"] + e["dur_s"], (name, e, t)
    assert spans["outer"]["start_s"] <= spans["inner"]["start_s"]


def test_span_sync_only_when_recording(monkeypatch):
    """``sync=`` synchronizes a CUDA device once at the span's end while
    recording, and never off recording or on the CPU."""
    import torch

    from repro_torch.obs import RunLedger, get_ledger
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    with get_ledger().span("off", sync=card):
        pass
    assert calls == []
    led = RunLedger("sync")
    with led.span("on", sync=card):
        assert calls == []
    assert calls == [card]
    with led.span("cpu", sync=cpu):
        pass
    assert calls == [card]
    assert [e["name"] for e in led.events] == ["on", "cpu"]


def test_provenance_stamp_keys():
    from repro_torch.obs import provenance_stamp
    st = provenance_stamp(telemetry="interval")
    for k in ("torch_version", "cuda_version", "backend", "device_count",
              "device_kind", "cpu_count", "gpu"):
        assert k in st, st
    assert "jax_version" not in st
    assert st["telemetry"] == "interval"
    assert json.dumps(st)
    import torch
    if not torch.cuda.is_available():
        assert st["backend"] == "cpu" and st["gpu"] is None


def test_kernel_library_counters(tmp_path, monkeypatch):
    """Builds, loads and hits of the kernel libraries, with a stand-in
    compiler that writes a shared library (torch's own) where nvcc would:
    one build span, one miss, then hits."""
    import shutil
    from pathlib import Path

    import torch

    from repro_torch.kernels import build
    from repro_torch.obs import RunLedger, use_ledger
    lib = next(Path(torch.__file__).parent.joinpath("lib").glob(
        "libc10.so*"))
    fake = tmp_path / "fake_nvcc.py"
    fake.write_text("import shutil, sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    f"shutil.copy({str(lib)!r}, out)\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: sys.executable)
    monkeypatch.setattr(build, "NVCC_FLAGS", (str(fake),))
    libs = build.KernelLibraries()
    led = RunLedger("build")
    with use_ledger(led):
        libs.get("threefry")
        libs.get("threefry")
        libs.get("threefry")
    stats = libs.cache_stats()
    assert (stats["hits"], stats["misses"], stats["size"]) == (2, 1, 1)
    (name, builds), = stats["keys"].items()
    assert name.startswith("libthreefry-") and builds == 1
    assert [e["name"] for e in led.events if e["kind"] == "span"] == \
        ["kernel_build"]
    # a second process finds the library built: a load, no compile
    again = build.KernelLibraries()
    again.get("threefry")
    assert list(again.cache_stats()["keys"].values()) == [0]
    shutil.rmtree(tmp_path / "_build")


def test_kernel_library_builds_parts_and_links(tmp_path, monkeypatch):
    """A source in ``build.PARTS`` compiles as one object per part, each
    with its ``-DFLASH_PART`` and ``-c`` (no ``-shared``), started
    together, then one link of those objects into the library, which
    loads; the objects are removed.  A stand-in compiler logs its
    arguments and writes torch's own shared library where the link's
    output goes."""
    import json
    from pathlib import Path

    import torch

    from repro_torch.kernels import build
    lib = next(Path(torch.__file__).parent.joinpath("lib").glob(
        "libc10.so*"))
    calls = tmp_path / "calls.jsonl"
    fake = tmp_path / "fake_nvcc.py"
    fake.write_text(
        "import json, shutil, sys\n"
        f"open({str(calls)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "if '-c' in sys.argv:\n"
        "    open(out, 'w').write('object')\n"
        "else:\n"
        f"    shutil.copy({str(lib)!r}, out)\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: sys.executable)
    monkeypatch.setattr(build, "NVCC_FLAGS", (str(fake), "-shared", "-O3"))
    assert build.PARTS == {"flash_attention": 2}
    libs = build.KernelLibraries()
    libs.get("flash_attention")
    argvs = [json.loads(line) for line in calls.read_text().splitlines()]
    parts, link = argvs[:2], argvs[2]
    assert len(argvs) == 3
    objs = []
    for i, argv in enumerate(sorted(parts, key=lambda a: a[1])):
        assert argv[:3] == ["-O3", f"-DFLASH_PART={i}", "-c"]
        assert "-shared" not in argv
        assert argv[-1].endswith("flash_attention.cu")
        objs.append(argv[argv.index("-o") + 1])
    assert "-shared" in link and link[-2:] == objs
    assert not any(Path(o).exists() for o in objs)
    (name,) = libs.cache_stats()["keys"]
    assert name.startswith("libflash_attention-")
    # the parts are in the library's name: another split is another library
    before = build._lib_path("flash_attention")
    monkeypatch.setattr(build, "PARTS", {})
    assert build._lib_path("flash_attention") != before
