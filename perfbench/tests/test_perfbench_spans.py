"""The engine's spans and counters as the harness reads them
(``perfbench/harness/spans.py``): a run leaves every ledger empty unless
one is opened around it; under a ``RequestLedger`` the per-request parts
of a traced run sum to ``engine_host_ms``; the program's spans label the
device's idle gaps."""
import math

from repro_torch.obs import RunLedger, get_ledger, use_ledger

from perfbench.harness.main import run_cell
from perfbench.harness.spans import (PARTS, RequestLedger, _serve_spans,
                                     engine_parts, program_gaps)
from perfbench.harness.trace import Digest
from perfbench.tests.tiny import tiny_cell

SEED = 2**31 + 977
METRICS = ("upload_ms", "mab_ms", "daso_place_ms", "daso_train_ms",
           "engine_waits")


def test_untraced_run_records_nothing():
    """A ``--trace 0`` run opens no ledger: the default one stays empty
    while the engine serves, and the result reports the end-to-end
    metrics alone, as before the engine had spans."""
    default = get_ledger()
    res, run = run_cell(tiny_cell("vl-serve-loose"), SEED, 0.2, 0, "cpu")
    assert get_ledger() is default and not default.recording
    assert default.events == [] and default.counters == {}
    assert len(run.ok) > 0
    assert set(res["metrics"]) == {"serve_tokens_per_s", "serve_p90_ms",
                                   "setup_s"}
    assert "breakdown" not in res


def test_traced_run_parts_sum_to_engine_host_ms():
    """Under a ``RequestLedger`` a ``--trace 1`` run gives the five
    per-request numbers.  Per request, the engine's spans outside its two
    forwards never exceed ``engine_host_ms``'s part (the serve span lies
    inside the harness's wall, the tap's timers inside the plan and mono
    spans), and the serve span is its children and its own time.  Over
    the window the parts' means come within 5 % of ``engine_host_ms`` and
    the serve span's own time under 5 % of it.  What no part holds is a
    fixed ~0.35 ms a request on the CPU (span bookkeeping, the tap's work
    inside the plan and mono spans): 12-13 % of a request before DASO's
    16th replay, when the engine's host work is ~3 ms, so the window
    starts past it."""
    cell = tiny_cell("moe-serve-loose")
    cell.traffic = dict(cell.traffic, warmup_requests=16)
    led = RequestLedger()
    with use_ledger(led):
        res, run = run_cell(cell, SEED, 0.5, 1, "cpu")
    parts = engine_parts(led, run.ok)
    for name in METRICS:
        assert math.isfinite(parts[name]) and parts[name] >= 0, name
    kids = {}
    for e in led.events:
        kids.setdefault(e.get("parent"), []).append(e)
    for r, sp in zip(run.ok, _serve_spans(led, run.ok)):
        host = r["latency_s"] - r["plan_s"] - r["mono_s"]
        by = {c["name"]: c["dur_s"] for c in kids[sp["id"]]}
        part = sum(by.get(n, 0.0) for names in PARTS.values() for n in names)
        self_s = sp["dur_s"] - sum(by.values())
        assert 0 <= part <= host + 1e-9 and self_s >= 0, (r, by)
    host_ms = res["metrics"]["engine_host_ms"]["value"]
    part_ms = sum(parts[name] for name in PARTS)
    assert 0.95 * host_ms < part_ms <= host_ms, (part_ms, host_ms)
    assert parts["serve_self_ms"] < 0.05 * host_ms, parts
    assert parts["engine_waits"] >= 25 + 24
    assert parts["daso_ascent_steps"] > 0
    serves = [e for e in led.events if e["name"] == "engine.serve"]
    assert len(serves) == len(run.records) + len(run.traced) + 16


def test_program_spans_label_idle_gaps():
    """Each idle gap of the device takes the innermost program span
    around its middle, on the time base the digest gave the harness's
    ``serve`` mark; outside every span it is the client's."""
    led = RunLedger("gaps")
    t0 = 100.0                      # host clock of the traced request
    led.events = [
        {"kind": "span", "id": 0, "parent": None, "name": "engine.serve",
         "start_s": t0, "dur_s": 0.010},
        {"kind": "span", "id": 1, "parent": 0, "name": "engine.place",
         "start_s": t0 + 0.001, "dur_s": 0.003},
        {"kind": "span", "id": 2, "parent": 0, "name": "engine.plan",
         "start_s": t0 + 0.004, "dur_s": 0.005},
        {"kind": "span", "id": 3, "parent": 2, "name": "engine.plan.stage",
         "start_s": t0 + 0.004, "dur_s": 0.002}]
    offset = 5_000.0                # device us - host us
    base = t0 * 1e6 + offset
    ops = [("k", base + a, base + b, 7) for a, b in
           ((0, 1000), (3500, 5000), (5500, 6800), (8000, 9000),
            (12000, 13000))]
    digest = Digest(ops, [("serve", base, base + 10_000)], base,
                    base + 13_000)
    gaps = program_gaps(led, digest, [{"start": t0}])
    assert [g[0] for g in gaps] == ["client, between requests",
                                    "engine.place", "engine.plan",
                                    "engine.plan.stage"]
    assert [round(g[1] * 1e6) for g in gaps] == [3000, 2500, 1200, 500]


def test_sync_debug_counts_flagged_syncs_by_span(monkeypatch):
    """``sync_debug`` turns torch's sync debug mode to ``warn`` for its
    scope and back, counts each flagged synchronization under the
    innermost open span (``outside`` with none open), and passes every
    other warning on."""
    import warnings

    import torch

    from perfbench.harness.spans import sync_debug
    modes, shown = [], []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(warnings, "showwarning",
                        lambda message, *a, **k: shown.append(str(message)))
    flagged = "called a synchronizing CUDA operation"
    led = RequestLedger()
    with use_ledger(led), sync_debug(led):
        assert modes == ["warn"]
        warnings.warn(flagged)
        with led.span("engine.serve"):
            with led.span("engine.place"):
                warnings.warn(flagged)
                warnings.warn(flagged)
            warnings.warn("something else")
    assert modes == ["warn", "default"]
    assert {k: v for k, v in led.counters.items()
            if k.startswith("syncs.")} == {"syncs.outside": 1,
                                           "syncs.engine.place": 2}
    assert shown == ["something else"]
    assert led.counts[0] == {"syncs.engine.place": 2}
