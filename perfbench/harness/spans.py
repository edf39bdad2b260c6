"""The engine's own spans and counters (``repro_torch.obs``) in a run of a
cell, read per request.

``serve`` records, under a recording ledger, one ``engine.serve`` span per
request with its children (upload, decide, place, plan, mono, fidelity,
update, DASO training) and counters (``host.waits`` and the rest, see
``repro_torch.serving.engine``).  From a run made under a
``RequestLedger``:

* ``engine_parts``: means over the window's finished requests, like
  ``engine_host_ms``: ``upload_ms`` (``engine.upload``), ``mab_ms``
  (``engine.decide`` + ``engine.update``), ``daso_place_ms``
  (``engine.place``), ``daso_train_ms`` (``engine.daso_train``, summed
  and divided by the requests), ``fidelity_ms``; per request
  ``engine_waits`` (``host.waits``), ``h2d_bytes``,
  ``daso_ascent_steps`` and ``daso_train_epochs``; every child span's
  mean, and the ``engine.serve`` span's self time (outside its
  children);
* ``program_gaps``: the traced sub-window's longest idle gaps, each
  labelled by the innermost program span around its middle;
* ``sync_debug``: a scope that counts torch's flagged synchronizations
  by span.

The harness does not open a ledger: ``perfbench/spans.py`` runs a cell
under one and prints these.  Once ``perfbench/harness/main.py`` opens
the ledger of a ``--trace 1`` run itself, ``perfbench/spans.py``,
``RequestLedger.open`` and ``program_gaps`` go: the harness's own idle
gaps then carry the program's spans.
"""
from __future__ import annotations

import bisect
import warnings
from collections import defaultdict
from contextlib import contextmanager

import torch
from repro_torch.obs import HOST_WAITS, RunLedger

from perfbench.harness.trace import Digest

#: the per-layer numbers and the spans each sums
PARTS = {"upload_ms": ("engine.upload",),
         "mab_ms": ("engine.decide", "engine.update"),
         "daso_place_ms": ("engine.place",),
         "daso_train_ms": ("engine.daso_train",),
         "fidelity_ms": ("engine.fidelity",)}
#: the per-request numbers and the counter each reads
COUNTS = {"engine_waits": HOST_WAITS, "h2d_bytes": "engine.h2d_bytes",
          "daso_ascent_steps": "daso.ascent_steps",
          "daso_train_epochs": "daso.train_epochs"}


class RequestLedger(RunLedger):
    """A recording ledger that also keeps, per ``engine.serve`` span id,
    the counters that grew while it was open (``counts``), and the names
    of the open spans on the calling thread (``open``), innermost last."""

    def __init__(self, name: str = "engine"):
        super().__init__(name)
        self.counts = {}
        self.open = []

    def span(self, name, parent=None, sync=None, **attrs):
        return self._tracked(name, super().span(name, parent, sync, **attrs))

    @contextmanager
    def _tracked(self, name, cm):
        before = dict(self.counters) if name == "engine.serve" else None
        self.open.append(name)
        try:
            with cm as sid:
                yield sid
        finally:
            self.open.pop()
        if before is not None:
            self.counts[sid] = {k: v - before.get(k, 0)
                                for k, v in self.counters.items()
                                if v != before.get(k, 0)}


@contextmanager
def sync_debug(led):
    """Count every call torch flags as synchronizing (its sync debug mode,
    on a card) into the ``RequestLedger`` ``led``, as ``syncs.<innermost
    open span>``: a check of ``host.waits``."""
    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            led.count("syncs." + (led.open[-1] if led.open else "outside"))
        else:
            shown(message, category, filename, lineno, file, line)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")


def _spans(ledger):
    return [e for e in ledger.events if e["kind"] == "span"]


def _serve_spans(ledger, records):
    """The ``engine.serve`` span of each record (a request the harness
    timed from ``start`` for ``latency_s``), in the records' order."""
    serves = sorted((e for e in _spans(ledger) if e["name"] ==
                     "engine.serve"), key=lambda e: e["start_s"])
    starts = [e["start_s"] for e in serves]
    out = []
    for r in records:
        k = bisect.bisect_left(starts, r["start"])
        if k == len(serves) or starts[k] > r["start"] + r["latency_s"]:
            raise ValueError(f"request {r['index']} has no engine.serve "
                             "span")
        out.append(serves[k])
    return out


def engine_parts(ledger, records):
    """Per-request means of the engine's spans and counters over
    ``records``, in ms for the spans; None without records."""
    if not records:
        return None
    kids = defaultdict(list)
    for e in _spans(ledger):
        kids[e["parent"]].append(e)
    sums = defaultdict(float)
    for sp in _serve_spans(ledger, records):
        by = defaultdict(float)
        for c in kids[sp["id"]]:
            by[c["name"]] += c["dur_s"]
        for part, names in PARTS.items():
            sums[part] += 1e3 * sum(by[n] for n in names)
        for name, s in by.items():
            sums[f"{name}_ms"] += 1e3 * s
        sums["serve_ms"] += 1e3 * sp["dur_s"]
        sums["serve_self_ms"] += 1e3 * (sp["dur_s"] - sum(by.values()))
        counts = ledger.counts[sp["id"]]
        for key, counter in COUNTS.items():
            sums[key] += counts.get(counter, 0)
        for k, v in counts.items():
            if k.startswith("syncs."):
                sums[k] += v
    return {k: v / len(records) for k, v in sorted(sums.items())}


def program_gaps(ledger, digest, traced, k=10):
    """The digest's ``k`` longest idle gaps, each labelled by the
    innermost program span around its middle (outside every span, the
    client between requests); None where the digest has no device
    operation.  The spans go onto the digest's device time base by the
    offset it gave the harness's ``serve`` marks, one per traced request
    from its ``start``."""
    serve = [m for m in digest.marks if m[0] == "serve"]
    if not serve or not traced:
        return None
    offset = serve[0][1] - traced[0]["start"] * 1e6
    marks = [(e["name"], e["start_s"] * 1e6 + offset,
              (e["start_s"] + e["dur_s"]) * 1e6 + offset)
             for e in _spans(ledger)]
    return Digest(digest.ops, marks, digest.start_us,
                  digest.end_us).idle_gaps(k)
