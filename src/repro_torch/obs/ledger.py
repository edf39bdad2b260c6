"""Host-side run ledger: nested wall-clock spans, counters, warnings,
interval-series snapshots and a provenance stamp, exported as JSONL.

The port of ``repro.obs.ledger``.  It makes the host half of a run
observable: where the wall clock went (upload vs dispatch vs summarize
of the interval program), how the kernel libraries were obtained
(``repro_torch.kernels.build.cache_stats()`` feeds ``add_cache_stats``:
loads served from the process, libraries loaded or built), and on which
torch / CUDA / card the numbers were measured (``provenance_stamp``).

One process-global ledger is always active (``get_ledger``); scoped
recording swaps it with ``use_ledger``.  Recording is a lock plus a dict
append per event, so the driver records every run.
``tools/obs_report.py`` renders a dumped ledger into a text report (span
tree, cache stats, sparkline interval curves).
"""
from __future__ import annotations

import json
import os
import subprocess
import threading
import time
from contextlib import contextmanager


def _card() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def provenance_stamp(**knobs) -> dict:
    """The run-provenance stamp: torch and CUDA versions, the device fleet
    (kind and count; the CPU's when no card is visible), the CPU count and,
    with a card, its ``nvidia-smi`` name and power limit.  Pass knobs as
    keyword overrides."""
    import torch
    cuda = torch.cuda.is_available()
    prov = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "cpu_count": os.cpu_count(),
        "gpu": _card() if cuda else None,
    }
    prov.update(knobs)
    return prov


class RunLedger:
    """Append-only trace of one run: spans (nested via a thread-local
    stack, or an explicit ``parent=`` id for worker threads), counters,
    warnings, named interval series, and an optional cache-stats
    snapshot.  ``dump`` writes one JSON object per line."""

    def __init__(self, name: str = "run"):
        self.name = name
        self.created_s = time.time()
        self._origin = time.perf_counter()
        self.provenance = None
        self.cache_stats = None
        self.events = []
        self.counters = {}
        self.series = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._next_id = 0

    # ------------------------------------------------------------ spans

    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_span(self):
        """Id of the innermost open span on THIS thread (None at root) —
        hand it to worker threads as their ``span(parent=...)``."""
        st = self._stack()
        return st[-1] if st else None

    @contextmanager
    def span(self, name: str, parent=None, **attrs):
        """Record a wall-clock span: its start (``start_s``, seconds since
        the ledger was made) and duration.  Nesting comes from the
        per-thread span stack; ``parent`` overrides it."""
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        st = self._stack()
        pid = parent if parent is not None else (st[-1] if st else None)
        st.append(sid)
        t0 = time.perf_counter()
        try:
            yield sid
        finally:
            dur = time.perf_counter() - t0
            st.pop()
            ev = {"kind": "span", "id": sid, "parent": pid, "name": name,
                  "start_s": t0 - self._origin, "dur_s": dur}
            if attrs:
                ev["attrs"] = attrs
            with self._lock:
                self.events.append(ev)

    # ------------------------------------------- counters / warnings / data

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def warn(self, message: str, **attrs):
        ev = {"kind": "warning", "message": message}
        if attrs:
            ev["attrs"] = attrs
        with self._lock:
            self.events.append(ev)

    def warnings(self):
        with self._lock:
            return [e for e in self.events if e["kind"] == "warning"]

    def add_series(self, name: str, cols, data):
        """Attach a named (T, C) interval series (e.g. one trace's
        ``summary["telemetry"]`` payload) for the report's curves."""
        import numpy as np
        arr = np.asarray(data, np.float64)
        if arr.ndim != 2 or arr.shape[1] != len(tuple(cols)):
            raise ValueError(f"series {name!r}: data {arr.shape} does not "
                             f"match {len(tuple(cols))} cols")
        with self._lock:
            self.series.append({"name": name, "cols": list(cols),
                                "data": arr.tolist()})

    def add_cache_stats(self, stats: dict):
        """Snapshot ``repro_torch.kernels.build.cache_stats()`` into the
        ledger (last call wins — take it after the runs you report on)."""
        with self._lock:
            self.cache_stats = dict(stats)

    def stamp(self, **knobs) -> dict:
        """Fill the provenance block (imports torch)."""
        self.provenance = provenance_stamp(**knobs)
        return self.provenance

    # ---------------------------------------------------------- profiling

    @contextmanager
    def profile(self, trace_dir: str):
        """Opt-in ``torch.profiler`` trace (CPU, and CUDA where there is a
        card) around a block; the Chrome trace lands in ``trace_dir`` and
        the block is also recorded as a ledger span."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(trace_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with self.span("profile", trace_dir=trace_dir):
                yield
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    # ------------------------------------------------------------- export

    def to_lines(self):
        with self._lock:
            lines = [{"kind": "meta", "name": self.name,
                      "created_s": self.created_s,
                      "provenance": self.provenance}]
            lines += list(self.events)
            lines.append({"kind": "counters",
                          "counters": dict(self.counters)})
            if self.cache_stats is not None:
                lines.append({"kind": "cache_stats", **self.cache_stats})
            lines += [{"kind": "series", **s} for s in self.series]
        return lines

    def dump(self, path: str) -> str:
        """Write the ledger as JSONL (one event per line)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for ln in self.to_lines():
                f.write(json.dumps(ln) + "\n")
        return path


def load_ledger_lines(path: str):
    """Parse a dumped JSONL ledger back into its event dicts."""
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


_ACTIVE = RunLedger("default")


def get_ledger() -> RunLedger:
    """The currently-active ledger (a process-global default unless a
    ``use_ledger`` scope is open)."""
    return _ACTIVE


@contextmanager
def use_ledger(ledger: RunLedger):
    """Route driver instrumentation into ``ledger`` for the scope's
    duration, then restore the previous one."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = ledger
    try:
        yield ledger
    finally:
        _ACTIVE = prev
