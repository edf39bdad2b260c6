"""Host-side run ledger: nested wall-clock spans, counters, warnings,
interval-series snapshots and a provenance stamp, exported as JSONL.

The port of ``repro.obs.ledger``.  It makes the host half of a run
observable: where the wall clock went (upload vs dispatch vs summarize
of the interval program), how the kernel libraries were obtained
(``repro_torch.kernels.build.cache_stats()`` feeds ``add_cache_stats``:
loads served from the process, libraries loaded or built), and on which
torch / CUDA / card the numbers were measured (``provenance_stamp``).

One process-global ledger is always active (``get_ledger``), and it
records nothing: its ``span`` yields None without reading a clock and its
``count`` returns at once, so instrumented code costs an attribute check
while no one listens.  ``use_ledger(RunLedger(...))`` turns recording on
for its scope.  Recording is a lock plus a dict append per event.
Span starts are ``time.perf_counter`` readings, so a reader can put them
on any time base anchored on that clock.  ``tools/obs_report.py`` renders
a dumped ledger into a text report (span tree, cache stats, sparkline
interval curves).
"""
from __future__ import annotations

import json
import os
import subprocess
import threading
import time
from contextlib import contextmanager, nullcontext


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
    snapshot.  ``dump`` writes one JSON object per line.  A ledger made
    with ``recording=False`` keeps no span, counter or warning."""

    def __init__(self, name: str = "run", recording: bool = True):
        self.name = name
        self.recording = recording
        self.created_s = time.time()
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

    def span(self, name: str, parent=None, sync=None, **attrs):
        """Record a wall-clock span: its start (``start_s``, a
        ``time.perf_counter`` reading) and duration.  Nesting comes from
        the per-thread span stack; ``parent`` overrides it.  With ``sync``
        (a torch device) the span ends after a synchronize of a CUDA
        device, so its wall holds the device work queued inside it.  Off
        recording, a shared no-op context that yields None."""
        if not self.recording:
            return _OFF
        return self._span(name, parent, sync, attrs)

    @contextmanager
    def _span(self, name, parent, sync, attrs):
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
            if sync is not None and sync.type == "cuda":
                import torch
                torch.cuda.synchronize(sync)
            dur = time.perf_counter() - t0
            st.pop()
            ev = {"kind": "span", "id": sid, "parent": pid, "name": name,
                  "start_s": t0, "dur_s": dur}
            if attrs:
                ev["attrs"] = attrs
            with self._lock:
                self.events.append(ev)

    # ------------------------------------------- counters / warnings / data

    def count(self, name: str, n: int = 1):
        if not self.recording:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def warn(self, message: str, **attrs):
        if not self.recording:
            return
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


#: what a span yields, and does, off recording
_OFF = nullcontext()

#: The counter of the points where the host waits for the card, counted
#: at each site (on the CPU too, where nothing waits, so that a count is
#: the same on either device).  The sites on the serving engine's path:
#:   * every blocking host-to-device copy of host data: the engine's
#:     ``_tensor`` (and so ``batch``), and ``core/mab``'s float32
#:     constants (``_scalar32``);
#:   * every device read: the engine's ``_read`` (the decision, the
#:     placement's assignment and DASO input, the fidelity),
#:     ``core/daso.optimize_placement``'s step-norm test before each step
#:     but the first, and ``core/mab._host_max``;
#:   * every explicit synchronize: the engine's ``_sync``.
#: A span's own ``sync=`` is tracing's, and not counted.
HOST_WAITS = "host.waits"

_ACTIVE = RunLedger("default", recording=False)


def get_ledger() -> RunLedger:
    """The currently-active ledger: a process-global default that records
    nothing, unless a ``use_ledger`` scope is open."""
    return _ACTIVE


@contextmanager
def use_ledger(ledger: RunLedger):
    """Route instrumentation into ``ledger`` for the scope's duration (and
    so turn recording on), then restore the previous one."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = ledger
    try:
        yield ledger
    finally:
        _ACTIVE = prev
