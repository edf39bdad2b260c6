"""Observability of the port: run ledgers and provenance stamps (the port
of ``repro.obs``).

``RunLedger`` traces the host side of a run (the interval program's
grid / upload / dispatch / summarize spans, the kernel libraries' build
and load counters, warnings, interval-series snapshots) and exports JSONL
that ``tools/obs_report.py`` renders; the on-device half is the
``telemetry="interval"`` knob of ``repro_torch.env.torchsim``.
"""
from repro_torch.obs.ledger import (HOST_WAITS, RunLedger, get_ledger,
                                    load_ledger_lines, provenance_stamp,
                                    use_ledger)

__all__ = ["HOST_WAITS", "RunLedger", "get_ledger", "load_ledger_lines",
           "provenance_stamp", "use_ledger"]
