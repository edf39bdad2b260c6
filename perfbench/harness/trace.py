"""The device trace of a traced run's sub-window, from ``torch.profiler``
recording device activity only (CUPTI), so that the host runs at its
usual pace: every device operation (kernels, copies, memsets) in the
sub-window.  The host's side comes from the harness's own marks (host
clock intervals of the requests and, inside them, of the engine's plan,
monolithic forward, placement and DASO training), put on the device's
time base by an anchor: the one operation launched right after a device
synchronize when the sub-window opens.

From it: the busy seconds (the union of the operations' intervals), the
operations that took most time, and the longest idle gaps labelled by
the innermost mark around each gap's middle."""
from __future__ import annotations

from collections import defaultdict

NAME_CHARS = 160


class Digest:
    def __init__(self, ops, marks, start_us, end_us):
        self.ops = ops            # [(name, start_us, end_us, stream)] sorted
        self.marks = marks        # [(name, start_us, end_us)] device base
        self.start_us, self.end_us = start_us, end_us

    @property
    def window_s(self):
        return (self.end_us - self.start_us) / 1e6

    def merged(self):
        out = []
        for _, a, b, _ in self.ops:
            a, b = max(a, self.start_us), min(b, self.end_us)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.merged()) / 1e6

    def op_seconds(self, match, memset_before=False):
        """(seconds, count) of the operations whose names ``match`` picks,
        with the memset just before each on its stream when
        ``memset_before``."""
        total, n = 0.0, 0
        last = {}
        for name, a, b, stream in self.ops:
            if match(name):
                total += b - a
                n += 1
                prev = last.get(stream)
                if memset_before and prev and "memset" in prev[0].lower():
                    total += prev[2] - prev[1]
            last[stream] = (name, a, b)
        return total / 1e6, n

    def top_ops(self, k=10):
        by = defaultdict(float)
        for name, a, b, _ in self.ops:
            by[name[:NAME_CHARS]] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k=10):
        gaps, at = [], self.start_us
        for a, b in self.merged():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.end_us > at:
            gaps.append((at, self.end_us))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._label((a + b) / 2), (b - a) / 1e6]
                for a, b in gaps[:k]]

    def _label(self, t):
        best = None
        for name, a, b in self.marks:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "client, between requests"


def digest(prof, anchor_s, marks, start_s, end_s) -> Digest:
    """The sub-window [start_s, end_s] (host clock, seconds) of a
    profile whose first device operation was launched at ``anchor_s``;
    ``marks`` are (name, start_s, end_s) on the host clock."""
    from torch.autograd import DeviceType
    ops = sorted((e.name, e.time_range.start, e.time_range.end,
                  getattr(e, "device_resource_id", 0))
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
    ops.sort(key=lambda o: o[1])
    if not ops:
        return Digest([], [], 0.0, (end_s - start_s) * 1e6)
    offset = ops[0][1] - anchor_s * 1e6
    dev = [(n, a * 1e6 + offset, b * 1e6 + offset) for n, a, b in marks]
    return Digest(ops[1:], dev, start_s * 1e6 + offset,
                  end_s * 1e6 + offset)
