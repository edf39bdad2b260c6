"""Heterogeneous edge cluster model — the paper's Table 3 Azure fleet.

50 worker VMs (B2ms / E2asv4 / B4ms / E4asv4) + an L8sv2 broker.  Power
curves follow the SPEC-benchmark linear idle→peak model the paper cites;
costs are the Table 3 $/hr figures.  A NumPy copy of the reference
``repro.env.cluster``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkerType:
    name: str
    cores: int
    mips: float            # per Table 3 (aggregate MIPS)
    ram_mb: float
    ram_bw: float          # MB/s
    ping_ms: float
    net_bw: float          # MB/s NIC
    disk_bw: float         # MB/s
    cost_hr: float         # USD/hr
    power_idle: float      # W (SPEC-style linear model)
    power_peak: float
    mobile: bool


WORKER_TYPES = {
    # name          cores MIPS   RAM    RAMbw ping netbw  disk   $/hr    Pidle Ppeak mobile
    "B2ms":   WorkerType("B2ms",   2, 4029, 4295,  372, 2, 1000, 13.40, 0.0944, 75, 117, True),
    "E2asv4": WorkerType("E2asv4", 2, 4019, 4172,  412, 2, 1000, 10.30, 0.1480, 71, 110, True),
    "B4ms":   WorkerType("B4ms",   4, 8102, 7962,  360, 3, 2500, 10.60, 0.1890, 83, 142, False),
    "E4asv4": WorkerType("E4asv4", 4, 7962, 7962,  476, 3, 2500, 11.64, 0.2960, 79, 131, False),
}

# 50-worker fleet (20 + 10 + 10 + 10; the paper's Table 3 lists the four
# worker SKUs for its 50-VM London deployment)
FLEET_SPEC = [("B2ms", 20), ("E2asv4", 10), ("B4ms", 10), ("E4asv4", 10)]

#: the paper's 10 MBps NIC ceiling on chain activation transfers
NIC_CAP_MB = 10.0


@dataclasses.dataclass
class Cluster:
    types: List[WorkerType]

    @property
    def n(self):
        return len(self.types)

    def mips(self):
        return np.array([t.mips for t in self.types], np.float64)

    def ram(self):
        return np.array([t.ram_mb for t in self.types], np.float64)

    def net_bw(self):
        return np.array([t.net_bw for t in self.types], np.float64)

    def cost_hr(self):
        return np.array([t.cost_hr for t in self.types], np.float64)

    def mobile_mask(self):
        return np.array([t.mobile for t in self.types], bool)

    def power(self, util):
        """util (n,) in [0,1] -> Watts (n,)."""
        idle = np.array([t.power_idle for t in self.types])
        peak = np.array([t.power_peak for t in self.types])
        return idle + (peak - idle) * np.clip(util, 0, 1)


def make_cluster(fleet=FLEET_SPEC, compute_scale=1.0, ram_scale=1.0,
                 net_scale=1.0) -> Cluster:
    """Build the 50-worker fleet; scales support the paper's A.3
    compute/memory/network-constrained variants (0.5 = halved)."""
    types = []
    for name, qty in fleet:
        base = WORKER_TYPES[name]
        t = dataclasses.replace(
            base, mips=base.mips * compute_scale,
            ram_mb=base.ram_mb * ram_scale,
            net_bw=base.net_bw * net_scale)
        types.extend([t] * qty)
    return Cluster(types)
