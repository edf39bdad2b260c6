"""SUMO-style urban-mobility model for worker network volatility (§6.1).

Each mobile worker is a vehicle whose distance-to-broker follows a
bounded random waypoint walk; latency grows and effective bandwidth
shrinks with distance.  Deterministic per seed; a NumPy copy of the
reference ``repro.env.mobility`` with the identical draw sequence.
"""
from __future__ import annotations

import numpy as np


class MobilityModel:
    def __init__(self, n_workers: int, mobile_mask, seed: int = 0,
                 speed: float = 0.08, max_dist: float = 1.0):
        self.n = n_workers
        self.mobile = np.asarray(mobile_mask, bool)
        self.rng = np.random.RandomState(seed)
        self.dist = self.rng.uniform(0.1, 0.6, n_workers)
        self.dist[~self.mobile] = 0.15
        self.target = self.rng.uniform(0.05, max_dist, n_workers)
        self.speed = speed
        self.max_dist = max_dist

    def step(self):
        """Advance one scheduling interval; returns (lat_mult, bw_mult)."""
        move = np.clip(self.target - self.dist, -self.speed, self.speed)
        jitter = self.rng.normal(0, 0.01, self.n)
        self.dist = np.clip(self.dist + np.where(self.mobile, move + jitter, 0.0),
                            0.02, self.max_dist)
        reached = np.abs(self.target - self.dist) < 0.05
        new_targets = self.rng.uniform(0.05, self.max_dist, self.n)
        self.target = np.where(reached & self.mobile, new_targets, self.target)
        lat_mult = 1.0 + 3.0 * self.dist              # ping grows with distance
        bw_mult = 1.0 / (1.0 + 1.5 * self.dist)       # bandwidth shrinks
        return lat_mult, bw_mult
