"""Gillis-style latency-optimal layer partitioning (the baseline's core
algorithm, [32] §4): the part the serving plans use.

A NumPy copy of ``repro.core.partitioner``'s ``LayerCost``,
``model_layer_costs``, ``pipeline_latency``, ``optimal_partition`` and
``memory_feasible_partition`` (that module imports no JAX; the port keeps
its own copy).  Given
per-layer costs (FLOPs + activation bytes forwarded between consecutive
layers), find the contiguous partition of layers into at most K
fragments that minimizes end-to-end pipeline latency:

    latency(partition) = Σ_f  [ work(f) / speed(w_f)  +  hop(f→f+1) ]

Solved exactly by dynamic programming over (layer-prefix,
fragments-used), fragment f running on the f-th fastest worker
(round-robin).  The serving plans use it to choose pipeline-stage
boundaries from real per-layer cost tables.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LayerCost:
    flops: float           # forward FLOPs of this layer
    out_bytes: float       # activation bytes forwarded to the next layer
    param_bytes: float     # resident weight bytes


def model_layer_costs(cfg, seq: int, batch: int) -> List[LayerCost]:
    """Analytic per-layer cost table for any assigned architecture."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    act_bytes = batch * seq * d * 2.0
    out = []
    for kind in cfg.layer_kinds:
        p = cfg._block_params(kind, d, hd)
        flops = 2.0 * p * batch * seq
        if kind in ("attn", "local_attn", "xattn", "attn_moe"):
            w = cfg.sliding_window or seq
            flops += 4.0 * batch * seq * min(w, seq) * cfg.num_heads * hd
        out.append(LayerCost(flops, act_bytes, p * 2.0))
    return out


def pipeline_latency(costs: Sequence[LayerCost], cuts: Sequence[int],
                     speed_flops: float, hop_bw: float) -> float:
    """cuts = fragment boundaries [0, c1, ..., L]; single-speed fleet."""
    total = 0.0
    for a, b in zip(cuts[:-1], cuts[1:]):
        total += sum(c.flops for c in costs[a:b]) / speed_flops
        if b < len(costs):
            total += costs[b - 1].out_bytes / hop_bw
    return total


def optimal_partition(costs: Sequence[LayerCost], max_fragments: int,
                      speeds: Sequence[float], hop_bw: float,
                      exact: bool = False):
    """DP over (prefix, fragments): minimize Σ work/speed + hops.

    speeds are sorted descending and fragment f runs on speeds[f % len]
    (round-robin over the fastest workers, the Gillis serverless model).
    Returns (cuts, latency).
    """
    L = len(costs)
    K = min(max_fragments, L)
    speeds = sorted(speeds, reverse=True)
    pre = np.zeros(L + 1)
    for i, c in enumerate(costs):
        pre[i + 1] = pre[i] + c.flops
    INF = float("inf")
    # dp[k][i] = min latency of first i layers in k fragments
    dp = np.full((K + 1, L + 1), INF)
    back = np.zeros((K + 1, L + 1), int)
    dp[0][0] = 0.0
    for k in range(1, K + 1):
        spd = speeds[(k - 1) % len(speeds)]
        for i in range(1, L + 1):
            for j in range(k - 1, i):
                seg = (pre[i] - pre[j]) / spd
                hop = costs[i - 1].out_bytes / hop_bw if i < L else 0.0
                cand = dp[k - 1][j] + seg + hop
                if cand < dp[k][i]:
                    dp[k][i] = cand
                    back[k][i] = j
    if exact:
        best_k = min(max_fragments, L)
    else:
        best_k = int(np.argmin(dp[:, L]))
    cuts = [L]
    i, k = L, best_k
    while k > 0:
        i = int(back[k][i])
        cuts.append(i)
        k -= 1
    cuts.reverse()
    return cuts, float(dp[best_k][L])


def memory_feasible_partition(costs: Sequence[LayerCost],
                              ram_budget_bytes: float):
    """Fewest contiguous fragments with per-fragment weights under budget
    (Gillis memory-optimal serving mode).  Greedy is optimal here.
    Returns the cuts [0, ..., L]; raises ValueError when one layer alone
    exceeds the budget."""
    cuts = [0]
    acc = 0.0
    for i, c in enumerate(costs):
        if acc + c.param_bytes > ram_budget_bytes and acc > 0:
            cuts.append(i)
            acc = 0.0
        acc += c.param_bytes
        if c.param_bytes > ram_budget_bytes:
            raise ValueError(f"layer {i} alone exceeds the RAM budget")
    cuts.append(len(costs))
    return cuts
