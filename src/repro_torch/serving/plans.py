"""Execution plans: the paper's split strategies as serving plans.

The port of ``repro.serving.plans``:

* ``layer_pipeline``: the layer-split analog.  The layer stack is cut
  into S sequential stages (on a multi-device fleet, one device group per
  stage, activations forwarded stage to stage).  Full fidelity, higher
  per-request latency, pipelined throughput.

* ``semantic_branch``: the semantic-split analog.  B disjoint branches,
  each using a 1/B head-group and 1/B ffn-channel slice of the weights,
  run the whole depth and their logits are averaged.  Reduced fidelity
  (branches share no features), lower latency.

Both are real executions of the same parameters (sliced views), so the
accuracy/latency trade-off the MAB consumes is measured, not assumed.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.partitioner import model_layer_costs, optimal_partition
from repro_torch.models import model as M
from repro_torch.obs import get_ledger

LAYER_PLAN, SEMANTIC_PLAN = 0, 1


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    kind: int                 # LAYER_PLAN | SEMANTIC_PLAN
    num_stages: int = 2       # pipeline stages (layer plan)
    num_branches: int = 2     # parallel branches (semantic plan)


def stage_bounds(num_layers: int, num_stages: int):
    b = np.linspace(0, num_layers, num_stages + 1).astype(int)
    return list(zip(b[:-1], b[1:]))


def optimal_stage_bounds(cfg, seq: int, batch: int, num_stages: int):
    """Gillis-DP stage boundaries from the analytic per-layer cost table
    (latency-balanced cuts instead of equal layer counts)."""
    costs = model_layer_costs(cfg, seq, batch)
    cuts, _ = optimal_partition(costs, num_stages, [1.0], hop_bw=1e15,
                                exact=True)
    return list(zip(cuts[:-1], cuts[1:]))


def pipeline_forward(params, batch, cfg, num_stages: int, bounds=None):
    """Layer-split execution: the operations of ``forward`` in the same
    order, structured as sequential stages (the per-stage boundary is
    where activations move between devices).  Equals ``forward`` bitwise
    for any stage boundaries; ``bounds`` defaults to equal layer counts,
    the serving engine passes Gillis-DP latency-balanced cuts.  A recording
    ledger gets an ``engine.plan.stage`` span per stage (the host's
    launches; it never synchronizes)."""
    M.check_supported(cfg, batch)
    ctx = M.make_ctx(batch, cfg)
    x = M.embed_tokens(params, batch, cfg, ctx["positions"])
    kinds = cfg.layer_kinds
    blocks = _flat_blocks(params, cfg)
    led = get_ledger()
    for k, (lo, hi) in enumerate(bounds or stage_bounds(len(kinds),
                                                        num_stages)):
        with led.span("engine.plan.stage", stage=k):
            for i in range(lo, hi):
                x = M.apply_block(kinds[i], blocks[i], x, ctx, cfg)
    return M.lm_head(params, x, cfg)


def _flat_blocks(params, cfg) -> List:
    """Per-layer params in order.  The port's parameters already hold one
    dict per layer (``models.model.params_from_jax`` unstacks the
    reference's body periods)."""
    blocks = params["blocks"]
    if len(blocks) != len(cfg.layer_kinds):
        raise ValueError(f"{len(blocks)} blocks for "
                         f"{len(cfg.layer_kinds)} layers")
    return list(blocks)


def _slice_block_params(block, cfg, branch, num_branches):
    """Head-group / channel-group slice of one block's weights (views):
    the self attention's heads and the MLP's channels, as the reference
    slices them; every other sub-layer (an ``xattn`` block's cross
    attention, MoE, Mamba, RG-LRU) runs whole in each branch."""
    def cut(arr, axis, n=num_branches, b=None):
        b = branch if b is None else b
        size = arr.shape[axis] // n
        return arr.narrow(axis, b * size, size)

    out = dict(block)
    if "attn" in block:
        a = dict(block["attn"])
        kvh = cfg.num_kv_heads
        if cfg.num_heads % num_branches == 0 and kvh % num_branches == 0:
            a["wq"] = cut(a["wq"], 1)
            a["wk"] = cut(a["wk"], 1)
            a["wv"] = cut(a["wv"], 1)
            a["wo"] = cut(a["wo"], 0)
            if "bq" in a:
                a["bq"], a["bk"], a["bv"] = (cut(a["bq"], 0), cut(a["bk"], 0),
                                             cut(a["bv"], 0))
        out["attn"] = a
    if "mlp" in block:
        m = dict(block["mlp"])
        m["w_up"] = cut(m["w_up"], 1)
        m["w_down"] = cut(m["w_down"], 0)
        if "w_gate" in m:
            m["w_gate"] = cut(m["w_gate"], 1)
        out["mlp"] = m
    return out


def branch_forward(params, batch, cfg, num_branches: int):
    """Semantic-split execution: B disjoint weight-slice branches run the
    whole depth; branch logits are averaged.  Approximate by construction
    (no cross-branch features): the fidelity cost the MAB trades against
    latency.  A recording ledger gets an ``engine.plan.branch`` span per
    branch (the host's launches; it never synchronizes)."""
    M.check_supported(cfg, batch)
    ctx = M.make_ctx(batch, cfg)
    kinds = cfg.layer_kinds
    blocks = _flat_blocks(params, cfg)
    led = get_ledger()

    def one_branch(branch):
        with led.span("engine.plan.branch", branch=branch):
            x = M.embed_tokens(params, batch, cfg, ctx["positions"])
            for kind, block in zip(kinds, blocks):
                sliced = _slice_block_params(block, cfg, branch,
                                             num_branches)
                x = M.apply_block(kind, sliced, x, ctx, cfg)
            return M.lm_head(params, x, cfg)

    logits = [one_branch(b) for b in range(num_branches)]
    return sum(logits) / num_branches


#: the card the napkin model prices (NVIDIA's data sheet, H100 SXM 80GB
#: HBM3 at its 700 W limit): dense bfloat16 tensor-core peak and HBM rate
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_S = 3.35e12


def plan_cost_model(cfg, plan: PlanSpec, seq: int, batch: int,
                    chips_per_slice: int = 1):
    """Napkin latency model (seconds) used to seed the MAB estimates:
    the layer pipeline pays its sequential stages plus a hop per stage
    boundary, the semantic plan one branch of 1/B of the work (the
    branches run in parallel).  The reference's shape, priced for one
    H100 instead of a TPU slice: compute at 40 % of the bf16 peak, and a
    hop as the (batch, seq, d) bf16 activation written and read once in
    HBM."""
    flops = 2.0 * cfg.active_param_count() * seq * batch
    rate = chips_per_slice * PEAK_FLOPS_BF16 * 0.4
    if plan.kind == LAYER_PLAN:
        hop_bytes = batch * seq * cfg.d_model * 2
        per_stage = flops / plan.num_stages / rate
        return plan.num_stages * per_stage + \
            (plan.num_stages - 1) * 2 * hop_bytes / HBM_BYTES_S
    return flops / plan.num_branches / rate
