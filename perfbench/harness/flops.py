"""The benchmark's own FLOP arithmetic of the served forwards: the matrix
products a forward needs at its shapes (2 x M x N x K each), with causal
attention counted over the (query, key) pairs it keeps, s (s + 1) / 2 per
head, and an MoE layer over the top-k experts of every token (the model's
FLOPs: tokens dropped at the capacity are not subtracted).

A request runs its plan's forwards and the monolithic forward: the layer
plan one ``"full"`` forward, the semantic plan ``branches`` forwards of
kind ``"branch"`` (1/B of the heads when both head counts divide by B,
1/B of the MLP channels; MoE, embedding and head whole)."""
from __future__ import annotations

from perfbench.reference.decoder import Shape

LAYER_PLAN = 0


def branch_heads(sh: Shape, kind: str, branches: int):
    """(heads, kv heads, MLP channels) of one forward of ``kind``."""
    h, kv, ff = sh.heads, sh.kv_heads, sh.ff
    if kind == "branch":
        if h % branches == 0 and kv % branches == 0:
            h, kv = h // branches, kv // branches
        ff //= branches
    return h, kv, ff


def forward_flops(config: dict, kind: str, branches: int, b: int,
                  s: int) -> float:
    sh = Shape(config)
    h, kv, ff = branch_heads(sh, kind, branches)
    t = b * s
    d, hd = sh.d, sh.hd
    layer = 2.0 * t * d * (h + 2 * kv) * hd + 2.0 * t * h * hd * d
    layer += 4.0 * b * h * hd * s * (s + 1) / 2
    if sh.experts:
        layer += 2.0 * t * d * sh.experts
        layer += 2.0 * t * sh.top_k * 3 * d * sh.ff_expert
        if sh.ff_shared:
            layer += 2.0 * t * 3 * d * sh.ff_shared + 2.0 * t * d
    else:
        layer += 2.0 * t * 3 * d * ff
    return sh.layers * layer + 2.0 * t * d * sh.vocab


def request_forwards(plan: int, branches: int):
    """The forwards one request runs: its plan's, then the monolithic."""
    kinds = ["full"] if plan == LAYER_PLAN else ["branch"] * branches
    return kinds + ["full"]


def request_flops(config: dict, plan: int, branches: int, b: int,
                  s: int) -> float:
    return sum(forward_flops(config, k, branches, b, s)
               for k in request_forwards(plan, branches))
