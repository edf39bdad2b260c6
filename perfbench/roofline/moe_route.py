"""``kernels/moe_route`` (``csrc/moe_route.cu``): per MoE layer of every
forward (an MoE runs whole in each semantic branch), one routing of the
(G, gs, E) float32 router logits into (G, gs, k) expert ids, gates and
slots.  Its device operations are ``route_kernel`` and the memset of its
ticket and tile flags just before it on its stream; the bound is the
bytes (softmax and top-k are a few operations per logit)."""
from __future__ import annotations

from perfbench.reference.decoder import Shape

MEMSET_BEFORE = True


def match(name: str) -> bool:
    return "route_kernel" in name and "bwd" not in name


def calls(config: dict, kind: str, branches: int, b: int, s: int):
    sh = Shape(config)
    if not sh.experts:
        return []
    t = b * s
    gs = min(sh.group_size, t)
    groups = -(-t // gs)
    return [{"groups": groups, "gs": gs, "E": sh.experts,
             "k": sh.top_k}] * sh.layers


def cost(c: dict):
    rows = c["groups"] * c["gs"]
    return 0.0, 4.0 * rows * (c["E"] + 3 * c["k"])
