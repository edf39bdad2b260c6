"""Seeded weights on the device, in the layout the program reads
(``repro_torch.models.model``: ``{"embed", "final_norm", "head",
"blocks"}``, one dict per layer).

Every leaf is a view of one of two flat buffers (bfloat16, and float32 for
the MoE router and shared gate, which the program keeps in float32), each
filled by a few ``normal_`` calls of one CUDA generator and then scaled per
leaf: normal x fan_in ** -0.5 for products, 0.1 x normal for norm weights
(applied as 1 + w) and biases.  Leaves start at multiples of 512 bytes, as
the caching allocator would place separate tensors.
"""
from __future__ import annotations

import torch

from perfbench.reference.decoder import Shape

#: scale of the drawn norm weights and attention biases
SMALL = 0.1
#: elements per normal_ call
CHUNK = 1 << 30
ALIGN_BYTES = 512


def leaf_specs(config: dict):
    """[(path, shape, dtype, scale)] of every weight, in drawing order."""
    sh = Shape(config)
    d, hd, H, KV = sh.d, sh.hd, sh.heads, sh.kv_heads
    bf, f32 = torch.bfloat16, torch.float32
    specs = [(("embed",), (sh.vocab, d), bf, d ** -0.5),
             (("final_norm",), (d,), bf, SMALL),
             (("head",), (d, sh.vocab), bf, d ** -0.5)]
    for i in range(sh.layers):
        b = ("blocks", i)
        specs += [(b + ("norm1",), (d,), bf, SMALL),
                  (b + ("attn", "wq"), (d, H, hd), bf, d ** -0.5),
                  (b + ("attn", "wk"), (d, KV, hd), bf, d ** -0.5),
                  (b + ("attn", "wv"), (d, KV, hd), bf, d ** -0.5),
                  (b + ("attn", "wo"), (H, hd, d), bf, (H * hd) ** -0.5),
                  (b + ("attn", "bq"), (H, hd), bf, SMALL),
                  (b + ("attn", "bk"), (KV, hd), bf, SMALL),
                  (b + ("attn", "bv"), (KV, hd), bf, SMALL),
                  (b + ("norm2",), (d,), bf, SMALL)]
        if sh.experts:
            E, f, fs = sh.experts, sh.ff_expert, sh.ff_shared
            m = b + ("moe",)
            specs += [(m + ("router",), (d, E), f32, d ** -0.5),
                      (m + ("w_gate",), (E, d, f), bf, d ** -0.5),
                      (m + ("w_up",), (E, d, f), bf, d ** -0.5),
                      (m + ("w_down",), (E, f, d), bf, f ** -0.5)]
            if fs:
                specs += [(m + ("shared", "w_gate"), (d, fs), bf, d ** -0.5),
                          (m + ("shared", "w_up"), (d, fs), bf, d ** -0.5),
                          (m + ("shared", "w_down"), (fs, d), bf,
                           fs ** -0.5),
                          (m + ("shared_gate",), (d, 1), f32, d ** -0.5)]
        else:
            specs += [(b + ("mlp", "w_gate"), (d, sh.ff), bf, d ** -0.5),
                      (b + ("mlp", "w_up"), (d, sh.ff), bf, d ** -0.5),
                      (b + ("mlp", "w_down"), (sh.ff, d), bf,
                       sh.ff ** -0.5)]
    return specs


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def _put(tree, path, leaf):
    for key in path[:-1]:
        if isinstance(key, int):
            while len(tree) <= key:
                tree.append({})
            tree = tree[key]
        else:
            tree = tree.setdefault(key, [] if key == "blocks" else {})
    tree[path[-1]] = leaf


def make_weights(config: dict, generator: torch.Generator, device):
    """The weights of ``config`` drawn from ``generator`` on ``device``."""
    specs = leaf_specs(config)
    offsets, totals = [], {}
    for _, shape, dtype, _ in specs:
        align = ALIGN_BYTES // torch.empty((), dtype=dtype).element_size()
        at = -(-totals.get(dtype, 0) // align) * align
        offsets.append(at)
        totals[dtype] = at + _numel(shape)
    flats = {}
    for dtype, total in totals.items():
        flat = torch.empty(total, dtype=dtype, device=device)
        for lo in range(0, total, CHUNK):
            flat[lo:lo + CHUNK].normal_(generator=generator)
        flats[dtype] = flat
    tree = {}
    for (path, shape, dtype, scale), at in zip(specs, offsets):
        leaf = flats[dtype][at:at + _numel(shape)].view(shape)
        leaf.mul_(scale)
        _put(tree, path, leaf)
    return tree
