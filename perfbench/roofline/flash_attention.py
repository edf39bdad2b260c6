"""``kernels/flash_attention`` (``csrc/flash_attention.cu``), the bfloat16
forward on the tensor cores: one causal self-attention call per attention
layer of every forward."""
from __future__ import annotations

from perfbench.harness.flops import branch_heads
from perfbench.reference.decoder import Shape


def match(name: str) -> bool:
    return "flash_attention" in name and "bwd" not in name


def calls(config: dict, kind: str, branches: int, b: int, s: int):
    sh = Shape(config)
    h, kv, _ = branch_heads(sh, kind, branches)
    return [{"b": b, "s": s, "h": h, "kvh": kv, "hd": sh.hd,
             "itemsize": 2}] * sh.layers


def cost(c: dict):
    b, s, h, kvh, hd = c["b"], c["s"], c["h"], c["kvh"], c["hd"]
    flops = 4.0 * b * h * hd * s * (s + 1) / 2
    nbytes = c["itemsize"] * b * s * hd * (2 * h + 2 * kvh)
    return flops, nbytes
