"""GQA self attention of the dense and MoE blocks.

The port of ``repro.models.attention``'s prefill path.  Weights keep the
reference's einsum layouts (``wq`` (d, h, hd), ``wk``/``wv`` (d, kvh, hd),
``wo`` (h, hd, d), optional biases), so head slicing for the semantic
plan ports line for line.  The reference picks ``full_attention`` up to
2048 tokens and ``blockwise_attention`` above; both compute the function
of the flash-attention kernel, which the port calls at any length
(``repro_torch.kernels.flash_attention``: the CUDA kernel on the card,
its eager twin on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense_init


def attn_init(generator, cfg, dtype, device=None):
    d, h, k, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    p = {"wq": dense_init(generator, (d, h, hd), dtype, device=device),
         "wk": dense_init(generator, (d, k, hd), dtype, device=device),
         "wv": dense_init(generator, (d, k, hd), dtype, device=device),
         "wo": dense_init(generator, (h, hd, d), dtype, fan_in=h * hd,
                          device=device)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((k, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((k, hd), dtype=dtype, device=device)
    return p


def _proj(x, w):
    """einsum("bsd,dhe->bshe") as one matrix product."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).unflatten(-1, (h, e))


def project_qkv(p, x, cfg):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _rope_qk(q, k, positions, cfg):
    """Rotary embedding of q and k (``pos_emb="rope"``); ``"none"``
    leaves them.  The model refuses other position schemes before here."""
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k


def self_attention(p, x, positions, cfg, window=0):
    """Full-sequence causal self attention (prefill).  x (b, s, d);
    positions (b, s) are ``0..s-1``, the flash kernel's implicit ones.
    Returns (y, (k, v))."""
    q, k, v = project_qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True, window=window)
    h, hd, d = p["wo"].shape
    y = out.reshape(*out.shape[:2], h * hd) @ p["wo"].reshape(h * hd, d)
    return y, (k, v)
