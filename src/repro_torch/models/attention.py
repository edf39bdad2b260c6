"""GQA self attention of the attention blocks, its decode step, and the
cross attention of musicgen's ``xattn`` blocks.

The port of ``repro.models.attention``'s prefill, decode and cross
attention paths.
Weights keep the reference's einsum layouts (``wq`` (d, h, hd),
``wk``/``wv`` (d, kvh, hd), ``wo`` (h, hd, d), optional biases), so head
slicing for the semantic plan ports line for line.  The reference picks
``full_attention`` up to 2048 tokens and ``blockwise_attention`` above;
both compute the function of the flash-attention kernel, which the port
calls at any length (``repro_torch.kernels.flash_attention``: the CUDA
kernel on the card, its eager twin on the CPU).  Decode attends one token
to a ring-buffer cache through the same kernel, with the reference's
position trick as the mask; cross attention runs it non-causal over the
conditioning sequence.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.dist import flatten_last2, unflatten_last
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init


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
    return unflatten_last(x @ w.reshape(d, h * e), (h, e))


def project_qkv(p, x, cfg):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _rope_qk(q, k, positions, cfg, positions3=None):
    """Rotary embedding of q and k: ``pos_emb="rope"`` by ``positions``
    (b, s); ``"mrope"`` by ``positions3`` (b, 3, s), or by ``positions``
    on all three streams when it is None; ``"none"`` and
    ``"sinusoidal"`` (added to the embedding instead) leave them."""
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    elif cfg.pos_emb == "mrope":
        if positions3 is None:
            b, s = positions.shape
            positions3 = positions[:, None, :].expand(b, 3, s)
        q = apply_mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta)
    return q, k


def _out_proj(out, wo):
    """einsum("bshe,hed->bsd") as one matrix product."""
    h, hd, d = wo.shape
    return flatten_last2(out) @ wo.reshape(h * hd, d)


def self_attention(p, x, positions, cfg, window=0, explicit=False,
                   positions3=None):
    """Full-sequence causal self attention (prefill).  x (b, s, d);
    positions (b, s) int32.  Without ``explicit`` the positions are
    ``0..s-1``, the flash kernel's implicit ones; with it the kernel
    masks by the given positions (offset or packed rows), as the
    reference's ``full_attention`` does.  Under M-RoPE ``positions3``
    (b, 3, s) rotates q and k; the mask still reads ``positions``.
    Returns (y, (k, v)), k after the rotary embedding."""
    q, k, v = project_qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg, positions3)
    pos = positions.to(torch.int32).contiguous() if explicit else None
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True, window=window, pos_q=pos, pos_k=pos)
    return _out_proj(out, p["wo"]), (k, v)


def cross_attention(p, x, cond, cfg):
    """x (b, s, d) attends to the conditioning ``cond`` (b, n, d): q from
    x, k and v from cond, no rotary embedding, no causal mask.  The
    reference's ``full_attention`` with ``causal=False`` masks nothing, so
    this is the flash kernel non-causal at sq = s, sk = n with implicit
    positions.  Prefill and decode (s = 1) alike."""
    q = _proj(x, p["wq"])
    k, v = _proj(cond, p["wk"]), _proj(cond, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=False)
    return _out_proj(out, p["wo"])


# ------------------------------------------------------------- decoding

#: the position of a ring slot not written yet: past every query, so the
#: causal mask hides it (the reference's ``decode_attention`` trick)
UNWRITTEN = 2 ** 30


def init_attn_cache(cfg, batch, ctx_len, window=0, dtype=torch.bfloat16,
                    device=None):
    """A zero ring buffer of W = min(ctx_len, window) slots (ctx_len
    without a window): ``{"k", "v"}`` each (batch, W, kvh, hd)."""
    w = min(ctx_len, window) if window else ctx_len
    shape = (batch, w, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p, x, cache, pos, cfg):
    """One-token decode.  x (b, 1, d); pos the current position (a
    Python int).  The token's k and v go to ring slot ``pos % W`` of the
    cache, which is updated in place (one slot written, not the whole
    buffer copied, unlike the reference's functional select) and
    returned; attention is permutation-invariant over the slots, so the
    ring needs no unrotation: the query sits at position 1, written slots
    at 0 and the others at ``UNWRITTEN``, and the causal mask does the
    rest."""
    q, k, v = project_qkv(p, x, cfg)
    b = x.shape[0]
    pos_b = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    # under M-RoPE the reference rotates by pos on all three streams
    q, k = _rope_qk(q, k, pos_b, cfg)
    W = cache["k"].shape[1]
    slot = pos % W
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    pos_k = torch.full((W,), UNWRITTEN, dtype=torch.int32, device=x.device)
    pos_k[:min(pos + 1, W)] = 0
    out = flash_attention(q.to(cache["k"].dtype).contiguous(), cache["k"],
                          cache["v"], causal=True, window=0,
                          pos_q=torch.ones_like(pos_b),
                          pos_k=pos_k.expand(b, W).contiguous())
    return _out_proj(out.to(x.dtype), p["wo"]), cache
