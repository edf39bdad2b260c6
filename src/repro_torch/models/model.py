"""Decoder model of the dense attention, MoE, Mamba and RG-LRU blocks.

The port of ``repro.models.model`` for ``"attn"``, ``"attn_moe"``,
``"mamba"``, ``"rglru"`` and ``"local_attn"`` blocks: parameters are a
dict ``{"embed", "final_norm", "head", "blocks"}`` with one dict per
layer in ``blocks`` (the reference stacks its body periods along a
leading axis for ``lax.scan``; the port's forward is a plain loop over
layers, and ``params_from_jax`` unstacks that axis).

Public API:
    init_params(cfg, generator, device)   -> params
    params_from_jax(tree, cfg, device)    -> params
    forward(params, batch, cfg)           -> logits (float32)

Other block kinds, explicit positions, M-RoPE, cross attention and
decoding raise, naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense_init, dtype_of, mlp_apply,
                                       mlp_init, rmsnorm)

#: the block kinds the port runs
PORTED_KINDS = ("attn", "attn_moe", "mamba", "rglru", "local_attn")

#: what the port does not run yet, and the ROADMAP queue-1 item that
#: brings it; anything else not ported is item 18
NOT_PORTED = {
    "decode": "item 17 (decode and the KV cache)",
    "positions": "item 17 (decode and the KV cache: explicit positions)",
}


def _not_ported(what: str):
    item = NOT_PORTED.get(what, "item 18 (the remaining model zoo)")
    return NotImplementedError(f"repro_torch does not run {what!r} yet "
                               f"(ROADMAP queue 1 {item})")


def check_supported(cfg, batch=None):
    """Raise for a config or batch that needs what the port lacks: block
    kinds other than ``PORTED_KINDS``, position schemes other than rope or
    none, and batch entries other than ``tokens``."""
    for kind in cfg.layer_kinds:
        if kind not in PORTED_KINDS:
            raise _not_ported(kind)
    if cfg.pos_emb not in ("rope", "none"):
        raise _not_ported(cfg.pos_emb)
    for key in batch or ():
        if key != "tokens":
            raise _not_ported("positions" if key.startswith("positions")
                              else key)


# ------------------------------------------------------------ parameters

def init_block(generator, kind, cfg, device=None):
    if kind not in PORTED_KINDS:
        raise _not_ported(kind)
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model

    def norm():
        return torch.zeros((d,), dtype=dtype, device=device)

    if kind == "mamba":
        return {"norm1": norm(),
                "mamba": ssm_mod.mamba_init(generator, cfg, dtype,
                                            device=device)}
    if kind == "rglru":
        return {"norm1": norm(),
                "rglru": rglru_mod.rglru_init(generator, cfg, dtype,
                                              device=device),
                "norm2": norm(),
                "mlp": mlp_init(generator, d, cfg.d_ff, cfg, dtype,
                                device=device)}
    block = {"norm1": norm(),
             "attn": attn.attn_init(generator, cfg, dtype, device=device),
             "norm2": norm()}
    if kind == "attn_moe":
        block["moe"] = moe_mod.moe_init(generator, cfg, dtype, device=device)
    else:
        block["mlp"] = mlp_init(generator, d, cfg.d_ff, cfg, dtype,
                                device=device)
    return block


def init_params(cfg, generator=None, device="cuda"):
    """Random parameters with the reference's distribution (``dense_init``:
    normal × 1/√fan_in in float32, cast to ``param_dtype``; norms zero;
    the MoE router and shared gate, Mamba's ``A_log`` and ``D`` and the
    RG-LRU's ``b_a``, ``b_i`` and ``Lambda`` stay float32, as the
    reference keeps them),
    drawn from ``generator`` (default: a CPU generator seeded 0) on its
    own device and placed on ``device``."""
    check_supported(cfg)
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dtype = dtype_of(cfg.param_dtype)
    d, v = cfg.d_model, cfg.vocab_size
    params = {"embed": dense_init(generator, (v, d), dtype, fan_in=d,
                                  device=dev),
              "final_norm": torch.zeros((d,), dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (d, v), dtype, device=dev)
    params["blocks"] = [init_block(generator, kind, cfg, device=dev)
                        for kind in cfg.layer_kinds]
    return params


def _to_tensors(tree, device):
    """NumPy leaves as tensors of the same dtype (ml_dtypes' bfloat16 goes
    through float32, exactly)."""
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v, device) for v in tree]
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device=device)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_jax(tree, cfg, device="cuda"):
    """The reference's parameter pytree (``repro.models.init_params``),
    given as NumPy arrays, as the port's parameters on ``device``: the
    body's leading period axis is unstacked into one dict per layer, in
    the order prefix, body periods, suffix.  Each leaf keeps its own
    dtype (the reference keeps the MoE router and shared gate, Mamba's
    ``A_log`` and ``D`` and the RG-LRU's ``b_a``, ``b_i`` and ``Lambda``
    in float32 under a bfloat16 ``param_dtype``)."""
    check_supported(cfg)
    dev = resolve(device)
    prefix, (pattern, periods), suffix = cfg.scan_segments
    blocks = list(tree.get("prefix", []))
    for i in range(periods):
        period = _index(tree["body"], i)
        blocks.extend(period[f"b{j}"] for j in range(len(pattern)))
    blocks.extend(tree.get("suffix", []))
    params = {k: tree[k] for k in ("embed", "final_norm", "head")
              if k in tree}
    params["blocks"] = blocks
    return _to_tensors(params, dev)


# --------------------------------------------------------------- forward

def positions_of(tokens):
    """The implicit positions ``0..s-1`` of every row, (b, s) int32."""
    b, s = tokens.shape[:2]
    return torch.arange(s, dtype=torch.int32,
                        device=tokens.device).expand(b, s)


def embed_tokens(params, tokens, cfg):
    x = params["embed"][tokens.long()]
    return x.to(dtype_of(cfg.compute_dtype))


def block_window(kind, cfg):
    """The attention window of a block kind: the hybrid's ``local_attn``
    blocks take the RG-LRU config's local window, the others
    ``cfg.sliding_window`` (0: none)."""
    if kind == "local_attn":
        return cfg.rglru.local_window
    return cfg.sliding_window


def apply_block(kind, p, x, positions, cfg):
    """One block, each sub-layer pre-norm with a residual: ``"attn"`` and
    ``"local_attn"`` are self attention then the MLP, ``"attn_moe"`` self
    attention then the MoE FFN, ``"mamba"`` the Mamba mixer alone,
    ``"rglru"`` the RG-LRU mixer then the MLP.  Returns the new residual
    stream."""
    if kind not in PORTED_KINDS:
        raise _not_ported(kind)
    if kind == "mamba":
        return x + ssm_mod.mamba_apply(
            p["mamba"], rmsnorm(x, p["norm1"], cfg.norm_eps), cfg)
    if kind == "rglru":
        x = x + rglru_mod.rglru_apply(
            p["rglru"], rmsnorm(x, p["norm1"], cfg.norm_eps), cfg)
        return x + mlp_apply(p["mlp"], rmsnorm(x, p["norm2"], cfg.norm_eps),
                             cfg)
    h, _ = attn.self_attention(p["attn"],
                               rmsnorm(x, p["norm1"], cfg.norm_eps),
                               positions, cfg,
                               window=block_window(kind, cfg))
    x = x + h
    xn = rmsnorm(x, p["norm2"], cfg.norm_eps)
    if kind == "attn_moe":
        return x + moe_mod.moe_apply(p["moe"], xn, cfg)
    return x + mlp_apply(p["mlp"], xn, cfg)


def lm_head(params, x, cfg):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].transpose(-1, -2) if cfg.tie_embeddings \
        else params["head"]
    return (x @ w).float()


def forward(params, batch, cfg):
    """Full-sequence forward of ``batch["tokens"]`` (b, s); returns
    float32 logits (b, s, vocab)."""
    check_supported(cfg, batch)
    tokens = batch["tokens"]
    positions = positions_of(tokens)
    x = embed_tokens(params, tokens, cfg)
    for kind, p in zip(cfg.layer_kinds, params["blocks"]):
        x = apply_block(kind, p, x, positions, cfg)
    return lm_head(params, x, cfg)


def decode_step(params, tokens, cache, pos, cfg):
    """One-token decode with a KV cache: not ported yet."""
    raise _not_ported("decode")
