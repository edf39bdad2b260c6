"""Input stand-ins per (architecture × input shape), allocating nothing.

The port of ``repro.launch.specs``: the reference's ShapeDtypeStructs
are tensors on the meta device here (``device="meta"``, the default), or
any other device a caller asks for (the dry-run turns them into fake
tensors).  They drive the FLOP counter (``launch.flopcount``) and the
dry-run (``launch.dryrun``).
"""
from __future__ import annotations

import torch

from repro_torch.configs import INPUT_SHAPES
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import init_cache, init_params

#: above this context a decode runs the sliding-window cache
#: (``cfg.long_context_window``) on the dense architectures, as the
#: reference's ``decode_specs``; the sub-quadratic ones carry their
#: states and local windows as they are
SLIDING_ABOVE = 65536


def _spec(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def train_batch_specs(cfg, batch, seq, device="meta"):
    """``tokens`` and ``labels`` (b, s) int32, or (b, s, cb) under
    codebooks, and the entries the config reads: ``visual_embeds`` /
    ``visual_mask``, ``cond``, ``positions3``."""
    tok = (batch, seq, cfg.num_codebooks) if cfg.num_codebooks \
        else (batch, seq)
    specs = {"tokens": _spec(tok, torch.int32, device),
             "labels": _spec(tok, torch.int32, device)}
    cd = dtype_of(cfg.compute_dtype)
    if cfg.visual_frontend:
        specs["visual_embeds"] = _spec((batch, seq, cfg.d_model), cd, device)
        specs["visual_mask"] = _spec((batch, seq), torch.bool, device)
    if cfg.cross_attention:
        specs["cond"] = _spec((batch, cfg.cond_len, cfg.d_model), cd, device)
    if cfg.pos_emb == "mrope":
        specs["positions3"] = _spec((batch, 3, seq), torch.int32, device)
    return specs


def prefill_batch_specs(cfg, batch, seq, device="meta"):
    specs = train_batch_specs(cfg, batch, seq, device)
    specs.pop("labels")
    return specs


def decode_specs(cfg, batch, ctx_len, device="meta"):
    """(tokens, cache, pos, extras) for ``serve_step``: the cache of
    ``ctx_len`` positions (the sliding window above ``SLIDING_ABOVE``);
    ``pos`` is ``ctx_len - 1``, a Python int (the port's decode reads its
    position on the host), so every ring slot is written."""
    tok = (batch, 1, cfg.num_codebooks) if cfg.num_codebooks else (batch, 1)
    sliding = cfg.long_context_window if ctx_len > SLIDING_ABOVE else None
    cache = init_cache(cfg, batch, ctx_len, sliding=sliding, device=device)
    extras = {}
    cd = dtype_of(cfg.compute_dtype)
    if cfg.cross_attention:
        extras["cond"] = _spec((batch, cfg.cond_len, cfg.d_model), cd, device)
    if cfg.visual_frontend:
        extras["visual_embeds"] = _spec((batch, 1, cfg.d_model), cd, device)
        extras["visual_mask"] = _spec((batch, 1), torch.bool, device)
    return _spec(tok, torch.int32, device), cache, ctx_len - 1, extras


def params_specs(cfg, device="meta"):
    """The parameters' shapes and dtypes, drawn from nothing
    (``models.model.init_params`` on the meta device)."""
    return init_params(cfg, device=device)


def input_specs(cfg, shape_name: str, device="meta"):
    """Every model input of one named input shape (``INPUT_SHAPES``)."""
    info = INPUT_SHAPES[shape_name]
    b, s = info["global_batch"], info["seq_len"]
    if info["kind"] == "train":
        return {"batch": train_batch_specs(cfg, b, s, device)}
    if info["kind"] == "prefill":
        return {"batch": prefill_batch_specs(cfg, b, s, device)}
    tokens, cache, pos, extras = decode_specs(cfg, b, s, device)
    return {"tokens": tokens, "cache": cache, "pos": pos, "extras": extras}
