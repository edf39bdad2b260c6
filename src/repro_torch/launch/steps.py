"""Prefill, serve (one-token decode) and eval steps.

The port of ``repro.launch.steps``' serving factories at ``mesh=None``:
each returns a function over the port's parameters that mirrors the
reference's step.  The port runs on one card: a ``mesh`` raises (a
sharded model is ROADMAP queue 1 items 12 and 18), and the training step
comes with the training slice.  The factories resolve their device when
they are made (``device="cuda"`` unless the caller asks for the CPU);
the steps move the batch's tokens there.

    prefill_step(params, batch)             -> (last logits (b, vocab), cache)
    serve_step(params, tokens, cache, pos)  -> (logits (b, vocab), cache)
    eval_step(params, batch)                -> logits (b, s, vocab)
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.models.model import decode_step, forward, prefill


def _single_card(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "repro_torch steps run on one card; a mesh is ROADMAP queue 1 "
            "items 12 and 18 (sharding and the remaining model zoo)")


def _on(batch, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def make_prefill_step(cfg, mesh=None, device="cuda", max_ctx=None):
    """prefill_step(params, batch) -> (logits of the last position, cache).
    The caches hold ``max_ctx`` positions, by default the prompt's length
    as in the reference's step (decoding past it wraps the ring, a
    sliding window of the prompt's length); ``prefill``'s own default,
    s + 32, keeps 32 decode steps exact."""
    _single_card(mesh)
    dev = resolve(device)

    def prefill_step(params, batch):
        batch = _on(batch, dev)
        logits, cache = prefill(params, batch, cfg,
                                max_ctx=max_ctx or batch["tokens"].shape[1])
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg, mesh=None, device="cuda"):
    """serve_step(params, tokens (b, 1), cache, pos) -> (logits (b, vocab),
    cache): one-token decode over the KV / state cache."""
    _single_card(mesh)
    dev = resolve(device)

    def serve_step(params, tokens, cache, pos, extras=None):
        logits, cache = decode_step(params, torch.as_tensor(tokens,
                                                            device=dev),
                                    cache, pos, cfg, batch_extras=extras)
        return logits[:, -1], cache

    return serve_step


def make_eval_step(cfg, mesh=None, device="cuda"):
    """eval_step(params, batch) -> full-sequence logits."""
    _single_card(mesh)
    dev = resolve(device)

    def eval_step(params, batch):
        return forward(params, _on(batch, dev), cfg)

    return eval_step
