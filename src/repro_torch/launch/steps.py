"""Train, prefill, serve (one-token decode) and eval steps.

The port of ``repro.launch.steps`` at ``mesh=None``: each factory returns
a function over the port's parameters that mirrors the reference's step.
The port runs on one card: a ``mesh`` raises (a sharded model is ROADMAP
queue 1 items 12 and 18).  The factories resolve their device when they
are made (``device="cuda"`` unless the caller asks for the CPU); the steps
move the batch there.

    train_step(params, opt_state, batch[, lr_t]) -> (params, opt_state,
                                                    {"loss", "grad_norm"})
    prefill_step(params, batch)             -> (last logits (b, vocab), cache)
    serve_step(params, tokens, cache, pos)  -> (logits (b, vocab), cache)
    eval_step(params, batch)                -> logits (b, s, vocab)
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import (decode_step, forward, loss_fn, prefill,
                                      stack_groups)
from repro_torch.optim.optimizers import clip_by_global_norm_, make_optimizer
from repro_torch.tree import tree_leaves, tree_unflatten


def _single_card(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "repro_torch steps run on one card; a mesh is ROADMAP queue 1 "
            "items 12 and 18 (sharding and the remaining model zoo)")


def _on(batch, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def make_train_step(cfg, mesh=None, lr=3e-4, clip=1.0, device="cuda"):
    """train_step(params, opt_state, batch, lr_t=None) -> (params,
    opt_state, {"loss": the mean cross entropy, "grad_norm": the norm
    before clipping}).  The gradients are ``torch.autograd.grad`` of
    ``loss_fn`` over the flat parameter list (``tree_leaves``); over
    ``cfg.grad_accum`` microbatches (the batch split along its first axis)
    they accumulate in float32 for AdamW and in the parameter dtype for
    Adafactor and are divided by their count, as the reference's scan;
    then ``clip_by_global_norm_(·, clip)`` and ``cfg.optimizer``'s update
    at ``lr_t`` (a float or a () tensor), else ``lr``.  ``opt_state`` is
    ``make_optimizer(cfg.optimizer, stack_groups(params, cfg))``'s init
    of the flat parameters.  The step writes the new parameters and state
    into the given tensors (the reference's arithmetic, bit for bit, one
    leaf at a time) and returns them: it holds one copy of the model's
    state, as the reference's jitted step does with donated buffers.
    The optimizer's groups are read from the first call's parameters."""
    _single_card(mesh)
    dev = resolve(device)
    accum_dtype = torch.float32 if cfg.optimizer == "adamw" \
        else dtype_of(cfg.param_dtype)
    update = None

    def grads_of(leaves, params, mb):
        with torch.enable_grad():
            wrt = [p.detach().requires_grad_() for p in leaves]
            total, metrics = loss_fn(tree_unflatten(params, wrt), mb, cfg)
            grads = torch.autograd.grad(total, wrt, allow_unused=True)
        return ([torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)], metrics["ce"].detach())

    def train_step(params, opt_state, batch, lr_t=None):
        nonlocal update
        if update is None:
            _, update = make_optimizer(cfg.optimizer,
                                       stack_groups(params, cfg))
        step_lr = lr if lr_t is None else lr_t
        batch = _on(batch, dev)
        leaves = tree_leaves(params)
        A = cfg.grad_accum
        if A > 1:
            micro = {k: v.reshape((A, v.shape[0] // A) + v.shape[1:])
                     for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                     for p in leaves]
            ce = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(A):
                g, c = grads_of(leaves, params,
                                {k: v[i] for k, v in micro.items()})
                for a, b in zip(grads, g):
                    a.add_(b.to(accum_dtype))
                del g
                ce = ce + c
            for g in grads:
                g.div_(A)
            ce = ce / A
        else:
            grads, ce = grads_of(leaves, params, batch)
        gnorm = clip_by_global_norm_(grads, clip)
        with torch.no_grad():
            leaves, opt_state = update(grads, opt_state, leaves, step_lr)
        return (tree_unflatten(params, leaves), opt_state,
                {"loss": ce, "grad_norm": gnorm})

    return train_step


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
