"""Train, prefill, serve (one-token decode) and eval steps.

The port of ``repro.launch.steps``: each factory returns a function over
the port's parameters that mirrors the reference's step.  Without a mesh
the step runs on one device, resolved when the factory is made
(``device="cuda"`` unless the caller asks for the CPU or the meta
device), and moves the batch there.  With a ``DeviceMesh`` (the
production mesh of ``launch.mesh``, or any other) the parameters, state,
batch and cache are DTensors placed by ``launch.sharding``, the model
constrains its activations at the reference's points
(``sharding.make_constrain``) and DTensor runs each operator on the
shards; the optimizer updates each leaf's local shard (its update is
elementwise, or for Adafactor runs on the DTensors).

    train_step(params, opt_state, batch[, lr_t]) -> (params, opt_state,
                                                    {"loss", "grad_norm"})
    prefill_step(params, batch)             -> (last logits (b, vocab), cache)
    serve_step(params, tokens, cache, pos)  -> (logits (b, vocab), cache)
    eval_step(params, batch)                -> logits (b, s, vocab)
"""
from __future__ import annotations

import functools

import torch

from repro_torch.device import resolve
from repro_torch.launch.sharding import make_constrain
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import (decode_step, forward, loss_fn, prefill,
                                      stack_groups)
from repro_torch.optim.optimizers import clip_by_global_norm_, make_optimizer
from repro_torch.tree import tree_leaves, tree_unflatten


def _setup(cfg, mesh, device):
    """(device, constrain) of a step: without a mesh the resolved device
    and no constraint; with one the mesh's device type and
    ``make_constrain``."""
    if mesh is None:
        return resolve(device), None
    if not hasattr(mesh, "mesh_dim_names") or not hasattr(mesh,
                                                          "device_type"):
        raise TypeError(f"mesh must be a torch DeviceMesh, not "
                        f"{type(mesh).__name__}")
    return torch.device(mesh.device_type), make_constrain(mesh, cfg)


def _meshed(step, mesh):
    """``step`` itself without a mesh; on one, run under DTensor's
    implicit replication: the model's small plain tensors (positions,
    masks, scalars) join the DTensors as replicated."""
    if mesh is None:
        return step
    from torch.distributed.tensor.experimental import implicit_replication

    @functools.wraps(step)
    def run(*args, **kwargs):
        with implicit_replication():
            return step(*args, **kwargs)

    return run


def _placed_like(g, p):
    """A gradient in its parameter's placements (on a mesh autograd leaves
    it where the last operator put it: a partial sum, another split),
    ready for the shard-local update; any other tensor as it is."""
    if hasattr(g, "placements") and tuple(g.placements) != tuple(
            p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _on(batch, dev):
    return {k: v if hasattr(v, "placements")
            else torch.as_tensor(v, device=dev) for k, v in batch.items()}


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
    The optimizer's groups are read from the first call's parameters.
    On a mesh microbatch i takes rows i, i + A, i + 2A, ... (the
    reference's split takes A consecutive blocks): each rank's rows of the
    batch then stay its own; the gradient is the same mean over the same
    rows."""
    dev, constrain = _setup(cfg, mesh, device)
    accum_dtype = torch.float32 if cfg.optimizer == "adamw" \
        else dtype_of(cfg.param_dtype)
    update = None

    def grads_of(leaves, params, mb):
        with torch.enable_grad():
            wrt = [p.detach().requires_grad_() for p in leaves]
            total, metrics = loss_fn(tree_unflatten(params, wrt), mb, cfg,
                                     constrain=constrain)
            grads = torch.autograd.grad(total, wrt, allow_unused=True)
        return ([torch.zeros_like(p) if g is None else _placed_like(g, p)
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
            if mesh is None:
                micro = {k: v.reshape((A, v.shape[0] // A) + v.shape[1:])
                         for k, v in batch.items()}
            else:
                micro = {k: v.reshape((v.shape[0] // A, A) + v.shape[1:])
                         .transpose(0, 1) for k, v in batch.items()}
            grads = [torch.zeros_like(p, dtype=accum_dtype) for p in leaves]
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

    return _meshed(train_step, mesh)


def make_prefill_step(cfg, mesh=None, device="cuda", max_ctx=None):
    """prefill_step(params, batch) -> (logits of the last position, cache).
    The caches hold ``max_ctx`` positions, by default the prompt's length
    as in the reference's step (decoding past it wraps the ring, a
    sliding window of the prompt's length); ``prefill``'s own default,
    s + 32, keeps 32 decode steps exact."""
    dev, constrain = _setup(cfg, mesh, device)

    def prefill_step(params, batch):
        batch = _on(batch, dev)
        logits, cache = prefill(params, batch, cfg,
                                max_ctx=max_ctx or batch["tokens"].shape[1],
                                constrain=constrain)
        return logits[:, -1], cache

    return _meshed(prefill_step, mesh)


def make_serve_step(cfg, mesh=None, device="cuda"):
    """serve_step(params, tokens (b, 1), cache, pos) -> (logits (b, vocab),
    cache): one-token decode over the KV / state cache."""
    dev, constrain = _setup(cfg, mesh, device)

    def serve_step(params, tokens, cache, pos, extras=None):
        tokens = _on({"tokens": tokens}, dev)["tokens"]
        logits, cache = decode_step(params, tokens, cache, pos, cfg,
                                    batch_extras=extras,
                                    constrain=constrain)
        return logits[:, -1], cache

    return _meshed(serve_step, mesh)


def make_eval_step(cfg, mesh=None, device="cuda"):
    """eval_step(params, batch) -> full-sequence logits."""
    dev, constrain = _setup(cfg, mesh, device)

    def eval_step(params, batch):
        return forward(params, _on(batch, dev), cfg, constrain=constrain)

    return _meshed(eval_step, mesh)
