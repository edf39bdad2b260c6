"""``launch.steps.make_train_step`` against the JAX reference's jitted
train step.

Three steps from the same parameters and optimizer state
(``params_from_jax``, ``opt_state_from_jax``) on the same
``TokenPipeline`` batches at the training CLI's schedule (peak 3e-4,
warmup 20 of 100 steps), reduced float32 models: TinyLlama under AdamW, TinyLlama under Adafactor (its
statistics over ``stack_groups``), recurrentgemma with
``grad_accum=2``, qwen2-vl (M-RoPE) and musicgen (``xattn`` blocks, the
pipeline's (b, s, 4) codebook batches).  Parameters, optimizer state, loss and gradient norm
agree at rtol 1e-4 / atol 1e-5 of each leaf's largest entry.

AdamW's update m̂ / (√v̂ + eps) of a gradient entry near 0 magnifies that
entry's float32 rounding (XLA and PyTorch sum in other orders): its first
step is g / (|g| + eps).  A leaf the reference initialises to 0 (the
norms, the biases) holds nothing but such updates, so its scale is the
learning rate's and, from the reference's init, TinyLlama's
``blocks/1/norm1`` ends 1.1e-3 of its scale from the reference after one
step while its gradient, m and v agree to 2e-6.  The runs therefore start
from the reference's init with a seeded offset (normal × 0.1) on those
leaves; ``test_train_steps_from_init_match_in_moments`` holds the run
from the init itself on the loss, the gradient norm and the moments.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import TokenPipeline
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves, tree_unflatten

STEPS, S = 3, 12
#: launch/train.py's learning rate and schedule
PEAK, WARMUP, TOTAL = 3e-4, 20, 100


def _close(got, want, where=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=where)


def _offset_zero_leaves(params):
    """The reference's init with normal × 0.1 (seed 5) added to every
    leaf that it initialises to 0."""
    rng = np.random.RandomState(5)

    def offset(p):
        p = np.asarray(p)
        if np.any(p):
            return jnp.asarray(p)
        return jnp.asarray((0.1 * rng.randn(*p.shape)).astype(p.dtype))
    return jax.tree.map(offset, params)


def _run(arch, change, batch, from_init=False):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **change)
    cfg = dataclasses.replace(get_config(arch).reduced(), **change)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    if not from_init:
        jparams = _offset_zero_leaves(jparams)
    j_init, _ = jopt.make_optimizer(jcfg.optimizer)
    jstate = j_init(jparams)
    np_params = jax.tree.map(np.asarray, jparams)
    params = tmodel.params_from_jax(np_params, cfg, device="cpu")
    state = tmodel.opt_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                      device="cpu")
    jstep = jax.jit(jsteps.make_train_step(jcfg, mesh=None, lr=PEAK))
    tstep = tsteps.make_train_step(cfg, lr=PEAK, device="cpu")
    pipe = TokenPipeline(cfg.vocab_size, S, batch, seed=2,
                         num_codebooks=cfg.num_codebooks)
    for i in range(STEPS):
        b = pipe.next_batch()
        lr = jopt.warmup_cosine(i, PEAK, warmup_steps=WARMUP,
                                total_steps=TOTAL)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()},
                                    jnp.float32(lr))
        params, state, m = tstep(params, state, b,
                                 topt.warmup_cosine(i, PEAK, WARMUP, TOTAL))
        _close(m["loss"], jm["loss"], f"loss at step {i}")
        _close(m["grad_norm"], jm["grad_norm"], f"grad_norm at step {i}")
    want_s = tmodel.opt_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                       device="cpu")
    assert type(state) is type(want_s) and int(state.step) == STEPS
    for field in state._fields[1:]:
        for i, (g, w) in enumerate(zip(getattr(state, field),
                                       getattr(want_s, field))):
            _close(g, w.numpy(), f"{field} {i}")
    return cfg, params, jparams


@pytest.mark.parametrize("arch,change,batch", [
    ("tinyllama-1.1b", {}, 2),
    ("tinyllama-1.1b", {"optimizer": "adafactor"}, 2),
    ("recurrentgemma-9b", {"grad_accum": 2}, 4),
    ("qwen2-vl-7b", {}, 2), ("musicgen-medium", {}, 2)])
def test_three_train_steps_match_reference(arch, change, batch):
    cfg, params, jparams = _run(arch, change, batch)
    want = tree_leaves(tmodel.params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    for i, (g, w) in enumerate(zip(tree_leaves(params), want)):
        assert g.dtype == w.dtype
        _close(g, w.numpy(), f"param {i}")


def test_train_steps_from_init_match_in_moments():
    _run("tinyllama-1.1b", {}, 2, from_init=True)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_step_writes_in_place_what_the_functional_update_gives(
        optimizer):
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              optimizer=optimizer)
    params = tmodel.init_params(cfg, device="cpu")
    groups = tmodel.stack_groups(params, cfg)
    init, update = topt.make_optimizer(optimizer, groups)
    state = init(tree_leaves(params))
    batch = TokenPipeline(cfg.vocab_size, 8, 2).next_batch()
    # the optimizer's update, on copies, from the same gradients
    leaves = tree_leaves(params)
    wrt = [p.detach().clone().requires_grad_() for p in leaves]
    total, _ = tmodel.loss_fn(
        tree_unflatten(params, wrt),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = list(torch.autograd.grad(total, wrt))
    topt.clip_by_global_norm_(grads, 1.0)
    want, want_state = update(
        grads, type(state)(state.step.clone(),
                           *[[t.clone() for t in x] for x in state[1:]]),
        [p.detach().clone() for p in leaves], 3e-4)
    step = tsteps.make_train_step(cfg, device="cpu")
    new, new_state, m = step(params, state, batch)
    got = tree_leaves(new)
    assert all(a is b for a, b in zip(got, tree_leaves(params)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(new_state.step) == 1 and np.isfinite(float(m["loss"]))
    for field in new_state._fields[1:]:
        assert all(torch.equal(a, b) for a, b in
                   zip(getattr(new_state, field),
                       getattr(want_state, field)))



def test_train_step_refuses_a_mesh():
    cfg = get_config("tinyllama-1.1b").reduced()
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsteps.make_train_step(cfg, mesh=object(), device="cpu")
