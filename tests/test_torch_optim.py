"""The port's optimizers, clipping and schedule against the JAX reference
(``repro.optim.optimizers``).

``warmup_cosine`` must equal the reference's float32 value bit for bit;
AdamW and Adafactor run three steps on the reference's parameter tree of a
reduced model (``init_params(PRNGKey(0))``, body periods stacked) and on
the port's per-layer tensors (``params_from_jax``, Adafactor over
``stack_groups``), from the same gradients, and agree at rtol 1e-6
(atol 1e-6 of each leaf's largest entry); the clipping at rtol 1e-6 above
and below its limit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-6)


def _close(got, want, where=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, atol=1e-6 * scale, err_msg=where,
                               **TOL)


@pytest.mark.parametrize("warmup,total", [(20, 100), (100, 10000), (5, 37),
                                          (1, 120), (20, 1000)])
def test_warmup_cosine_is_bitwise_the_reference(warmup, total):
    for step in range(121):
        want = np.float32(jopt.warmup_cosine(step, 3e-4,
                                             warmup_steps=warmup,
                                             total_steps=total))
        got = topt.warmup_cosine(step, 3e-4, warmup_steps=warmup,
                                 total_steps=total)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), (step, got, want)


@pytest.mark.parametrize("max_norm", [1e-3, 1e3])
def test_clip_by_global_norm_above_and_below_the_limit(max_norm):
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(3, 5).astype(np.float32),
            "b": [rng.randn(7).astype(np.float32),
                  rng.randn(2, 2, 2).astype(np.float32)]}
    want, want_n = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                            max_norm)
    got = [torch.from_numpy(a).clone() for a in tree_leaves(tree)]
    n = topt.clip_by_global_norm_(got, max_norm)
    _close(n, want_n, "norm")
    _close(topt.global_norm([torch.from_numpy(a)
                             for a in tree_leaves(tree)]),
           jopt.global_norm(tree), "global_norm")
    for g, w in zip(got, tree_leaves(want)):
        assert g.dtype == torch.float32
        _close(g, w, f"clipped at {max_norm}")
    if max_norm > float(want_n):
        for g, a in zip(got, tree_leaves(tree)):
            np.testing.assert_array_equal(g.numpy(), a)


def test_clip_keeps_each_leaf_dtype():
    got = [torch.ones(4, dtype=torch.bfloat16), torch.ones(3)]
    n = topt.clip_by_global_norm_(got, 0.5)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32]
    assert n.dtype == torch.float32
    want = (torch.ones(()) * 0.5 / n).bfloat16()
    assert torch.equal(got[0], want.expand(4))


def _model(arch):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(1)
    grads = [jax.tree.map(lambda p: (rng.randn(*p.shape) * 0.01).astype(
        p.dtype), params) for _ in range(3)]
    return jcfg, cfg, params, grads


def _run_both(name, arch):
    jcfg, cfg, params, grads = _model(arch)
    tparams = tmodel.params_from_jax(params, cfg, device="cpu")
    leaves = tree_leaves(tparams)
    groups = tmodel.stack_groups(tparams, cfg)
    j_init, j_update = jopt.make_optimizer(name)
    t_init, t_update = topt.make_optimizer(name, groups)
    jstate = j_init(jax.tree.map(jnp.asarray, params))
    tstate = t_init(leaves)
    jp = jax.tree.map(jnp.asarray, params)
    step = jax.jit(j_update)
    for i, g in enumerate(grads):
        lr = jopt.warmup_cosine(i, 1e-2, warmup_steps=2, total_steps=3)
        jp, jstate = step(jax.tree.map(jnp.asarray, g), jstate, jp, lr)
        tg = tree_leaves(tmodel.params_from_jax(g, cfg, device="cpu"))
        leaves, tstate = t_update(tg, tstate, leaves,
                                  topt.warmup_cosine(i, 1e-2, 2, 3))
    return cfg, jp, jstate, leaves, tstate


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b"])
def test_adamw_tree_matches_reference(arch):
    cfg, jp, jstate, leaves, tstate = _run_both("adamw", arch)
    want_p = tree_leaves(tmodel.params_from_jax(jax.tree.map(np.asarray, jp),
                                                cfg, device="cpu"))
    for i, (g, w) in enumerate(zip(leaves, want_p)):
        _close(g, w.numpy(), f"param {i}")
    want_s = tmodel.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                       cfg, device="cpu")
    assert int(tstate.step) == int(want_s.step) == 3
    for field in ("m", "v"):
        for i, (g, w) in enumerate(zip(getattr(tstate, field),
                                       getattr(want_s, field))):
            _close(g, w.numpy(), f"{field} {i}")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b",
                                  "qwen2-moe-a2.7b"])
def test_adafactor_over_stack_groups_matches_reference(arch):
    cfg, jp, jstate, leaves, tstate = _run_both("adafactor", arch)
    want_p = tree_leaves(tmodel.params_from_jax(jax.tree.map(np.asarray, jp),
                                                cfg, device="cpu"))
    for i, (g, w) in enumerate(zip(leaves, want_p)):
        _close(g, w.numpy(), f"param {i}")
    want_s = tmodel.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                       cfg, device="cpu")
    assert int(tstate.step) == int(want_s.step) == 3
    for field in ("vr", "vc"):
        got, want = getattr(tstate, field), getattr(want_s, field)
        assert [tuple(t.shape) for t in got] == \
            [tuple(t.shape) for t in want]
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w.numpy(), f"{field} {i}")


def test_adafactor_without_groups_is_per_tensor():
    p = [torch.randn(4, 3), torch.randn(5)]
    state = topt.adafactor_init(p)
    assert [tuple(t.shape) for t in state.vr] == [(4,), (5,)]
    assert [tuple(t.shape) for t in state.vc] == [(3,), (1,)]
    new, state = topt.adafactor_update_([torch.ones(4, 3), torch.ones(5)],
                                        state, p, 0.1)
    assert int(state.step) == 1 and new[0] is p[0]


def test_make_optimizer_names():
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd")


def _clone_state(state):
    return type(state)(state.step.clone(),
                       *[[t.clone() for t in x] for x in state[1:]])


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_inplace_update_in_slices_equals_functional(monkeypatch, optimizer):
    """The update, in slices of 7 elements, gives the bits of the update
    over whole tensors (for AdamW also of the functional
    ``adamw_update``) and writes them into its arguments; so does the
    clip."""
    rng = np.random.RandomState(4)
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in ((5, 6), (11,), (3, 4, 2))]
    grads = [torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
             for p in params]
    init, update = topt.make_optimizer(optimizer)
    state = init(params)
    want, want_s = update(grads, _clone_state(state),
                          [p.clone() for p in params], 1e-2)
    if optimizer == "adamw":
        fn, fn_s = topt.adamw_update(grads, state, params, 1e-2)
        assert all(torch.equal(a, b) for a, b in zip(fn, want))
        for field in ("m", "v"):
            assert all(torch.equal(a, b) for a, b in
                       zip(getattr(fn_s, field), getattr(want_s, field)))
    clipped = [g.clone() for g in grads]
    n = topt.clip_by_global_norm_(clipped, 0.5)
    monkeypatch.setattr(topt, "SLICE", 7)
    mine = [p.clone() for p in params]
    got, got_s = update(grads, state, mine, 1e-2)
    assert all(a is b for a, b in zip(got, mine))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for field in got_s._fields[1:]:
        assert all(torch.equal(a, b) for a, b in
                   zip(getattr(got_s, field), getattr(want_s, field)))
        assert all(a is b for a, b in zip(getattr(got_s, field),
                                          getattr(state, field)))
    mine = [g.clone() for g in grads]
    assert torch.equal(topt.clip_by_global_norm_(mine, 0.5), n)
    assert all(torch.equal(a, b) for a, b in zip(mine, clipped))
