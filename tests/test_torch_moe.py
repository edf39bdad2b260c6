"""The port's MoE layer and the reduced qwen2-moe model against the JAX
reference.

The reference's ``onehot`` and ``gather`` dispatches compute one function
(its own test holds them at atol 1e-5); the port runs one index dispatch
for both, and is held against each.  Configurations follow
``tests/test_moe_and_decode.py``: reduced qwen2-moe-a2.7b (d=256) with 4
experts top-2, group sizes that force several groups and zero-token
padding, with and without the shared expert, and a capacity factor of 1.0
that drops tokens.  Parameters are the reference's (``moe_init`` /
``init_params`` with a ``PRNGKey``) carried across; inputs are made with
numpy.  Tolerances: logits rtol 1e-4 / atol 1e-5; one layer rtol 1e-5
with atol 1e-6 times the largest output.  The layer's outputs reach ~30
at these inputs (expert outputs ~200), and each side's float32 softmax
rounds the gates its own way, an ulp of a gate times an expert output,
so a bound fixed in absolute terms would test the scale of the inputs.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serving import plans as jplans
from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.serving import plans as tplans

LOGITS = dict(rtol=1e-4, atol=1e-5)


def _close_layer(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def _moe_cfgs(gs=8, dispatch="onehot", cf=4.0, experts=4, k=2, shared=0):
    """The reference's and the port's reduced qwen2-moe with these MoE
    settings (``tests/test_moe_and_decode.py``'s ``_moe_cfg``)."""
    out = []
    for get in (jget_config, get_config):
        cfg = get("qwen2-moe-a2.7b").reduced()
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, group_size=gs, dispatch=dispatch, capacity_factor=cf,
            num_experts=experts, top_k=k, num_shared_experts=shared,
            shared_d_ff=cfg.d_model if shared else 0)))
    return out


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _layer_case(seed, **kw):
    jcfg, cfg = _moe_cfgs(**kw)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    x = (np.random.RandomState(3 + seed).randn(2, 11, cfg.d_model)
         * 0.5).astype(np.float32)
    return jcfg, cfg, jp, _torch_tree(jp), x


@pytest.mark.parametrize("dispatch", ["onehot", "gather"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("gs", [4, 8, 64])
def test_moe_apply_matches_both_dispatches(gs, shared, dispatch):
    jcfg, cfg, jp, tp, x = _layer_case(0, gs=gs, shared=shared,
                                       dispatch=dispatch)
    want = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    got = tmoe.moe_apply(tp, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _close_layer(got.numpy(), want)


@pytest.mark.parametrize("dispatch", ["onehot", "gather"])
def test_moe_apply_with_dropped_tokens(dispatch):
    """cf=1.0 at gs=64: capacity 32 per expert, and the hot experts drop
    their later entries on both sides."""
    jcfg, cfg, jp, tp, x = _layer_case(1, gs=64, cf=1.0, shared=1,
                                       dispatch=dispatch)
    xt = torch.from_numpy(x)
    xg, _, gs = tmoe._group(xt, cfg.moe)
    C = tmoe._capacity(gs, cfg.moe)
    _, _, slot = tmoe.moe_route(tmoe.router_logits(tp, xg), cfg.moe.top_k)
    assert int((slot >= C).sum()) > 0              # something overflows
    want = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    _close_layer(tmoe.moe_apply(tp, xt, cfg).numpy(), want)


def test_router_topk_matches_reference():
    jcfg, cfg, jp, tp, x = _layer_case(2)
    x2 = x.reshape(-1, cfg.d_model)
    want = jmoe.router_topk(jp, jnp.asarray(x2), jcfg.moe)
    got = tmoe.router_topk(tp, torch.from_numpy(x2), cfg.moe)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("S,gs", [(22, 4), (22, 8), (22, 64), (8, 8)])
def test_group_and_capacity(S, gs):
    """Groups, zero-token padding and capacity as the reference makes
    them."""
    jcfg, cfg = _moe_cfgs(gs=gs)
    x = np.random.RandomState(S).randn(2, S // 2, 8).astype(np.float32)
    jg, jS, jgs = jmoe._group(jnp.asarray(x), jcfg.moe)
    tg, tS, tgs = tmoe._group(torch.from_numpy(x), cfg.moe)
    assert (tS, tgs) == (jS, jgs)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tmoe._capacity(tgs, cfg.moe) == jmoe._capacity(jgs, jcfg.moe)


@pytest.fixture(scope="module")
def reduced():
    jcfg = jget_config("qwen2-moe-a2.7b").reduced()
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    tok = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (2, 16)).astype(np.int32)
    return jcfg, cfg, jparams, params, tok


def test_forward_matches_reference(reduced):
    jcfg, cfg, jparams, params, tok = reduced
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tok)}, jcfg)
    got = tmodel.forward(params, {"tokens": torch.from_numpy(tok)}, cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_plans_match_reference(reduced):
    """The layer plan equals the forward bitwise; the semantic plan slices
    only the attention heads of an ``attn_moe`` block (the MoE is not
    sliced), as the reference's."""
    jcfg, cfg, jparams, params, tok = reduced
    batch = {"tokens": torch.from_numpy(tok)}
    mono = tmodel.forward(params, batch, cfg)
    assert torch.equal(tplans.pipeline_forward(params, batch, cfg, 2), mono)
    want = jplans.branch_forward(jparams, {"tokens": jnp.asarray(tok)}, jcfg,
                                 num_branches=2)
    got = tplans.branch_forward(params, batch, cfg, num_branches=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    sliced = tplans._slice_block_params(params["blocks"][0], cfg, 1, 2)
    assert sliced["attn"]["wq"].shape[1] == cfg.num_heads // 2
    assert sliced["moe"] is params["blocks"][0]["moe"]
