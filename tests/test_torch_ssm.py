"""The port's Mamba block and the reduced falcon-mamba model against the
JAX reference.

Reduced falcon-mamba-7b (2 layers, d=256, d_in=512, n=16, dt_rank 16,
float32), with the reference's parameters (``mamba_init`` /
``init_params`` with a ``PRNGKey``) carried across and inputs made with
numpy.  Tolerances: one layer rtol 1e-5 / atol 1e-6 (float32; the port
scans in sequence order, the reference's chunked associative scan in a
tree order within chunks); logits rtol 1e-4 / atol 1e-5.  A Mamba block
has no attention heads and no MLP, so the semantic plan's two branches
are the whole model twice and their average is the forward.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.serving import plans as jplans
from repro_torch.configs import get_config
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.serving import plans as tplans

LOGITS = dict(rtol=1e-4, atol=1e-5)
LAYER = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def block():
    jcfg = jget_config("falcon-mamba-7b").reduced()
    cfg = get_config("falcon-mamba-7b").reduced()
    jp = jssm.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = (np.random.RandomState(1).randn(2, 19, cfg.d_model)
         * 0.5).astype(np.float32)
    return jcfg, cfg, jp, tp, x


def _xc(jcfg, jp, x):
    """The reference's post-conv activations of x."""
    d_in = jcfg.ssm.expand * jcfg.d_model
    xi = (jnp.asarray(x) @ jp["in_proj"])[..., :d_in]
    return np.array(jax.nn.silu(jlayers.causal_conv1d(
        xi, jp["conv_w"], jp["conv_b"])))


def test_causal_conv1d():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 24).astype(np.float32)
    w = rng.randn(4, 24).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    got = tlayers.causal_conv1d(*(torch.from_numpy(a) for a in (x, w, b)))
    want = jlayers.causal_conv1d(*(jnp.asarray(a) for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


@pytest.mark.parametrize("scan_bf16", [False, True])
def test_ssm_inputs(block, scan_bf16):
    jcfg, cfg, jp, tp, x = block
    jcfg = dataclasses.replace(jcfg, ssm_scan_bf16=scan_bf16)
    cfg = dataclasses.replace(cfg, ssm_scan_bf16=scan_bf16)
    xc = _xc(jcfg, jp, x)
    want = jssm._ssm_inputs(jp, jnp.asarray(xc), jcfg)
    got = tssm._ssm_inputs(tp, torch.from_numpy(xc), cfg)
    dtype = torch.bfloat16 if scan_bf16 else torch.float32
    for g, w in zip(got, want):
        assert g.dtype == dtype and tuple(g.shape) == w.shape
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if scan_bf16:          # at most one bfloat16 ulp apart
            np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-6)
        else:
            np.testing.assert_allclose(g, w, **LAYER)


def test_mamba_apply(block):
    jcfg, cfg, jp, tp, x = block
    want = jssm.mamba_apply(jp, jnp.asarray(x), jcfg)
    got = tssm.mamba_apply(tp, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


def test_mamba_init_layout(block):
    """The reference's shapes and dtypes; ``dt_bias`` is numpy's
    RandomState(0) draw on both sides, so it is equal; ``A_log`` is the
    float32 log of 1..n (each side's ``log`` rounds its own way)."""
    jcfg, cfg, jp, tp, _ = block
    own = tssm.mamba_init(torch.Generator().manual_seed(0), cfg,
                          torch.float32)
    assert own.keys() == tp.keys()
    for k, a in own.items():
        assert a.shape == tp[k].shape and a.dtype == tp[k].dtype, k
    assert torch.equal(own["dt_bias"], tp["dt_bias"])
    np.testing.assert_allclose(own["A_log"].numpy(), tp["A_log"].numpy(),
                               rtol=1e-6)


def test_decode_paths_raise(block):
    """The decode paths, which raised until ROADMAP item 17 was ported:
    ``mamba_prefill`` (output and cache), ``init_mamba_cache`` and one
    ``mamba_decode`` step from the prefill's cache match the reference
    (the single-layer tolerance)."""
    jcfg, cfg, jp, tp, x = block
    wy, wc = jssm.mamba_prefill(jp, jnp.asarray(x), jcfg)
    gy, gc = tssm.mamba_prefill(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **LAYER)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]), **LAYER)
    zero = tssm.init_mamba_cache(cfg, 2)
    for k, w in jssm.init_mamba_cache(jcfg, 2).items():
        assert tuple(zero[k].shape) == w.shape and not zero[k].any()
    step = x[:, :1] * 0.7
    wy, wc = jssm.mamba_decode(jp, jnp.asarray(step), wc, jcfg)
    gy, gc = tssm.mamba_decode(tp, torch.from_numpy(step), gc, cfg)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **LAYER)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]), **LAYER)


@pytest.fixture(scope="module")
def reduced():
    jcfg = jget_config("falcon-mamba-7b").reduced()
    cfg = get_config("falcon-mamba-7b").reduced()
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
    """Both plans equal the forward bitwise (no heads or MLP channels to
    slice), and the semantic plan matches the reference's."""
    jcfg, cfg, jparams, params, tok = reduced
    batch = {"tokens": torch.from_numpy(tok)}
    mono = tmodel.forward(params, batch, cfg)
    assert torch.equal(tplans.pipeline_forward(params, batch, cfg, 2), mono)
    got = tplans.branch_forward(params, batch, cfg, num_branches=2)
    assert torch.equal(got, mono)
    want = jplans.branch_forward(jparams, {"tokens": jnp.asarray(tok)}, jcfg,
                                 num_branches=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
