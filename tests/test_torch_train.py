"""The port's training loss and its gradients against the JAX reference.

Every family the port trains, cut to ``reduced()`` (float32): TinyLlama
(``attn``), qwen2-moe (``attn_moe``, whose load-balance aux loss is not
0), falcon-mamba (``mamba``), recurrentgemma (``rglru`` +
``local_attn``), qwen2-vl (``attn`` under M-RoPE, its three streams the
plain positions) and musicgen (``xattn`` over the zero ``cond`` that
``make_ctx`` supplies, (b, s, 4) codebook tokens and labels).  The reference's parameters (``init_params(PRNGKey(0))``)
go to the port through ``params_from_jax``; the batch is the
``TokenPipeline``'s.  ``loss_fn``'s value, its ``ce`` and ``aux`` and the
gradient of every parameter (``jax.value_and_grad`` against
``torch.autograd.grad`` through the kernels' backward twins) agree at
rtol 1e-4 / atol 1e-5 of each leaf's largest entry.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import TokenPipeline
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from repro_torch.tree import tree_flatten, tree_leaves

TOL = dict(rtol=1e-4)
ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
         "recurrentgemma-9b", "qwen2-vl-7b", "musicgen-medium")
B, S = 2, 12


def _close(got, want, where=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, err_msg=where,
                               **TOL)


def _setup(arch):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    batch = TokenPipeline(cfg.vocab_size, S, B, seed=3,
                          num_codebooks=cfg.num_codebooks).next_batch()
    return jcfg, cfg, params, batch


def _port_loss_and_grads(cfg, params, batch):
    tparams = tmodel.params_from_jax(params, cfg, device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(tparams)]
    total, metrics = tmodel.loss_fn(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(total, leaves)
    return total, metrics, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    jcfg, cfg, params, batch = _setup(arch)
    (want_total, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, jcfg), has_aux=True))(params,
                                                                batch)
    total, metrics, grads = _port_loss_and_grads(cfg, params, batch)
    _close(total, want_total, "total")
    _close(metrics["ce"], want_m["ce"], "ce")
    _close(metrics["aux"], want_m["aux"], "aux")
    if arch == "qwen2-moe-a2.7b":
        assert float(metrics["aux"].detach()) > 0
    want = tree_leaves(tmodel.params_from_jax(
        jax.tree.map(np.asarray, want_g), cfg, device="cpu"))
    names = [n for n, _ in tree_flatten(tmodel.params_from_jax(
        params, cfg, device="cpu"))]
    assert len(grads) == len(want)
    for name, g, w in zip(names, grads, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _close(g, w.numpy(), f"{arch} d{name}")


def test_remat_equals_no_remat_bitwise():
    _, cfg, params, batch = _setup("qwen2-moe-a2.7b")
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        total, metrics, grads = _port_loss_and_grads(c, params, batch)
        out.append([total, metrics["aux"], *grads])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_forward_without_aux_is_unchanged():
    _, cfg, params, batch = _setup("qwen2-moe-a2.7b")
    tparams = tmodel.params_from_jax(params, cfg, device="cpu")
    tb = {"tokens": torch.from_numpy(batch["tokens"])}
    logits = tmodel.forward(tparams, tb, cfg)
    logits2, aux = tmodel.forward(tparams, tb, cfg, with_aux=True)
    assert torch.equal(logits, logits2) and aux.shape == ()


def test_codebook_labels_raise_naming_their_item():
    _, cfg, params, batch = _setup("tinyllama-1.1b")
    tparams = tmodel.params_from_jax(params, cfg, device="cpu")
    bad = {"tokens": torch.from_numpy(batch["tokens"]),
           "labels": torch.from_numpy(batch["labels"])[..., None]}
    with pytest.raises(ValueError, match="do not match tokens"):
        tmodel.loss_fn(tparams, bad, cfg)
