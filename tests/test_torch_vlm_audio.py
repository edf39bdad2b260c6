"""The port's last two served families against the JAX reference:
qwen2-vl-7b (M-RoPE over (temporal, height, width) ids, visual embeds
merged under a mask) and musicgen-medium (``xattn`` blocks: self
attention, cross attention to a conditioning sequence, MLP; 4 codebooks;
sinusoidal positions).

Both cut to ``reduced()`` (2 layers, d=256, 4 heads over 2 kv heads for
qwen2-vl and 4 for musicgen, hd=32, M-RoPE sections (4, 6, 6), a 4-token
``cond``, vocab 128, float32).  The reference's parameters
(``init_params(PRNGKey(0))``) go to the port through ``params_from_jax``,
its caches through ``cache_from_jax``.  The inputs are not trivial:
musicgen's ``cond`` is standard normal (zeros make its cross attention
exactly 0) and qwen2-vl's ``positions3`` walk a 2 × 2 patch grid under
random visual embeds (``launch.serve.request_extras``), so the three
M-RoPE streams differ.  Tolerances: logits and caches rtol 1e-4 / atol
1e-5, single layers rtol 1e-5 / atol 1e-6, as the served families'
tests use.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serving import plans as jplans
from repro_torch.configs import get_config
from repro_torch.launch.serve import request_extras
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.serving import plans as tplans

LOGITS = dict(rtol=1e-4, atol=1e-5)
LAYER = dict(rtol=1e-5, atol=1e-6)
ARCHS = ("qwen2-vl-7b", "musicgen-medium")
B, S, STEPS = 2, 16, 4


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tokens(cfg, seed, s):
    shape = (B, s) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    return np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                               shape).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    tok = _tokens(cfg, 0, S + STEPS)
    extras = request_extras(cfg, B, S, seed=1, grid=2)
    return arch, jcfg, cfg, jparams, params, tok, extras


def _batches(tok, extras):
    """The same batch for both sides."""
    jb = {"tokens": jnp.asarray(tok), **{k: jnp.asarray(v)
                                         for k, v in extras.items()}}
    tb = {"tokens": _t(tok), **{k: _t(v) for k, v in extras.items()}}
    return jb, tb


def _decode_extras(extras):
    """The entries a decode step reads: musicgen's ``cond``."""
    return {k: v for k, v in extras.items() if k == "cond"}


def test_apply_mrope_distinct_streams():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, 3, 32).astype(np.float32)
    p3 = rng.randint(0, 50, (2, 3, 12)).astype(np.int32)
    for sections in ((4, 6, 6), (16, 0, 0), (2, 7, 7)):
        got = tlayers.apply_mrope(_t(x), _t(p3), sections, 1e6)
        want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(p3), sections,
                                   1e6)
        np.testing.assert_allclose(_np(got), _np(want), **LAYER)
    same = np.broadcast_to(p3[:, :1], p3.shape).copy()
    assert torch.allclose(
        tlayers.apply_mrope(_t(x), _t(same), (4, 6, 6), 1e6),
        tlayers.apply_rope(_t(x), _t(same[:, 0]), 1e6), atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        tlayers.apply_mrope(_t(x), _t(p3), (4, 6, 5))


def test_apply_mrope_bfloat16_matches_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 2, 32).astype(np.float32)
    p3 = rng.randint(0, 300, (2, 3, 9)).astype(np.int32)
    got = tlayers.apply_mrope(_t(x).bfloat16(), _t(p3), (4, 6, 6), 1e6)
    want = jlayers.apply_mrope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(p3),
                               (4, 6, 6), 1e6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got.float()),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dim", [256, 1536, 6])
def test_sinusoidal_embedding(dim):
    """Within 2^-23 × the largest position: the float32 frequencies
    (``pow``) may differ by an ulp between XLA and PyTorch, and the angle
    position × frequency carries that relative error (2.1e-4 found at
    positions below 5000)."""
    pos = np.random.RandomState(4).randint(0, 5000, (2, 11)).astype(np.int32)
    got = tlayers.sinusoidal_embedding(_t(pos), dim)
    want = jlayers.sinusoidal_embedding(jnp.asarray(pos), dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=2.0 ** -23 * pos.max())


@pytest.mark.parametrize("s", [1, 9])
def test_cross_attention(s):
    jcfg = jget_config("musicgen-medium").reduced()
    cfg = get_config("musicgen-medium").reduced()
    jp = jattn.attn_init(jax.random.PRNGKey(6), jcfg, jnp.float32,
                         cross=True)
    tp = tmodel._to_tensors(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(7)
    x = rng.randn(B, s, cfg.d_model).astype(np.float32)
    cond = rng.randn(B, cfg.cond_len, cfg.d_model).astype(np.float32)
    got = tattn.cross_attention(tp, _t(x), _t(cond), cfg)
    want = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(cond), jcfg)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)
    # and with qkv biases (no family has both, the path takes them)
    bcfg = dataclasses.replace(cfg, qkv_bias=True)
    bj = dict(jp, **{k: jnp.asarray(rng.randn(*shape).astype(np.float32))
                     for k, shape in (("bq", (4, 32)), ("bk", (4, 32)),
                                      ("bv", (4, 32)))})
    got = tattn.cross_attention(tmodel._to_tensors(
        jax.tree.map(np.asarray, bj), "cpu"), _t(x), _t(cond), bcfg)
    want = jattn.cross_attention(bj, jnp.asarray(x), jnp.asarray(cond),
                                 dataclasses.replace(jcfg, qkv_bias=True))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


def test_params_match_reference_layout(model):
    """``init_params`` makes the reference's tree, shapes and count:
    codebook embeddings and heads (cb, ·, ·), an ``xattn`` block's
    ``norm_x`` and ``xattn`` beside its self attention."""
    arch, _, cfg, _, params, _, _ = model
    own = tmodel.init_params(cfg, device="cpu")
    flat = dict(tmodel.tree_flatten(own))
    carried = dict(tmodel.tree_flatten(params))
    assert flat.keys() == carried.keys()
    for k in flat:
        assert flat[k].shape == carried[k].shape, k
    assert sum(t.numel() for t in flat.values()) == cfg.param_count()
    if cfg.num_codebooks:
        assert tuple(own["embed"].shape) == (4, cfg.vocab_size, cfg.d_model)
        assert tuple(own["head"].shape) == (4, cfg.d_model, cfg.vocab_size)
        assert {"norm_x", "xattn"} <= own["blocks"][0].keys()


def test_forward_matches_reference(model):
    _, jcfg, cfg, jparams, params, tok, extras = model
    jb, tb = _batches(tok[:, :S], extras)
    want, _ = jmodel.forward(jparams, jb, jcfg)
    got = tmodel.forward(params, tb, cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
    # the extra inputs matter: without them the logits move
    plain = tmodel.forward(params, {"tokens": _t(tok[:, :S])}, cfg)
    assert float((plain - got).abs().max()) > 1e-3


def test_pipeline_forward_is_bitwise_forward(model):
    _, jcfg, cfg, jparams, params, tok, extras = model
    jb, tb = _batches(tok[:, :S], extras)
    full = tmodel.forward(params, tb, cfg)
    for stages in (1, 2):
        assert torch.equal(tplans.pipeline_forward(params, tb, cfg, stages),
                           full)
    want = jplans.pipeline_forward(jparams, jb, jcfg, 2)
    np.testing.assert_allclose(_np(full), _np(want), **LOGITS)


def test_branch_forward_matches_reference(model):
    """The semantic plan slices the self attention's heads and the MLP's
    channels; musicgen's cross attention runs whole in every branch, as
    in the reference."""
    _, jcfg, cfg, jparams, params, tok, extras = model
    jb, tb = _batches(tok[:, :S], extras)
    want = jplans.branch_forward(jparams, jb, jcfg, num_branches=2)
    got = tplans.branch_forward(params, tb, cfg, num_branches=2)
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
    sliced = tplans._slice_block_params(params["blocks"][0], cfg, 0, 2)
    assert sliced["attn"]["wq"].shape[1] == cfg.num_heads // 2
    if "xattn" in sliced:
        assert sliced["xattn"]["wq"].shape[1] == cfg.num_heads


@pytest.fixture(scope="module")
def decoded(model):
    """Both sides' prefill of S tokens (with the extras) and STEPS
    teacher-forced decode steps (with musicgen's cond): per stage
    (logits, cache)."""
    _, jcfg, cfg, jparams, params, tok, extras = model
    jb, tb = _batches(tok[:, :S], extras)
    jl, jc = jmodel.prefill(jparams, jb, jcfg)
    tl, tc = tmodel.prefill(params, tb, cfg)
    copy = lambda c: [{k: v.clone() for k, v in d.items()} for d in c]
    out = [((tl, copy(tc)), (jl, jc))]
    dx = _decode_extras(extras)
    for i in range(STEPS):
        pos = S + i
        jl, jc = jmodel.decode_step(
            jparams, jnp.asarray(tok[:, pos:pos + 1]), jc, jnp.int32(pos),
            jcfg, batch_extras={k: jnp.asarray(v) for k, v in dx.items()})
        tl, tc = tmodel.decode_step(
            params, _t(tok[:, pos:pos + 1]), tc, pos, cfg,
            batch_extras={k: _t(v) for k, v in dx.items()})
        out.append(((tl, copy(tc)), (jl, jc)))
    return out


@pytest.mark.parametrize("stage", [0, 1, STEPS])
def test_prefill_and_decode_match_reference(model, decoded, stage):
    arch, jcfg, cfg, *_ = model
    (tl, tc), (jl, jc) = decoded[stage]
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS)
    want = tmodel.cache_from_jax(jax.tree.map(np.asarray, jc), cfg,
                                 device="cpu")
    assert len(tc) == len(want) == cfg.num_layers
    for i, (g, w) in enumerate(zip(tc, want)):
        assert g.keys() == w.keys() == {"k", "v"}
        for key in g:
            np.testing.assert_allclose(_np(g[key]), _np(w[key]), **LOGITS,
                                       err_msg=f"{arch} {stage} {i} {key}")


def test_mrope_decode_broadcasts_pos():
    """At decode the reference rotates by the step's position on all three
    M-RoPE streams, whatever ``positions3`` the extras hold: the port
    reads and ignores them alike."""
    cfg = get_config("qwen2-vl-7b").reduced()
    params = tmodel.init_params(cfg, device="cpu")
    tok = _t(_tokens(cfg, 3, 1))
    runs = []
    for extras in ({}, {"positions3": _t(np.full((B, 3, 1), 99, np.int32))}):
        cache = tmodel.init_cache(cfg, B, ctx_len=8, device="cpu")
        runs.append(tmodel.decode_step(params, tok, cache, 5, cfg,
                                       batch_extras=extras)[0])
    assert torch.equal(runs[0], runs[1])


def test_codebook_labels_raise_naming_the_training_slice():
    """Codebook labels (b, s, cb) train: one cross entropy per codebook,
    averaged, as the reference's ``loss_fn`` (the dry-run counts
    musicgen's training step with them); labels of another shape than
    the tokens raise."""
    jcfg = jget_config("musicgen-medium").reduced()
    cfg = get_config("musicgen-medium").reduced()
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    tok, lab = _tokens(cfg, 4, 6), _tokens(cfg, 5, 6)
    want, wm = jmodel.loss_fn(jparams, {"tokens": jnp.asarray(tok),
                                        "labels": jnp.asarray(lab)}, jcfg)
    got, gm = tmodel.loss_fn(params, {"tokens": _t(tok), "labels": _t(lab)},
                             cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(_np(gm["ce"]), np.asarray(wm["ce"]),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="do not match tokens"):
        tmodel.loss_fn(params, {"tokens": _t(tok),
                                "labels": _t(lab[..., 0])}, cfg)


def test_unknown_batch_entries_raise(model):
    _, _, cfg, _, params, tok, _ = model
    with pytest.raises(ValueError, match="unknown batch entry 'audio'"):
        tmodel.forward(params, {"tokens": _t(tok), "audio": _t(tok)}, cfg)
