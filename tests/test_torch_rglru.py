"""The port's RG-LRU block and the reduced recurrentgemma-9b against the JAX
reference.

Reduced recurrentgemma-9b (4 layers: rglru, rglru, local_attn, rglru;
d=256, lru width 256 in 16 gate blocks, 4 query heads over 1 kv head,
hd=32, local window 8, float32), with the reference's parameters
(``rglru_init`` / ``init_params`` with a ``PRNGKey``) carried across and
inputs made with numpy.  Sequences are longer than the window (19 and 24
tokens), so the local attention's window bites.  Tolerances: the block
rtol 1e-5 / atol 1e-6 (float32; the port scans in sequence order, the
reference's associative scan in a tree order within chunks); logits rtol
1e-4 / atol 1e-5.  With one kv head the semantic plan cannot slice heads
(the reference's ``_slice_block_params`` needs the kv count to divide), so
each branch runs all heads and the whole RG-LRU mixer over half the MLP.
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
from repro.models import rglru as jrglru
from repro.serving import plans as jplans
from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from repro_torch.models import rglru as trglru
from repro_torch.serving import plans as tplans

ARCH = "recurrentgemma-9b"
LOGITS = dict(rtol=1e-4, atol=1e-5)
LAYER = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def block():
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = jrglru.rglru_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = (np.random.RandomState(1).randn(2, 19, cfg.d_model)
         * 0.5).astype(np.float32)
    return jcfg, cfg, jp, tp, x


def _xc(jp, x):
    """The reference's post-conv activations of x."""
    xi = jnp.asarray(x) @ jp["in_x"]
    return np.array(jlayers.causal_conv1d(xi, jp["conv_w"], jp["conv_b"]))


def test_block_matmul(block):
    _, _, jp, tp, x = block
    xc = _xc(jp, x)
    got = trglru._block_matmul(torch.from_numpy(xc), tp["w_a"])
    want = jrglru._block_matmul(jnp.asarray(xc), jp["w_a"])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


def test_gates(block):
    """a and the gated input, with b_a, b_i and Lambda moved off their
    initial constants so every term of the gates is exercised."""
    _, _, jp, tp, x = block
    rng = np.random.RandomState(5)
    w = jp["Lambda"].shape[0]
    extra = {k: rng.uniform(-1.0, 1.0, w).astype(np.float32)
             for k in ("b_a", "b_i", "Lambda")}
    jp = dict(jp, **{k: jnp.asarray(v) for k, v in extra.items()})
    tp = dict(tp, **{k: torch.from_numpy(v) for k, v in extra.items()})
    xc = _xc(jp, x)
    want = jrglru._gates(jp, jnp.asarray(xc))
    got = trglru._gates(tp, torch.from_numpy(xc))
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w_.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **LAYER)
    assert 0.0 < float(got[0].min()) and float(got[0].max()) < 1.0


def test_rglru_apply(block):
    jcfg, cfg, jp, tp, x = block
    want = jrglru.rglru_apply(jp, jnp.asarray(x), jcfg)
    got = trglru.rglru_apply(tp, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


def test_rglru_init_layout(block):
    """The reference's keys, shapes and dtypes: under a bfloat16 dtype the
    gate biases and Lambda stay float32; their values are the
    reference's constants."""
    jcfg, cfg, _, _, _ = block
    jp = jrglru.rglru_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    own = trglru.rglru_init(torch.Generator().manual_seed(0), cfg,
                            torch.bfloat16)
    assert own.keys() == jp.keys()
    for k, a in own.items():
        assert tuple(a.shape) == jp[k].shape, k
        assert str(a.dtype).split(".")[1] == str(jp[k].dtype), k
    for k in ("b_a", "b_i", "Lambda", "conv_b"):
        np.testing.assert_array_equal(own[k].float().numpy(),
                                      np.asarray(jp[k], np.float32))


def test_decode_paths_raise(block):
    """The decode paths, which raised until ROADMAP item 17 was ported:
    ``rglru_prefill`` (output and cache), ``init_rglru_cache`` and one
    ``rglru_decode`` step from the prefill's cache match the reference
    (the single-layer tolerance)."""
    jcfg, cfg, jp, tp, x = block
    wy, wc = jrglru.rglru_prefill(jp, jnp.asarray(x), jcfg)
    gy, gc = trglru.rglru_prefill(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **LAYER)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]), **LAYER)
    zero = trglru.init_rglru_cache(cfg, 2)
    for k, w in jrglru.init_rglru_cache(jcfg, 2).items():
        assert tuple(zero[k].shape) == w.shape and not zero[k].any()
    step = x[:, :1] * 0.7
    wy, wc = jrglru.rglru_decode(jp, jnp.asarray(step), wc, jcfg)
    gy, gc = trglru.rglru_decode(tp, torch.from_numpy(step), gc, cfg)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **LAYER)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]), **LAYER)


@pytest.fixture(scope="module")
def reduced():
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert cfg.layer_kinds == ("rglru", "rglru", "local_attn", "rglru")
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.rglru.local_window) == (256, 4, 1, 32,
                                                               8)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    tok = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (2, 24)).astype(np.int32)
    return jcfg, cfg, jparams, params, tok


def test_forward_matches_reference(reduced):
    jcfg, cfg, jparams, params, tok = reduced
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tok)}, jcfg)
    got = tmodel.forward(params, {"tokens": torch.from_numpy(tok)}, cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_local_attention_takes_the_local_window(reduced):
    """The hybrid's attention layers use ``rglru.local_window`` (8), not
    ``sliding_window`` (0): widening the local window changes the logits
    at 24 tokens, and the reference's forward moves with it."""
    jcfg, cfg, jparams, params, tok = reduced
    assert tmodel.block_window("local_attn", cfg) == 8
    assert tmodel.block_window("attn", cfg) == cfg.sliding_window == 0
    wide = dataclasses.replace(
        cfg, rglru=dataclasses.replace(cfg.rglru, local_window=4096))
    jwide = dataclasses.replace(
        jcfg, rglru=dataclasses.replace(jcfg.rglru, local_window=4096))
    batch = {"tokens": torch.from_numpy(tok)}
    got = tmodel.forward(params, batch, wide)
    assert float((got - tmodel.forward(params, batch, cfg)).abs().max()) \
        > 1e-3
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tok)}, jwide)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_plans_match_reference(reduced):
    """The layer plan equals the forward bitwise; the semantic plan, which
    slices only the MLP channels here, matches the reference's."""
    jcfg, cfg, jparams, params, tok = reduced
    batch = {"tokens": torch.from_numpy(tok)}
    mono = tmodel.forward(params, batch, cfg)
    for stages in (1, 2, 3):
        assert torch.equal(tplans.pipeline_forward(params, batch, cfg,
                                                   stages), mono)
    bounds = tplans.optimal_stage_bounds(cfg, seq=256, batch=1, num_stages=2)
    assert torch.equal(tplans.pipeline_forward(params, batch, cfg, 2,
                                               bounds=bounds), mono)
    want = jplans.pipeline_forward(jparams, {"tokens": jnp.asarray(tok)},
                                   jcfg, num_stages=2)
    np.testing.assert_allclose(mono.numpy(), np.asarray(want), **LOGITS)
    got = tplans.branch_forward(params, batch, cfg, num_branches=2)
    want = jplans.branch_forward(jparams, {"tokens": jnp.asarray(tok)}, jcfg,
                                 num_branches=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    assert float((got - mono).abs().max()) > 1e-3     # genuinely approximate


def test_branch_slices_only_the_mlp(reduced):
    """kvh=1 does not divide into 2 branches: heads and the RG-LRU mixer
    stay whole, the MLP's channels are halved."""
    _, cfg, _, params, _ = reduced
    for kind, blk in zip(cfg.layer_kinds, params["blocks"]):
        sliced = tplans._slice_block_params(blk, cfg, 1, 2)
        mixer = "attn" if kind == "local_attn" else "rglru"
        for k, t in blk[mixer].items():
            assert sliced[mixer][k] is t, (kind, k)
        assert sliced["mlp"]["w_up"].shape[1] == cfg.d_ff // 2


def test_param_count(reduced):
    """The reference's parameters, carried across, number what the config
    counts (the port's own ``init_params`` is counted in
    ``test_torch_model.py::test_unported_archs_raise``)."""
    _, cfg, _, params, _ = reduced
    leaves = [t for blk in params["blocks"] for m in blk.values()
              for t in (m.values() if isinstance(m, dict) else [m])]
    leaves += [params[k] for k in ("embed", "final_norm", "head")]
    assert sum(t.numel() for t in leaves) == cfg.param_count()


def test_full_config():
    cfg = get_config(ARCH)
    kinds = cfg.layer_kinds
    assert (cfg.num_layers, kinds.count("rglru"),
            kinds.count("local_attn")) == (38, 26, 12)
    assert (cfg.d_model, cfg.rglru.lru_width, cfg.rglru.gate_blocks,
            cfg.rglru.conv_kernel, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.rglru.local_window, cfg.d_ff,
            cfg.vocab_size, cfg.tie_embeddings) == \
        (4096, 4096, 16, 4, 16, 1, 256, 2048, 12288, 256000, False)
    assert cfg.param_count() == jget_config(ARCH).param_count() \
        == 9_627_095_040


def test_stage_bounds_match_reference():
    """The Gillis-DP cuts over the hybrid's cost table (rglru and
    local_attn layers) are the reference's, at full width and reduced."""
    for cfg, jcfg in ((get_config(ARCH), jget_config(ARCH)),
                      (get_config(ARCH).reduced(),
                       jget_config(ARCH).reduced())):
        for stages in (2, 3, 4):
            assert tplans.optimal_stage_bounds(cfg, 1024, 4, stages) == \
                jplans.optimal_stage_bounds(jcfg, 1024, 4, stages)


def test_serve_cli_runs_the_hybrid_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "2",
                "--batch", "1", "--seq", "12"])
    out = capsys.readouterr().out
    assert "plan latencies" in out and "req   1" in out
