"""The port's model and serving plans against the JAX reference.

TinyLlama-1.1B cut to ``reduced()`` (2 layers, d=256, 4 heads / 2 kv
heads, hd=32, vocab 128, float32).  The reference's parameters
(``init_params(PRNGKey(0))``) go to the port through
``params_from_jax``; inputs are made with numpy.  Tolerances: logits
rtol 1e-4 / atol 1e-5 (float32 through two layers and a vocab head,
summed in other orders); single layers rtol 1e-5 / atol 1e-6.
``pipeline_forward`` must equal ``forward`` bitwise, as the reference's.
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
from repro.models import moe as jmoe
from repro.serving import plans as jplans
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.serving import plans as tplans

LOGITS = dict(rtol=1e-4, atol=1e-5)
LAYER = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def small():
    jcfg = jget_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    params = tmodel.params_from_jax(tree, cfg, device="cpu")
    tok = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (2, 16)).astype(np.int32)
    return jcfg, cfg, jparams, params, tok


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_rmsnorm():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 64).astype(np.float32)
    w = (0.1 * rng.randn(64)).astype(np.float32)
    got = tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    want = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_interleaved(fraction):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, 3, 32).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                             10000.0, fraction)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                              fraction)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


@pytest.mark.parametrize("activation,gated", [("silu", True),
                                               ("gelu_plain", False),
                                               ("relu2", False)])
def test_mlp_apply(small, activation, gated):
    _, cfg, _, _, _ = small
    cfg = dataclasses.replace(cfg, activation=activation, mlp_gated=gated)
    rng = np.random.RandomState(3)
    p = {"w_up": rng.randn(256, 512), "w_down": rng.randn(512, 256) / 20,
         "w_gate": rng.randn(256, 512)}
    p = {k: v.astype(np.float32) / 16 for k, v in p.items()}
    if not gated:
        del p["w_gate"]
    x = rng.randn(2, 7, 256).astype(np.float32)
    got = tlayers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), cfg)
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("threshold", [2048, 8])
def test_self_attention(small, window, threshold):
    """Against the reference's full_attention (threshold 2048) and its
    blockwise path (threshold 8 forces it at 40 tokens)."""
    jcfg, cfg, jparams, params, _ = small
    x = np.random.RandomState(4).randn(2, 40, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    ctx = {"positions": jnp.asarray(pos), "blockwise_threshold": threshold}
    jp = jax.tree.map(lambda a: a[0], jparams["body"])["b0"]["attn"]
    want, _ = jattn.self_attention(jp, jnp.asarray(x), ctx, jcfg,
                                   window=window)
    got, _ = tattn.self_attention(params["blocks"][0]["attn"],
                                  torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()), cfg,
                                  window=window)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


def test_forward_matches_reference(small):
    jcfg, cfg, jparams, params, tok = small
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tok)}, jcfg)
    got = tmodel.forward(params, {"tokens": torch.from_numpy(tok)}, cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


def _leaves(tree, path=""):
    """{path: tensor} of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{path}/{k}"))
    return out


def test_params_match_reference_layout(small):
    """init_params gives the reference's shapes, dtypes and scales, and
    as many parameters as the config counts."""
    _, cfg, _, from_jax, _ = small
    own = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert _leaves(own).keys() == _leaves(from_jax).keys()
    for path, a in _leaves(own).items():
        assert a.shape == _leaves(from_jax)[path].shape, path
        assert a.dtype == torch.float32, path
    assert sum(a.numel() for a in _leaves(own).values()) == \
        cfg.param_count()
    wq = own["blocks"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert not own["blocks"][0]["norm1"].any()


def test_params_from_jax_bfloat16():
    """bfloat16 parameters cross over unchanged (through float32)."""
    jcfg = dataclasses.replace(jget_config("tinyllama-1.1b").reduced(),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              param_dtype="bfloat16")
    jparams = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    got = params["blocks"][1]["mlp"]["w_gate"]
    want = jax.tree.map(lambda a: a[1], jparams["body"])["b0"]["mlp"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want["w_gate"], np.float32))


def test_full_config_counts():
    cfg = get_config("tinyllama-1.1b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (22, 2048, 32, 4, 64, 5632, 32000)
    assert cfg.param_count() == jget_config("tinyllama-1.1b").param_count()


def test_pipeline_forward_is_bitwise_forward(small):
    _, cfg, _, params, tok = small
    batch = {"tokens": torch.from_numpy(tok)}
    want = tmodel.forward(params, batch, cfg)
    for stages in (1, 2, 3):
        got = tplans.pipeline_forward(params, batch, cfg, stages)
        assert torch.equal(got, want), stages
    bounds = tplans.optimal_stage_bounds(cfg, seq=256, batch=1, num_stages=2)
    got = tplans.pipeline_forward(params, batch, cfg, 2, bounds=bounds)
    assert torch.equal(got, want)


def test_branch_forward_matches_reference(small):
    jcfg, cfg, jparams, params, tok = small
    want = jplans.branch_forward(jparams, {"tokens": jnp.asarray(tok)}, jcfg,
                                 num_branches=2)
    got = tplans.branch_forward(params, {"tokens": torch.from_numpy(tok)},
                                cfg, num_branches=2)
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
    mono = tmodel.forward(params, {"tokens": torch.from_numpy(tok)}, cfg)
    assert float((got - mono).abs().max()) > 1e-3     # genuinely approximate


@pytest.mark.parametrize("arch,item", [("qwen2-moe-a2.7b", "item 17"),
                                       ("falcon-mamba-7b", "item 17"),
                                       ("recurrentgemma-9b", "item 17"),
                                       ("musicgen-medium", "item 18"),
                                       ("qwen2-vl-7b", "item 18")])
def test_unported_archs_raise(arch, item):
    """MoE, Mamba and RG-LRU hybrid models, which raised for decoding
    until item 17 was ported, and musicgen and qwen2-vl, which raised at
    init until item 18's serving slice, build on the CPU at the reduced
    size and decode one token from a zero cache (musicgen one token per
    codebook, its logits one row per codebook)."""
    cfg = get_config(arch).reduced()
    params = tmodel.init_params(cfg, device="cpu")
    # the reference's analytic count leaves out each MoE layer's (d, 1)
    # shared-expert gate, which its init makes
    gates = cfg.num_layers * cfg.d_model if cfg.moe else 0
    assert sum(a.numel() for a in _leaves(params).values()) == \
        cfg.param_count() + gates
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    tok = torch.zeros((1, 1) + cb, dtype=torch.int32)
    cache = tmodel.init_cache(cfg, 1, ctx_len=4, device="cpu")
    logits, cache = tmodel.decode_step(params, tok, cache, 0, cfg)
    assert logits.shape == (1, 1) + cb + (cfg.vocab_size,)
    assert torch.isfinite(logits).all()


#: leaves the reference keeps in float32 whatever ``param_dtype`` says
FLOAT32_LEAVES = ("router", "shared_gate", "A_log", "D", "b_a", "b_i",
                  "Lambda")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "falcon-mamba-7b",
                                  "recurrentgemma-9b"])
def test_leaf_dtypes_follow_reference(arch):
    """Under a bfloat16 ``param_dtype`` the router, shared gate, A_log, D
    and the RG-LRU's b_a, b_i and Lambda stay float32 and every other leaf
    is bfloat16: ``params_from_jax`` keeps each leaf's dtype and
    ``init_params`` makes the same tree."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="bfloat16")
    jparams = jmodel.init_params(jax.random.PRNGKey(2), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    carried = _leaves(tmodel.params_from_jax(tree, cfg, device="cpu"))
    own = _leaves(tmodel.init_params(cfg, device="cpu"))
    assert carried.keys() == own.keys()
    ref = _leaves(tmodel._index(tree["body"], 0))
    for path, a in carried.items():
        want = torch.float32 if path.rsplit("/", 1)[-1] in FLOAT32_LEAVES \
            else torch.bfloat16
        assert a.dtype == want and own[path].dtype == want, path
        if path.startswith("/blocks/0/"):
            r = ref["/b0/" + path[len("/blocks/0/"):]]
            assert str(r.dtype) == str(want).split(".")[1], path
            np.testing.assert_array_equal(a.float().numpy(),
                                          r.astype(np.float32))
    assert any(p.endswith(FLOAT32_LEAVES) for p in carried)


def test_bfloat16_routing_matches_reference():
    """With bfloat16 weights the router stays float32 on both sides, so the
    port's routing of a bfloat16 activation picks the reference's
    experts."""
    arch = "qwen2-moe-a2.7b"
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="bfloat16")
    jp = jax.tree.map(lambda a: a[0],
                      jmodel.init_params(jax.random.PRNGKey(3), jcfg)["body"])
    jp = jp["b0"]["moe"]
    tp = tmodel._to_tensors(jax.tree.map(np.asarray, jp), "cpu")
    x = jnp.asarray(np.random.RandomState(4).randn(64, cfg.d_model),
                    jnp.bfloat16)
    _, want, _ = jmoe.router_topk(jp, x, jcfg.moe)
    eid, _, _ = tmoe.moe_route(tmoe.router_logits(
        tp, torch.from_numpy(np.asarray(x, np.float32)).bfloat16()),
        cfg.moe.top_k)
    assert tp["router"].dtype == torch.float32
    np.testing.assert_array_equal(eid.numpy(), np.asarray(want))


def test_unported_batches_raise(small):
    """Explicit positions and decoding run since item 17; M-RoPE's
    ``positions3`` and cross attention's ``cond`` run since item 18's
    serving slice, and a config that does not read them ignores them, as
    the reference does; an entry no model reads raises."""
    _, cfg, _, params, tok = small
    t = torch.from_numpy(tok)
    pos = tmodel.positions_of(t)
    plain = tmodel.forward(params, {"tokens": t}, cfg)
    assert torch.equal(tmodel.forward(params, {"tokens": t,
                                               "positions": pos}, cfg),
                       plain)
    cache = tmodel.init_cache(cfg, t.shape[0], ctx_len=32, device="cpu")
    logits, _ = tmodel.decode_step(params, t[:, :1], cache, 16, cfg)
    assert torch.isfinite(logits).all()
    for key in ("positions3", "cond"):
        assert torch.equal(tmodel.forward(params, {"tokens": t, key: t},
                                          cfg), plain)
        with pytest.raises(ValueError, match="unknown batch entry"):
            tmodel.forward(params, {"tokens": t, key + "s": t}, cfg)
    with pytest.raises(ValueError, match="unknown batch entry"):
        tplans.branch_forward(params, {"tokens": t, "conds": t}, cfg, 2)
    with pytest.raises(ValueError, match="unknown batch entry"):
        tmodel.decode_step(params, t[:, :1], cache, 16, cfg,
                           batch_extras={"conds": t})


@pytest.mark.parametrize("arch,hd", [("kimi-k2-1t-a32b", 112),
                                     ("nemotron-4-340b", 192)])
def test_real_head_dim_cut_matches_reference(arch, hd):
    """A narrow cut of kimi-k2 (its dense layer 0 and one MoE layer) and
    of nemotron-4 (one relu² layer, half-rotary) at their real head dims,
    where ``reduced()`` alone sets 32: the forward against the
    reference's."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(max_layers=1),
                               head_dim=hd)
    cfg = dataclasses.replace(get_config(arch).reduced(max_layers=1),
                              head_dim=hd)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert cfg.resolved_head_dim == hd
    jparams = jmodel.init_params(jax.random.PRNGKey(5), jcfg)
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    assert params["blocks"][0]["attn"]["wq"].shape[-1] == hd
    tok = np.random.RandomState(6).randint(0, cfg.vocab_size,
                                           (2, 24)).astype(np.int32)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tok)}, jcfg)
    got = tmodel.forward(params, {"tokens": torch.from_numpy(tok)}, cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
