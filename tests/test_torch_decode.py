"""The port's prefill, KV / state cache and one-token decode against the
JAX reference.

Every family the port serves, cut to ``reduced()`` (float32): TinyLlama
(``attn``), qwen2-moe (``attn_moe``), falcon-mamba (``mamba``) and
recurrentgemma (``rglru`` + ``local_attn``, window 8).  The reference's
parameters (``init_params(PRNGKey(0))``) go to the port through
``params_from_jax``, its caches through ``cache_from_jax``; inputs are
made with numpy.  Tolerances: logits, and the caches a model run
collects, rtol 1e-4 / atol 1e-5 (float32 through the embedding and the
layers before, summed in other orders: a cache leaf of magnitude ~4 is
up to 7e-6 off, an eighth of an ulp of float32 per layer); single layers
and the caches they return rtol 1e-5 / atol 1e-6; decode against the
teacher-forced forward within 2e-3, the reference's own bound
(``tests/test_arch_smoke.py::test_prefill_decode_matches_forward``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels.ref import attention_ref, selective_scan_ref
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm

LOGITS = dict(rtol=1e-4, atol=1e-5)
CACHE = dict(rtol=1e-5, atol=1e-6)
ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
         "recurrentgemma-9b")
B, S, STEPS = 2, 12, 6


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_cache(got, want_tree, jcfg, cfg, tol=LOGITS, where=""):
    """The port's per-layer cache against the reference's pytree."""
    want = tmodel.cache_from_jax(jax.tree.map(np.asarray, want_tree), cfg,
                                 device="cpu")
    assert len(got) == len(want) == cfg.num_layers
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), (where, i)
        for key in g:
            assert g[key].dtype == w[key].dtype, (where, i, key)
            np.testing.assert_allclose(_np(g[key]), _np(w[key]), **tol,
                                       err_msg=f"{where} layer {i} {key}")


def _copy(cache):
    return [{k: v.clone() for k, v in c.items()} for c in cache]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    tok = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    return arch, jcfg, cfg, jparams, params, tok


@pytest.fixture(scope="module")
def decoded(model):
    """Both sides' prefill of S tokens and STEPS teacher-forced decode
    steps: the prefill's (logits, cache), and per step (logits, cache)."""
    _, jcfg, cfg, jparams, params, tok = model
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok[:, :S])},
                            jcfg)
    tl, tc = tmodel.prefill(params, {"tokens": _t(tok[:, :S])}, cfg)
    # the attention rings are written in place: keep a copy per stage
    out = {"prefill": ((tl, _copy(tc)), (jl, jc)), "steps": []}
    for i in range(STEPS):
        pos = S + i
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok[:, pos:pos + 1]),
                                    jc, jnp.int32(pos), jcfg)
        tl, tc = tmodel.decode_step(params, _t(tok[:, pos:pos + 1]), tc,
                                    pos, cfg)
        out["steps"].append(((tl, _copy(tc)), (jl, jc)))
    return out


def test_prefill_logits_and_caches_match_reference(model, decoded):
    arch, jcfg, cfg, *_ = model
    (tl, tc), (jl, jc) = decoded["prefill"]
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS)
    _assert_cache(tc, jc, jcfg, cfg, where=f"{arch} prefill")


@pytest.mark.parametrize("step", [1, STEPS])
def test_decode_steps_match_reference(model, decoded, step):
    arch, jcfg, cfg, *_ = model
    (tl, tc), (jl, jc) = decoded["steps"][step - 1]
    assert tuple(tl.shape) == jl.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS)
    _assert_cache(tc, jc, jcfg, cfg, where=f"{arch} step {step}")


def test_prefill_decode_matches_forward(model):
    """Decode after prefill against the port's full forward at the same
    positions (teacher forcing), at the reference's 2e-3."""
    _, _, cfg, _, params, tok = model
    full = tmodel.forward(params, {"tokens": _t(tok)}, cfg)
    _, cache = tmodel.prefill(params, {"tokens": _t(tok[:, :S])}, cfg)
    for pos in range(S, S + STEPS):
        logits, cache = tmodel.decode_step(params, _t(tok[:, pos:pos + 1]),
                                           cache, pos, cfg)
        err = float((logits[:, 0] - full[:, pos]).abs().max())
        assert err < 2e-3, f"decode mismatch {err} at {pos}"


def test_sliding_window_decode_ring_wraps():
    """Decoding to position 2W over a W=8 ring reuses its slots; logits
    and caches follow the reference's at every step."""
    jcfg = jget_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    b, W = 1, 8
    jc = jmodel.init_cache(jcfg, b, ctx_len=64, sliding=W)
    tc = tmodel.init_cache(cfg, b, ctx_len=64, sliding=W, device="cpu")
    assert tc[0]["k"].shape == (b, W, cfg.num_kv_heads,
                                cfg.resolved_head_dim)
    tok = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                           (b, 2 * W)).astype(np.int32)
    for pos in range(2 * W):
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok[:, pos:pos + 1]),
                                    jc, jnp.int32(pos), jcfg)
        tl, tc = tmodel.decode_step(params, _t(tok[:, pos:pos + 1]), tc, pos,
                                    cfg)
        assert torch.isfinite(tl).all()
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS,
                                   err_msg=f"position {pos}")
    _assert_cache(tc, jc, jcfg, cfg, where="ring after 2W")


def test_ssm_cache_is_independent_of_context_length():
    cfg = get_config("falcon-mamba-7b").reduced()
    sizes = [sum(t.numel() for c in tmodel.init_cache(cfg, 2, ctx_len=n,
                                                      device="cpu")
                 for t in c.values()) for n in (128, 1 << 19)]
    assert sizes[0] == sizes[1]
    jcfg = jget_config("falcon-mamba-7b").reduced()
    want = sum(np.prod(x.shape) for x in jax.tree.leaves(
        jmodel.init_cache(jcfg, 2, ctx_len=128)))
    assert sizes[0] == want


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b"])
def test_init_cache_matches_reference(arch):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    got = tmodel.init_cache(cfg, 3, ctx_len=20, device="cpu")
    _assert_cache(got, jmodel.init_cache(jcfg, 3, ctx_len=20), jcfg, cfg,
                  tol=dict(rtol=0, atol=0))


def test_decode_batch_invariance(model):
    """A row's decode does not depend on the other rows of its batch."""
    _, _, cfg, _, params, tok = model
    toks = _t(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (3, 1)).astype(np.int32))
    l3, _ = tmodel.decode_step(params, toks, tmodel.init_cache(
        cfg, 3, ctx_len=16, device="cpu"), 0, cfg)
    l1, _ = tmodel.decode_step(params, toks[1:2], tmodel.init_cache(
        cfg, 1, ctx_len=16, device="cpu"), 0, cfg)
    np.testing.assert_allclose(_np(l3[1]), _np(l1[0]), atol=1e-5)


def _positions(kind, b, s):
    if kind == "offset":
        return (np.arange(s)[None] + np.array([[3], [40]])[:b]).astype(
            np.int32)
    # two packed sequences per row, each counting from 0
    cut = s // 3
    row = np.concatenate([np.arange(cut), np.arange(s - cut)])
    return np.broadcast_to(row, (b, s)).astype(np.int32).copy()


@pytest.mark.parametrize("kind", ["offset", "packed"])
def test_forward_with_explicit_positions(model, kind):
    """``batch["positions"]`` against the reference's ``forward`` (whose
    ``full_attention`` masks by the positions).  Rotary attention sees
    only position differences, so offset rows give the implicit
    positions' logits; packed rows give others."""
    arch, jcfg, cfg, jparams, params, tok = model
    pos = _positions(kind, B, S)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tok[:, :S]),
                                       "positions": jnp.asarray(pos)}, jcfg)
    got = tmodel.forward(params, {"tokens": _t(tok[:, :S]),
                                  "positions": _t(pos)}, cfg)
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
    plain = tmodel.forward(params, {"tokens": _t(tok[:, :S])}, cfg)
    if kind == "offset" or arch == "falcon-mamba-7b":   # mamba: no positions
        np.testing.assert_allclose(_np(got), _np(plain), **LOGITS)
    else:
        assert float((got - plain).abs().max()) > 1e-3


def test_prefill_with_explicit_positions_matches_reference(model):
    arch, jcfg, cfg, jparams, params, tok = model
    pos = _positions("offset", B, S)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok[:, :S]),
                                      "positions": jnp.asarray(pos)}, jcfg)
    tl, tc = tmodel.prefill(params, {"tokens": _t(tok[:, :S]),
                                     "positions": _t(pos)}, cfg)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS)
    _assert_cache(tc, jc, jcfg, cfg, where=f"{arch} offset prefill")


@pytest.mark.parametrize("step", ["prefill", "serve", "eval"])
def test_steps_match_reference(model, step):
    """``launch.steps``' factories against the reference's at
    ``mesh=None``: the prefill step's last logits and cache (``max_ctx``
    the prompt's length), one serve step from that cache at position S
    (the ring wraps), and the eval step's logits."""
    arch, jcfg, cfg, jparams, params, tok = model
    batch = {"tokens": tok[:, :S]}
    jpre = jsteps.make_prefill_step(jcfg)
    tpre = tsteps.make_prefill_step(cfg, device="cpu")
    if step == "eval":
        want = jsteps.make_eval_step(jcfg)(jparams, {"tokens": jnp.asarray(
            tok[:, :S])})
        got = tsteps.make_eval_step(cfg, device="cpu")(params,
                                                       {"tokens": _t(
                                                           tok[:, :S])})
        np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
        return
    jl, jc = jpre(jparams, {"tokens": jnp.asarray(batch["tokens"])})
    tl, tc = tpre(params, batch)
    if step == "serve":
        nxt = tok[:, S:S + 1]
        jl, jc = jsteps.make_serve_step(jcfg)(jparams, jnp.asarray(nxt), jc,
                                              jnp.int32(S))
        tl, tc = tsteps.make_serve_step(cfg, device="cpu")(params, nxt, tc, S)
    assert tuple(tl.shape) == jl.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS)
    _assert_cache(tc, jc, jcfg, cfg, where=f"{arch} {step} step")


def test_steps_refuse_a_mesh():
    cfg = get_config("tinyllama-1.1b").reduced()
    for make in (tsteps.make_prefill_step, tsteps.make_serve_step,
                 tsteps.make_eval_step):
        with pytest.raises(TypeError, match="DeviceMesh"):
            make(cfg, mesh=object(), device="cpu")


# ------------------------------------------------------- the two twins

@pytest.mark.parametrize("case", [
    # (b, sq, sk, h, kvh, hd, causal, window, positions)
    (2, 1, 40, 8, 2, 16, True, 0, "ring"),
    (1, 1, 33, 4, 4, 32, True, 0, "ring"),
    (2, 20, 20, 4, 1, 16, True, 0, "offset"),
    (2, 20, 20, 4, 2, 16, True, 5, "offset"),
    (2, 24, 24, 4, 2, 16, True, 0, "packed"),
    (1, 12, 30, 2, 1, 16, False, 7, "offset"),
])
def test_attention_ref_positions_match_full_attention(case):
    """The twin's ``pos_q`` / ``pos_k`` mask against the reference's
    ``models.attention.full_attention``, the decode ring's position trick
    (written slots at 0, the others at 2**30, the query at 1) among
    them."""
    b, sq, sk, h, kvh, hd, causal, window, kind = case
    rng = np.random.RandomState(sum(case[:6]))
    q = rng.randn(b, sq, h, hd).astype(np.float32)
    k = rng.randn(b, sk, kvh, hd).astype(np.float32)
    v = rng.randn(b, sk, kvh, hd).astype(np.float32)
    if kind == "ring":
        pos_q = np.ones((b, sq), np.int32)
        valid = np.arange(sk) < sk - 7
        pos_k = np.broadcast_to(np.where(valid, 0, 2 ** 30),
                                (b, sk)).astype(np.int32)
    elif kind == "offset":
        pos_q = (np.arange(sq)[None] + sk - sq
                 + 11 * np.arange(b)[:, None]).astype(np.int32)
        pos_k = (np.arange(sk)[None] + 11 * np.arange(b)[:, None]).astype(
            np.int32)
    else:
        pos_q = pos_k = np.broadcast_to(np.arange(sq) % 10,
                                        (b, sq)).astype(np.int32)
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos_q),
                                jnp.asarray(pos_k), window=window,
                                causal=causal)
    got = attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window,
                        pos_q=_t(pos_q), pos_k=_t(pos_k))
    np.testing.assert_allclose(_np(got), _np(want), **CACHE)


def test_attention_ref_implicit_positions_unchanged():
    """Without position arrays the twin is today's: explicit ``0..s-1``
    gives the same bits."""
    rng = np.random.RandomState(9)
    q = _t(rng.randn(2, 17, 4, 16).astype(np.float32))
    k = _t(rng.randn(2, 17, 2, 16).astype(np.float32))
    v = _t(rng.randn(2, 17, 2, 16).astype(np.float32))
    pos = torch.arange(17, dtype=torch.int32).expand(2, 17)
    assert torch.equal(attention_ref(q, k, v, window=6),
                       attention_ref(q, k, v, window=6, pos_q=pos,
                                     pos_k=pos))
    with pytest.raises(ValueError):
        attention_ref(q, k, v, pos_q=pos)


@pytest.mark.parametrize("shape", [(2, 37, 16, 4), (1, 64, 8, 16),
                                   (3, 1, 8, 2)])
def test_selective_scan_ref_final_state(shape):
    """The twin's final state (and y) against the reference's chunked
    ``models.ssm.selective_scan``, which returns (y, h_final)."""
    b, s, d, n = shape
    rng = np.random.RandomState(s)
    dA = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    dBx = (0.1 * rng.randn(*shape)).astype(np.float32)
    C = rng.randn(b, s, n).astype(np.float32)
    wy, wh = jssm.selective_scan(jnp.asarray(dA), jnp.asarray(dBx),
                                 jnp.asarray(C))
    gy, gh = selective_scan_ref(_t(dA), _t(dBx), _t(C), final_state=True)
    assert gh.shape == (b, d, n) and gh.dtype == torch.float32
    np.testing.assert_allclose(_np(gh), _np(wh), **CACHE)
    np.testing.assert_allclose(_np(gy), _np(wy), **CACHE)
    assert torch.equal(gy, selective_scan_ref(_t(dA), _t(dBx), _t(C)))


# ------------------------------------------------------- single layers

def test_causal_conv1d_step_matches_reference():
    rng = np.random.RandomState(11)
    x = rng.randn(3, 24).astype(np.float32)
    state = rng.randn(3, 3, 24).astype(np.float32)
    w = rng.randn(4, 24).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    wy, ws = jlayers.causal_conv1d_step(jnp.asarray(x), jnp.asarray(state),
                                        jnp.asarray(w), jnp.asarray(bias))
    gy, gs = tlayers.causal_conv1d_step(_t(x), _t(state), _t(w), _t(bias))
    np.testing.assert_allclose(_np(gy), _np(wy), **CACHE)
    np.testing.assert_array_equal(_np(gs), _np(ws))


@pytest.mark.parametrize("pos", [0, 5, 13])
def test_decode_attention_matches_reference(pos):
    """One layer's decode attention over a W=8 ring, before, at and after
    the wrap."""
    jcfg = jget_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    jp = jax.tree.map(lambda a: a[0], jmodel.init_params(
        jax.random.PRNGKey(0), jcfg)["body"])["b0"]["attn"]
    tp = tmodel._to_tensors(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(pos)
    shape = (2, 8, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {k: rng.randn(*shape).astype(np.float32) for k in ("k", "v")}
    x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    wy, wc = jattn.decode_attention(jp, jnp.asarray(x), {
        k: jnp.asarray(v) for k, v in cache.items()}, jnp.int32(pos), {},
        jcfg)
    gy, gc = tattn.decode_attention(tp, _t(x), {k: _t(v.copy()) for k, v in
                                                cache.items()}, pos, cfg)
    np.testing.assert_allclose(_np(gy), _np(wy), **CACHE)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(gc[k]), _np(wc[k]), **CACHE)


def test_decode_attention_bfloat16_within_tolerance():
    """In bfloat16 the reference's ``full_attention`` rounds the softmax
    weights to bf16 before P·V (``attention.py:76``); the port's twin
    keeps them in float32 (the card's kernel rounds the unnormalized P).
    The two decode attentions stay within the bf16 flash tolerance, 2e-2
    of the output's scale (ROADMAP queue 3)."""
    jcfg = dataclasses.replace(jget_config("tinyllama-1.1b").reduced(),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jax.tree.map(lambda a: a[0], jmodel.init_params(
        jax.random.PRNGKey(0), jcfg)["body"])["b0"]["attn"]
    tp = tmodel._to_tensors(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(7)
    shape = (2, 40, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {k: rng.randn(*shape).astype(np.float32) for k in ("k", "v")}
    x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    wy, _ = jattn.decode_attention(jp, jnp.asarray(x, jnp.bfloat16), {
        k: jnp.asarray(v, jnp.bfloat16) for k, v in cache.items()},
        jnp.int32(30), {}, jcfg)
    gy, _ = tattn.decode_attention(tp, _t(x).bfloat16(), {
        k: _t(v).bfloat16() for k, v in cache.items()}, 30, cfg)
    want = np.asarray(wy, np.float32)
    err = float(np.abs(gy.float().numpy() - want).max())
    assert err <= 2e-2 * float(np.abs(want).max()), err


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_recurrent_decode_layers_match_reference(arch):
    """``mamba_decode`` / ``rglru_decode`` on a random cache, and the
    prefill of both layers, against the reference."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jblock = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    jp = jax.tree.map(lambda a: a[0], jblock["body"])["b0"]
    name = "mamba" if arch.startswith("falcon") else "rglru"
    jmod, tmod = (jssm, tssm) if name == "mamba" else (jrglru, trglru)
    jp = jp[name]
    tp = tmodel._to_tensors(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(2)
    init = getattr(tmod, f"init_{name}_cache")(cfg, 2)
    cache = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in init.items()}
    x = (0.5 * rng.randn(2, 1, cfg.d_model)).astype(np.float32)
    wy, wc = getattr(jmod, f"{name}_decode")(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jcfg)
    gy, gc = getattr(tmod, f"{name}_decode")(
        tp, _t(x), {k: _t(v) for k, v in cache.items()}, cfg)
    np.testing.assert_allclose(_np(gy), _np(wy), **CACHE)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(gc[k]), _np(wc[k]), **CACHE)
    for s in (2, 9):                   # shorter and longer than the conv
        xs = (0.5 * rng.randn(2, s, cfg.d_model)).astype(np.float32)
        wy, wc = getattr(jmod, f"{name}_prefill")(jp, jnp.asarray(xs), jcfg)
        gy, gc = getattr(tmod, f"{name}_prefill")(tp, _t(xs), cfg)
        np.testing.assert_allclose(_np(gy), _np(wy), **CACHE)
        for k in ("h", "conv"):
            np.testing.assert_allclose(_np(gc[k]), _np(wc[k]), **CACHE)


@pytest.mark.parametrize("tokens", [1, 2, 4])
def test_moe_at_decode_token_count_matches_reference(tokens):
    """``moe_apply`` on b·1 tokens, fewer than a routing group
    (gs = b < group_size; at the full config's capacity factor the
    capacity is top_k), against the reference."""
    cf = get_config("qwen2-moe-a2.7b").moe.capacity_factor
    jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=cf)) for c in (
            jget_config("qwen2-moe-a2.7b").reduced(),
            get_config("qwen2-moe-a2.7b").reduced()))
    assert tokens < cfg.moe.group_size
    assert tmoe._capacity(tokens, cfg.moe) == cfg.moe.top_k
    jp = jax.tree.map(lambda a: a[0], jmodel.init_params(
        jax.random.PRNGKey(4), jcfg)["body"])["b0"]["moe"]
    tp = tmodel._to_tensors(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.RandomState(tokens).randn(tokens, 1, cfg.d_model).astype(
        np.float32)
    want = _np(jmoe.moe_apply(jp, jnp.asarray(x), jcfg))
    got = tmoe.moe_apply(tp, _t(x), cfg)
    # outputs reach ~80: atol 1e-6 of the largest, as test_torch_moe's rule
    np.testing.assert_allclose(_np(got), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
