"""The port's flash attention against the reference's.

On the CPU ``repro_torch.kernels.flash_attention`` runs its eager twin
``ref.attention_ref``; it is held against the Pallas kernel (interpret
mode, as ``tests/test_kernels.py`` runs it) and against the reference's
``ref.attention_ref`` at every shape, dtype, window and non-causal case
of ``tests/test_kernels.py``, with that file's tolerances: atol 2e-5 in
float32, 2e-2 in bfloat16 (one bfloat16 rounding of outputs of size
~1).  Inputs are made with numpy in float32 and cast once on each side.
The CUDA kernel against the twin needs a card and skips here.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as pallas_flash
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CAUSAL_SHAPES = [
    (2, 64, 64, 4, 2, 32),
    (1, 128, 128, 8, 8, 64),
    (2, 96, 96, 4, 1, 32),        # GQA kv=1 (recurrentgemma-style)
    (1, 33, 77, 2, 2, 16),        # ragged, non-multiple sizes
]


def _inputs(seed, b, sq, sk, h, kvh, hd, dtype):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, sq, h, hd).astype(np.float32),
            rng.randn(b, sk, kvh, hd).astype(np.float32),
            rng.randn(b, sk, kvh, hd).astype(np.float32)]
    jax_side = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    port_side = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jax_side, port_side


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check(jax_side, port_side, dtype, q_block, kv_block, **kw):
    got = flash_attention(*port_side, **kw)
    assert got.dtype == port_side[0].dtype
    assert tuple(got.shape) == tuple(port_side[0].shape)
    tol = TOL[dtype]
    pallas = pallas_flash(*jax_side, q_block=q_block, kv_block=kv_block, **kw)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(jref.attention_ref(
        *jax_side, **kw)), atol=tol)


@pytest.mark.parametrize("shape", CAUSAL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_matches_pallas_and_ref(shape, dtype):
    jax_side, port_side = _inputs(1, *shape, dtype)
    _check(jax_side, port_side, dtype, 32, 32, causal=True)


@pytest.mark.parametrize("window", [8, 32])
def test_sliding_window_matches_pallas_and_ref(window):
    jax_side, port_side = _inputs(2, 2, 80, 80, 4, 2, 32, "float32")
    _check(jax_side, port_side, "float32", 16, 16, causal=True,
           window=window)


def test_noncausal_matches_pallas_and_ref():
    jax_side, port_side = _inputs(3, 1, 40, 56, 2, 2, 64, "float32")
    _check(jax_side, port_side, "float32", 16, 16, causal=False)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_256_matches_pallas_and_ref(window, dtype):
    """recurrentgemma-9b's head dim: 4 query heads over one kv head, with
    and without a window that bites at 40 tokens."""
    jax_side, port_side = _inputs(7, 1, 40, 40, 4, 1, 256, dtype)
    _check(jax_side, port_side, dtype, 16, 16, causal=True, window=window)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,h", [(112, 8), (192, 12)])
def test_head_dims_112_192_match_pallas_and_ref(hd, h, window, dtype):
    """kimi-k2-1t-a32b's and nemotron-4-340b's head dims, each with its
    model's query heads per kv head (8 and 12) over one kv head, with and
    without a window that bites at 40 tokens."""
    jax_side, port_side = _inputs(9, 1, 40, 40, h, 1, hd, dtype)
    _check(jax_side, port_side, dtype, 16, 16, causal=True, window=window)


def test_every_attention_model_head_dim_is_built():
    """Every registered config with attention layers runs them at a head
    dim the kernels are compiled for, so no model raises on the card for
    its head dim; the float32 kernel's group limit covers each model's
    query heads per kv head."""
    from repro_torch.configs import all_configs, get_config
    from repro_torch.kernels.flash_attention import HEAD_DIMS, MAX_GROUP
    assert set(MAX_GROUP) == set(HEAD_DIMS)
    seen = {}
    for name in all_configs():
        cfg = get_config(name)
        if not any("attn" in kind for kind in cfg.layer_kinds):
            continue
        hd = cfg.resolved_head_dim
        assert hd in HEAD_DIMS, f"{name}: head dim {hd} not in {HEAD_DIMS}"
        assert cfg.num_heads // cfg.num_kv_heads <= MAX_GROUP[hd], name
        seen[name] = hd
    assert seen["kimi-k2-1t-a32b"] == 112 and seen["nemotron-4-340b"] == 192


def test_cuda_wrapper_refuses_what_the_kernel_lacks():
    """The CUDA wrapper's checks come before any launch: a head dim the
    kernels are not compiled for; in float32, more query heads per kv head
    than the CUDA-core kernel's CTA holds at that head dim (64 rows at
    hd=256, 128 below), while the bfloat16 tensor-core kernel takes any
    group; and, in bfloat16, an operand that is not 16-byte aligned (the
    kernel copies 16-byte rows)."""
    from repro_torch.kernels.flash_attention import (MAX_GROUP,
                                                     flash_attention_cuda,
                                                     max_group)
    assert MAX_GROUP[256] == 64 and MAX_GROUP[128] == 128
    assert max_group(torch.float32, 256) == 64
    assert all(max_group(torch.bfloat16, hd) is None for hd in MAX_GROUP)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 2, 2, 512), dtype=dtype)
        k = torch.zeros((1, 2, 1, 512), dtype=dtype)
        with pytest.raises(ValueError, match="head dim 512"):
            flash_attention_cuda(q, k, k)
    q, k = torch.zeros((1, 2, 128, 256)), torch.zeros((1, 2, 1, 256))
    with pytest.raises(ValueError, match="128 query heads per kv head > 64"):
        flash_attention_cuda(q, k, k)
    flat = torch.zeros(2 * 2 * 64 + 1, dtype=torch.bfloat16)
    q = flat[1:].view(1, 2, 2, 64)
    k = torch.zeros((1, 2, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        flash_attention_cuda(q, k, k)


def _tiled_bf16_attention(q, k, v, causal, window, bn):
    """The bfloat16 tensor-core kernel's numerics, eagerly: float32 scores
    of the bf16 q and k, an online softmax over tiles of ``bn`` keys with
    float32 running max and denominator (of the unrounded p), P rounded to
    bf16 before the P V product, float32 accumulation, the output rounded
    to bf16 once; a row that sees no key gets mean(v)."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, sq, kvh, g, hd)
    kf, vf = k.float(), v.float()
    m = torch.full((b, kvh, g, sq), float("-inf"))
    l = torch.zeros((b, kvh, g, sq))
    o = torch.zeros((b, kvh, g, sq, hd))
    qp = torch.arange(sq)[:, None]
    for k0 in range(0, sk, bn):
        kt, vt = kf[:, k0:k0 + bn], vf[:, k0:k0 + bn]
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kt) * hd ** -0.5
        kp = torch.arange(k0, k0 + kt.shape[1])[None, :]
        mask = torch.ones((sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            mask &= qp >= kp
        if window:
            mask &= (qp - kp) < window
        s = torch.where(mask, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(torch.isinf(m_new), 0.0, m_new)
        corr = torch.exp(m - base)
        p = torch.exp(s - base[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p.bfloat16().float(), vt)
        m = m_new
    mean_v = vf.mean(1)[:, :, None, None, :]            # (b, kvh, 1, 1, hd)
    out = torch.where(l[..., None] > 0, o / l[..., None].clamp_min(1e-30),
                      mean_v)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).bfloat16()


@pytest.mark.parametrize("case", [
    (96, 16, 1, 256, 64, 0),      # recurrentgemma's 16/1 heads at hd=256
    (96, 16, 1, 256, 64, 40),     # with a window that bites
    (160, 4, 4, 128, 128, 0),     # qwen2-moe's g=1 at hd=128, ragged tile
])
def test_bf16_tensor_core_numerics_within_tolerance(case):
    """The tolerance budget the card relies on: the kernel's tiled online
    softmax with P rounded to bf16 stays within the bfloat16 atol 2e-2 of
    the reference's attention_ref and of the Pallas kernel (interpret
    mode) at a serving-like head dim and group, reduced sequence."""
    s, h, kvh, hd, bn, window = case
    jax_side, port_side = _inputs(8, 1, s, s, h, kvh, hd, "bfloat16")
    got = _tiled_bf16_attention(*port_side, True, window, bn)
    pallas = pallas_flash(*jax_side, causal=True, window=window,
                          q_block=16, kv_block=16)
    want = jref.attention_ref(*jax_side, causal=True, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL["bfloat16"])
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=TOL["bfloat16"])


def test_row_with_no_visible_key_matches_ref():
    """sq > sk with a window: late rows see no key; the reference's
    softmax over all-masked scores is uniform, so they get mean(v)."""
    jax_side, port_side = _inputs(4, 1, 24, 8, 2, 1, 16, "float32")
    got = tref.attention_ref(*port_side, causal=True, window=4)
    want = jref.attention_ref(*jax_side, causal=True, window=4)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)
    mean_v = port_side[2].mean(dim=1)[:, None]          # (b, 1, kvh=1, hd)
    np.testing.assert_allclose(_f32(got[:, -1:]),
                               np.broadcast_to(_f32(mean_v), (1, 1, 2, 16)),
                               atol=2e-5)


def test_rejects_mismatched_operands():
    _, (q, k, v) = _inputs(5, 1, 8, 8, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1),
                        v[:, :, :1].repeat(1, 1, 3, 1))
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q, k.double(), v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_twin(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for shape in CAUSAL_SHAPES:
        _, port_side = _inputs(6, *shape, dtype)
        cuda = [t.cuda() for t in port_side]
        before = flash_attention.launches
        got = flash_attention(*cuda, causal=True)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        want = tref.attention_ref(*cuda, causal=True)
        np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                                   atol=TOL[dtype])
