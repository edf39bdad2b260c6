"""The port's backward twins against the JAX reference's gradients.

Each kernel's gradient has a plain PyTorch twin in
``repro_torch.kernels.ref`` (what a CPU tensor runs, and what the card's
backward kernel is held against).  Each twin is held against ``jax.vjp``
of the reference's jnp function (``repro.kernels.ref.attention_ref``,
``repro.models.attention.full_attention`` for explicit positions,
``selective_scan_ref``, ``rglru_scan_ref``, ``moe_route_ref``'s gates)
and against torch autograd of the forward twin, through the
``torch.autograd.Function`` the model calls, on the same float32 inputs
made with numpy.  Tolerance: rtol 1e-5 / atol 1e-6 of each output's
largest entry.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_route import moe_route
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.selective_scan import selective_scan


def _close(got, want, where=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=where)


def _vjp(fn, args, cot):
    """(fn(*args), its vjp at cot), in one jitted call."""
    def both(args, cot):
        out, pull = jax.vjp(fn, *args)
        return out, pull(cot)
    return jax.jit(both)([jnp.asarray(a) for a in args], jnp.asarray(cot))


def _autograd(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, torch.from_numpy(cot))


#: (b, sq, sk, h, kvh, hd, causal, window): GQA, MHA, a window, sq != sk
#: (the rows past sk + window - 1 see no key), non-causal; kimi-k2's and
#: nemotron-4's head dims (112, 192) at their groups of 8 and 12
FLASH = [(2, 12, 12, 4, 2, 16, True, 0), (1, 16, 16, 4, 4, 32, True, 0),
         (2, 14, 14, 8, 2, 16, True, 5), (1, 11, 6, 4, 1, 16, True, 3),
         (1, 7, 10, 2, 2, 16, False, 0), (1, 10, 10, 8, 1, 112, True, 0),
         (1, 9, 9, 12, 1, 192, True, 4)]


@pytest.mark.parametrize("case", FLASH)
def test_flash_backward_matches_jax_vjp(case):
    b, sq, sk, h, kvh, hd, causal, window = case
    rng = np.random.RandomState(sum(case))
    q = rng.randn(b, sq, h, hd).astype(np.float32)
    k = rng.randn(b, sk, kvh, hd).astype(np.float32)
    v = rng.randn(b, sk, kvh, hd).astype(np.float32)
    do = rng.randn(b, sq, h, hd).astype(np.float32)
    out, want = _vjp(lambda q, k, v: jref.attention_ref(q, k, v, causal,
                                                        window),
                     (q, k, v), do)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = ref.attention_ref(*t, causal=causal, window=window,
                               return_lse=True)
    _close(o, out, "forward")
    got = ref.attention_bwd_ref(*t, o, lse, torch.from_numpy(do),
                                causal=causal, window=window)
    through, auto = _autograd(
        lambda q, k, v: flash_attention(q, k, v, causal, window), (q, k, v),
        do)
    _, twin = _autograd(
        lambda q, k, v: ref.attention_ref(q, k, v, causal, window),
        (q, k, v), do)
    for name, g, a, tw, w in zip("qkv", got, auto, twin, want):
        _close(g, w, f"d{name} twin vs jax.vjp")
        _close(a, w, f"d{name} flash_attn_fwd's autograd vs jax.vjp")
        _close(g, tw.numpy(), f"d{name} twin vs autograd of the twin")


@pytest.mark.parametrize("kind", ["offset", "packed"])
def test_flash_backward_explicit_positions(kind):
    b, s, h, kvh, hd, window = 2, 12, 4, 2, 16, 4
    rng = np.random.RandomState(7)
    q = rng.randn(b, s, h, hd).astype(np.float32)
    k = rng.randn(b, s, kvh, hd).astype(np.float32)
    v = rng.randn(b, s, kvh, hd).astype(np.float32)
    do = rng.randn(b, s, h, hd).astype(np.float32)
    ar = np.arange(s, dtype=np.int32)
    pos = (ar[None] + 5 + 300 * np.arange(b, dtype=np.int32)[:, None]
           if kind == "offset" else
           np.broadcast_to(np.where(ar < s // 3, ar, ar - s // 3),
                           (b, s))).astype(np.int32)
    pos = np.ascontiguousarray(pos)
    _, want = _vjp(lambda q, k, v: jattn.full_attention(
        q, k, v, jnp.asarray(pos), jnp.asarray(pos), window=window),
        (q, k, v), do)
    tp = torch.from_numpy(pos)
    _, got = _autograd(lambda q, k, v: flash_attention(
        q, k, v, True, window, tp, tp), (q, k, v), do)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, f"d{name} ({kind} positions)")


def test_flash_function_is_used_only_for_gradients():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 5, 2, 16).astype(np.float32))
               for _ in range(3))
    assert flash_attention(q, k, v).grad_fn is None
    out = flash_attention(q.requires_grad_(), k, v)
    # the autograd formula registered on repro_torch::flash_attn_fwd
    assert "repro_torch_flash_attn_fwd" in type(out.grad_fn).__name__
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None


@pytest.mark.parametrize("case", [(2, 9, 6, 4), (1, 13, 8, 16), (3, 5, 4, 2)])
def test_selective_scan_backward_matches_jax_vjp(case):
    b, s, d, n = case
    rng = np.random.RandomState(d + n)
    dA = (0.5 + 0.5 * rng.rand(b, s, d, n)).astype(np.float32)
    dBx = (0.1 * rng.randn(b, s, d, n)).astype(np.float32)
    C = rng.randn(b, s, n).astype(np.float32)
    gy = rng.randn(b, s, d).astype(np.float32)
    _, want = _vjp(jref.selective_scan_ref, (dA, dBx, C), gy)
    got = ref.selective_scan_bwd_ref(*(torch.from_numpy(a)
                                       for a in (dA, dBx, C, gy)))
    _, auto = _autograd(selective_scan, (dA, dBx, C), gy)
    _, twin = _autograd(ref.selective_scan_ref, (dA, dBx, C), gy)
    for name, g, a, tw, w in zip(("dA", "dBx", "C"), got, auto, twin, want):
        assert g.dtype == torch.float32
        _close(g, w, f"g_{name} twin vs jax.vjp")
        _close(a, w, f"g_{name} selective_scan_fwd's autograd vs jax.vjp")
        _close(g, tw.numpy(), f"g_{name} twin vs autograd of the twin")


def test_selective_scan_backward_keeps_bfloat16():
    rng = np.random.RandomState(1)
    dA, dBx = (torch.from_numpy(rng.rand(1, 4, 3, 2).astype(np.float32))
               .bfloat16() for _ in range(2))
    C = torch.from_numpy(rng.randn(1, 4, 2).astype(np.float32))
    g = ref.selective_scan_bwd_ref(dA, dBx, C, torch.ones(1, 4, 3))
    assert [t.dtype for t in g] == [torch.bfloat16, torch.bfloat16,
                                    torch.float32]


@pytest.mark.parametrize("case", [(2, 11, 6), (1, 17, 32)])
def test_rglru_scan_backward_matches_jax_vjp(case):
    rng = np.random.RandomState(sum(case))
    a = (0.8 + 0.2 * rng.rand(*case)).astype(np.float32)
    bx = (0.1 * rng.randn(*case)).astype(np.float32)
    gh = rng.randn(*case).astype(np.float32)
    _, want = _vjp(jref.rglru_scan_ref, (a, bx), gh)
    ta = torch.from_numpy(a)
    h = ref.rglru_scan_ref(ta, torch.from_numpy(bx))
    got = ref.rglru_scan_bwd_ref(ta, h, torch.from_numpy(gh))
    _, auto = _autograd(rglru_scan, (a, bx), gh)
    _, twin = _autograd(ref.rglru_scan_ref, (a, bx), gh)
    for name, g, au, tw, w in zip(("a", "bx"), got, auto, twin, want):
        _close(g, w, f"g_{name} twin vs jax.vjp")
        _close(au, w, f"g_{name} rglru_scan_fwd's autograd vs jax.vjp")
        _close(g, tw.numpy(), f"g_{name} twin vs autograd of the twin")


def _route_logits(rng, S, E, tie):
    logits = rng.randn(S, E).astype(np.float32)
    if tie:
        # a near-tie at the k-th pick: experts 1 and 2 a few ulps apart
        logits[:, 2] = np.nextafter(np.nextafter(logits[:, 1], np.inf),
                                    np.inf)
    return logits


@pytest.mark.parametrize("S,E,k,tie", [(16, 8, 2, False), (9, 60, 4, False),
                                       (12, 4, 1, False), (10, 8, 2, True),
                                       (7, 16, 4, True)])
def test_moe_route_gate_backward_matches_jax_vjp(S, E, k, tie):
    rng = np.random.RandomState(S * E + k)
    logits = _route_logits(rng, S, E, tie)
    g_gate = rng.randn(S, k).astype(np.float32)
    want_ids = np.asarray(jref.moe_route_ref(jnp.asarray(logits), k)[0])
    _, (want,) = _vjp(lambda lg: jref.moe_route_ref(lg, k)[1], (logits,),
                      g_gate)
    tl = torch.from_numpy(logits)
    eid = ref.moe_route_ref(tl, k)[0]
    np.testing.assert_array_equal(eid.numpy(), want_ids)
    got = ref.moe_route_bwd_ref(tl, eid, torch.from_numpy(g_gate))
    ts = torch.from_numpy(logits).requires_grad_()
    auto = torch.autograd.grad(moe_route(ts, k)[1], ts,
                               torch.from_numpy(g_gate))[0]
    lg = torch.from_numpy(logits).requires_grad_()
    twin = torch.autograd.grad(ref.moe_route_ref(lg, k)[1], lg,
                               torch.from_numpy(g_gate))[0]
    # at k=1 every gate is 1 and its true gradient 0; the scale is then
    # the incoming gradient's
    scale = float(np.abs(np.asarray(want)).max()) or 1.0
    floor = float(np.abs(g_gate).max()) if k == 1 else scale
    for name, g in (("twin", got), ("moe_route_fwd autograd", auto)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6 * max(scale, floor),
                                   err_msg=f"{name} vs jax.vjp")
    np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=1e-5,
                               atol=1e-6 * max(scale, floor))


def test_moe_route_ids_and_slots_carry_no_gradient():
    lg = torch.randn(6, 8, requires_grad=True)
    eid, gate, slot = moe_route(lg, 2)
    assert not eid.requires_grad and not slot.requires_grad
    assert gate.requires_grad


@pytest.mark.parametrize("scale", [1.0, 1e-10])
def test_gate_normalisation_vjp_matches_jax_including_the_clamp(scale):
    """The normalisation v / max(Σv, 1e-9): from finite logits Σv >= 1/E,
    so the clamp binds only for small v given directly."""
    rng = np.random.RandomState(3)
    v = (scale * rng.rand(5, 3)).astype(np.float32)
    g = rng.randn(5, 3).astype(np.float32)
    _, (want,) = _vjp(lambda v: v / jnp.maximum(v.sum(-1, keepdims=True),
                                                1e-9), (v,), g)
    got = ref.gate_norm_vjp(torch.from_numpy(v), torch.from_numpy(g))
    _close(got, want, f"scale {scale}")
