"""The port's FLOP counter (``repro_torch.launch.flopcount``) against the
reference's (``repro.launch.flopcount``).

* The reference's two counter tests, ported.
* Each kernel operator's forward rule against the reference's
  ``count_fn`` of its jnp twin, at several shapes: products and the rest
  separately, exactly.
* Every assigned architecture × every input shape, counted on the meta
  device at full width (depth cut to the dense prefix and two periods of
  the block pattern, at most 2 microbatches, in both packages): the product FLOPs equal the
  reference's after the named corrections of ``_torch_counts`` (computed
  from the shapes), the total is within 5 %, and the bytes ratio is
  printed.
* The same step counted on the CPU equals its count on the meta device,
  for a 2-layer model of each family.
"""
from __future__ import annotations

import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_counts as tc
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_route import moe_route
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.launch import dryrun
from repro_torch.launch.flopcount import FlopCounter, count_fn


def _meta(*shapes, dtype=torch.float32):
    return [torch.empty(s, dtype=dtype, device="meta") for s in shapes]


def test_flopcount_matmul_exact():
    a, b = _meta((8, 16), (16, 4))
    counter = count_fn(lambda x, y: x @ y, a, b)
    assert counter.flops == 2 * 8 * 16 * 4
    assert counter.dot_flops == counter.flops


def test_flopcount_scales_loop_by_length():
    c, xs = _meta((4, 4), (10, 4, 4))

    def f(c, xs):
        for i in range(xs.shape[0]):
            c = c @ xs[i]
        return c

    assert count_fn(f, c, xs).flops == 10 * 2 * 4 * 4 * 4


def _port_split(fn, *args, causal_skip=False):
    counter = FlopCounter(attn_causal_skip=causal_skip)
    with counter:
        fn(*args)
    return counter.dot_flops, counter.other_flops


#: (b, sq, sk, h, kvh, hd, causal, window): full causal, windowed,
#: non-causal (cross attention), decode; then blockwise (sq > 2048),
#: padded, windowed
FLASH_FULL = [(2, 64, 64, 4, 2, 16, True, 0), (3, 100, 100, 6, 3, 8, True, 16),
              (2, 64, 32, 4, 4, 16, False, 0), (2, 1, 128, 4, 2, 16, True, 0)]
FLASH_BLOCKWISE = [(1, 4096, 4, 2, 16, 0, False), (1, 3000, 4, 2, 16, 0, False),
                   (2, 4096, 4, 1, 16, 0, True), (1, 4096, 2, 1, 16, 2048,
                                                  False),
                   (1, 5000, 2, 1, 16, 0, True)]


@pytest.mark.parametrize("case", FLASH_FULL)
def test_flash_rule_matches_full_attention(case):
    from repro.models import attention as jattn
    b, sq, sk, h, kvh, hd, causal, window = case
    want = tc.split_count(
        lambda q, k, v, pq, pk: jattn.full_attention(
            q, k, v, pq, pk, window=window, causal=causal),
        tc.sds((b, sq, h, hd)), tc.sds((b, sk, kvh, hd)),
        tc.sds((b, sk, kvh, hd)), tc.sds((b, sq), jnp.int32),
        tc.sds((b, sk), jnp.int32))
    q, k = _meta((b, sq, h, hd), (b, sk, kvh, hd), dtype=torch.bfloat16)
    pos = None
    if sq == 1:                                     # decode: explicit
        pos = _meta((b, sq), (b, sk), dtype=torch.int32)
    got = _port_split(lambda: flash_attention(
        q, k, k, causal, window, *(pos or (None, None))))
    assert got == want


@pytest.mark.parametrize("case", FLASH_BLOCKWISE)
def test_flash_rule_matches_blockwise_attention(case):
    from repro.models import attention as jattn
    b, s, h, kvh, hd, window, skip = case
    want = tc.split_count(
        lambda q, k, v, p: jattn.blockwise_attention(
            q, k, v, p, p, window=window, causal_skip=skip),
        tc.sds((b, s, h, hd)), tc.sds((b, s, kvh, hd)),
        tc.sds((b, s, kvh, hd)), tc.sds((b, s), jnp.int32))
    q, k = _meta((b, s, h, hd), (b, s, kvh, hd), dtype=torch.bfloat16)
    got = _port_split(lambda: flash_attention(q, k, k, True, window),
                      causal_skip=skip)
    assert got == want


@pytest.mark.parametrize("case", [(1, 64, 8, 4), (2, 100, 16, 16),
                                  (1, 1, 8, 16)])
def test_selective_scan_rule_matches_chunked_scan(case):
    from repro.models import ssm as jssm
    b, s, d, n = case
    want = tc.split_count(lambda a, bx, c: jssm.selective_scan(a, bx, c),
                          tc.sds((b, s, d, n), jnp.float32),
                          tc.sds((b, s, d, n), jnp.float32),
                          tc.sds((b, s, n), jnp.float32))
    dA, dBx, C = _meta((b, s, d, n), (b, s, d, n), (b, s, n))
    assert _port_split(lambda: selective_scan(dA, dBx, C, True)) == want


@pytest.mark.parametrize("case", [(1, 64, 8), (2, 100, 16), (1, 1, 8)])
def test_rglru_rule_matches_linear_recurrence(case):
    from repro.models import rglru as jrglru
    want = tc.split_count(lambda a, bx: jrglru.linear_recurrence(a, bx),
                          tc.sds(case, jnp.float32), tc.sds(case, jnp.float32))
    a, bx = _meta(case, case)
    assert _port_split(lambda: rglru_scan(a, bx)) == want


@pytest.mark.parametrize("case", [(1, 16, 8, 2), (3, 64, 60, 4),
                                  (2, 100, 16, 1)])
def test_moe_route_rule_matches_route_twin(case):
    from repro.kernels import ref as jref
    G, gs, E, k = case
    want = tc.split_count(jax.vmap(lambda lg: jref.moe_route_ref(lg, k)),
                          tc.sds((G, gs, E), jnp.float32))
    (logits,) = _meta((G, gs, E))
    assert _port_split(lambda: moe_route(logits, k)) == want


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_step_counts_match_reference(arch, shape):
    info = INPUT_SHAPES[shape]
    rcfg = tc.cut_depth(tc.ref_config(arch))
    cfg = tc.cut_depth(get_config(arch))
    r_dot, r_other, r_total, r_bytes = tc.ref_step(rcfg, shape)
    assert r_dot + r_other == pytest.approx(r_total, rel=1e-12)
    got = dryrun.count_step(cfg, shape)
    b, s = info["global_batch"], info["seq_len"]
    c_other = 0.0
    if info["kind"] == "train":
        c_dot = tc.train_dot_corrections(cfg, b, s)
    elif info["kind"] == "prefill":
        c_dot = tc.prefill_dot_corrections(cfg, b, s)
    else:
        c_dot, c_other = tc.decode_corrections(cfg, b, s)
    assert got.dot_flops == pytest.approx(r_dot + c_dot, rel=1e-9, abs=0)
    assert got.flops == pytest.approx(r_total + c_dot + c_other, rel=0.05)
    print(f"{arch} {shape}: flops {got.flops:.6e} vs {r_total:.6e}, "
          f"bytes {got.hbm_bytes:.4e} vs {r_bytes:.4e} "
          f"(ratio {got.hbm_bytes / r_bytes:.3f})")


FAMILIES = ["tinyllama-1.1b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
            "recurrentgemma-9b", "musicgen-medium", "qwen2-vl-7b"]


def _cpu_inputs(tree, seed):
    """Real CPU tensors of ``tree``'s meta tensors (ints in [0, 8), bools
    alternating, floats small normals), the tree's Python values kept."""
    from repro_torch.tree import tree_flatten, tree_unflatten
    g = torch.Generator().manual_seed(seed)
    out = []
    for _, t in tree_flatten(tree):
        if not isinstance(t, torch.Tensor):
            out.append(t)
        elif t.dtype in (torch.int32, torch.int64):
            out.append(torch.randint(0, 8, t.shape, generator=g,
                                     dtype=t.dtype))
        elif t.dtype == torch.bool:
            out.append(torch.arange(t.numel()).reshape(t.shape) % 2 == 0)
        else:
            out.append((0.1 * torch.randn(t.shape, generator=g)).to(t.dtype))
    return tree_unflatten(tree, out)


@pytest.mark.parametrize("arch", FAMILIES)
def test_cpu_count_equals_meta_count(arch, monkeypatch):
    """A 2-layer model's train step, prefill and decode count the same on
    real CPU tensors as on the meta device."""
    from repro_torch import configs
    from repro_torch.launch import specs
    cfg = get_config(arch).reduced()
    shapes = {"train": dict(seq_len=8, global_batch=2, kind="train"),
              "prefill": dict(seq_len=8, global_batch=2, kind="prefill"),
              "decode": dict(seq_len=12, global_batch=2, kind="decode")}
    monkeypatch.setattr(configs, "INPUT_SHAPES", shapes)
    monkeypatch.setattr(specs, "INPUT_SHAPES", shapes)
    for name in shapes:
        step, args = dryrun.step_and_inputs(cfg, name, "meta")
        meta = count_fn(step, *args)
        step, args = dryrun.step_and_inputs(cfg, name, "cpu")
        args = _cpu_inputs(args, seed=len(name))
        cpu = count_fn(step, *args)
        assert (cpu.dot_flops, cpu.other_flops, cpu.hbm_bytes) == (
            meta.dot_flops, meta.other_flops, meta.hbm_bytes), (arch, name)
        assert cpu.dot_flops > 0
