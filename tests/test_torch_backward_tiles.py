"""The algorithms of the two tiled backward kernels, emulated on the CPU.

``csrc/flash_attention.cu``'s bfloat16 backward and
``csrc/selective_scan.cu``'s backward run only on the card.  Their
algorithms are written out here in plain float32 PyTorch, tile by tile in
the kernels' order, and held against the eager twins the kernels are held
against on the card:

- flash: the dQ pass over row tiles and the key tiles each can see, the
  dK/dV pass over key tiles and, in order, the row tiles that can see
  them (rows numbered position * g + head, the kernels' skip bounds), with
  P and dS rounded to bfloat16 before their products; against
  ``ref.attention_bwd_ref`` within 2e-2 of each output's scale;
- the scan: a forward pass that keeps the state before every L-th step,
  then each chunk of L steps recomputed from its checkpoint and walked
  backwards; g_dA and g_dBx equal ``ref.selective_scan_bwd_ref``'s bit for
  bit, g_C within rtol 1e-6.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref



def _kernel_tiles():
    """The bfloat16 kernels' tiles per head dim, read from the
    ``BwdMma<hd>`` lines of csrc/flash_attention.cu: rows per dQ CTA, keys
    per dQ tile, keys per dK/dV CTA, rows per dK/dV tile."""
    src = (Path(ref.__file__).parent / "csrc" / "flash_attention.cu") \
        .read_text()
    found = re.findall(
        r"struct BwdMma<(\d+)> \{\s*static constexpr int QWARPS = (\d+), "
        r"QN = (\d+), KWARPS = \d+, BN = (\d+), BM = (\d+);", src)
    return {int(hd): (16 * int(qw), int(qn), int(bn), int(bm))
            for hd, qw, qn, bn, bm in found}


#: the kernels' tiles per head dim, and small ones that cut these shapes
#: into many tiles
KERNEL_TILES = _kernel_tiles()
SMALL_TILES = (16, 8, 8, 16)
TILES = [*KERNEL_TILES.values(), SMALL_TILES]
TILE_IDS = [f"hd{hd}_tiles" for hd in KERNEL_TILES] + ["small_tiles"]
#: tests/test_torch_backward.py's FLASH: GQA, MHA, a window, sq != sk (rows
#: past sk + window - 1 see no key), non-causal
FLASH = [(2, 12, 12, 4, 2, 16, True, 0), (1, 16, 16, 4, 4, 32, True, 0),
         (2, 14, 14, 8, 2, 16, True, 5), (1, 11, 6, 4, 1, 16, True, 3),
         (1, 7, 10, 2, 2, 16, False, 0)]
BF16_ATOL = 2e-2


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _row_view(x, g):
    """(b, s, kvh * g, hd) -> (b, kvh, s * g, hd): row pos * g + head."""
    b, s, h, hd = x.shape
    return x.reshape(b, s, h // g, g, hd).permute(0, 2, 1, 3, 4) \
        .reshape(b, h // g, s * g, hd)


def _row_stat(x, g):
    """(b, h, sq) -> (b, kvh, sq * g) in the same row order."""
    b, h, sq = x.shape
    return x.reshape(b, h // g, g, sq).permute(0, 1, 3, 2) \
        .reshape(b, h // g, sq * g)


def _visible(qp, kp, causal, window):
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= (qp - kp) < window
    return ok


def emulate_flash_bwd(q, k, v, o, lse, do, causal, window, pos_q=None,
                      pos_k=None, tiles=SMALL_TILES):
    """The bfloat16 backward kernels' algorithm in float32: (dq, dk, dv)."""
    qm, qn, bn, bm = tiles
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    rows = sq * g
    scale = hd ** -0.5
    explicit = pos_q is not None
    Q, dO = _row_view(q, g), _row_view(do, g)
    L = _row_stat(lse, g)
    D = _row_stat((do * o).sum(-1).permute(0, 2, 1), g)
    rpos = torch.arange(rows) // g
    dq = torch.zeros(b, kvh, rows, hd)
    dk = torch.zeros(b, sk, kvh, hd)
    dv = torch.zeros(b, sk, kvh, hd)
    for bi in range(b):
        qpos = (pos_q[bi].long()[rpos] if explicit else rpos)
        kpos = pos_k[bi].long() if explicit else torch.arange(sk)
        for kv in range(kvh):
            K, V = k[bi, :, kv], v[bi, :, kv]
            # dQ: row tiles, the key tiles their rows can see
            for r0 in range(0, rows, qm):
                r1 = min(r0 + qm, rows)
                first, last = r0 // g, (r1 - 1) // g
                lo = max(0, first - window + 1) if window > 0 and \
                    not explicit else 0
                lo = lo // qn * qn
                hi = min(sk, last + 1) if causal and not explicit else sk
                Lr = L[bi, kv, r0:r1, None]
                for k0 in range(lo, hi, qn):
                    k1 = min(k0 + qn, sk)
                    s = Q[bi, kv, r0:r1] @ K[k0:k1].T
                    dp = dO[bi, kv, r0:r1] @ V[k0:k1].T
                    ok = _visible(qpos[r0:r1, None], kpos[None, k0:k1],
                                  causal, window)
                    p = torch.where(ok, torch.exp2(s * scale * math.log2(
                        math.e) - Lr * math.log2(math.e)), 0.0)
                    ds = p * (dp - D[bi, kv, r0:r1, None])
                    dq[bi, kv, r0:r1] += _bf16(ds) @ K[k0:k1]
            # dK, dV: key tiles, the row tiles that can see them, in order
            for k0 in range(0, sk, bn):
                k1 = min(k0 + bn, sk)
                rlo, rhi = 0, rows
                if not explicit:
                    if causal:
                        rlo = min(rows, k0 * g)
                    if window > 0 and sq - 1 < sk + window - 1:
                        rhi = min(rows, (k1 - 1 + window) * g)
                for r0 in range(rlo, rhi, bm):
                    r1 = min(r0 + bm, rhi)
                    Lr = L[bi, kv, r0:r1, None]
                    uniform = torch.isinf(Lr)
                    s = Q[bi, kv, r0:r1] @ K[k0:k1].T
                    dp = dO[bi, kv, r0:r1] @ V[k0:k1].T
                    ok = _visible(qpos[r0:r1, None], kpos[None, k0:k1],
                                  causal, window)
                    p = torch.where(ok, torch.exp2(
                        s * scale * math.log2(math.e)
                        - torch.where(uniform, 0.0, Lr) * math.log2(math.e)),
                        0.0)
                    p = torch.where(uniform, 1.0 / sk, p)
                    ds = torch.where(uniform, 0.0,
                                     p * (dp - D[bi, kv, r0:r1, None]))
                    dv[bi, k0:k1, kv] += _bf16(p).T @ dO[bi, kv, r0:r1]
                    dk[bi, k0:k1, kv] += _bf16(ds).T @ Q[bi, kv, r0:r1]
    dq = dq.reshape(b, kvh, sq, g, hd).permute(0, 2, 1, 3, 4) \
        .reshape(b, sq, h, hd)
    return dq * scale, dk * scale, dv


def _flash_inputs(case, seed):
    b, sq, sk, h, kvh, hd = case[:6]
    rng = np.random.RandomState(seed)
    q, do = (_bf16(torch.from_numpy(rng.randn(b, sq, h, hd)).float())
             for _ in range(2))
    k, v = (_bf16(torch.from_numpy(rng.randn(b, sk, kvh, hd)).float())
            for _ in range(2))
    return q, k, v, do


def _hold(got, want, where):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(w.abs().max()) or 1.0
        err = float((a - w).abs().max())
        assert err <= BF16_ATOL * scale, \
            f"{where} {name}: {err:.3e} > {BF16_ATOL} x {scale:.3e}"


def test_kernel_tiles_read_for_every_head_dim():
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    assert sorted(KERNEL_TILES) == [16, 32, 64, 112, 128, 192, 256]
    assert sorted(KERNEL_TILES) == sorted(HEAD_DIMS)


@pytest.mark.parametrize("tiles", TILES, ids=TILE_IDS)
@pytest.mark.parametrize("case", FLASH)
def test_flash_tiled_backward_matches_twin(case, tiles):
    causal, window = case[6], case[7]
    q, k, v, do = _flash_inputs(case, sum(case[:6]))
    o, lse = ref.attention_ref(q, k, v, causal=causal, window=window,
                               return_lse=True)
    o = _bf16(o)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    got = emulate_flash_bwd(q, k, v, o, lse, do, causal, window,
                            tiles=tiles)
    _hold(got, want, f"{case}")


def test_flash_tiled_backward_sees_no_key_rows():
    """sq > sk + window - 1: the last rows see no key (lse = +inf) and give
    every key 1/sk of their dO in dV, with dS = 0."""
    case = (1, 11, 6, 4, 1, 16, True, 3)
    q, k, v, do = _flash_inputs(case, 11)
    o, lse = ref.attention_ref(q, k, v, causal=True, window=3,
                               return_lse=True)
    o = _bf16(o)
    assert torch.isinf(lse).any()
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=3)
    for tiles in TILES:
        got = emulate_flash_bwd(q, k, v, o, lse, do, True, 3, tiles=tiles)
        _hold(got, want, f"no visible key, tiles {tiles}")
        assert torch.equal(got[0][:, 8:], torch.zeros_like(got[0][:, 8:]))


@pytest.mark.parametrize("kind", ["offset", "packed"])
def test_flash_tiled_backward_explicit_positions(kind):
    b, s, h, kvh, hd, window = 2, 12, 4, 2, 16, 4
    q, k, v, do = _flash_inputs((b, s, s, h, kvh, hd), 7)
    ar = np.arange(s, dtype=np.int32)
    pos = (ar[None] + 5 + 300 * np.arange(b, dtype=np.int32)[:, None]
           if kind == "offset" else
           np.broadcast_to(np.where(ar < s // 3, ar, ar - s // 3), (b, s)))
    pos = torch.from_numpy(np.ascontiguousarray(pos, dtype=np.int32))
    kw = dict(causal=True, window=window, pos_q=pos, pos_k=pos)
    o, lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
    o = _bf16(o)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for tiles in TILES:
        got = emulate_flash_bwd(q, k, v, o, lse, do, True, window, pos, pos,
                                tiles=tiles)
        _hold(got, want, f"{kind} positions, tiles {tiles}")


def emulate_scan_bwd(dA, dBx, C, gy, L):
    """The scan backward kernel's algorithm at checkpoint length L:
    (g_dA, g_dBx, g_C) float32."""
    b, s, d, n = dA.shape
    h = torch.zeros(b, d, n)
    ckpts = []
    g_C = torch.empty(b, s, n)
    for t in range(s):
        if t % L == 0:
            ckpts.append(h)
        h = dA[:, t] * h + dBx[:, t]
        g_C[:, t] = (gy[:, t, :, None] * h).sum(1)
    g_dA = torch.empty(b, s, d, n)
    g_dBx = torch.empty(b, s, d, n)
    carry = torch.zeros(b, d, n)
    for c in range(len(ckpts) - 1, -1, -1):
        t0 = c * L
        hh, hp = ckpts[c], []
        for t in range(t0, min(t0 + L, s)):
            hp.append(hh)
            hh = dA[:, t] * hh + dBx[:, t]
        for t in range(min(t0 + L, s) - 1, t0 - 1, -1):
            gh = C[:, t, None, :] * gy[:, t, :, None] + carry
            g_dBx[:, t] = gh
            g_dA[:, t] = gh * hp[t - t0]
            carry = dA[:, t] * gh
    return g_dA, g_dBx, g_C


@pytest.mark.parametrize("chunk", ["1", "3", "7", "s", "s+5"])
@pytest.mark.parametrize("case", [(2, 23, 6, 4), (1, 16, 5, 16),
                                  (3, 9, 4, 3)])
def test_checkpointed_scan_backward_matches_twin(case, chunk):
    b, s, d, n = case
    L = {"s": s, "s+5": s + 5}.get(chunk) or int(chunk)
    rng = np.random.RandomState(sum(case) + L)
    dA = torch.from_numpy(0.5 + 0.5 * rng.rand(b, s, d, n)).float()
    dBx = torch.from_numpy(0.1 * rng.randn(b, s, d, n)).float()
    C = torch.from_numpy(rng.randn(b, s, n)).float()
    gy = torch.from_numpy(rng.randn(b, s, d)).float()
    g_dA, g_dBx, g_C = emulate_scan_bwd(dA, dBx, C, gy, L)
    w_dA, w_dBx, w_C = ref.selective_scan_bwd_ref(dA, dBx, C, gy)
    assert torch.equal(g_dA, w_dA) and torch.equal(g_dBx, w_dBx)
    scale = float(w_C.abs().max())
    torch.testing.assert_close(g_C, w_C, rtol=1e-6, atol=1e-6 * scale)
