"""The port's MoE routing against the reference's.

On the CPU ``repro_torch.kernels.moe_route`` runs its eager twin
``ref.moe_route_ref``; it is held against the reference's
``ref.moe_route_ref`` and the Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) at that file's shapes and block sizes,
with its tolerances: expert ids and slots exactly, gates within atol 1e-5
(one float32 softmax and division, summed in other orders).  Inputs are
made with numpy.  Where every remaining probability underflows to 0 the
Pallas kernel picks expert 0 again; the port follows ``moe_route_ref``
(distinct experts, the lower index first), as the model's ``lax.top_k``
router does.  The CUDA kernel against the twin needs a card and skips
here (``tests/test_torch_gpu.py``); ``_route_tiles`` below emulates its
one-launch form (top-k over packed 64-bit keys, ranks within a tile by
ranking warps, tile prefixes by a windowed look-back in ticket order) and
is held against the twin.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.moe_route import moe_route as pallas_moe_route
from _torch_ref import route_plan
from repro_torch.kernels.moe_route import moe_route
from repro_torch.kernels.ref import moe_route_ref

GATE_ATOL = 1e-5


def _check(got, want):
    eid, gate, slot = got
    weid, wgate, wslot = (np.asarray(a) for a in want)
    assert eid.dtype == torch.int32 and slot.dtype == torch.int32
    assert gate.dtype == torch.float32
    np.testing.assert_array_equal(eid.numpy(), weid)
    np.testing.assert_array_equal(slot.numpy(), wslot)
    np.testing.assert_allclose(gate.numpy(), wgate, atol=GATE_ATOL)


@pytest.mark.parametrize("S,E,k,block", [
    (64, 8, 2, 32), (100, 16, 4, 32), (33, 4, 1, 16),
])
def test_twin_matches_reference_and_pallas(S, E, k, block):
    logits = np.random.RandomState(42 + S).randn(S, E).astype(np.float32)
    before = moe_route.launches
    got = moe_route(torch.from_numpy(logits), k)
    assert moe_route.launches == before          # the CPU runs the twin
    _check(got, jref.moe_route_ref(jnp.asarray(logits), k))
    _check(got, pallas_moe_route(jnp.asarray(logits), k, block=block,
                                 interpret=True))


def test_ties_break_to_the_lower_index():
    """Logits on a coarse grid tie often; the twin's order among equal
    probabilities is lax.top_k's."""
    rng = np.random.RandomState(5)
    logits = (np.round(rng.randn(256, 60) * 4) / 4).astype(np.float32)
    _check(moe_route_ref(torch.from_numpy(logits), 4),
           jref.moe_route_ref(jnp.asarray(logits), 4))


def test_slots_are_dense_per_expert():
    logits = np.random.RandomState(7).randn(200, 8).astype(np.float32)
    eid, _, slot = moe_route(torch.from_numpy(logits), 2)
    eid, slot = eid.numpy().ravel(), slot.numpy().ravel()
    for e in range(8):
        s = np.sort(slot[eid == e])
        assert (s == np.arange(len(s))).all()    # 0..n_e-1 exactly once


def test_grouped_form_equals_per_group_calls():
    """(G, gs, E): G independent routings, the slot counters starting at 0
    in every group."""
    logits = torch.from_numpy(
        np.random.RandomState(8).randn(3, 40, 6).astype(np.float32))
    grouped = moe_route(logits, 3)
    for g in range(3):
        one = moe_route(logits[g], 3)
        for a, b in zip(grouped, one):
            assert torch.equal(a[g], b)
    assert int(grouped[2][1].min()) == 0


def test_underflow_diverges_from_pallas():
    """Every probability but one underflows: the twin takes distinct
    experts [0, 1] with slots [0, 0], as moe_route_ref; the Pallas kernel
    takes expert 0 twice, with slots [0, 1]."""
    logits = np.array([[0.0, -200.0, -200.0, -200.0]], np.float32)
    eid, gate, slot = moe_route(torch.from_numpy(logits), 2)
    assert eid.tolist() == [[0, 1]] and slot.tolist() == [[0, 0]]
    assert gate.tolist() == [[1.0, 0.0]]
    _check((eid, gate, slot), jref.moe_route_ref(jnp.asarray(logits), 2))
    peid, _, pslot = pallas_moe_route(jnp.asarray(logits), 2,
                                      interpret=True)
    assert np.asarray(peid).tolist() == [[0, 0]]
    assert np.asarray(pslot).tolist() == [[0, 1]]


def test_rejects_bad_shapes():
    with pytest.raises(ValueError, match="top_k"):
        moe_route(torch.zeros((4, 3)), 4)
    with pytest.raises(ValueError, match="logits"):
        moe_route(torch.zeros((2, 2, 2, 2)), 1)


# ------------------------------------------ the kernel's one-launch form

def _topk_keys(probs, k):
    """Top-k by the kernel's keys: the probability's float32 bits above the
    complemented index, picked entries 0."""
    bits = probs.contiguous().view(torch.int32).numpy().astype(np.int64) \
        & 0xffffffff
    E = probs.shape[-1]
    keys = (bits << 32) | (0xffffffff - np.arange(E))
    keys = keys.astype(np.uint64)
    ids = np.zeros(probs.shape[:-1] + (k,), dtype=np.int64)
    for j in range(k):
        best = keys.argmax(-1)
        ids[..., j] = best
        np.put_along_axis(keys, best[..., None], np.uint64(0), -1)
    return ids


def _route_tiles(eids, tt, threads, rank_warps, cpw, rng):
    """Slots of the kernel's tiles: per tile, ranking warp w walks its
    chunks of 32 (token, choice) entries over running per-expert counts
    (a rank among equal experts within a chunk is __match_any_sync's), a
    prefix over the warps gives each warp's offsets, and the look-back
    sums the counts of earlier tiles, ``threads`` flags at a time, back to
    the nearest tile whose inclusive prefix is published (a random set of
    them, as tiles finish in any order; tile 0 always is)."""
    G, gs, k = eids.shape
    E = int(eids.max()) + 1
    tiles = -(-gs // tt)
    slots = np.zeros((G, gs * k), dtype=np.int64)
    for g in range(G):
        flat = eids[g].reshape(-1)
        agg, incl = [], []
        for t in range(tiles):
            ent = flat[t * tt * k:min(gs, (t + 1) * tt) * k]
            rows = np.zeros((rank_warps, E), dtype=np.int64)
            loc = np.zeros(len(ent), dtype=np.int64)
            for i0 in range(0, len(ent), 32):
                w = (i0 // 32) // cpw
                chunk = ent[i0:i0 + 32]
                for i, e in enumerate(chunk):
                    loc[i0 + i] = rows[w, e] + int((chunk[:i] == e).sum())
                rows[w] += np.bincount(chunk, minlength=E)
            pre = np.cumsum(rows, axis=0) - rows          # per-warp offsets
            cnt = rows.sum(axis=0)
            done = [j == 0 or rng.rand() < 0.3 for j in range(t)]
            base, j = np.zeros(E, dtype=np.int64), t - 1
            while j >= 0:
                window = list(range(j, max(j - threads, -1), -1))
                first = next((jj for jj in window if done[jj]), None)
                for jj in window:
                    if jj == first:
                        base += incl[jj]
                        break
                    base += agg[jj]
                if first is not None:
                    break
                j -= len(window)
            agg.append(cnt)
            incl.append(base + cnt)
            ws = (np.arange(len(ent)) // 32) // cpw
            slots[g, t * tt * k:t * tt * k + len(ent)] = \
                base[ent] + pre[ws, ent] + loc
    return slots.reshape(G, gs, k)


@pytest.mark.parametrize("G,gs,E,k", [
    (3, 77, 4, 1), (3, 77, 4, 3), (1, 4096, 60, 4), (4, 150, 60, 4),
    (2, 77, 1024, 7), (1, 40, 1024, 2), (1, 1500, 4, 2),
])
def test_one_launch_form_matches_twin(G, gs, E, k):
    """Keys and tile prefixes reproduce the twin's experts and slots: several
    groups, gs not a multiple of the tile, E in {4, 60, 1024}, at the plan
    the kernel takes and at smaller tiles (longer look-backs)."""
    rng = np.random.RandomState(G * 1000 + gs + E + k)
    logits = torch.from_numpy(
        (np.round(rng.randn(G, gs, E) * 4) / 4).astype(np.float32))
    eid, _, slot = moe_route_ref(logits, k)
    probs = torch.softmax(logits, dim=-1)
    assert np.array_equal(_topk_keys(probs, k), eid.numpy())
    plans = {route_plan(gs, E, k)[1:]}
    for tile, vpl in ((1, 8), (16, 4), (32, 16)):
        plans.add(route_plan(gs, E, k, tile=tile, vpl=vpl)[1:])
    for plan in sorted(plans):
        got = _route_tiles(eid.numpy(), *plan, rng)
        assert np.array_equal(got, slot.numpy()), plan


def test_one_launch_form_overflowing_group():
    """Half the tokens lean hard on expert 3: its slots run far past the
    capacity of 1.0 × gs·k/E, tile after tile."""
    rng = np.random.RandomState(11)
    gs, E, k = 700, 60, 4
    x = rng.randn(2, gs, E)
    x[:, ::2, 3] += 8.0
    logits = torch.from_numpy(x.astype(np.float32))
    eid, _, slot = moe_route_ref(logits, k)
    assert int(slot.max()) >= 2 * (gs * k // E)
    for plan in (route_plan(gs, E, k)[1:], (16, 32, 2, 1)):
        got = _route_tiles(eid.numpy(), *plan, rng)
        assert np.array_equal(got, slot.numpy()), plan


def test_one_launch_keys_order_ties_and_nan():
    """Equal probabilities go to the lower index, a NaN above every number
    (the twin's torch.argmax), all-zero rows to the lowest unpicked."""
    probs = torch.tensor([[0.25, 0.5, 0.25, 0.0, 0.0],
                          [0.0, float("nan"), 0.5, float("nan"), 0.5],
                          [1.0, 0.0, 0.0, 0.0, 0.0]])
    from repro_torch.kernels.ref import topk_distinct
    want = topk_distinct(probs, 4)[1].numpy()
    assert np.array_equal(_topk_keys(probs, 4), want)
    assert want.tolist() == [[1, 0, 2, 3], [1, 3, 2, 4], [0, 1, 2, 3]]
