"""The port's MAB deploy functions against ``repro.core.mab``.

UCB decisions must be exact, and the Algorithm-1 end-of-interval update
must reproduce the reference's float32 state (Q, N, R, eps, rho) and its
int32 interval counter bit for bit over several fuzzed intervals,
starting from the literal state of ``tools/regen_golden.py``.  The
reference runs jitted under ``jax.enable_x64(True)``, as the jitted
driver runs it, over 12 slot rows: XLA:CPU sums a fused reduction of up
to 14 rows in row order, as the port does; over more rows it regroups
the float32 sums (ROADMAP queue 3), which ``test_reward_sums_divergence``
bounds at one float32 ulp.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import MAB_LITERAL
from repro.core import mab as jmab
from repro_torch.core import mab as tmab

HP = dict(phi=0.3, gamma=0.3, k=0.1)
FIELDS = ("Q", "N", "R", "eps", "rho", "t")


def _jax_state(d):
    return jmab.MABState(
        Q=jnp.asarray(d["Q"], jnp.float32), N=jnp.asarray(d["N"], jnp.float32),
        R=jnp.asarray(d["R"], jnp.float32),
        eps=jnp.asarray(d["eps"], jnp.float32),
        rho=jnp.asarray(d["rho"], jnp.float32),
        t=jnp.asarray(d["t"], jnp.int32))


def _rand_state(rng):
    return {"Q": rng.uniform(0, 1, (2, 2)), "N": rng.randint(0, 40, (2, 2)),
            "R": rng.uniform(200, 4000, 3), "eps": rng.uniform(0.05, 1),
            "rho": rng.uniform(0.01, 0.9), "t": int(rng.randint(1, 500))}


def _assert_state_equal(port, ref, what):
    got = tmab.mab_state_to_numpy(port)
    for k in FIELDS:
        want = np.asarray(getattr(ref, k))
        g = got[k][0]
        assert g.dtype == want.dtype, f"{what} {k}: {g.dtype} {want.dtype}"
        assert g.tobytes() == want.tobytes(), f"{what} {k}: {g} != {want}"


@pytest.mark.parametrize("seed", range(6))
def test_decide_ucb_batch_exact(seed):
    rng = np.random.RandomState(seed)
    d = MAB_LITERAL if seed == 0 else _rand_state(rng)
    M = 64
    sla = rng.uniform(100, 5000, M).astype(np.float32)
    app = rng.randint(0, 3, M).astype(np.int32)
    with jax.enable_x64(True):
        dj, cj = jax.jit(jmab.decide_ucb_batch, static_argnums=3)(
            _jax_state(d), sla, app, 0.5)
    st = tmab.mab_state_from_numpy(d, device="cpu")
    dt, ct = tmab.decide_ucb_batch(st, torch.from_numpy(sla)[None],
                                   torch.from_numpy(app)[None], 0.5)
    np.testing.assert_array_equal(dt[0].numpy(), np.asarray(dj))
    np.testing.assert_array_equal(ct[0].numpy(), np.asarray(cj))
    assert dt.dtype == torch.int32


def test_decide_ucb_per_cell_states():
    """Each grid cell decides against its own state."""
    rng = np.random.RandomState(11)
    states = [_rand_state(rng) for _ in range(4)]
    port = tmab.MABState(*[torch.cat([getattr(
        tmab.mab_state_from_numpy(s, device="cpu"), k) for s in states])
        for k in FIELDS])
    sla = rng.uniform(100, 5000, (4, 16)).astype(np.float32)
    app = rng.randint(0, 3, (4, 16)).astype(np.int32)
    d, _ = tmab.decide_ucb_batch(port, torch.from_numpy(sla),
                                 torch.from_numpy(app), 0.5)
    for g, s in enumerate(states):
        with jax.enable_x64(True):
            dj, _ = jmab.decide_ucb_batch(_jax_state(s), sla[g], app[g], 0.5)
        np.testing.assert_array_equal(d[g].numpy(), np.asarray(dj))


def test_decide_ucb_one_row_per_cell():
    """``decide_ucb`` takes one (sla, app) per grid cell."""
    rng = np.random.RandomState(5)
    states = [_rand_state(rng) for _ in range(3)]
    port = tmab.MABState(*[torch.cat([getattr(
        tmab.mab_state_from_numpy(s, device="cpu"), k) for s in states])
        for k in FIELDS])
    sla = rng.uniform(100, 5000, 3).astype(np.float32)
    app = rng.randint(0, 3, 3).astype(np.int32)
    d, c = tmab.decide_ucb(port, torch.from_numpy(sla), torch.from_numpy(app))
    assert d.shape == c.shape == (3,)
    for g, s in enumerate(states):
        with jax.enable_x64(True):
            dj, cj = jmab.decide_ucb(_jax_state(s), sla[g], app[g], 0.5)
        assert int(d[g]) == int(dj) and int(c[g]) == int(cj)


@pytest.mark.parametrize("seed", range(4))
def test_end_of_interval_masked_exact(seed):
    """10 fuzzed intervals of feedback over 12 slot rows, from the literal
    state; the state must match bit for bit after every interval."""
    rng = np.random.RandomState(seed)
    ref = _jax_state(MAB_LITERAL)
    port = tmab.mab_state_from_numpy(MAB_LITERAL, device="cpu")
    fn = jax.jit(jmab.end_of_interval_masked, static_argnums=(7, 8, 9))
    M = 12
    for it in range(10):
        apps = rng.randint(0, 3, M).astype(np.int32)
        sla = rng.uniform(100, 5000, M).astype(np.float32)
        resp = rng.uniform(100, 5000, M).astype(np.float32)
        acc = rng.uniform(0.8, 1.0, M).astype(np.float32)
        dec = rng.randint(0, 2, M).astype(np.int32)
        mask = rng.rand(M) < (0.1 if it % 3 == 2 else 0.6)
        with jax.enable_x64(True):
            ref = fn(ref, apps, sla, resp, acc, dec, mask, HP["phi"],
                     HP["gamma"], HP["k"])
        port = tmab.end_of_interval_masked(
            port, *[torch.from_numpy(a)[None] for a in
                    (apps, sla, resp, acc, dec, mask)], **HP)
        _assert_state_equal(port, ref, f"interval {it}")


@pytest.mark.parametrize("seed", range(3))
def test_reward_sums_divergence(seed):
    """Over 24 rows the port still sums each bucket in row order (JAX's
    op-by-op result, exactly), while the jitted reference regroups the
    float32 sums; the two stay within one float32 ulp."""
    rng = np.random.RandomState(seed)
    M = 24
    apps = rng.randint(0, 3, M).astype(np.int32)
    sla = rng.uniform(100, 5000, M).astype(np.float32)
    resp = rng.uniform(100, 5000, M).astype(np.float32)
    acc = rng.uniform(0.8, 1.0, M).astype(np.float32)
    dec = rng.randint(0, 2, M).astype(np.int32)
    mask = rng.rand(M) < 0.8
    ref = _jax_state(MAB_LITERAL)
    with jax.enable_x64(True):
        o_jit, c_jit = jax.jit(jmab.interval_rewards_masked)(
            ref, apps, sla, resp, acc, dec, mask)
        o_eager, _ = jmab.interval_rewards_masked(ref, apps, sla, resp, acc,
                                                  dec, mask)
    port = tmab.mab_state_from_numpy(MAB_LITERAL, device="cpu")
    o, c = tmab.interval_rewards_masked(
        port, *[torch.from_numpy(a)[None] for a in
                (apps, sla, resp, acc, dec, mask)])
    np.testing.assert_array_equal(c[0].numpy(), np.asarray(c_jit))
    assert o[0].numpy().tobytes() == np.asarray(o_eager).tobytes()
    np.testing.assert_allclose(o[0].numpy(), np.asarray(o_jit),
                               rtol=2.0 ** -23, atol=0)


def test_end_of_interval_empty_mask_only_ticks():
    port = tmab.mab_state_from_numpy(MAB_LITERAL, grid=2, device="cpu")
    z = torch.zeros((2, 5))
    out = tmab.end_of_interval_masked(
        port, z.int(), z.float(), z.float(), z.float(), z.int(),
        torch.zeros((2, 5), dtype=torch.bool), **HP)
    for k in ("Q", "N", "R", "eps", "rho"):
        assert torch.equal(getattr(out, k), getattr(port, k))
    assert out.t.tolist() == [41, 41] and out.t.dtype == torch.int32


def test_mab_state_from_numpy_round_trips():
    st = tmab.mab_state_from_numpy(MAB_LITERAL, grid=3, device="cpu")
    assert st.Q.shape == (3, 2, 2) and st.eps.shape == (3,)
    assert st.Q.dtype == torch.float32 and st.t.dtype == torch.int32
    back = tmab.mab_state_to_numpy(st)
    for k in FIELDS:
        want = np.asarray(MAB_LITERAL[k]).astype(tmab._FIELDS[k])
        for g in range(3):
            assert back[k][g].dtype == want.dtype
            assert back[k][g].tobytes() == want.tobytes(), k
    again = tmab.mab_state_from_numpy({k: v[0] for k, v in back.items()},
                                      grid=3, device="cpu")
    for k in FIELDS:
        assert torch.equal(getattr(again, k), getattr(st, k))


def test_mab_state_from_reference_fields():
    """The reference's own ``MABState`` fields carry across unchanged."""
    ref = _jax_state(MAB_LITERAL)
    d = {k: np.asarray(getattr(ref, k)) for k in FIELDS}
    st = tmab.mab_state_from_numpy(d, device="cpu")
    _assert_state_equal(st, ref, "carried")


def test_interval_rewards_bucketing():
    """The reference test's four tasks (two high-SLA layer splits, two
    low-SLA semantic ones): counts and mean rewards per bucket."""
    s = tmab.init_state(1, device="cpu")
    s = s._replace(R=torch.tensor([[10.0]]))
    apps = torch.zeros(4, dtype=torch.int32)
    sla = torch.tensor([20.0, 20.0, 5.0, 5.0])        # 2 high, 2 low
    resp = torch.tensor([15.0, 25.0, 4.0, 6.0])       # met, miss, met, miss
    acc = torch.tensor([0.9, 0.9, 0.8, 0.8])
    dec = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    O, cnt = tmab.interval_rewards(s, apps, sla, resp, acc, dec)
    assert O.shape == cnt.shape == (2, 2) and O.dtype == torch.float32
    np.testing.assert_allclose(cnt.numpy(), [[2, 0], [0, 2]])
    np.testing.assert_allclose(float(O[tmab.HIGH, tmab.LAYER]), 0.7,
                               rtol=1e-6)
    np.testing.assert_allclose(float(O[tmab.LOW, tmab.SEMANTIC]), 0.65,
                               rtol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_interval_rewards_matches_reference(seed):
    """The unmasked form against ``repro.core.mab.interval_rewards`` on
    fuzzed rows (12 of them: the reference's sums in row order)."""
    rng = np.random.RandomState(seed)
    d = _rand_state(rng)
    n = 12
    apps = rng.randint(0, 3, n).astype(np.int32)
    sla = rng.uniform(100, 5000, n).astype(np.float32)
    resp = rng.uniform(100, 5000, n).astype(np.float32)
    acc = rng.uniform(0.5, 1.0, n).astype(np.float32)
    dec = rng.randint(0, 2, n).astype(np.int32)
    wO, wc = jmab.interval_rewards(_jax_state(d), *map(jnp.asarray, (
        apps, sla, resp, acc, dec)))
    gO, gc = tmab.interval_rewards(
        tmab.mab_state_from_numpy(d, device="cpu"),
        *map(torch.from_numpy, (apps, sla, resp, acc, dec)))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_allclose(gO.numpy(), np.asarray(wO), rtol=1e-6)
