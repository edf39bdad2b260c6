"""The port's threefry PRNG against ``jax.random``, bit for bit, on the CPU.

``repro_torch.core.prng`` implements JAX's non-partitionable threefry
mode, the mode that reproduces the reference's golden fixtures; every
reference draw here runs inside ``jax.threefry_partitionable(False)``,
with ``jax.enable_x64`` for the 64-bit cases.  Held exactly:
``prng_key``, ``fold_in``, ``split``, ``bits32``/``bits64`` and
``uniform32``/``uniform64`` over keys near 2**32 and data up to 2**32 − 1,
``bernoulli`` at both widths (including ``bernoulli``'s default p, which
draws 64 bits under x64), and the twin of the ``threefry_rows`` kernel
against the same chain written with ``jax.random``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels.threefry import threefry_rows

SEEDS = (0, 1, 42, 123456789, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1)
DATA = (0, 1, 7, 100, 10 ** 4, 2 ** 31 + 5, 2 ** 32 - 1)


def _jax_words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _mode():
    return jax.threefry_partitionable(False)


def _keys(seeds):
    with _mode():
        jk = [jax.random.PRNGKey(s) for s in seeds]
    return jk, torch.stack([prng.prng_key(s) for s in seeds])


def test_prng_key_matches():
    jk, tk = _keys(SEEDS)
    np.testing.assert_array_equal(np.stack([_jax_words(k) for k in jk]),
                                  tk.numpy())


@pytest.mark.parametrize("data", DATA)
def test_fold_in_matches(data):
    jk, tk = _keys(SEEDS)
    with _mode():
        want = np.stack([_jax_words(jax.random.fold_in(k, data))
                         for k in jk])
    np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(), want)
    # a tensor of data folds each row into its own key
    d = torch.full((len(SEEDS),), data, dtype=torch.int64)
    np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(), want)


def test_split_matches():
    jk, tk = _keys(SEEDS)
    with _mode():
        want = np.stack([_jax_words(jax.random.split(k)) for k in jk])
    a, b = prng.split(tk)
    np.testing.assert_array_equal(a.numpy(), want[:, 0])
    np.testing.assert_array_equal(b.numpy(), want[:, 1])


def test_bits_match():
    jk, tk = _keys(SEEDS)
    with _mode(), jax.enable_x64(True):
        b32 = np.array([int(jax.random.bits(k, dtype=jnp.uint32))
                        for k in jk], np.int64)
        b64 = np.array([np.uint64(jax.random.bits(k, dtype=jnp.uint64))
                        for k in jk], np.uint64)
    np.testing.assert_array_equal(prng.bits32(tk).numpy(), b32)
    np.testing.assert_array_equal(prng.bits64(tk).numpy().view(np.uint64),
                                  b64)


def test_uniforms_match():
    jk, tk = _keys(SEEDS)
    with _mode(), jax.enable_x64(True):
        u32 = np.array([jax.random.uniform(k, dtype=jnp.float32)
                        for k in jk], np.float32)
        u64 = np.array([jax.random.uniform(k, dtype=jnp.float64)
                        for k in jk], np.float64)
    got32, got64 = prng.uniform32(tk), prng.uniform64(tk)
    assert got32.dtype == torch.float32 and got64.dtype == torch.float64
    np.testing.assert_array_equal(got32.numpy(), u32)
    np.testing.assert_array_equal(got64.numpy(), u64)


def test_bernoulli_widths_match():
    """``bernoulli`` draws at the width of p: float32 p takes 32 bits,
    a float64 p and the default (a Python 0.5) 64 bits under x64."""
    rng = np.random.RandomState(0)
    seeds = list(rng.randint(0, 2 ** 32, 200, dtype=np.int64))
    jk, tk = _keys(seeds)
    p32 = np.float32(0.37)
    with _mode(), jax.enable_x64(True):
        w32 = np.array([bool(jax.random.bernoulli(k, jnp.float32(p32)))
                        for k in jk])
        w64 = np.array([bool(jax.random.bernoulli(k, 0.37)) for k in jk])
        wdef = np.array([bool(jax.random.bernoulli(k)) for k in jk])
    np.testing.assert_array_equal(
        prng.bernoulli(tk, torch.tensor(p32), 32).numpy(), w32)
    np.testing.assert_array_equal(prng.bernoulli(tk, 0.37, 64).numpy(), w64)
    np.testing.assert_array_equal(prng.bernoulli(tk, 0.5, 64).numpy(), wdef)
    assert 0 < wdef.sum() < len(seeds)


@pytest.mark.parametrize("t", (0, 3, 9999))
def test_threefry_rows_twin_matches_jax_chain(t):
    """The kernel's twin: row a of cell g draws from fold_in(fold_in(key_g,
    t), a); with p the split keys give (bernoulli(k1, p), bernoulli(k2,
    0.5)) at p's width, without p it is bernoulli(k, 0.5)."""
    seeds = (0, 5, 2 ** 32 - 1)
    rows = 37
    jk, tk = _keys(seeds)
    eps32 = np.float32(0.3)
    p = torch.tensor([0.0, 1.0, 0.6180339887498949], dtype=torch.float64)
    with _mode(), jax.enable_x64(True):
        want = {"coin": [], "e32": [], "c32": [], "e64": [], "c64": []}
        for g, k in enumerate(jk):
            kt = jax.random.fold_in(k, t)
            row = [jax.random.fold_in(kt, a) for a in range(rows)]
            want["coin"].append([bool(jax.random.bernoulli(r)) for r in row])
            for w, pw in (("32", jnp.float32(eps32)),
                          ("64", jnp.float64(p[g].item()))):
                sp = [jax.random.split(r) for r in row]
                want["e" + w].append([bool(jax.random.bernoulli(s[0], pw))
                                      for s in sp])
                want["c" + w].append([bool(jax.random.bernoulli(s[1], 0.5))
                                      for s in sp])
    want = {k: np.array(v) for k, v in want.items()}
    np.testing.assert_array_equal(threefry_rows(tk, t, rows).numpy(),
                                  want["coin"])
    p32 = torch.full((3,), float(eps32), dtype=torch.float64)
    e, c = threefry_rows(tk, t, rows, p=p32, width=32)
    np.testing.assert_array_equal(e.numpy(), want["e32"])
    np.testing.assert_array_equal(c.numpy(), want["c32"])
    e, c = threefry_rows(tk, t, rows, p=p, width=64)
    np.testing.assert_array_equal(e.numpy(), want["e64"])
    np.testing.assert_array_equal(c.numpy(), want["c64"])
    # p = 0 never explores, p = 1 always does
    assert not e[0].any() and e[1].all()


def test_threefry_rows_checks_arguments():
    key = torch.zeros((2, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        threefry_rows(key.int(), 0, 4)
    with pytest.raises(ValueError, match="float64"):
        threefry_rows(key, 0, 4, p=torch.zeros(2), width=32)
    with pytest.raises(ValueError, match="width"):
        threefry_rows(key, 0, 4, p=torch.zeros(2, dtype=torch.float64),
                      width=16)
    assert threefry_rows(key, 0, 0).shape == (2, 0)
