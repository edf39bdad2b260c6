"""JAX's threefry2x32 PRNG, bit for bit, in plain PyTorch.

The counterpart of the ``jax.random`` calls the reference's in-loop
learners make (``repro.core.mab.decide_train_rows``,
``gillis_decide_rows`` and the ``random+daso`` arm of
``repro.env.jaxsim.engines``), in JAX's non-partitionable threefry mode
(``jax.threefry_partitionable(False)``), the mode that reproduces the
reference's golden fixtures.

A key is a (..., 2) int64 tensor of two uint32 words; every word is an
int64 holding a value below 2**32 (the arithmetic masks with
``0xFFFFFFFF`` and never relies on ``torch.uint32``).  All functions
broadcast over the leading axes.

  * ``threefry2x32(k0, k1, x0, x1)``: 20 rounds in 5 groups of 4, the
    rotations (13, 15, 26, 6) and (17, 29, 16, 24) in turn, a key
    injection after each group;
  * ``prng_key(seed) = (0, seed)``; ``fold_in(k, d) = threefry(k, (0, d))``;
  * ``split(k)``: the two keys ``(a0, a1)``, ``(b0, b1)`` with
    ``(a_i, b_i) = threefry(k, (i, i + 2))``;
  * ``bits32(k) = threefry(k, (0, 0))[0]``; ``bits64(k) = a << 32 | b``
    with ``(a, b) = threefry(k, (0, 1))``;
  * ``uniform32 = f32((bits32 >> 9) | 0x3F800000) - 1``, which is
    ``(bits32 >> 9) * 2**-23`` exactly, and ``uniform64 = f64((bits64 >>
    12) | 0x3FF0000000000000) - 1``, which is ``(bits64 >> 12) * 2**-52``;
  * ``bernoulli(k, p, width) = uniform_width(k) < p``.  ``jax.random
    .bernoulli`` draws at the width of ``p``'s dtype: 32 bits for a
    float32 p, 64 for a float64 p or a Python float under
    ``enable_x64`` (its default p=0.5 is a Python float).
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
#: threefry's key-schedule parity constant
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

i8 = torch.int64


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under the key words
    (k0, k1); every argument an int64 tensor (or int) of uint32 values,
    broadcast together.  Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed, device="cpu"):
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32: (0, seed)."""
    seed = int(seed)
    if not 0 <= seed <= MASK:
        raise ValueError(f"prng_key: seed {seed} is not in [0, 2**32)")
    return torch.tensor([0, seed], dtype=i8, device=device)


def _words(key):
    return key[..., 0], key[..., 1]


def fold_in(key, data):
    """``jax.random.fold_in``: data (int or int64 tensor, taken mod 2**32)
    folded into key (..., 2)."""
    k0, k1 = _words(key)
    if isinstance(data, torch.Tensor):
        data = data.to(i8) & MASK
    else:
        data = int(data) & MASK
    y0, y1 = threefry2x32(k0, k1, 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key):
    """``jax.random.split(key)`` into two keys, each (..., 2)."""
    k0, k1 = _words(key)
    a0, b0 = threefry2x32(k0, k1, 0, 2)
    a1, b1 = threefry2x32(k0, k1, 1, 3)
    return torch.stack([a0, a1], dim=-1), torch.stack([b0, b1], dim=-1)


def bits32(key):
    """``jax.random.bits(key, dtype=uint32)`` of a scalar draw, as int64."""
    k0, k1 = _words(key)
    return threefry2x32(k0, k1, 0, 0)[0]


def bits64(key):
    """``jax.random.bits(key, dtype=uint64)`` of a scalar draw, as the int64
    of the same 64 bits."""
    k0, k1 = _words(key)
    a, b = threefry2x32(k0, k1, 0, 1)
    return (a << 32) | b


def uniform32(key):
    """``jax.random.uniform(key, dtype=float32)`` of a scalar draw."""
    return (bits32(key) >> 9).to(torch.float32) * 2.0 ** -23


def uniform64(key):
    """``jax.random.uniform(key, dtype=float64)`` of a scalar draw."""
    k0, k1 = _words(key)
    a, b = threefry2x32(k0, k1, 0, 1)
    mant = (a << 20) | (b >> 12)            # the top 52 of the 64 bits
    return mant.to(torch.float64) * 2.0 ** -52


def uniform(key, width: int):
    if width == 32:
        return uniform32(key)
    if width == 64:
        return uniform64(key)
    raise ValueError(f"uniform: width {width} is not 32 or 64")


def bernoulli(key, p, width: int):
    """``jax.random.bernoulli(key, p)`` of a scalar draw at ``width`` bits
    (the width of p's dtype in the reference)."""
    return uniform(key, width) < p
