"""Deterministic synthetic data pipelines, the port of
``repro.data.pipeline`` (NumPy, no downloads).

Two families, as in the reference:
  * token streams for LM training of the assigned architectures
    (``TokenPipeline``: a noisy order-2 Markov chain, so that training
    reduces the loss); its batches are byte-equal to the reference's for
    the same arguments and seed;
  * class-structured "image" vectors for the paper's edge applications
    (``synthetic_classification``: MNIST / FashionMNIST / CIFAR100
    stand-ins with their input dims and class counts).

Batches are NumPy arrays on the host; the train step moves them to its
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """The paper's application set A = {MNIST, FashionMNIST, CIFAR100}."""
    name: str
    input_dim: int
    num_classes: int
    difficulty: float       # controls class separability (higher = harder)
    container_mb: tuple     # split-fragment image sizes from §6.2


APPS = {
    "mnist": AppSpec("mnist", 28 * 28, 10, 0.8, (8, 14)),
    "fashionmnist": AppSpec("fashionmnist", 28 * 28, 10, 1.6, (34, 56)),
    "cifar100": AppSpec("cifar100", 32 * 32 * 3, 100, 1.0, (47, 76)),
}
APP_NAMES = list(APPS)


def synthetic_classification(app: str, n: int, seed: int = 0):
    """Gaussian class clusters on a random manifold.  Class centers depend
    only on the app (so train and test seeds share the task); the seed
    drives the noise and the labels.  As in the reference, the centers'
    seed is ``hash(app)``, which Python salts per process unless
    ``PYTHONHASHSEED`` is set: two processes agree only under one salt."""
    spec = APPS[app]
    centers_rng = np.random.RandomState(abs(hash(app)) % 2**31)
    centers = centers_rng.randn(spec.num_classes,
                                spec.input_dim).astype(np.float32)
    centers *= 2.0 / np.sqrt(spec.input_dim)
    rng = np.random.RandomState((abs(hash(app)) % 2**31) ^ (seed + 1))
    y = rng.randint(0, spec.num_classes, n)
    noise = rng.randn(n, spec.input_dim).astype(np.float32)
    x = centers[y] + spec.difficulty * 0.35 * noise
    return x.astype(np.float32), y.astype(np.int32)


class TokenPipeline:
    """Deterministic pseudo-corpus LM batches: each token has 8 likely
    successors (over the first min(vocab, 4096) ids), 10 % of tokens are
    uniform noise.  ``next_batch()`` -> ``{"tokens", "labels"}`` int32 (b,
    s), labels the tokens shifted by one; with ``num_codebooks`` (b, s, cb),
    codebook i offset by 7·i modulo the vocab."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, num_codebooks: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.cb = num_codebooks
        self.rng = np.random.RandomState(seed)
        v = min(vocab_size, 4096)
        self._v = v
        self._succ = self.rng.randint(0, v, (v, 8))

    def next_batch(self):
        shape = (self.batch, self.seq + 1)
        v = self._v
        toks = np.empty(shape, np.int64)
        toks[:, 0] = self.rng.randint(0, v, self.batch)
        choice = self.rng.randint(0, 8, shape)
        noise = self.rng.rand(*shape) < 0.1
        rand_tok = self.rng.randint(0, v, shape)
        for t in range(1, self.seq + 1):
            nxt = self._succ[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(noise[:, t], rand_tok[:, t], nxt)
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        if self.cb:
            tokens = np.stack([(tokens + i * 7) % self.vocab
                               for i in range(self.cb)], axis=-1)
            labels = np.stack([(labels + i * 7) % self.vocab
                               for i in range(self.cb)], axis=-1)
        return {"tokens": tokens, "labels": labels}
