"""The one traffic generator: it reads a mix's parameters and makes request
``i`` of seed ``seed`` the same way every time.

A mix file (``traffic/<name>.json``) gives the request block (``batch`` x
``seq`` tokens), the deadline range in ms and the size of the block over
which deadlines are stratified, the plans' shapes (``stages``,
``branches``, ``slices``), the warm-up requests of set-up, the number of
finished requests the check samples, the traced sub-window, and for a model
with a visual front end the patch grid and how many distinct patch
embeddings are drawn.

Every seed gets the same sizes and the same set of deadlines: within each
block of ``deadline_block`` requests the deadlines are the block's evenly
spaced points of the range, in an order drawn from the seed.  Tokens are
uniform over the vocabulary; each request's come from its own generator
``(seed, i)``.
"""
from __future__ import annotations

import numpy as np
import torch


def visual_layout(batch: int, seq: int, grid: int):
    """``visual_mask`` (batch, seq) and ``positions3`` (batch, 3, seq) of a
    grid x grid patch block starting at seq / 8, Qwen2-VL's M-RoPE ids:
    text before the block at (i, i, i); patch (r, c) at (st, st + r,
    st + c); text after it from the block's largest id + 1."""
    n = grid * grid
    st = seq // 8
    if st + n > seq:
        raise ValueError(f"a {grid} x {grid} patch block does not fit {seq} "
                         f"positions from {st}")
    mask = np.zeros((batch, seq), bool)
    mask[:, st:st + n] = True
    p3 = np.broadcast_to(np.arange(seq), (3, seq)).copy()
    r, c = np.divmod(np.arange(n), grid)
    p3[:, st:st + n] = [np.full(n, st), st + r, st + c]
    p3[:, st + n:] = st + grid + np.arange(seq - st - n)
    return mask, np.ascontiguousarray(
        np.broadcast_to(p3, (batch, 3, seq)).astype(np.int32))


class Traffic:
    def __init__(self, mix: dict, config: dict, seed: int,
                 generator: torch.Generator = None, device=None):
        self.mix = mix
        self.seed = int(seed)
        self.batch, self.seq = mix["batch"], mix["seq"]
        self.vocab = config["vocab_size"]
        lo, hi = mix["deadline_ms"]
        self.deadline_range = (lo / 1e3, hi / 1e3)
        self.block = mix["deadline_block"]
        self.extras = None
        if config.get("visual_frontend"):
            d = config["hidden_size"]
            mask, p3 = visual_layout(self.batch, self.seq, mix["visual_grid"])
            pool = torch.randn((mix["visual_pool"], self.batch, self.seq, d),
                               generator=generator, device=device) * d ** -0.5
            self.pool = pool.cpu().numpy()
            self.extras = {"visual_mask": mask, "positions3": p3}

    def deadline_s(self, i: int) -> float:
        blk, j = divmod(i, self.block)
        order = np.random.default_rng([self.seed, 1, blk]).permutation(
            self.block)
        lo, hi = self.deadline_range
        return lo + (hi - lo) * (order[j] + 0.5) / self.block

    def request(self, i: int):
        """(tokens (batch, seq) int32, extras dict of NumPy arrays,
        deadline in s) of request i."""
        rng = np.random.default_rng([self.seed, 0, i])
        tokens = rng.integers(0, self.vocab, (self.batch, self.seq),
                              dtype=np.int32)
        extras = None
        if self.extras is not None:
            extras = dict(self.extras,
                          visual_embeds=self.pool[rng.integers(
                              len(self.pool))])
        return tokens, extras, self.deadline_s(i)

    def tensors(self, i: int, device):
        """Request i as the reference's batch of tensors on ``device``."""
        tokens, extras, _ = self.request(i)
        batch = {"tokens": torch.as_tensor(tokens, device=device)}
        for k, v in (extras or {}).items():
            batch[k] = torch.as_tensor(v, device=device)
        return batch
