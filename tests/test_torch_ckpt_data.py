"""The port's data pipeline, checkpoints and training CLI.

``TokenPipeline`` batches are byte-equal to the reference's
(``repro.data.pipeline``) for three seeds and the codebook variant, and
``synthetic_classification``'s are equal in one process; a checkpoint of
a bfloat16 parameter tree with both optimizer states comes back
bit-exact, in the reference's layout; ``python -m
repro_torch.launch.train --device cpu --reduced`` trains with a finite
loss and continues from ``--ckpt``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train
from repro_torch.models.model import init_params, stack_groups
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


@pytest.mark.parametrize("seed,cb", [(0, 0), (1, 0), (7, 0), (3, 4)])
def test_token_pipeline_is_byte_equal_to_reference(seed, cb):
    want = jpipe.TokenPipeline(5000, 33, 3, seed=seed, num_codebooks=cb)
    got = tpipe.TokenPipeline(5000, 33, 3, seed=seed, num_codebooks=cb)
    for _ in range(3):
        w, g = want.next_batch(), got.next_batch()
        assert w.keys() == g.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype
            assert g[key].shape == w[key].shape
            assert g[key].tobytes() == w[key].tobytes(), key


@pytest.mark.parametrize("app", jpipe.APP_NAMES)
def test_synthetic_classification_equals_reference(app):
    x, y = tpipe.synthetic_classification(app, 50, seed=2)
    wx, wy = jpipe.synthetic_classification(app, 50, seed=2)
    assert x.tobytes() == wx.tobytes() and y.tobytes() == wy.tobytes()


def _bf16_tree():
    cfg = get_config("tinyllama-1.1b").reduced()
    params = init_params(cfg, device="cpu")
    # bfloat16 but for the MLPs, which stay float32: a mixed tree
    leaves = [t if "/mlp/" in name else t.bfloat16()
              for name, t in tree_flatten(params)]
    return cfg, tree_unflatten(params, leaves)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_checkpoint_round_trip_is_bit_exact(tmp_path, opt):
    cfg, params = _bf16_tree()
    init, update = make_optimizer(opt, stack_groups(params, cfg))
    leaves = tree_leaves(params)
    state = init(leaves)
    grads = [torch.randn(p.shape).to(p.dtype) for p in leaves]
    _, state = update(grads, state, leaves, 1e-3)
    tree = (params, state)
    save_checkpoint(str(tmp_path), tree, step=7)
    with open(tmp_path / "index.json") as f:
        index = json.load(f)
    assert index["step"] == 7
    assert "bfloat16" in {leaf["dtype"] for leaf in index["leaves"]}
    assert all(os.path.exists(tmp_path / leaf["file"])
               for leaf in index["leaves"])
    like = (params, type(state)(*[
        torch.zeros_like(x) if isinstance(x, torch.Tensor)
        else [torch.zeros_like(t) for t in x] for x in state]))
    got, step = restore_checkpoint(str(tmp_path), like)
    assert step == 7 and type(got[1]) is type(state)
    want_leaves, got_leaves = tree_leaves(tree), tree_leaves(got)
    assert len(want_leaves) == len(got_leaves)
    for a, b in zip(want_leaves, got_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_refuses_a_wrong_shape(tmp_path):
    save_checkpoint(str(tmp_path), {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="a"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"a": torch.zeros(3)})


def test_train_cli_on_the_cpu_continues_from_its_checkpoint(tmp_path,
                                                            capsys):
    ck = str(tmp_path / "ck")
    losses = train.main(["--device", "cpu", "--reduced", "--steps", "4",
                         "--seq", "16", "--batch", "2", "--ckpt", ck])
    out = capsys.readouterr().out
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert "arch=tinyllama-1.1b" in out and "step     3 loss" in out
    assert " -> " in out and "improved" in out
    more = train.main(["--device", "cpu", "--reduced", "--steps", "6",
                       "--seq", "16", "--batch", "2", "--ckpt", ck])
    out = capsys.readouterr().out
    assert "restored step 4 from" in out and len(more) == 2
    assert np.all(np.isfinite(more))
