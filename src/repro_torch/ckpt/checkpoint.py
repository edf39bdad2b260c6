"""Checkpoints: the port of ``repro.ckpt.checkpoint``, in its layout.

A checkpoint is a directory holding ``index.json`` (the step and, per
leaf, its path name, file, dtype and shape) and one ``leaf_NNNNN.npy`` per
leaf.  Trees are nested dicts, lists, tuples and NamedTuples (the
optimizer states) of tensors, flattened in JAX's order
(``repro_torch.tree``); a bfloat16 tensor is stored as its uint16 bits
with ``"bfloat16"`` in the index.  ``restore_checkpoint(dir, like)`` checks the leaf count, each
shape and each dtype against ``like`` and returns tensors on ``like``'s
devices; a save and a restore give back the same bits.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten

INDEX = "index.json"


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(directory: str, tree, step: int = 0):
    """Writes ``tree`` and ``step`` to ``directory`` (created if needed)."""
    os.makedirs(directory, exist_ok=True)
    index = {"step": int(step), "leaves": []}
    for i, (name, leaf) in enumerate(tree_flatten(tree)):
        arr, dtype = _to_numpy(torch.as_tensor(leaf))
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(directory, fname), arr)
        index["leaves"].append({"name": name, "file": fname,
                                "dtype": dtype, "shape": list(arr.shape)})
    with open(os.path.join(directory, INDEX), "w") as f:
        json.dump(index, f, indent=1)


def restore_checkpoint(directory: str, like_tree):
    """(tree in ``like_tree``'s structure, step): each leaf checked against
    ``like_tree``'s shape and dtype and placed on its device.  Raises
    ``FileNotFoundError`` when the directory holds no checkpoint."""
    with open(os.path.join(directory, INDEX)) as f:
        index = json.load(f)
    flat = tree_flatten(like_tree)
    if len(flat) != len(index["leaves"]):
        raise ValueError(f"leaf count mismatch {len(flat)} vs "
                         f"{len(index['leaves'])}")
    leaves = []
    for meta, (name, like) in zip(index["leaves"], flat):
        like = torch.as_tensor(like)
        arr = np.load(os.path.join(directory, meta["file"]))
        if list(arr.shape) != list(like.shape):
            raise ValueError(f"{meta['name']}: {arr.shape} vs "
                             f"{tuple(like.shape)}")
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if t.dtype != like.dtype:
            raise ValueError(f"{meta['name']}: {t.dtype} vs {like.dtype}")
        leaves.append(t.to(like.device))
    return tree_unflatten(like_tree, leaves), index["step"]
