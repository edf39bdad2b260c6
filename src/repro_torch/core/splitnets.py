"""Real layer-wise and semantic splitting of neural networks (Fig. 1/2).

The port of ``repro.core.splitnets``.  The paper builds on two splitting
schemes:

* **Layer-wise** [Gillis, 32]: partition a trained network's layers into
  sequential fragments.  Functionally exact: composing the fragments
  runs the monolithic network's operations in the same order, so it
  reproduces the monolithic output bit for bit.  Cost: fragments execute
  sequentially, and intermediate activations travel between workers.

* **Semantic** [SplitNet, 16]: partition classes into groups; each branch
  is an independent sub-network (its own hidden features and a window of
  the input, no cross-branch weights) trained to score only its class
  group.  Branches run in parallel; the combiner concatenates their
  log-softmaxed class scores.  Accuracy drops (limited feature sharing),
  latency drops (parallel, each branch is 1/G-th the width).

An MLP classifier is a list of layers ``[{"w" (a, b), "b" (b,)}]`` of
float32 tensors on one device; products are ``torch.matmul`` (cuBLAS on
the card, with TF32 off).  The reference draws its weights from a JAX
key; the port draws them from a ``torch.Generator``, and
``classifier_from_numpy`` carries the reference's parameters across.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    input_dim: int
    num_classes: int
    hidden: int = 256
    depth: int = 4            # number of hidden layers


def init_mlp(generator, dims: Sequence[int], device="cuda"):
    """He-normal weights (normal × √(2 / fan_in)) and zero biases, drawn
    in float32 from ``generator`` on its own device, layer by layer, and
    placed on ``device``."""
    dev = resolve(device)
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator, dtype=torch.float32,
                        device=generator.device) * math.sqrt(2.0 / a)
        params.append({"w": w.to(dev),
                       "b": torch.zeros((b,), dtype=torch.float32,
                                        device=dev)})
    return params


def classifier_from_numpy(params, device="cuda"):
    """The reference's ``[{"w", "b"}]`` layer list (NumPy arrays, or
    anything ``np.asarray`` takes) as float32 tensors on ``device``."""
    dev = resolve(device)
    return [{k: torch.from_numpy(np.array(p[k], dtype=np.float32)).to(dev)
             for k in ("w", "b")} for p in params]


def mlp_apply(params, x):
    for i, p in enumerate(params):
        x = torch.matmul(x, p["w"]) + p["b"]
        if i < len(params) - 1:
            x = F.relu(x)
    return x


def classifier_dims(cfg: ClassifierConfig, width=None, out=None):
    h = width or cfg.hidden
    return [cfg.input_dim] + [h] * cfg.depth + [out or cfg.num_classes]


def train_classifier(generator, cfg, x, y, dims=None, steps=300, lr=1e-2,
                     batch=256, class_subset=None, device="cuda",
                     params=None):
    """Plain SGD with momentum, the reference's step: the mean cross
    entropy of ``log_softmax``, ``vel = 0.9·vel + g``, ``p = p − lr·vel``,
    over batches of the indices ``np.random.RandomState(0).randint(0, n,
    batch)`` drawn step by step; ``class_subset`` keeps the rows of those
    classes and renumbers them 0..len−1 in its order.  Starts from
    ``params`` if given (a layer list on ``device``, not modified), else
    from ``init_mlp(generator, dims)``.  x, y are NumPy arrays (n, d) and
    (n,) int; returns the trained layer list."""
    dev = resolve(device)
    dims = dims or classifier_dims(cfg)
    x, y = np.asarray(x), np.asarray(y)
    if class_subset is not None:
        sel = np.isin(y, class_subset)
        x, y = x[sel], y[sel]
        remap = {c: i for i, c in enumerate(class_subset)}
        y = np.vectorize(remap.get)(y)
    n = x.shape[0]
    if params is None:
        params = init_mlp(generator, dims, device=dev)
    params = [{k: t.detach().clone() for k, t in p.items()} for p in params]
    vel = [{k: torch.zeros_like(t) for k, t in p.items()} for p in params]
    rng = np.random.RandomState(0)
    idx = torch.as_tensor(np.stack([rng.randint(0, n, batch)
                                    for _ in range(steps)]).astype(np.int64),
                          device=dev) if steps else None
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(y, dtype=torch.int64, device=dev)
    leaves = [t for p in params for t in p.values()]
    vels = [t for v in vel for t in v.values()]
    rows = torch.arange(batch, device=dev)
    with torch.no_grad():
        for i in range(steps):
            grads = _ce_grads(params, xt[idx[i]], yt[idx[i]], rows)
            torch._foreach_mul_(vels, 0.9)
            torch._foreach_add_(vels, grads)
            torch._foreach_sub_(leaves, torch._foreach_mul(vels, lr))
    return params


def _ce_grads(params, xb, yb, rows):
    """The gradients of the mean cross entropy of ``log_softmax`` at the
    batch (xb, yb), written out as autograd forms them: (softmax − one
    hot) / B at the logits, then back through each layer (w: hᵀ·g, b: the
    column sums of g, the layer below: g·wᵀ where its ReLU passed).  In
    the order of ``params``' leaves (w, b per layer)."""
    hs = [xb]
    for i, p in enumerate(params):
        h = torch.matmul(hs[-1], p["w"]) + p["b"]
        hs.append(F.relu(h) if i < len(params) - 1 else h)
    g = torch.softmax(hs[-1], dim=-1)
    g[rows, yb] -= 1.0
    g = g / xb.shape[0]
    grads = []
    for i in range(len(params) - 1, -1, -1):
        grads[:0] = [torch.matmul(hs[i].T, g), g.sum(0)]
        if i:
            g = torch.matmul(g, params[i]["w"].T) * (hs[i] > 0)
    return grads


def accuracy(params, x, y, apply=mlp_apply):
    """The share of rows whose argmax of ``apply(params, x)`` is y."""
    first = params
    while not isinstance(first, torch.Tensor):
        first = first[0] if isinstance(first, list) else first["w"]
    dev = first.device
    with torch.no_grad():
        pred = torch.argmax(apply(params, torch.as_tensor(
            x, dtype=torch.float32, device=dev)), -1)
    return float((pred == torch.as_tensor(y, dtype=torch.int64,
                                          device=dev)).float().mean())


# ------------------------------------------------------------ layer split

def layer_split(params, num_fragments: int) -> List[list]:
    """Partition the layer list into ~equal sequential fragments."""
    L = len(params)
    num_fragments = min(num_fragments, L)
    bounds = np.linspace(0, L, num_fragments + 1).astype(int)
    return [params[a:b] for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def layer_split_apply(fragments, x):
    """Sequential (pipelined) execution of layer fragments: the operations
    of ``mlp_apply`` in its order, so the output is bitwise its own on
    the same device."""
    h = x
    for i, frag in enumerate(fragments):
        last_fragment = i == len(fragments) - 1
        for j, p in enumerate(frag):
            h = torch.matmul(h, p["w"]) + p["b"]
            is_output = last_fragment and j == len(frag) - 1
            if not is_output:
                h = F.relu(h)
    return h


def fragment_flops(fragments, batch=1):
    return [sum(2 * batch * p["w"].shape[0] * p["w"].shape[1] for p in f)
            for f in fragments]


# --------------------------------------------------------- semantic split

def class_groups(num_classes: int, num_branches: int):
    bounds = np.linspace(0, num_classes, num_branches + 1).astype(int)
    return [list(range(a, b)) for a, b in zip(bounds[:-1], bounds[1:])]


def feature_groups(input_dim: int, num_branches: int, coverage: float = 0.6):
    """Per-branch contiguous feature windows covering ``coverage`` of the
    input each (overlapping): SplitNet branches specialize on feature
    subsets; full disjointness is harsher than the published 2-7 % drop,
    and 60 % windows calibrate the penalty to Fig. 2's range."""
    if num_branches == 1:
        return [(0, input_dim)]
    w = max(1, int(input_dim * coverage))
    starts = np.linspace(0, input_dim - w, num_branches).astype(int)
    return [(int(a), int(a + w)) for a in starts]


def train_semantic_split(generators, cfg: ClassifierConfig, x, y,
                         num_branches: int, steps=300, device="cuda"):
    """Train one branch per class group (``class_groups``), each on its
    feature window (``feature_groups``) at width max(8, hidden / G), from
    ``generators[i]``'s draw (the reference splits one key into one per
    branch).  Returns (branches, (class groups, feature windows))."""
    groups = class_groups(cfg.num_classes, num_branches)
    fgroups = feature_groups(cfg.input_dim, num_branches)
    if len(generators) != num_branches:
        raise ValueError(f"{len(generators)} generators for {num_branches} "
                         f"branches")
    x = np.asarray(x)
    width = max(8, cfg.hidden // num_branches)
    branches = []
    for gen, g, (lo, hi) in zip(generators, groups, fgroups):
        sub = dataclasses.replace(cfg, input_dim=hi - lo)
        dims = [hi - lo] + [width] * cfg.depth + [len(g)]
        branches.append(train_classifier(gen, sub, x[:, lo:hi], y,
                                         dims=dims, steps=steps,
                                         class_subset=g, device=device))
    return branches, (groups, fgroups)


def semantic_split_apply(branches, groups, x):
    """Branch execution and score concatenation (the combiner): each
    branch scores only its classes, log-softmaxed, concatenated in group
    order."""
    _, fgroups = groups
    outs = [mlp_apply(b, x[..., lo:hi]) for b, (lo, hi) in zip(branches,
                                                               fgroups)]
    return torch.cat([F.log_softmax(o, dim=-1) for o in outs], dim=-1)
