"""Sharding rules for every architecture on the production mesh.

The port of ``repro.launch.sharding``, with the reference's strategy:

  * batch              -> ('pod', 'data')           (pure DP over pods)
  * residual seq       -> 'model'                   (sequence parallelism)
  * heads / ffn hidden / experts / vocab -> 'model' (tensor / expert parallel)
  * params + optimizer state: FSDP over ('pod', 'data') on the largest
    non-TP dim, TP over 'model'

A dim is split over an axis group only if the group's size divides it.
A partition spec here is a tuple with one entry per tensor dim: None,
``"model"`` or a tuple of batch axes (``("data",)``, ``("pod",
"data")``), entry for entry the reference's ``PartitionSpec``.
``placements(mesh, spec)`` turns one into DTensor placements on a
``DeviceMesh``.

``param_pspec`` applies the reference's rules, by leaf name and shape,
to the port's per-layer leaves (``blocks/<i>/...``): the reference
stacks its body periods along a leading axis, which its rules skip, so a
port leaf gets the spec of its reference leaf without that axis
(``models.model.stack_groups`` maps one onto the other).
``params_shardings``, ``opt_state_shardings``, ``batch_shardings`` and
``cache_shardings`` give placements for whole trees; ``distribute``
places a tree's tensors on the mesh.  ``make_constrain`` is the model's
hook: it redistributes a DTensor activation to the reference's
``with_sharding_constraint`` spec of its kind, and leaves any other
tensor as it is.
"""
from __future__ import annotations

from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.models.dist import placed
from repro_torch.models.model import stack_groups
from repro_torch.optim.optimizers import AdafactorState, AdamWState
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

MODEL = "model"


def _axes_size(mesh, axes):
    sizes = axis_sizes(mesh)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return n


def _fit(mesh, dim_size, axes):
    """axes if the dim divides evenly over them, else None."""
    if axes is None or dim_size <= 0:
        return None
    if dim_size % _axes_size(mesh, axes) == 0:
        return axes
    return None


def _spec(nd, *dims):
    return tuple(list(dims) + [None] * (nd - len(dims)))


def param_pspec(mesh, cfg, path, shape):
    """The partition spec of the parameter leaf at ``path`` (``"embed"``,
    ``"blocks/3/attn/wq"``, ...) of ``shape``: the reference's rules."""
    base = path.split("/")[-1]
    d = tuple(shape)
    nd = len(d)
    fsdp = batch_axes(mesh)
    tp = MODEL

    def spec(*dims):
        return _spec(nd, *dims)

    if base == "embed":
        if cfg.num_codebooks:
            return spec(None, _fit(mesh, d[1], tp), _fit(mesh, d[2], fsdp))
        return spec(_fit(mesh, d[0], tp), _fit(mesh, d[1], fsdp))
    if base == "head":
        if cfg.num_codebooks:
            return spec(None, _fit(mesh, d[1], fsdp), _fit(mesh, d[2], tp))
        return spec(_fit(mesh, d[0], fsdp), _fit(mesh, d[1], tp))
    if nd <= 1:  # norms, 1-d biases, Lambda, D, dt_bias, conv_b
        split = base in ("Lambda", "D", "conv_b", "b_a", "b_i", "dt_bias")
        return spec(_fit(mesh, d[0], tp) if split else None)
    if base in ("wq", "wk", "wv"):
        heads = _fit(mesh, d[1], tp)
        return spec(_fit(mesh, d[0], fsdp), heads, None)
    if base in ("bq", "bk", "bv"):
        return spec(_fit(mesh, d[0], tp), None)
    if base == "wo":
        return spec(_fit(mesh, d[0], tp), None, _fit(mesh, d[2], fsdp))
    if base in ("w_up", "w_gate") and nd == 2:       # dense MLP
        return spec(_fit(mesh, d[0], fsdp), _fit(mesh, d[1], tp))
    if base == "w_down" and nd == 2:
        return spec(_fit(mesh, d[0], tp), _fit(mesh, d[1], fsdp))
    if base in ("router", "shared_gate"):
        return spec(_fit(mesh, d[0], fsdp), None)
    if base in ("w_up", "w_gate", "w_down") and nd == 3:  # MoE experts
        if _fit(mesh, d[0], tp):                          # expert parallel
            return spec(tp, _fit(mesh, d[1], fsdp), None)
        if base == "w_down":                              # TP in the expert
            return spec(None, _fit(mesh, d[1], tp), _fit(mesh, d[2], fsdp))
        return spec(None, _fit(mesh, d[1], fsdp), _fit(mesh, d[2], tp))
    if base in ("in_proj", "in_x", "in_gate"):       # mamba, rglru
        return spec(_fit(mesh, d[0], fsdp), _fit(mesh, d[1], tp))
    if base in ("conv_w", "dt_proj"):
        return spec(None, _fit(mesh, d[1], tp))
    if base in ("x_proj", "A_log"):
        return spec(_fit(mesh, d[0], tp), None)
    if base in ("out_proj", "out"):
        return spec(_fit(mesh, d[0], tp), _fit(mesh, d[1], fsdp))
    if base in ("w_a", "w_i"):                       # block-diag (gb, bw, bw)
        return spec(_fit(mesh, d[0], tp), None, None)
    # fallback: FSDP on the largest dim
    big = max(range(nd), key=lambda i: d[i])
    dims = [None] * nd
    dims[big] = _fit(mesh, d[big], fsdp)
    return spec(*dims)


def placements(mesh, spec):
    """DTensor placements on ``mesh`` of a partition spec: mesh dim j
    splits the tensor dim whose entry names its axis (a tuple of axes
    splits one dim over several mesh dims, the first axis outermost, as
    the reference's ``PartitionSpec``), else replicates."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return tuple(out)


def params_pspecs(mesh, cfg, params):
    """The partition spec of every parameter leaf, a tree like
    ``params``."""
    return tree_unflatten(params, [param_pspec(mesh, cfg, path, t.shape)
                                   for path, t in tree_flatten(params)])


def params_shardings(mesh, cfg, params):
    """DTensor placements of every parameter leaf, a tree like
    ``params``."""
    return tree_unflatten(params, [
        placements(mesh, param_pspec(mesh, cfg, path, t.shape))
        for path, t in tree_flatten(params)])


def _by_shape_match(shape, by_shape):
    """The reference's ``opt_state_shardings`` match of a state leaf's
    shape against the parameters' (reference-shaped) specs."""
    if shape in by_shape:
        return by_shape[shape]
    for pshape, sp in by_shape.items():
        for cut in (1, 2):
            if shape == pshape[:-cut]:
                return tuple(sp[:len(shape)])
        if len(shape) == len(pshape) and all(
                a == b or a == 1 for a, b in zip(shape, pshape)):
            return tuple(s if a == b else None
                         for s, a, b in zip(sp, shape, pshape))
    for pshape, sp in by_shape.items():
        if len(pshape) >= 2 and shape == pshape[:-2] + pshape[-1:]:
            return tuple(list(sp[:-2]) + [sp[-1]])
    return (None,) * len(shape)


def opt_state_shardings(mesh, cfg, opt_state, params):
    """Placements of the optimizer state, mirroring the parameters'
    (ZeRO-style): AdamW's moments take their parameter's spec;
    Adafactor's statistics (one per reference leaf, ``stack_groups``)
    take the reference's rule: the spec of the first reference-shaped
    parameter leaf of their shape, else that spec cut to a factored
    statistic's shape, else replicated; ``step`` is replicated.  Returns a state of the
    same type holding placements."""
    flat = tree_flatten(params)
    specs = [param_pspec(mesh, cfg, path, t.shape) for path, t in flat]
    by_shape = {}
    for group in stack_groups(params, cfg):
        if isinstance(group, int):
            shape, sp = tuple(flat[group][1].shape), specs[group]
        else:
            shape = (len(group),) + tuple(flat[group[0]][1].shape)
            sp = (None,) + specs[group[0]]
        by_shape.setdefault(shape, sp)
    rep = placements(mesh, ())

    def match(t):
        return placements(mesh, _by_shape_match(tuple(t.shape), by_shape))

    if isinstance(opt_state, AdamWState):
        own = [placements(mesh, sp) for sp in specs]
        return AdamWState(step=rep, m=own, v=list(own))
    return AdafactorState(step=rep, vr=[match(t) for t in opt_state.vr],
                          vc=[match(t) for t in opt_state.vc])


def batch_pspec(mesh, shape):
    """Inputs: dim 0 over the batch axes, the rest unsplit (the residual
    constraint re-shards inside the model)."""
    dims = [None] * len(shape)
    if dims:
        dims[0] = _fit(mesh, shape[0], batch_axes(mesh))
    return tuple(dims)


def batch_shardings(mesh, batch):
    """Placements of every batch entry (a dict of tensors)."""
    return {k: placements(mesh, batch_pspec(mesh, v.shape))
            for k, v in batch.items()}


def cache_pspec(mesh, name, shape):
    """KV caches: batch over the batch axes, cache length over 'model'
    (sequence-sharded KV); SSM / RNN states: the inner dim over 'model'
    (mamba h (b, d_in, n), rglru h (b, w)); conv inputs (b, k-1, d): d
    over 'model'."""
    ba = batch_axes(mesh)
    nd = len(shape)
    dims = [None] * nd
    if name in ("k", "v"):                            # (b, W, kvh, hd)
        dims[0] = _fit(mesh, shape[0], ba)
        dims[1] = _fit(mesh, shape[1], MODEL)
    elif name == "h":
        inner = -2 if nd >= 3 else -1
        dims[inner] = _fit(mesh, shape[inner], MODEL)
        dims[0] = _fit(mesh, shape[0], ba)
    elif name == "conv":
        dims[-1] = _fit(mesh, shape[-1], MODEL)
        dims[0] = _fit(mesh, shape[0], ba)
    return tuple(dims)


def cache_shardings(mesh, cfg, cache):
    """Placements of a decode cache (one dict per layer)."""
    return [{k: placements(mesh, cache_pspec(mesh, k, t.shape))
             for k, t in layer.items()} for layer in cache]


def distribute(tree, shardings, mesh):
    """``tree``'s tensors as DTensors on ``mesh`` with the matching
    placements of ``shardings`` (a tree of the same structure); each rank
    keeps only its shard, and nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor
    out = [distribute_tensor(t, mesh, p, src_data_rank=None)
           for t, p in zip(tree_leaves(tree), _placement_leaves(shardings))]
    return tree_unflatten(tree, out)


def _placement_leaves(tree):
    """The placement tuples of a sharding tree, in ``tree_flatten``'s
    order (a plain tuple is a leaf; dicts, lists and NamedTuples are
    walked)."""
    if isinstance(tree, dict):
        return [p for key in sorted(tree) for p in _placement_leaves(tree[key])]
    if isinstance(tree, list) or hasattr(tree, "_fields"):
        return [p for item in tree for p in _placement_leaves(item)]
    return [tree]


# --------------------------------------------------- activation constraints

def constrain_pspec(mesh, shape, kind):
    """The reference's ``with_sharding_constraint`` spec of an activation
    of ``kind``, or None for a kind it leaves alone."""
    nd = len(shape)
    if nd < 2:
        return None
    ba = batch_axes(mesh)
    dims = [None] * nd
    if kind == "residual":                          # (b, s, d)
        dims[0] = _fit(mesh, shape[0], ba)
        if nd == 3:
            dims[1] = _fit(mesh, shape[1], MODEL)
    elif kind in ("ffn_hidden", "ssm_inner", "rnn_inner", "logits"):
        dims[0] = _fit(mesh, shape[0], ba)
        dims[-1] = _fit(mesh, shape[-1], MODEL)
    elif kind == "moe_group":                       # (G, gs, d)
        dims[0] = _fit(mesh, shape[0], ba)
    elif kind == "moe_buffer":                      # (G, E*C+1, d)
        dims[0] = _fit(mesh, shape[0], ba)
        dims[-1] = _fit(mesh, shape[-1], MODEL)
    elif kind == "moe_expert":                      # (G, E, C, d)
        off = nd - 4
        if off >= 0:
            dims[off] = _fit(mesh, shape[off], ba)
        dims[off + 1] = _fit(mesh, shape[off + 1], MODEL)
        if dims[off + 1] is None:
            dims[-1] = _fit(mesh, shape[-1], MODEL)
    else:
        return None
    return tuple(dims)


def make_constrain(mesh, cfg):
    """constrain(x, kind): a DTensor ``x`` redistributed to
    ``constrain_pspec``'s placements (the reference's
    ``with_sharding_constraint``); any other tensor, or a kind without a
    spec, as it is."""
    del cfg

    def constrain(x, kind):
        if not hasattr(x, "placements"):
            return x
        spec = constrain_pspec(mesh, x.shape, kind)
        if spec is None:
            return x
        want = placements(mesh, spec)
        if tuple(x.placements) == want:
            # already placed: the gradient is held to the same placement
            # (the one its producer made), as a redistribution's returns
            # to its input's
            return placed(x, want, want)
        return x.redistribute(mesh, want)

    return constrain
