"""FLOP and byte counter over a PyTorch step, with the reference's rules.

The port of ``repro.launch.flopcount``, which walks a jaxpr.  Here the
step runs under ``FlopCounter``, a ``TorchDispatchMode`` that sees every
operator as it runs (on the card, on the CPU, on the meta device or on
fake tensors), so a Python loop is counted as it runs: the counterpart of
the reference's "scan body × length".  The rules are the reference's:

  * a matrix product (``mm``, ``bmm``, ``addmm``, ...) is 2·M·N·K FLOPs;
  * every other operator is 1 FLOP per output element (elementwise ops
    and reductions), except views, copies and tensor creation, which are
    free (the reference's ``reshape``, ``transpose``, ``concatenate``,
    ``pad``, ``broadcast_in_dim``, ``iota``, ...);
  * HBM bytes are charged at materialising operators: products, gathers
    and scatters, sorts and top-k, cumulative ops and arg-reductions (each
    input read once, each output written once); elementwise chains are
    taken as fused, as XLA fuses them;
  * the model kernels (``repro_torch::*`` operators, ``kernels.ops``) are
    counted by their own cost rules (``kernels.ops.COST_RULES``: the
    forward's equals what the reference counts for its jnp twin) and
    charge their own traffic as bytes; what their CPU implementation does
    inside is never seen, so a step counts the same on the card, on the
    CPU and on the meta device.

On DTensor operands the counter steps aside (returns ``NotImplemented``)
so that DTensor runs first: it then counts the local operators on each
rank's shards, and the functional collectives DTensor issues, whose
result bytes it sums by kind (``collective_bytes``), as the reference's
dry-run sums the HLO's collectives.

``count_fn(fn, *args)`` runs ``fn`` under a counter and adds the
reference's I/O term, one read of every input and one write of every
output.
"""
from __future__ import annotations

from collections import Counter

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the kernel modules register their operators and cost rules on import
from repro_torch.kernels import (flash_attention, moe_route,  # noqa: F401
                                 rglru_scan, selective_scan)
from repro_torch.kernels.ops import COST_RULES

#: matrix products: 2·(output elements)·K, K the contracted length
PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot"}
#: materialising operators: bytes charged, 1 FLOP per output element
MATERIALIZING = {
    "gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index", "_unsafe_index",
    "index_select", "index_put", "index_put_", "_index_put_impl_",
    "index_add", "index_add_", "index_copy", "index_copy_", "embedding",
    "embedding_dense_backward", "take_along_dim", "sort", "topk", "cumsum",
    "cumsum_", "cumprod", "logcumsumexp", "argmax", "argmin",
    "masked_scatter", "nonzero"}
#: views, copies and creation: free
FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "permute", "transpose", "transpose_", "t", "t_",
    "unsqueeze", "unsqueeze_", "squeeze", "squeeze_", "select", "slice",
    "as_strided", "as_strided_", "alias", "detach", "detach_", "split",
    "split_with_sizes", "chunk", "unbind", "narrow", "diagonal",
    "unflatten", "flatten", "view_as", "clone", "copy_", "copy", "_to_copy",
    "to", "contiguous", "cat", "stack", "constant_pad_nd", "pad", "roll",
    "repeat", "flip", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_zeros", "new_ones", "new_full", "arange",
    "scalar_tensor", "lift_fresh", "lift_fresh_copy", "fill_", "zero_",
    "_local_scalar_dense", "slice_backward", "select_backward",
    "slice_scatter", "select_scatter", "_conj", "_neg_view", "resolve_conj",
    "resolve_neg", "set_", "resize_", "_unsafe_split"}
#: functional collectives by the reference's HLO kinds
COLLECTIVES = (("all_gather", "all-gather"), ("reduce_scatter",
                                              "reduce-scatter"),
               ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
               ("alltoall", "all-to-all"), ("permute", "collective-permute"),
               ("broadcast", "all-reduce"))
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (its own shape and dtype: on a
    DTensor the global tensor, on a shard the shard)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _numel(tree) -> int:
    return sum(t.numel() for t in _tensors(tree))


def _positional(func, args, kwargs):
    """The operator's arguments in schema order, defaults filled in."""
    out = list(args)
    for a in func._schema.arguments[len(args):]:
        out.append(kwargs[a.name] if a.name in kwargs else a.default_value)
    return out


def _product_flops(name, args, out):
    """(2·(output elements)·K, K the contracted length; 1 per output
    element for the input ``addmm`` / ``baddbmm`` add)."""
    adds = name in ("addmm", "baddbmm")
    a = args[1] if adds else args[0]
    n_out = out.numel()
    return 2.0 * n_out * a.shape[-1], float(n_out if adds else 0)


def _kind(func):
    """How the counter charges an operator: ``"kernel"`` (a cost rule),
    ``"product"``, ``"free"``, ``"materializing"``, a collective's kind,
    or ``"elementwise"``."""
    if func in COST_RULES:
        return "kernel"
    name = func.__name__.split(".")[0]
    if func.namespace in ("_c10d_functional", "c10d_functional", "_dtensor"):
        for key, kind in COLLECTIVES:
            if key in name:
                return kind
        return "free"
    if name in FREE:
        return "free"
    if name in PRODUCTS:
        return "product"
    if name in MATERIALIZING:
        return "materializing"
    return "elementwise"


#: operator -> (``_kind``, its name), filled as operators are first seen
_KINDS = {}


def _dtensor_type():
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor
    return DTensor


class FlopCounter(TorchDispatchMode):
    """Counts the operators run while it is active: ``dot_flops``,
    ``other_flops``, ``flops`` (their sum), ``hbm_bytes``,
    ``collective_bytes`` / ``collective_counts`` by kind, and ``ops``
    (calls per operator).  ``attn_causal_skip`` is the config's: above
    2048 query rows the reference's twin of flash attention skips the
    key blocks above the diagonal under it."""

    def __init__(self, attn_causal_skip=False):
        super().__init__()
        self.opts = {"attn_causal_skip": bool(attn_causal_skip)}
        self.dot_flops = 0.0
        self.other_flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes = {k: 0 for k in COLLECTIVE_KINDS}
        self.collective_counts = {k: 0 for k in COLLECTIVE_KINDS}
        self.ops = Counter()
        self._dtensor = _dtensor_type()
        self._fake_on_entry = None

    def __enter__(self):
        # DTensor's sharding propagation runs operators under a fake mode
        # of its own to learn output shapes; only the operators that run
        # under the mode active here (none, or the dry-run's) are the step's
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    @property
    def flops(self):
        return self.dot_flops + self.other_flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor is not None and any(
                issubclass(t, self._dtensor) for t in types):
            # DTensor first: its local operators and collectives come back
            # here on the shards
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is self._fake_on_entry:
            self.count(func, args, kwargs, out)
        return out

    def count(self, func, args, kwargs, out):
        """Add one operator call's FLOPs and bytes."""
        known = _KINDS.get(func)
        if known is None:
            known = _KINDS[func] = (_kind(func), str(func))
        kind, name = known
        self.ops[name] += 1
        if kind == "free":
            return
        if kind == "kernel":
            dot, other = COST_RULES[func](_positional(func, args, kwargs),
                                          self.opts)
            self.dot_flops += dot
            self.other_flops += other
            self.hbm_bytes += nbytes((args, kwargs)) + nbytes(out)
        elif kind == "product":
            dot, other = _product_flops(func.__name__.split(".")[0], args,
                                        out)
            self.dot_flops += dot
            self.other_flops += other
            self.hbm_bytes += nbytes((args, kwargs)) + nbytes(out)
        elif kind in COLLECTIVE_KINDS:
            self.collective_bytes[kind] += nbytes(out)
            self.collective_counts[kind] += 1
        else:
            self.other_flops += out.numel() if isinstance(
                out, torch.Tensor) else _numel(out)
            if kind == "materializing":
                self.hbm_bytes += nbytes((args, kwargs)) + nbytes(out)

    def summary(self) -> dict:
        return {"dot_flops": self.dot_flops, "other_flops": self.other_flops,
                "flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts)}


def count_fn(fn, *args, attn_causal_skip=False, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a ``FlopCounter``; returns the
    counter, its ``hbm_bytes`` plus one read of every input and one write
    of every output (the reference's I/O term), and ``fn``'s result is
    kept as ``.result``."""
    counter = FlopCounter(attn_causal_skip=attn_causal_skip)
    with counter:
        result = fn(*args, **kwargs)
    counter.hbm_bytes += nbytes((args, kwargs)) + nbytes(result)
    counter.result = result
    return counter
