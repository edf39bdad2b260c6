"""Per-row threefry draws of one interval: the CUDA kernel and its
dispatcher.

Replaces the reference's per-row ``jax.random`` calls (not a Pallas
kernel): ``repro.core.mab.decide_train_rows`` and ``gillis_decide_rows``
and the ``random+daso`` arm of ``repro.env.jaxsim.engines``, in JAX's
non-partitionable threefry mode.

``threefry_rows(key, t, rows, p=None, width=64)``: key (G, 2) int64 of
uint32 words, for cell g and row a ``k = fold_in(fold_in(key[g], t), a)``;
with ``p`` (G,) float64 the draws are (explore, coin), ``explore =
U_width(k1) < p[g]`` and ``coin = U_64(k2) < 0.5`` with ``(k1, k2) =
split(k)``; without ``p``, ``U_64(k) < 0.5``.  Outputs bool (G, rows).
A CUDA tensor launches the kernel (``csrc/threefry.cu``: one thread per
row, the 20 rounds in registers); a CPU tensor runs the eager twin
``ref.threefry_rows_ref``.  There is no fallback from one to the other.
``threefry_rows.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import LIBRARIES
from repro_torch.kernels.ref import threefry_rows_ref


def _check(key, t, rows, p, width):
    if key.dim() != 2 or key.shape[1] != 2 or key.dtype != torch.int64:
        raise ValueError(f"threefry_rows: key must be (G, 2) int64, got "
                         f"{tuple(key.shape)} {key.dtype}")
    if not 0 <= int(t) < 2 ** 32:
        raise ValueError(f"threefry_rows: t {t} is not a uint32")
    if rows < 0:
        raise ValueError(f"threefry_rows: rows {rows} < 0")
    if p is not None:
        if width not in (32, 64):
            raise ValueError(f"threefry_rows: width {width} is not 32 or 64")
        if tuple(p.shape) != (key.shape[0],) or p.dtype != torch.float64:
            raise ValueError(f"threefry_rows: p must be ({key.shape[0]},) "
                             f"float64, got {tuple(p.shape)} {p.dtype}")
        if p.device != key.device:
            raise ValueError("threefry_rows: key and p on different devices")


_LAUNCHER = []


def _launcher():
    """The library's C entry point, typed once per process."""
    if not _LAUNCHER:
        fn = LIBRARIES.get("threefry").threefry_rows_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint] \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        _LAUNCHER.append(fn)
    return _LAUNCHER[0]


def threefry_rows_cuda(key, t: int, rows: int, p=None, width: int = 64):
    """Launch the CUDA kernel on CUDA tensors; returns freshly allocated
    outputs."""
    _check(key, t, rows, p, width)
    key = key.contiguous()
    G = key.shape[0]
    coin = torch.empty((G, rows), dtype=torch.bool, device=key.device)
    explore = None if p is None else torch.empty_like(coin)
    if coin.numel():
        fn = _launcher()
        with torch.cuda.device(key.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(key.data_ptr(),
                    None if p is None else p.contiguous().data_ptr(),
                    int(t), G, rows, int(p is not None), width,
                    None if explore is None else explore.data_ptr(),
                    coin.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"threefry_rows kernel launch failed: CUDA "
                               f"error {rc}")
        threefry_rows.launches += 1
    return coin if p is None else (explore, coin)


def threefry_rows(key, t: int, rows: int, p=None, width: int = 64):
    """The draws: the CUDA kernel on CUDA tensors, the eager twin on CPU
    tensors."""
    if key.device.type == "cpu":
        _check(key, t, rows, p, width)
        return threefry_rows_ref(key, t, rows, p, width)
    if key.device.type != "cuda":
        raise ValueError(f"threefry_rows: unsupported device {key.device}")
    return threefry_rows_cuda(key, t, rows, p, width)


threefry_rows.launches = 0
