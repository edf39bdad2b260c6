"""Device resolution shared by every entry point of the port.

Entry points default to ``device="cuda"``.  Only an explicit CPU device
runs on the CPU; asking for CUDA on a machine without a card raises
instead of falling back.
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on; raises when CUDA is
    asked for (the default) and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run the eager "
            "PyTorch path on the CPU")
    return dev


#: (card index, part) -> that part's CUDA stream, kept for the process
_PART_STREAMS = {}


def part_stream(dev, i: int):
    """The CUDA stream of part ``i`` (a pipeline stage, a grid part) on the
    card ``dev``, made once and kept: the caching allocator pools memory
    per stream, so a fresh stream per call would allocate the part's
    tensors anew on every call."""
    dev = torch.device(dev)
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    key = (index, i)
    if key not in _PART_STREAMS:
        _PART_STREAMS[key] = torch.cuda.Stream(device=index)
    return _PART_STREAMS[key]
