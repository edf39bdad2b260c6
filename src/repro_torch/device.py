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
