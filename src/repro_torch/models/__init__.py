"""Decoder models of the port: attention, MoE, Mamba and RG-LRU blocks."""
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_params, prefill)

__all__ = ["init_params", "forward", "prefill", "init_cache", "decode_step"]
