"""Tiny cells for the CPU tests: each configuration file's model with its
sizes cut (the same keys and block kinds), and its cell's mix at 2 x 32
tokens."""
from __future__ import annotations

import copy

from perfbench.harness.spec import Cell

TINY = {"qwen2-moe-a2.7b": dict(hidden_size=64, num_hidden_layers=2,
                                num_attention_heads=4, num_key_value_heads=4,
                                intermediate_size=128,
                                moe_intermediate_size=32,
                                shared_expert_intermediate_size=64,
                                num_experts=8, num_experts_per_tok=2,
                                vocab_size=256),
        "qwen2-vl-7b": dict(hidden_size=64, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2,
                            intermediate_size=128, vocab_size=256,
                            rope_scaling={"type": "mrope",
                                          "mrope_section": [2, 3, 3]})}


def tiny_cell(name):
    """The cell ``name`` cut for the CPU: tiny widths, 2 x 32 tokens, a
    2 x 2 patch block, 2 warm-up requests, a sample of 2."""
    cell = Cell(name)
    cell.config = dict(copy.deepcopy(cell.config), **TINY[cell.config["name"]])
    cell.traffic = dict(cell.traffic, batch=2, seq=32, check_sample=2,
                        trace_requests=2, warmup_requests=2)
    if "visual_grid" in cell.traffic:
        cell.traffic.update(visual_grid=2, visual_pool=2)
    return cell
