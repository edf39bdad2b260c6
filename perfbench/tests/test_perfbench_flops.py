"""The benchmark's own FLOP and byte arithmetic against the program's
counter (``launch/flopcount.FlopCounter``) at a tiny cut, on the CPU.

The counter counts what the program runs; the benchmark counts what the
model needs.  Their products differ by named terms only: causal attention
(the counter's rule counts every (query, key) pair, the benchmark the
s (s + 1) / 2 kept ones) and the MoE's weighted combine of the k expert
outputs (a batched product to the counter, a weighted sum to the
benchmark).  At capacity factor 1 with gs * k / E whole, the experts'
buffers hold exactly the routed (token, choice) pairs."""
import pytest
import torch

from perfbench.harness.flops import forward_flops
from perfbench.harness.program import port_config
from perfbench.harness.traffic import Traffic
from perfbench.harness.weights import make_weights
from perfbench.reference.decoder import Shape
from perfbench.roofline import flash_attention, moe_route
from perfbench.tests.tiny import tiny_cell


def _cell(name):
    c = tiny_cell(name)
    if c.config.get("num_experts"):
        # 64 tokens x 2 choices / 8 experts = 16 slots each, none empty
        c.config["moe_capacity_factor"] = 1.0
    return c


@pytest.mark.parametrize("cell", ["moe-serve-loose", "vl-serve-loose"])
@pytest.mark.parametrize("kind", ["full", "branch"])
def test_forward_flops_match_the_counter(cell, kind):
    from repro_torch.launch.flopcount import FlopCounter
    from repro_torch.serving import plans
    c = _cell(cell)
    cfg, mix = c.config, c.traffic
    b, s = mix["batch"], mix["seq"]
    gen = torch.Generator().manual_seed(1)
    weights = make_weights(cfg, gen, "cpu")
    pcfg = port_config(cfg)
    batch = Traffic(mix, cfg, 1, gen, "cpu").tensors(0, "cpu")
    with torch.no_grad(), FlopCounter() as counter:
        if kind == "full":
            plans.M.forward(weights, batch, pcfg)
        else:
            plans.branch_forward(weights, batch, pcfg, 2)
    sh = Shape(cfg)
    mine = forward_flops(cfg, kind, 2, b, s) * (2 if kind == "branch" else 1)
    forwards = 2 if kind == "branch" else 1
    h = sh.heads // 2 if kind == "branch" else sh.heads
    full_pairs = s * s - s * (s + 1) / 2
    corrections = forwards * sh.layers * 4.0 * b * h * sh.hd * full_pairs
    if sh.experts:
        corrections += forwards * sh.layers * 2.0 * b * s * sh.top_k * sh.d
    assert counter.dot_flops == pytest.approx(mine + corrections, rel=1e-12)


def test_kernel_costs_match_the_counters_rules():
    from repro_torch.kernels.flash_attention import attention_cost
    for cell in ("moe-serve-loose", "vl-serve-tight"):
        cfg = _cell(cell).config
        for kind in ("full", "branch"):
            for c in flash_attention.calls(cfg, kind, 2, 4, 1024):
                flops, nbytes = flash_attention.cost(c)
                dot, _ = attention_cost(c["b"], c["s"], c["s"], c["h"],
                                        c["kvh"], c["hd"], True, 0)
                assert flops == dot * (c["s"] + 1) / (2 * c["s"])
                assert nbytes == 2 * c["b"] * c["s"] * c["hd"] * (
                    2 * c["h"] + 2 * c["kvh"])


def test_moe_route_bytes_match_the_counter():
    from repro_torch.kernels.moe_route import moe_route as route
    from repro_torch.launch.flopcount import FlopCounter
    cfg = _cell("moe-serve-loose").config
    (c,) = set(tuple(sorted(x.items()))
               for x in moe_route.calls(cfg, "full", 2, 2, 32))
    c = dict(c)
    logits = torch.randn(c["groups"], c["gs"], c["E"])
    with FlopCounter() as counter:
        route(logits, c["k"])
    assert counter.hbm_bytes == moe_route.cost(c)[1]
