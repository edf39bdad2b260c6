"""The plain reference against the port, both in float32 on the CPU, at a
tiny cut of each configuration: the monolithic forward, the layer-split
pipeline and the semantic branches."""
import pytest
import torch

from perfbench.harness import check as chk
from perfbench.harness.program import RouteTap, port_config
from perfbench.harness.traffic import Traffic
from perfbench.harness.weights import make_weights
from perfbench.reference import decoder as ref
from perfbench.tests.tiny import tiny_cell


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


@pytest.mark.parametrize("cell,groups", [("moe-serve-loose", 1),
                                         ("moe-serve-loose", 4),
                                         ("vl-serve-tight", 1)])
@pytest.mark.parametrize("plan", ["forward", "pipeline", "branch"])
def test_reference_matches_port_in_float32(cell, groups, plan):
    """``groups``: MoE dispatch groups per call (the capacity is per
    group)."""
    from repro_torch.serving import plans
    c = tiny_cell(cell)
    cfg, mix = c.config, c.traffic
    if groups > 1:
        cfg["moe_group_size"] = mix["batch"] * mix["seq"] // groups
    gen = torch.Generator().manual_seed(3)
    weights = _f32(make_weights(cfg, gen, "cpu"))
    pcfg = port_config(dict(cfg, torch_dtype="float32"))
    batch = Traffic(mix, cfg, 3, gen, "cpu").tensors(5, "cpu")
    moe = bool(cfg.get("num_experts"))
    tap = RouteTap() if moe else None
    try:
        with torch.no_grad():
            if plan == "forward":
                got = plans.M.forward(weights, batch, pcfg)
            elif plan == "pipeline":
                got = plans.pipeline_forward(weights, batch, pcfg, 2)
            else:
                got = plans.branch_forward(weights, batch, pcfg, 2)
        calls = tap.calls if moe else []
    finally:
        if moe:
            tap.close()
    routes = chk.forced(calls, cfg) if moe else None
    if plan == "branch":
        want = ref.branch_forward(cfg, weights, batch, 2, routes=routes)
    else:
        want = ref.forward(cfg, weights, batch, routes=routes)
    assert chk.route_faults(calls, cfg) == 0
    err = float((got - want).norm() / want.norm())
    assert err < 1e-5, err
    if moe:
        # the reference's own routing picks the same experts in float32
        own = []
        (ref.branch_forward(cfg, weights, batch, 2, record=own)
         if plan == "branch" else ref.forward(cfg, weights, batch,
                                              record=own))
        for (e, keep), (fe, fkeep) in zip(own, routes):
            assert torch.equal(e, fe.long()) and torch.equal(keep, fkeep)
