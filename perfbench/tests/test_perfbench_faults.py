"""The check catches a broken timed path: a tiny cut of each cell runs
through the whole harness on the CPU (set-up, window, check) with the
serving path broken underneath, and ``correct`` comes out false; the same
run unbroken comes out true.  The faults a serving cell can have: half of
the batch left out (its rows the mean of the rest), an answer altered
where it is produced (one position's logits), and under MoE an expert
choice altered where the router produces it.  A cell on one chip has no
exchange between chips, and serving keeps no state that a step could
leave unchanged."""
import pytest

from perfbench.harness.main import run_cell
from perfbench.tests.tiny import tiny_cell

CELLS = ["moe-serve-loose", "vl-serve-loose", "vl-serve-tight"]


def _half_batch(out):
    out = out.clone()
    h = out.shape[0] // 2
    out[h:] = out[:h].mean(0)
    return out


def _one_answer(out):
    out = out.clone()
    out[0, 3] = out[0, 3].roll(1)
    return out


def _run(cell, fault=None):
    res, _ = run_cell(tiny_cell(cell), 11, 0.05, 0, "cpu", fault=fault)
    return res


@pytest.mark.parametrize("cell", CELLS)
def test_unbroken_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["compared"]


@pytest.mark.parametrize("fault", [_half_batch, _one_answer],
                         ids=["half_batch", "one_answer"])
@pytest.mark.parametrize("cell", ["moe-serve-loose", "vl-serve-tight"])
def test_broken_plan_is_not_correct(cell, fault):
    assert not _run(cell, fault)["correct"]


def test_altered_expert_choice_is_not_correct(monkeypatch):
    from repro_torch.models import moe
    original = moe.moe_route

    def altered(logits, k):
        eid, gate, slot = original(logits, k)
        eid = eid.clone()
        eid[..., 0, 0] = (eid[..., 0, 0] + 1) % logits.shape[-1]
        return eid, gate, slot
    monkeypatch.setattr(moe, "moe_route", altered)
    res = _run("moe-serve-loose")
    assert not res["correct"]
    assert res["compared"]["route_faults"]["value"] > 0


def test_altered_router_input_is_not_correct(monkeypatch):
    """A fault upstream of the routing: the router's logits scaled where
    they are made.  The routing follows them, so ``route_faults`` stays 0;
    ``router_rel_err`` holds them against the reference's."""
    from repro_torch.models import moe
    original = moe.router_logits
    monkeypatch.setattr(moe, "router_logits",
                        lambda p, x: original(p, x) * 1.5)
    res = _run("moe-serve-loose")
    assert not res["correct"]
    assert res["compared"]["route_faults"]["value"] == 0
    c = res["compared"]["router_rel_err"]
    assert c["value"] > c["limit"]
