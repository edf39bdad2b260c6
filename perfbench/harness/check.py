"""Whether what the timed path produced is right: the sampled requests'
logits against the plain reference, at the timed sizes.

For each sampled request the reference runs once over the same weights and
inputs (the monolithic forward; under the semantic plan its branches too),
in blocks of one request and layer by layer, after the window has closed
and the engine is gone.  The numbers, each the worst over the sample:

* ``logits_rel_err``: ||program - reference|| / ||reference|| over a
  request's whole (b, s, vocab) logits, of the plan's output and of the
  monolithic forward's;
* ``row_rel_err_max``: the same per position, the largest;
* ``route_faults`` (MoE models): tokens whose routing breaks its rule;
* ``router_rel_err`` (MoE models): the program's router logits against the
  reference's, per MoE call, the largest.

Under an MoE model the reference follows the program's routing: each MoE
call's chosen experts and kept (token, choice) pairs, taken from the
``moe_route`` calls of the timed path; bfloat16 and float32 pick other
experts at the router's near-ties, and the flips would swamp every other
difference.  The routing is then checked by itself, against the
program's own router logits (``route_faults``), and those logits, with the
hidden state that makes them, against the reference's own
(``router_rel_err``).  The limits file of a cell's configuration names the
numbers it compares and their limits.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.harness.flops import LAYER_PLAN
from perfbench.reference import decoder as ref


class Sample:
    """A reservoir of k finished requests, drawn from the seed: request i
    (counted from 0 in the window) replaces a kept one with probability
    k / (i + 1).  Kept logits, and for an MoE model each routing call's
    router logits, expert ids, gates and slots, are copied into buffers
    made at set-up, so the window allocates nothing for them; ``nbytes``
    is their size, which the run's memory peak leaves out.
    ``route_shape`` is (calls of the plan at most, calls of the monolithic
    forward, G, gs, E, k), or None without MoE layers."""

    def __init__(self, k: int, seed: int, shape, device, route_shape=None):
        self.k = k
        self.rng = np.random.default_rng([int(seed), 7])
        self.slots = [None] * k                  # (index, plan)
        f32 = torch.float32

        def calls(n):
            G, gs, E, kk = route_shape[2:]
            return [(torch.empty((G, gs, E), dtype=f32, device=device),
                     torch.empty((G, gs, kk), dtype=torch.int32,
                                 device=device),
                     torch.empty((G, gs, kk), dtype=f32, device=device),
                     torch.empty((G, gs, kk), dtype=torch.int32,
                                 device=device)) for _ in range(n)]
        self.buf = []
        for _ in range(k):
            b = {"plan": torch.empty(shape, dtype=f32, device=device),
                 "mono": torch.empty(shape, dtype=f32, device=device)}
            if route_shape is not None:
                b["plan_routes"] = calls(route_shape[0])
                b["mono_routes"] = calls(route_shape[1])
            self.buf.append(b)
        self.nbytes = sum(t.numel() * t.element_size()
                          for b in self.buf for v in b.values()
                          for t in ([v] if torch.is_tensor(v) else
                                    [x for call in v for x in call]))
        self.seen = 0

    def offer(self, index, plan, outs):
        """outs: the tap's (plan logits, monolithic logits, plan routing
        calls, monolithic routing calls)."""
        i = self.seen
        self.seen += 1
        j = i if i < self.k else int(self.rng.integers(i + 1))
        if j >= self.k:
            return
        b = self.buf[j]
        b["plan"].copy_(outs[0])
        b["mono"].copy_(outs[1])
        n = {}
        for key, calls in (("plan_routes", outs[2]), ("mono_routes", outs[3])):
            if key in b:
                for dst, src in zip(b[key], calls):
                    for d, s_ in zip(dst, src):
                        d.copy_(s_)
                n[key] = len(calls)
        self.slots[j] = (index, plan, n)

    def kept(self):
        """[(index, plan, buffers)] with each routing list cut to the calls
        its request made."""
        out = []
        for j, slot in enumerate(self.slots):
            if slot is None:
                continue
            index, plan, n = slot
            b = dict(self.buf[j])
            for key, count in n.items():
                b[key] = b[key][:count]
            out.append((index, plan, b))
        return out


def numbers(out, want):
    """The comparison numbers of one output against its reference."""
    diff = (out - want).reshape(-1, want.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    row_err = diff.norm(dim=1) / w.norm(dim=1).clamp(min=1e-30)
    return {"logits_rel_err": float(diff.norm() / w.norm()),
            "row_rel_err_max": float(row_err.max())}


def worst(readings):
    """Each number's largest reading."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def router_err(got, want):
    """The largest relative error ||got - want|| / ||want|| over pairs of
    router logits, one pair per MoE call; inf where the calls' counts or
    shapes differ."""
    if len(got) != len(want):
        return float("inf")
    worst_ = 0.0
    for g, w in zip(got, want):
        w = w.reshape(-1, w.shape[-1])
        g = g.reshape(-1, g.shape[-1]).to(w)
        if g.shape != w.shape:
            return float("inf")
        worst_ = max(worst_, float((g - w).norm() / w.norm()))
    return worst_


def route_faults(calls, config):
    """How many tokens of the program's routing calls break the rule: the
    chosen experts distinct and a top-k set of the softmax of its own
    router logits (to 1e-6 of a probability: the kernel's exp and the
    reference's round differently), gates within 1e-5 of the chosen
    probabilities over their sum, slots equal to the first-come count."""
    sh = ref.Shape(config)
    bad = 0
    for logits, eid, gate, slot in calls:
        G, gs, E = logits.shape
        probs = torch.softmax(logits.reshape(-1, E), dim=-1)
        e = eid.reshape(-1, sh.top_k).long()
        chosen = probs.gather(-1, e)
        rest = probs.scatter(-1, e, float("-inf")).max(-1).values
        distinct = (e.sort(-1).values.diff(dim=-1) != 0).all(-1)
        top = chosen.min(-1).values >= rest - 1e-6
        want = chosen / chosen.sum(-1, keepdim=True).clamp(min=1e-9)
        gates_ok = ((gate.reshape(-1, sh.top_k) - want).abs()
                    <= 1e-5 * want.abs().clamp(min=1e-3)).all(-1)
        slots_ok = (ref.first_come_slots(e, gs, E)
                    == slot.reshape(-1, sh.top_k).long()).all(-1)
        bad += int((~(distinct & top & gates_ok & slots_ok)).sum())
    return bad


def forced(calls, config):
    """The reference's forced routing from routing calls: (eid, keep) per
    call, keep by the reference's own capacity rule."""
    sh = ref.Shape(config)
    out = []
    for _, eid, _, slot in calls:
        G, gs, _ = eid.shape
        out.append((eid.reshape(-1, sh.top_k),
                    slot.reshape(-1, sh.top_k) < ref.capacity(sh, gs)))
    return out


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return len(a) == len(b) and all(
        torch.equal(x, y) for pa, pb in zip(a, b) for x, y in zip(pa, pb))


def reference_outputs(config, weights, batch, plan, branches,
                      precision="f32", routes=(None, None), record=None,
                      router=None):
    """(reference of the plan's output, reference of the monolithic
    forward); ``routes`` = (the plan's, the monolithic forward's) forced
    routing or None; ``record`` = two lists that receive the routing,
    ``router`` = two lists that receive the router logits."""
    rec = record or (None, None)
    rlog = router or (None, None)
    full = ref.forward(config, weights, batch, precision, routes[1], rec[1],
                       rlog[1])
    if plan == LAYER_PLAN and _same(routes[0], routes[1]):
        for lists in (record, router):
            if lists is not None:
                lists[0].extend(lists[1])
        return full, full
    if plan == LAYER_PLAN:
        return ref.forward(config, weights, batch, precision, routes[0],
                           rec[0], rlog[0]), full
    return ref.branch_forward(config, weights, batch, branches, precision,
                              routes[0], rec[0], rlog[0]), full


def judge(config, weights, traffic, kept, branches, device, control=False):
    """Per sampled request the numbers of the plan's and the monolithic
    output against the reference (under an MoE model the reference follows
    the program's routing, ``route_faults`` checks that routing and
    ``router_rel_err`` the router logits it came from);
    returns (worst numbers, per-request readings).  With ``control`` each
    reading also holds ``control``: the numbers of the reference computed
    in fp8, put in the program's place (the float32 reference then follows
    the fp8 routing)."""
    moe = bool(config.get("num_experts"))
    readings = []
    for index, plan, b in kept:
        batch = traffic.tensors(index, device)
        routes, logs = (None, None), None
        r = {}
        if moe:
            calls = b["plan_routes"] + b["mono_routes"]
            routes = (forced(b["plan_routes"], config),
                      forced(b["mono_routes"], config))
            r["route_faults"] = route_faults(calls, config)
            logs = ([], [])
        want = reference_outputs(config, weights, batch, plan, branches,
                                 routes=routes, router=logs)
        r.update(worst([numbers(b["plan"], want[0]),
                        numbers(b["mono"], want[1])]))
        if moe:
            r["router_rel_err"] = router_err([c[0] for c in calls],
                                             logs[0] + logs[1])
        del want, logs
        if control:
            rec = ([], []) if moe else None
            low_logs, want_logs = (([], []), ([], [])) if moe \
                else (None, None)
            low = reference_outputs(config, weights, batch, plan, branches,
                                    "fp8", record=rec, router=low_logs)
            want = reference_outputs(config, weights, batch, plan, branches,
                                     routes=rec or (None, None),
                                     router=want_logs)
            r["control"] = worst([numbers(low[0], want[0]),
                                  numbers(low[1], want[1])])
            if moe:
                r["control"]["route_faults"] = 0
                r["control"]["router_rel_err"] = router_err(
                    low_logs[0] + low_logs[1], want_logs[0] + want_logs[1])
            del low, want, low_logs, want_logs
        r.update(index=index, plan=plan)
        readings.append(r)
    nums = worst([{k: v for k, v in r.items()
                   if k not in ("index", "plan", "control")}
                  for r in readings])
    return nums, readings


def compare(nums, limits):
    """{name: {"value", "limit"}} of the limits file's numbers and whether
    every one is within its limit."""
    out, ok = {}, True
    for name, limit in limits["numbers"].items():
        v = nums.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return out, ok
