"""Interval stages over the fixed-capacity slot tensors, batched over G.

The port of ``repro.env.jaxsim.kernels``; every tensor carries a leading
grid axis G where the reference relied on ``vmap``:

  * ``admit``        — scatter this interval's (padded) arrivals into free
                       task slots;
  * ``bestfit_requests`` / ``apply_requests`` / ``place`` — greedy BestFit
                       requests for unplaced fragments and the RAM
                       feasibility repair, both sequential scans in
                       admission order (``repro_torch.kernels.placement``);
  * ``run_substeps`` — the substep physics
                       (``repro_torch.kernels.edge_substep``);
  * ``select_variant`` / ``mab_decide_arrivals`` / ``mab_feedback`` — the
                       MAB deploy loop's decide and feedback stages;
                       ``mab_decide_arrivals_train`` the ε-greedy decide
                       of the train loop;
  * ``gillis_decide_arrivals`` / ``gillis_feedback`` — the Gillis
                       baseline's decide and TD(0) feedback;
  * ``state_features_k`` / ``daso_requests`` — the DASO placement stage:
                       per-worker features, then the surrogate ascent over
                       the first ``max_containers`` live fragments
                       (``repro_torch.core.daso.optimize_placement_grid``);
                       ``daso_requests_train`` the train loop's gated form.

Every stage here is vectorized over the grid; the three sequential or
fused pieces (the two placement scans and the substep physics) are CUDA
kernels on a CUDA grid and eager twins on a CPU grid.  Each cell's scan
stops at its own trip count (``n_new`` fragments to place, or
``n_alive`` slots to repair), so every cell sees exactly its own greedy
sequence.

JAX semantics kept where PyTorch's defaults differ: argsorts are stable
(dead slots all share the sequence number ``SEQ_DEAD``), argmax takes the
first maximum, ``searchsorted`` is left-sided, and a scatter to the
out-of-range slot K is dropped by masking.  ``seq`` and ``dropped`` are
int64.
"""
from __future__ import annotations

import torch

from repro_torch.core import daso as daso_mod
from repro_torch.core import mab as mab_mod
from repro_torch.env.cluster import NIC_CAP_MB
from repro_torch.kernels import placement
from repro_torch.kernels.edge_substep import edge_substep

SEQ_DEAD = torch.iinfo(torch.int64).max

f8, i4, i8 = torch.float64, torch.int32, torch.int64


def init_state(G: int, K: int, F: int, n: int, device) -> dict:
    """Empty slot store for G cells: all slots free, padding-done,
    worker −1."""
    def full(shape, value, dtype):
        return torch.full((G,) + shape, value, dtype=dtype, device=device)

    return {
        # per-fragment (G, K, F)
        "instr": full((K, F), 0.0, f8),
        "ram": full((K, F), 0.0, f8),
        "out_bytes": full((K, F), 0.0, f8),
        "worker": full((K, F), -1, i4),
        "done": full((K, F), True, torch.bool),
        "transfer": full((K, F), 0.0, f8),
        # per-task (G, K)
        "nfrag": full((K,), 0, i4),
        "chain": full((K,), False, torch.bool),
        "stage": full((K,), 0, i4),
        "placed": full((K,), False, torch.bool),
        "alive": full((K,), False, torch.bool),
        "task_done": full((K,), True, torch.bool),
        "sla": full((K,), 0.0, f8),
        "arrival_s": full((K,), 0.0, f8),
        "wait_s": full((K,), 0.0, f8),
        "acc": full((K,), 0.0, f8),
        "decision": full((K,), 0, i4),
        # learned-policy feedback channels (batch is 1.0 on dead slots so
        # norms never divide by zero)
        "app": full((K,), 0, i4),
        "batch": full((K,), 1.0, f8),
        "resp": full((K,), 0.0, f8),
        "seq": full((K,), SEQ_DEAD, i8),
        "seq_counter": full((), 0, i8),
        "dropped": full((), 0, i8),
    }


def admit(state: dict, arr: dict) -> dict:
    """Scatter the interval's arrival rows (G, A, ...) into free slots.

    Arrival *j* of a cell takes its *j*-th free slot (admission order is
    kept via ``seq``); arrivals beyond capacity are dropped and counted.
    """
    G, K, F = state["worker"].shape
    A = arr["valid"].shape[1]
    dev = state["worker"].device
    fcum = torch.cumsum((~state["alive"]).to(i8), dim=1)
    want = torch.arange(1, A + 1, device=dev).expand(G, A).contiguous()
    slots = torch.searchsorted(fcum, want, right=False)
    valid = arr["valid"]
    tgt = torch.where(valid & (slots < K), slots, K)
    s = dict(state)
    s["dropped"] = state["dropped"] + (valid & (tgt >= K)).sum(dim=1)
    # slot -> arrival row landing there (−1: none); column K collects the
    # dropped rows and is discarded
    src = torch.full((G, K + 1), -1, dtype=i8, device=dev)
    src.scatter_(1, tgt, torch.arange(A, device=dev).expand(G, A))
    src = src[:, :K]
    hit = src >= 0
    srcc = src.clamp(min=0)
    hit_f = hit[..., None]

    def pick(val):
        idx = srcc.reshape(G, K, *([1] * (val.dim() - 2))).expand(
            G, K, *val.shape[2:])
        return torch.gather(val, 1, idx)

    def put(name, val):
        h = hit.reshape(G, K, *([1] * (val.dim() - 2)))
        s[name] = torch.where(h, pick(val), state[name])

    fcols = torch.arange(F, dtype=i4, device=dev)
    put("instr", arr["instr"])
    put("ram", arr["ram"])
    put("out_bytes", arr["out_bytes"])
    s["worker"] = torch.where(hit_f, -1, state["worker"])
    put("done", fcols >= arr["nfrag"][..., None])
    s["transfer"] = torch.where(hit_f, 0.0, state["transfer"])
    put("nfrag", arr["nfrag"])
    put("chain", arr["chain"])
    s["stage"] = torch.where(hit, 0, state["stage"])
    s["placed"] = state["placed"] & ~hit
    s["alive"] = state["alive"] | hit
    s["task_done"] = state["task_done"] & ~hit
    put("sla", arr["sla"])
    put("arrival_s", arr["arrival_s"])
    s["wait_s"] = torch.where(hit, 0.0, state["wait_s"])
    put("acc", arr["acc"])
    put("decision", arr["decision"])
    put("app", arr["app"])
    put("batch", torch.clamp(arr["batch"].to(f8), min=1.0))
    s["resp"] = torch.where(hit, 0.0, state["resp"])
    s["seq"] = torch.where(hit, state["seq_counter"][:, None] + src,
                           state["seq"])
    s["seq_counter"] = state["seq_counter"] + valid.sum(dim=1)
    return s


def _admission_order(state: dict):
    """Per-cell slot indices sorted by admission sequence (dead last)."""
    key = torch.where(state["alive"], state["seq"], SEQ_DEAD)
    return torch.argsort(key, dim=1, stable=True)


def _ram_census(mask, wsafe, ram_task, n):
    """Per-worker (fragment count, RAM) of a (G, K, F) fragment mask; the
    RAM is ``ram_task @ cnt`` with exact integer counts ``cnt`` (G, K, n)
    (fragments of one task share one footprint)."""
    onehot = wsafe[..., None] == torch.arange(n, device=wsafe.device)
    cnt = (mask[..., None] & onehot).sum(dim=2).to(f8)          # (G, K, n)
    return cnt.sum(dim=1), torch.einsum("gk,gkn->gn", ram_task, cnt)


def bestfit_operands(state: dict, cl: dict) -> tuple:
    """The operands of ``placement.bestfit_scan`` for the whole grid: the
    flat (slot·F + f) indices of the fragments needing a worker in
    admission order (the first ``n_new`` of each row are real), the RAM
    tensor, the per-worker free RAM / load / score after the live-fragment
    census, the static score term, the capacities and the current
    workers."""
    G, K, F = state["worker"].shape
    n = cl["ram"].shape[0]
    dev = state["worker"].device
    cap, mips = cl["ram"], cl["mips"]
    worker, done, ram = state["worker"], state["done"], state["ram"]
    wsafe = worker.clamp(0, n - 1).long()
    live = (~done) & (worker >= 0)
    load0, ram_used0 = _ram_census(live, wsafe, ram[..., 0], n)
    static = 0.3 * mips / mips.max()
    order = _admission_order(state)
    new_mask = (~done) & (worker < 0)
    flat_ord = torch.gather(new_mask, 1,
                            order[..., None].expand(G, K, F)).reshape(G, K * F)
    ncum = torch.cumsum(flat_ord.to(i8), dim=1)
    want = torch.arange(1, K * F + 1, device=dev).expand(G, K * F)
    pos = torch.searchsorted(ncum, want.contiguous(),
                             right=False).clamp(max=K * F - 1)
    flat_pos = torch.gather(order, 1, pos // F) * F + pos % F
    score0 = -load0 + static + 0.1 * (cap - ram_used0) / cap
    return (flat_pos.contiguous(), ncum[:, -1].contiguous(), ram.contiguous(),
            cap - ram_used0, load0, score0, static, cap, worker.contiguous())


def bestfit_requests(state: dict, cl: dict):
    """Greedy BestFit worker requests for unplaced fragments (admission
    order); already-placed fragments keep their current worker."""
    return placement.bestfit_scan(*bestfit_operands(state, cl))


def repair_operands(state: dict, cl: dict, req) -> tuple:
    """The operands of ``placement.repair_scan`` for the whole grid.  A
    cell whose requests all fit their workers outright (the repair is then
    the identity) gets a trip count of 0; any other cell walks all its
    live slots in admission order."""
    F = state["worker"].shape[2]
    n = cl["ram"].shape[0]
    cap = cl["ram"]
    worker, done, ram = state["worker"], state["done"], state["ram"]
    alive, chain, stage = state["alive"], state["chain"], state["stage"]
    fidx = torch.arange(F, dtype=i4, device=req.device)
    live_und = ~done
    holds_f = torch.where(chain[..., None], fidx == stage[..., None], True)
    _, demand = _ram_census(live_und & holds_f, req.clamp(0, n - 1).long(),
                            ram[..., 0], n)
    feasible = (demand <= cap).all(dim=1)
    trip = torch.where(feasible, 0, alive.sum(dim=1))
    return (_admission_order(state), trip, alive, done, chain, stage,
            req.contiguous(), ram, cap, torch.where(live_und, req, worker),
            state["placed"] | alive)


def apply_requests(state: dict, cl: dict, req):
    """RAM feasibility repair of a (G, K, F) worker-request tensor."""
    worker2, placed = placement.repair_scan(*repair_operands(state, cl, req))
    s = dict(state)
    s["worker"] = worker2
    s["placed"] = placed
    return s


def place(state: dict, cl: dict) -> dict:
    """BestFit targets for unplaced fragments, then the feasibility
    repair."""
    return apply_requests(state, cl, bestfit_requests(state, cl))


def run_substeps(state: dict, acc: dict, bw_mult, cl: dict, *, substeps: int,
                 dt: float, swap_slowdown: float):
    """One interval of substep physics for every cell; returns
    (state, acc, busy).  The kernel runs on a CUDA grid, its twin on a CPU
    grid (``repro_torch.kernels.edge_substep``)."""
    (instr, done, transfer, stage, task_done, resp, now, metrics, busy,
     pwt_delta) = edge_substep(
        state["instr"], state["done"], state["transfer"], state["stage"],
        state["task_done"], state["resp"], acc["now"][:, None],
        acc["metrics"], state["worker"], state["ram"][..., 0].contiguous(),
        state["out_bytes"], state["nfrag"], state["chain"], state["placed"],
        state["sla"], state["arrival_s"], state["acc"], state["wait_s"],
        state["decision"], bw_mult.contiguous(), cl["mips"], cl["ram"],
        cl["net_bw"], substeps=substeps, dt=dt,
        swap_slowdown=swap_slowdown, nic_cap=NIC_CAP_MB)
    s = dict(state)
    s.update(instr=instr, done=done, transfer=transfer, stage=stage,
             task_done=task_done, resp=resp)
    a = dict(acc)
    a.update(now=now[:, 0], pwt=acc["pwt"] + pwt_delta, metrics=metrics)
    return s, a, busy


# -------------------------------------------------- learned-policy stages


def select_variant(shared: dict, var: dict, decision, arm_decisions=(0, 1)):
    """Realize split decisions (G, A) against one interval's dual-trace
    rows (variant axis V=2); returns the one-variant ``arr`` dict
    ``admit`` consumes.  ``arm_decisions`` maps the arm index to the
    decision code recorded on the task."""
    d = decision.long()

    def pick(x):
        if x.dim() == 3:                                  # (G, A, V)
            return torch.gather(x, 2, d[..., None])[..., 0]
        idx = d[..., None, None].expand(*d.shape, 1, x.shape[3])
        return torch.gather(x, 2, idx)[:, :, 0]           # (G, A, V, F)

    codes = torch.tensor(arm_decisions, dtype=i4, device=d.device)
    return {"valid": shared["valid"], "sla": shared["sla"],
            "arrival_s": shared["arrival_s"], "app": shared["app"],
            "batch": shared["batch"], "acc": pick(var["vacc"]),
            "chain": pick(var["vchain"]), "nfrag": pick(var["vnfrag"]),
            "instr": pick(var["vinstr"]), "ram": pick(var["vram"]),
            "out_bytes": pick(var["vout"]), "decision": codes[d]}


def _norm_f32(x, batch):
    """Batch-normalized deadline/response as the host decider computes it
    (float64 math, float32 cast)."""
    return (x * 40000.0 / batch).to(torch.float32)


def mab_decide_arrivals(mab_state, shared: dict, ucb_c: float):
    """UCB deployment decisions (eq. 9) for one interval's (G, A) arrival
    rows; padding rows get a harmless decision ``admit`` masks out."""
    sla_n = _norm_f32(shared["sla"], torch.clamp(shared["batch"].to(f8),
                                                 min=1.0))
    d, _ = mab_mod.decide_ucb_batch(mab_state, sla_n, shared["app"], ucb_c)
    return d


def mab_decide_arrivals_train(mab_state, shared: dict, key, t: int):
    """ε-greedy training decisions (eq. 6) for one interval's (G, A)
    arrival rows against each cell's state, with the per-row draws of
    ``mab.decide_train_rows`` from each cell's trace key (G, 2) and the
    interval ``t``.  SLAs are normalized as in ``mab_decide_arrivals``."""
    sla_n = _norm_f32(shared["sla"], torch.clamp(shared["batch"].to(f8),
                                                 min=1.0))
    d, _ = mab_mod.decide_train_rows(mab_state, key, t, sla_n, shared["app"])
    return d


def gillis_decide_arrivals(Q, eps, shared: dict, key, t: int, layer_ref):
    """Gillis ε-greedy arm decisions (layer vs compressed) for one
    interval's (G, A) arrival rows against each cell's Q-table and ε; the
    context buckets come from the raw SLA and batch (no normalization)."""
    arms, _ = mab_mod.gillis_decide_rows(
        Q, eps, key, t, shared["sla"], shared["batch"].to(f8),
        shared["app"], layer_ref)
    return arms


def gillis_feedback(Q, state: dict, fin, layer_ref, lr: float):
    """End-of-interval Gillis Q-updates over the slots that finished, in
    admission (``seq``) order: each slot's bucket recomputed from its
    stored SLA/batch/app, arm 0 for the layer split, reward ((resp <= sla)
    + acc) / 2, then ``mab.gillis_update_masked``."""
    ordr = torch.argsort(torch.where(fin, state["seq"], SEQ_DEAD), dim=1,
                         stable=True)

    def by_seq(x):
        return torch.gather(x, 1, ordr)

    bucket = mab_mod.gillis_bucket(state["sla"], state["batch"],
                                   state["app"], layer_ref)
    arm = (state["decision"] != 0).to(i4)
    reward = ((state["resp"] <= state["sla"]).to(f8) + state["acc"]) / 2.0
    return mab_mod.gillis_update_masked(
        Q, by_seq(state["app"]), by_seq(bucket), by_seq(arm),
        by_seq(reward), by_seq(fin), lr)


def mab_feedback(mab_state, state: dict, fin, phi: float, gamma: float,
                 k: float):
    """End-of-interval MAB bookkeeping over the slots that finished, fed
    in admission (``seq``) order."""
    ordr = torch.argsort(torch.where(fin, state["seq"], SEQ_DEAD), dim=1,
                         stable=True)
    batch = state["batch"]               # >= 1 by construction

    def by_seq(x):
        return torch.gather(x, 1, ordr)

    return mab_mod.end_of_interval_masked(
        mab_state, by_seq(state["app"]),
        by_seq(_norm_f32(state["sla"], batch)),
        by_seq(_norm_f32(state["resp"], batch)),
        by_seq(state["acc"].to(torch.float32)),
        by_seq(state["decision"].clamp(0, 1)), by_seq(fin), phi, gamma, k)


# ------------------------------------------------------ DASO placement stage


def state_features_k(state: dict, cl: dict, lat_mult, interval_s: float):
    """(G, n, 4) worker utilization features (cpu load, ram load, net
    quality, placed count), computed post-admit so new fragments (worker
    −1) are left out.  The censuses are float64 one-hot products (G,
    3, K·F) × (G, K·F, n), which sum in a fixed order on every run.
    ``lat_mult`` is this interval's (G, n) latency multipliers."""
    G, K, F = state["worker"].shape
    n = cl["mips"].shape[0]
    worker, done = state["worker"], state["done"]
    wsafe = worker.clamp(0, n - 1).long()
    live = (~done) & (worker >= 0)
    mips_f = torch.clamp(cl["mips"][wsafe], min=1)
    cpu_v = torch.where(live, state["instr"] / mips_f / interval_s, 0.0)
    is_stage = torch.arange(F, dtype=i4, device=worker.device) \
        == state["stage"][..., None]
    holds = live & ((~state["chain"][..., None]) | is_stage)
    ram_v = torch.where(holds, state["ram"] / cl["ram"][wsafe], 0.0)
    stacked = torch.stack([cpu_v, ram_v, live.to(f8)], dim=1)
    onehot = (wsafe[..., None] == torch.arange(n, device=worker.device)
              ).to(f8)
    sums = torch.bmm(stacked.reshape(G, 3, K * F),
                     onehot.reshape(G, K * F, n))
    cpu, ram_load, cnt = sums[:, 0], sums[:, 1], sums[:, 2]
    return torch.stack([torch.clamp(cpu, 0, 4) / 4.0,
                        torch.clamp(ram_load, 0, 2) / 2.0,
                        1.0 / lat_mult,
                        torch.clamp(cnt, 0, 8) / 8.0], dim=-1)


def _daso_rows(cfg, state: dict, req):
    """Container rows of the DASO stage, (G, C) each: the first
    ``cfg.max_containers`` live fragments in admission order (slot, column),
    whether the row holds one, its warm-start worker (its entry of ``req``:
    the current worker or the BestFit target) and its split decision
    clipped to {0, 1}."""
    G, K, F = state["worker"].shape
    n, C = cfg.num_workers, cfg.max_containers
    dev = req.device
    order = _admission_order(state)
    live = ~state["done"]
    flat_ord = torch.gather(live, 1,
                            order[..., None].expand(G, K, F)).reshape(G, K * F)
    ncum = torch.cumsum(flat_ord.to(i8), dim=1)
    want = torch.arange(1, C + 1, device=dev).expand(G, C).contiguous()
    pos = torch.searchsorted(ncum, want, right=False).clamp(max=K * F - 1)
    slot_i = torch.gather(order, 1, pos // F)
    f_i = pos % F
    rowvalid = torch.arange(C, device=dev) < ncum[:, -1:]
    warm = torch.gather(req.reshape(G, K * F), 1,
                        slot_i * F + f_i).clamp(0, n - 1)
    dec = torch.gather(state["decision"], 1, slot_i).clamp(0, 1)
    dec_i = torch.where(rowvalid, dec, 0)
    return slot_i, f_i, rowvalid, warm, dec_i


def daso_requests(cfg, theta, state: dict, feat, req):
    """The DASO placement stage (§5.3, eqs. 10–12) for every cell: the
    first ``cfg.max_containers`` live fragments become logit rows warm
    started from ``req``, the surrogate ``theta`` is ascended
    (``daso.optimize_placement_grid``, in ``feat``'s dtype), and each row's
    argmax worker is written back into the request tensor.  Fragments past
    the container budget keep their BestFit request, and
    ``apply_requests`` repairs the result."""
    slot_i, f_i, rowvalid, warm, dec_i = _daso_rows(cfg, state, req)
    logits = daso_mod.warm_start_logits(cfg, warm, rowvalid, feat.dtype)
    p_opt, _, _ = daso_mod.optimize_placement_grid(cfg, theta, feat, logits,
                                                   dec_i, rowvalid)
    return _write_rows(req, slot_i, f_i, rowvalid, p_opt)


def _write_rows(req, slot_i, f_i, rowvalid, logits):
    """``req`` with each valid container row's fragment set to the argmax
    worker of its logits."""
    G, K, F = req.shape
    assign = torch.argmax(logits, dim=-1).to(req.dtype)
    # rows past the live fragments write to the extra column K·F, which is
    # cut off
    tgt = torch.where(rowvalid, slot_i * F + f_i, K * F)
    out = torch.cat([req.reshape(G, K * F),
                     req.new_zeros((G, 1))], dim=1)
    out.scatter_(1, tgt, assign)
    return out[:, :K * F].reshape(G, K, F)


def daso_requests_train(cfg, theta, state: dict, feat, req, use_opt: bool):
    """The train loop's DASO stage: the rows of ``daso_requests``, ascended
    from their warm start when ``use_opt`` (a host-side gate: the interval
    index has reached ``place_min``), else the warm logits as they are;
    each valid row's argmax is written back into the request tensor.
    ``theta`` is the carried per-cell float32 θ; the ascent casts it to
    ``feat``'s dtype (float64).  Returns (requests, x) with x (G,
    feature_size) the packed surrogate input of the logits used."""
    slot_i, f_i, rowvalid, warm, dec_i = _daso_rows(cfg, state, req)
    p = daso_mod.warm_start_logits(cfg, warm, rowvalid, feat.dtype)
    if use_opt:
        p, _, _ = daso_mod.optimize_placement_grid(cfg, theta, feat, p,
                                                   dec_i, rowvalid)
    x = daso_mod.pack_input_grid(cfg, feat, p, dec_i, rowvalid)
    return _write_rows(req, slot_i, f_i, rowvalid, p), x
