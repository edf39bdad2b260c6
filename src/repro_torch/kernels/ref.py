"""Eager PyTorch twins of the port's kernels.

``edge_substep_ref`` is the port of ``repro.kernels.ref.edge_substep_ref``
with the same formulas in the same order, batched over an optional
leading grid axis G.  It is the oracle of the hand-written CUDA kernel
(``repro_torch.kernels.edge_substep``) and the path a CPU tensor takes.
``attention_ref`` is the port of ``repro.kernels.ref.attention_ref``, the
oracle of ``repro_torch.kernels.flash_attention`` and its CPU path, with
the explicit positions of ``repro.models.attention.full_attention`` beside
the implicit ones;
``moe_route_ref``, ``selective_scan_ref`` (which also gives the final
state, as ``repro.models.ssm.selective_scan`` does) and ``rglru_scan_ref``
are the ports of the reference's oracles of the same names, the oracles and CPU
paths of ``repro_torch.kernels.moe_route``,
``repro_torch.kernels.selective_scan`` and ``repro_torch.kernels.rglru_scan``.
``threefry_rows_ref``, built on ``repro_torch.core.prng``, is the oracle
and CPU path of ``repro_torch.kernels.threefry``.

Out-of-range stage: the reference gathers each chain's active-stage
channels with ``take_along_axis``, and JAX's default gather *fills* an
out-of-range index (``stage == F`` happens once a chain ran off its
last column): NaN for the float channels, True for ``done``.  So such a
stage is not runnable, holds no RAM, moves no transfer and counts as
done.  ``torch.gather`` raises on such an index instead, so the twin
clamps the index and substitutes those fill semantics explicitly.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng

f8 = torch.float64

NEG_INF = -1e30


def attention_ref(q, k, v, causal=True, window=0, pos_q=None, pos_k=None,
                  return_lse=False):
    """q (b, sq, h, hd); k, v (b, sk, kvh, hd) -> (b, sq, h, hd) in q's
    dtype.  Fully materialized, float32 inside; query head ``kv*g + gi``
    reads kv head ``kv``; scores are scaled by ``hd**-0.5``; masked scores
    are ``-1e30``, so a row with no visible key averages every value.
    With ``return_lse`` it returns (out, lse): lse (b, h, sq) float32 the
    natural-log logsumexp of each row's scaled visible scores, +inf for a
    row that sees no key (the kernel's, and the backward's, flag).

    Positions are ``0..s-1`` on both sides (the causal mask top-left
    aligned when sq != sk), or the int32 ``pos_q`` (b, sq) and ``pos_k``
    (b, sk) given together: key j is visible to query i when
    ``(!causal || pos_q[i] >= pos_k[j]) && (window <= 0 ||
    pos_q[i] - pos_k[j] < window)``, the mask of the reference's
    ``models.attention.full_attention``."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * hd ** -0.5
    if (pos_q is None) != (pos_k is None):
        raise ValueError("attention_ref: give pos_q and pos_k together")
    mask = _attention_mask(b, sq, sk, causal, window, pos_q, pos_k, q.device)
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    o = o.reshape(b, sq, h, hd).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(mask.any(-1), torch.logsumexp(s, dim=-1),
                      float("inf"))
    return o, lse.expand(b, kvh, g, sq).reshape(b, h, sq)


def _attention_mask(b, sq, sk, causal, window, pos_q, pos_k, device):
    """The visibility mask of ``attention_ref``, broadcastable to (b, kvh,
    g, sq, sk)."""
    if pos_q is None:
        qp = torch.arange(sq, device=device)[:, None]
        kp = torch.arange(sk, device=device)[None, :]
    else:
        qp = pos_q.long()[:, None, None, :, None]
        kp = pos_k.long()[:, None, None, None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    return mask


def attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=0,
                      pos_q=None, pos_k=None):
    """The gradient of ``attention_ref`` for the output's gradient ``do``,
    as the backward kernel forms it, in float32: P = exp(S·scale - lse)
    from the forward's logsumexp (0 where masked), D = rowsum(dO∘o),
    dV = Pᵀ dO, dS = P∘(dO Vᵀ - D), dQ = scale·dS K, dK = scale·dSᵀ Q,
    dK and dV summed over the g query heads of each kv head.  A row with
    lse = +inf saw no key: its P is 1/sk on every key and its dS is 0 (the
    gradient of the uniform softmax over all-masked scores).  Returns (dq,
    dk, dv) in the dtypes of q, k and v."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    qg = q.reshape(b, sq, kvh, g, hd).float()
    dog = do.reshape(b, sq, kvh, g, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * scale
    mask = _attention_mask(b, sq, sk, causal, window, pos_q, pos_k, q.device)
    L = lse.reshape(b, kvh, g, sq)[..., None]
    uniform = torch.isinf(L)
    p = torch.where(mask, torch.exp(s - torch.where(uniform, 0.0, L)), 0.0)
    p = torch.where(uniform, 1.0 / max(sk, 1), p)
    D = (do.float() * o.float()).sum(-1).reshape(b, sq, kvh, g)
    D = D.permute(0, 2, 3, 1)[..., None]                    # (b,kvh,g,sq,1)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, vf)
    ds = torch.where(uniform, 0.0, p * (dp - D))
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * scale
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def moe_route_bwd_ref(logits, eid, g_gate):
    """The gradient of ``moe_route_ref``'s gates with respect to the
    logits, as the backward kernel forms it: per token, with p the float32
    softmax, v_j = p[eid_j] and sum = Σ v_j, g_v = (g_gate - Σ g_gate·gate)
    / sum (g_gate / 1e-9 where the clamp holds, sum < 1e-9), then
    g_logits = p∘(g_p - Σ_j g_v_j v_j), g_p = g_v at the picked experts
    and 0 elsewhere.  logits (..., E), eid and g_gate (..., k); returns
    float32 (..., E)."""
    probs = torch.softmax(logits.float(), dim=-1)
    v = torch.gather(probs, -1, eid.long())
    g_v = gate_norm_vjp(v, g_gate.float())
    g_p = torch.zeros_like(probs).scatter_(-1, eid.long(), g_v)
    return probs * (g_p - (g_v * v).sum(-1, keepdim=True))


def gate_norm_vjp(v, g, eps=1e-9):
    """The vjp of ``v / max(Σ v, eps)`` (over the last axis) at v for g:
    (g - Σ g·v/Σ) / Σ where Σ >= eps, else g / eps (the clamp's gradient
    as torch's ``clamp`` passes it)."""
    total = v.sum(-1, keepdim=True)
    free = total >= eps
    den = torch.where(free, total, eps)
    dot = torch.where(free, (g * (v / den)).sum(-1, keepdim=True), 0.0)
    return (g - dot) / den


def topk_distinct(probs, k):
    """(values, indices) of the k largest entries along the last axis,
    largest first, the lower index first among equal values: the order of
    ``lax.top_k``.  k rounds of ``argmax`` (documented to return the first
    maximum), each masking its pick to -inf, so the k experts are distinct
    even where probabilities underflow to 0 (``torch.topk`` does not
    document its order among ties)."""
    p = probs.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(p, dim=-1, keepdim=True)
        vals.append(torch.gather(probs, -1, i))
        idxs.append(i)
        p.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def moe_route_ref(logits, top_k):
    """softmax -> top-k -> first-come slot assignment.

    logits (S, E), or (G, gs, E) for G independent routings; returns
    (eid int32, gate float32, slot int32), each (S, k) or (G, gs, k).
    Probabilities are the float32 softmax; the k experts are the k largest
    probabilities, distinct, the lower index first on ties; gates are the
    picked probabilities over ``max(sum, 1e-9)``; ``slot`` counts the
    earlier entries of the same expert in flattened (token, choice) order,
    per group."""
    grouped = logits.dim() == 3
    lg = logits if grouped else logits[None]
    probs = torch.softmax(lg.float(), dim=-1)
    gates, eids = topk_distinct(probs, top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    G, S, E = lg.shape
    flat = torch.nn.functional.one_hot(eids.reshape(G, S * top_k), E)
    pos = torch.cumsum(flat, dim=1) - 1
    slots = torch.gather(pos, 2, eids.reshape(G, S * top_k, 1))
    out = (eids.to(torch.int32), gates,
           slots.reshape(G, S, top_k).to(torch.int32))
    return out if grouped else tuple(o[0] for o in out)


def selective_scan_ref(dA, dBx, C, final_state=False):
    """Sequential reference of h_t = dA_t h_{t-1} + dBx_t; y_t = <h_t, C_t>.

    dA, dBx (b, s, d_in, n) and C (b, s, n) of any float dtype; the state
    and y (b, s, d_in) are float32, h_0 = 0.  With ``final_state`` it
    returns (y, h_s), h_s (b, d_in, n) float32 the state after the last
    step (the decode cache of ``mamba_prefill``)."""
    b, s, d_in, n = dA.shape
    h = torch.zeros((b, d_in, n), dtype=torch.float32, device=dA.device)
    ys = []
    for t in range(s):
        h = dA[:, t].float() * h + dBx[:, t].float()
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t].float()))
    if ys:
        y = torch.stack(ys, dim=1)
    else:
        y = torch.zeros((b, 0, d_in), dtype=torch.float32, device=dA.device)
    return (y, h) if final_state else y


def selective_scan_bwd_ref(dA, dBx, C, gy):
    """The gradient of ``selective_scan_ref``'s y for gy (b, s, d_in)
    float32, as the backward kernel forms it: the states recomputed, then
    gh_t = C_t·gy_t + dA_{t+1}·gh_{t+1} walked down the sequence, g_dA_t =
    gh_t·h_{t-1}, g_dBx_t = gh_t and g_C_t = Σ_d gy_t[d]·h_t[d].  Returns
    (g_dA, g_dBx) in the inputs' dtype and g_C (b, s, n) float32."""
    b, s, d_in, n = dA.shape
    h = torch.zeros((b, d_in, n), dtype=torch.float32, device=dA.device)
    hs = []
    for t in range(s):
        hs.append(h)
        h = dA[:, t].float() * h + dBx[:, t].float()
    hs.append(h)
    gy = gy.float()
    g_dA = torch.empty(dA.shape, dtype=torch.float32, device=dA.device)
    g_dBx = torch.empty_like(g_dA)
    g_C = torch.empty((b, s, n), dtype=torch.float32, device=dA.device)
    carry = torch.zeros((b, d_in, n), dtype=torch.float32, device=dA.device)
    for t in range(s - 1, -1, -1):
        gh = C[:, t, None, :].float() * gy[:, t, :, None] + carry
        g_dBx[:, t] = gh
        g_dA[:, t] = gh * hs[t]
        g_C[:, t] = torch.einsum("bd,bdn->bn", gy[:, t], hs[t + 1])
        carry = dA[:, t].float() * gh
    return g_dA.to(dA.dtype), g_dBx.to(dBx.dtype), g_C


def rglru_scan_bwd_ref(a, h, gh_out):
    """The gradient of ``rglru_scan_ref`` for gh_out (b, s, w) float32,
    as the backward kernel forms it from the forward's output h: gh_t =
    gh_out_t + a_{t+1}·gh_{t+1} walked down the sequence, g_a_t =
    gh_t·h_{t-1} (h_0 = 0) and g_bx_t = gh_t, each in a's dtype."""
    b, s, w = a.shape
    g_a = torch.empty((b, s, w), dtype=torch.float32, device=a.device)
    g_bx = torch.empty_like(g_a)
    carry = torch.zeros((b, w), dtype=torch.float32, device=a.device)
    for t in range(s - 1, -1, -1):
        gh = gh_out[:, t].float() + carry
        g_bx[:, t] = gh
        g_a[:, t] = gh * (h[:, t - 1] if t > 0 else 0.0)
        carry = a[:, t].float() * gh
    return g_a.to(a.dtype), g_bx.to(a.dtype)


def rglru_scan_ref(a, bx):
    """Sequential reference of h_t = a_t h_{t-1} + bx_t (elementwise),
    h_0 = 0.  a, bx (b, s, w) of any float dtype; h (b, s, w) float32.
    Each step is a product, then a sum, in float32."""
    b, s, w = a.shape
    h = torch.zeros((b, w), dtype=torch.float32, device=a.device)
    out = torch.empty((b, s, w), dtype=torch.float32, device=a.device)
    for t in range(s):
        h = a[:, t].float() * h + bx[:, t].float()
        out[:, t] = h
    return out


def threefry_rows_ref(key, t: int, rows: int, p=None, width: int = 64):
    """The per-row draws of one interval, with JAX's threefry bits: for
    cell g and row a, ``k = fold_in(fold_in(key[g], t), a)``; with ``p``
    (G,) float64, ``(k1, k2) = split(k)`` and the result is (explore,
    coin) with ``explore = U_width(k1) < p[g]`` and ``coin = U_64(k2) <
    0.5``; without ``p`` it is ``U_64(k) < 0.5``.  key (G, 2) int64 words;
    outputs bool (G, rows)."""
    kt = prng.fold_in(key, t)
    a = torch.arange(rows, dtype=torch.int64, device=key.device)
    k = prng.fold_in(kt[:, None, :], a[None, :])
    if p is None:
        return prng.bernoulli(k, 0.5, 64)
    k1, k2 = prng.split(k)
    return prng.bernoulli(k1, p[:, None], width), prng.bernoulli(k2, 0.5, 64)


#: operand order of the fused physics (carries first, then the
#: interval-static per-task/per-fragment channels, then cluster rows)
CARRY_NAMES = ("instr", "done", "transfer", "stage", "task_done", "resp",
               "now", "metrics")
STATIC_NAMES = ("worker", "ram_task", "out_bytes", "nfrag", "chain",
                "placed", "sla", "arrival", "acc_t", "wait_s", "decision",
                "bw_mult", "mips", "cap", "net_bw")
OUT_NAMES = CARRY_NAMES + ("busy", "pwt_delta")

#: the cluster rows shared by every grid cell (never batched)
SHARED_NAMES = ("mips", "cap", "net_bw")


def _take(x, idx):
    """x (G, K, F) at per-task column idx (G, K) -> (G, K)."""
    return torch.gather(x, 2, idx[..., None])[..., 0]


def edge_substep_ref(instr, done, transfer, stage, task_done, resp, now,
                     metrics, worker, ram_task, out_bytes, nfrag, chain,
                     placed, sla, arrival, acc_t, wait_s, decision,
                     bw_mult, mips, cap, net_bw, *, substeps, dt,
                     swap_slowdown, nic_cap):
    """One scheduling interval of SplitPlace substep physics.

    Shapes without a grid axis: (K, F) ``instr``/``done``/``transfer``/
    ``worker``/``out_bytes``; (K,) per-task channels; (1,) ``now``; (9,)
    ``metrics``; (n,) cluster rows.  With a grid axis every operand
    except ``mips``/``cap``/``net_bw`` gains a leading G.  Returns the
    ``OUT_NAMES`` tuple: updated carries plus per-worker busy seconds
    and the interval's per-worker completion census.
    """
    batched = instr.dim() == 3
    if not batched:
        args = [instr, done, transfer, stage, task_done, resp, now, metrics,
                worker, ram_task, out_bytes, nfrag, chain, placed, sla,
                arrival, acc_t, wait_s, decision, bw_mult]
        outs = edge_substep_ref(*[a[None] for a in args], mips, cap,
                                net_bw, substeps=substeps, dt=dt,
                                swap_slowdown=swap_slowdown,
                                nic_cap=nic_cap)
        return tuple(o[0] for o in outs)

    G, K, F = worker.shape
    n = mips.shape[0]
    dev = instr.device
    fidx = torch.arange(F, dtype=torch.int32, device=dev)
    arange_n = torch.arange(n, device=dev)
    wsafe = worker.clamp(0, n - 1).long()
    chain_f = chain[..., None]
    not_chain_f = ~chain_f
    placed_f = placed[..., None] & (worker >= 0)
    holdable = worker >= 0
    chactive = chain & placed & ~task_done
    kfn = wsafe[..., None] == arange_n                          # (G,K,F,n)
    mips_f = mips[wsafe]
    doh = (decision.clamp(0, 2)[..., None]
           == torch.arange(3, device=dev)).to(f8)               # (G,K,3)
    hand_static = chain_f & (fidx < (nfrag - 1)[..., None])
    out_r = torch.cat([torch.zeros_like(out_bytes[..., :1]),
                       out_bytes[..., :-1]], dim=2)
    w_prev = torch.roll(worker, 1, dims=2).clamp(0, n - 1).long()
    bw_pair = torch.minimum(
        torch.full_like(out_bytes, nic_cap),
        torch.minimum(net_bw[w_prev] / 100.0, net_bw[wsafe] / 100.0))
    gi = torch.arange(G, device=dev)[:, None, None]
    bw_pair = bw_pair * torch.minimum(bw_mult[gi, w_prev], bw_mult[gi, wsafe])
    swap_f8 = torch.tensor(swap_slowdown, dtype=f8, device=dev)

    def census(mask_f):
        """(G, K, n) per-(task, worker) counts of a (G, K, F) mask."""
        return (mask_f[..., None] & kfn).sum(dim=2).to(f8)

    now_s = now[:, 0].clone()
    busy = torch.zeros((G, n), dtype=f8, device=dev)
    m = metrics.clone()
    resp_rec = resp.clone()
    done0 = done
    for _ in range(substeps):
        notdone = ~done
        cnt = census(notdone & holdable & not_chain_f)
        is_stage = fidx == stage[..., None]
        tle = (transfer <= 0.0) & is_stage
        runnable = (not_chain_f | tle) & placed_f & notdone
        holds = (not_chain_f | is_stage) & holdable & notdone
        # active-stage channels; an out-of-range stage reads the fill
        # values (not runnable, not holding, no transfer)
        in_rng = (stage >= 0) & (stage < F)
        s_idx = stage.clamp(0, F - 1).long()
        w_stage = _take(wsafe, s_idx)
        cur_tl = _take(transfer, s_idx)
        bw_s = _take(bw_pair, s_idx)
        r_ch = _take(runnable, s_idx) & chain & in_rng
        h_ch = _take(holds, s_idx) & chain & in_rng
        ohs = (w_stage[..., None] == arange_n).to(f8)            # (G,K,n)
        load = cnt.sum(dim=1) + torch.einsum("gk,gkn->gn", r_ch.to(f8), ohs)
        ram_load = torch.einsum("gk,gkn->gn", ram_task, cnt) \
            + torch.einsum("gk,gkn->gn",
                           torch.where(h_ch, ram_task, 0.0), ohs)
        swap = ram_load > cap
        busy = busy + (load > 0) * dt
        load_f = torch.gather(load, 1, wsafe.reshape(G, -1)).reshape(G, K, F)
        swap_f = torch.gather(swap, 1, wsafe.reshape(G, -1)).reshape(G, K, F)
        rate = mips_f / torch.clamp(load_f, min=1.0)
        rate = torch.where(swap_f, rate * swap_f8, rate)
        instr = instr - torch.where(runnable, rate * dt, 0.0)
        newly = runnable & (instr <= 0.0)
        done = done | newly
        hand = newly & hand_static
        hand_r = torch.cat([torch.zeros_like(hand[..., :1]), hand[..., :-1]],
                           dim=2)
        transfer = torch.where(hand_r, out_r, transfer)
        newfin = done.all(dim=2) & ~task_done
        task_done = task_done | newfin
        resp_t = now_s[:, None] - arrival
        resp_rec = torch.where(newfin, resp_t, resp_rec)
        finf = newfin.to(f8)
        mcols = torch.stack(
            [torch.ones_like(resp_t), resp_t, (resp_t > sla).to(f8), acc_t,
             ((resp_t <= sla) + acc_t) / 2.0, wait_s,
             doh[..., 0], doh[..., 1], doh[..., 2]], dim=2)       # (G,K,9)
        m = m + torch.einsum("gk,gkc->gc", finf, mcols)
        s = stage
        cond = chactive & (s > 0) & (cur_tl > 0.0) & in_rng
        transfer = transfer - torch.where(
            cond, bw_s * 1e6 * dt, 0.0)[..., None] * is_stage
        done_s = torch.where(in_rng, _take(done, s_idx), True)
        adv = chactive & done_s & (s < nfrag - 1)
        stage = stage + adv.to(torch.int32)
        now_s = now_s + dt
    completed = done & ~done0
    pwt_delta = census(completed).sum(dim=1)
    return (instr, done, transfer, stage, task_done, resp_rec,
            now_s[:, None], m, busy, pwt_delta)
