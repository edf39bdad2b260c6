"""Mixture-of-Experts FFN: shared experts + routed top-k experts.

The port of ``repro.models.moe``.  Tokens are dispatched in groups
(GShard-style): capacity and slot positions are per group, with
gs = ``min(group_size, b·s)`` and the last group padded with zero tokens.
Weights keep the reference's layouts (``router`` (d, E) and
``shared_gate`` (d, 1) in float32 whatever ``param_dtype`` says,
``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d), ``shared`` an MLP).

The reference has two dispatches that compute one function, ``onehot``
(GShard einsums) and ``gather`` (scatter/gather); its own test holds them
together.  The port runs one index dispatch for both values of
``cfg.moe.dispatch``: ``moe_route`` gives each (token, choice) its expert,
gate and slot (the CUDA kernel on the card, its twin on the CPU); an entry
is kept when its slot is below the capacity C, is scattered to row
``eid·C + slot`` of a (G, E·C + 1, d) buffer whose last row is a sink for
the dropped ones, the experts run as batched products over (E, G·C, d),
and the outputs are gathered back and weighted by ``gate · keep``.
In training the gates carry the router's gradient (``moe_route``'s
backward kernel on the card), and ``aux_load_balance_loss`` is the
reference's Switch-style auxiliary loss in plain PyTorch (the reference
also computes it outside any kernel).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_route import moe_route
from repro_torch.kernels.ref import topk_distinct
from repro_torch.models.dist import constrained
from repro_torch.models.layers import (activation_fn, dense_init, mlp_apply,
                                       mlp_init)


def moe_init(generator, cfg, dtype, device=None):
    m = cfg.moe
    d = cfg.d_model
    p = {"router": dense_init(generator, (d, m.num_experts), torch.float32,
                              device=device),
         "w_gate": dense_init(generator, (m.num_experts, d, m.d_ff_expert),
                              dtype, device=device),
         "w_up": dense_init(generator, (m.num_experts, d, m.d_ff_expert),
                            dtype, device=device),
         "w_down": dense_init(generator, (m.num_experts, m.d_ff_expert, d),
                              dtype, fan_in=m.d_ff_expert, device=device)}
    if m.num_shared_experts:
        p["shared"] = mlp_init(generator, d, m.shared_d_ff, cfg, dtype,
                               device=device)
        p["shared_gate"] = dense_init(generator, (d, 1), torch.float32,
                                      device=device)
    return p


def router_logits(p, x):
    """The router's float32 logits of x (..., d); the product runs in full
    float32 (TF32 would change which experts are picked)."""
    return x.float() @ p["router"]


def router_topk(p, x2d, m):
    """x2d (..., d) -> (gates (..., k), idx (..., k), probs (..., E)), the
    reference's ``router_topk``: distinct experts, the lower index first
    on ties."""
    probs = torch.softmax(router_logits(p, x2d), dim=-1)
    top_vals, top_idx = topk_distinct(probs, m.top_k)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    return top_vals, top_idx, probs


def _group(x, m):
    """(b, s, d) -> (G, gs, d) token groups padded with zero tokens, the
    token count and the group size."""
    b, s, d = x.shape
    S = b * s
    gs = min(m.group_size, S)
    pad = (-S) % gs
    x2 = x.reshape(S, d)
    if pad:
        x2 = torch.cat([x2, x2.new_zeros((pad, d))], dim=0)
    return x2.reshape(-1, gs, d), S, gs


def _capacity(gs, m):
    return max(int(gs * m.top_k / m.num_experts * m.capacity_factor),
               m.top_k)


def _expert_ffn(p, xin, cfg):
    """xin (G, E, C, d) -> (G, E, C, d), per-expert gated MLP as batched
    products over the experts."""
    act = activation_fn(cfg.activation)
    G, E, C, d = xin.shape
    x = xin.transpose(0, 1).reshape(E, G * C, d)
    h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    y = h @ p["w_down"]
    return y.reshape(E, G, C, d).transpose(0, 1)


def _add_shared(p, x2, y, cfg):
    if cfg.moe.num_shared_experts:
        gate = torch.sigmoid(x2.float() @ p["shared_gate"])
        y = y + mlp_apply(p["shared"], x2, cfg) * gate.to(x2.dtype)
    return y


def moe_apply(p, x, cfg, constrain=None):
    """x (b, s, d) -> (b, s, d): routed experts plus the shared expert.
    ``constrain`` places the groups (``"moe_group"``), the dispatch
    buffers (``"moe_buffer"``) and the experts' inputs
    (``"moe_expert"``) as the reference's gather dispatch does."""
    m = cfg.moe
    b, s, d = x.shape
    E, k = m.num_experts, m.top_k
    xg, S, gs = _group(x, m)
    xg = constrained(constrain, xg, "moe_group")
    G = xg.shape[0]
    C = _capacity(gs, m)
    eid, gate, slot = moe_route(router_logits(p, xg).contiguous(), k)
    keep = slot < C                                          # (G, gs, k)
    dest = torch.where(keep, eid * C + slot, E * C).long()
    dest = dest.reshape(G, gs * k, 1).expand(G, gs * k, d)
    src = xg[:, :, None, :].expand(G, gs, k, d).reshape(G, gs * k, d)
    buf = constrained(constrain, xg.new_zeros((G, E * C + 1, d)),
                      "moe_buffer")
    buf.scatter_(1, dest, constrained(constrain, src, "moe_buffer"))
    xin = constrained(constrain, buf[:, :-1].reshape(G, E, C, d),
                      "moe_expert")
    xout = constrained(constrain, _expert_ffn(p, xin, cfg), "moe_expert")
    xout = torch.cat([xout.reshape(G, E * C, d), xg.new_zeros((G, 1, d))],
                     dim=1)
    xout = constrained(constrain, xout, "moe_buffer")
    gathered = torch.gather(xout, 1, dest).reshape(G, gs, k, d)
    w = (gate * keep).to(x.dtype)
    y = constrained(constrain, torch.einsum("gskd,gsk->gsd", gathered, w),
                    "moe_group").reshape(-1, d)
    if y.shape[0] != S:                              # the last group's pad
        y = y[:S]
    # back to (b, s, d) before the shared expert, which runs on x as it
    # is (the same products: a (b, s, d) matmul is a (b·s, d) one)
    return _add_shared(p, x, y.reshape(b, s, d), cfg)


def aux_load_balance_loss(p, x, cfg):
    """Switch-style auxiliary load-balance loss of x (b, s, d): E · Σ_e
    (the fraction of the tokens' top-k picks on e) · (the mean router
    probability of e), over the b·s tokens ungrouped, as the reference."""
    m = cfg.moe
    b, s, d = x.shape
    _, top_idx, probs = router_topk(p, x.reshape(b * s, d), m)
    # the one-hot picks as a comparison (``one_hot`` checks its indices
    # on the host on a real device and not on the meta one, so a step would
    # count differently there)
    picks = top_idx[..., None] == torch.arange(m.num_experts,
                                               device=top_idx.device)
    frac = picks.sum(1).float().mean(0)                      # (E,)
    return m.num_experts * torch.sum(frac * probs.mean(0))
