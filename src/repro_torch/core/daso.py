"""DASO — Decision-Aware Surrogate Optimization placement (§4.2).

The port of ``repro.core.daso``'s ``DASOConfig``, ``feature_size``,
``init_surrogate``, ``surrogate_apply``, ``pack_input``, ``train_epoch``,
``make_trainer``, ``optimize_placement``, ``placement_to_assignment`` and
``warm_start_logits``.  An FCN surrogate f([S_t, P_t, D_t]; θ) predicts
the QoS objective; it is trained with MSE (eq. 11, AdamW), and the
placement is found by gradient ascent of the surrogate output w.r.t.
relaxed placement logits (eq. 12), with momentum, until ``place_iters``
steps or an L2 step below ``tol``.

θ is a list of ``{"w", "b"}`` layers of float32 tensors, as in the
reference.  Two forms of the ascent:

  * the serving engine's ``optimize_placement``: one placement, float32,
    gradients from ``torch.autograd.grad``, a host read of the step norm
    per step;
  * the simulator's ``optimize_placement_grid``: one placement per grid
    cell (leading axis G), in the logits' dtype (float64 in the interval
    program, as the reference runs that stage under ``enable_x64``), the
    gradient by the chain rule written out, and ``place_iters`` masked
    steps that read nothing back from the device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.optim.optimizers import adamw_init, adamw_update

f32, f8 = torch.float32, torch.float64


class DASOConfig(NamedTuple):
    num_workers: int
    max_containers: int
    state_features: int          # per-worker utilization features
    hidden: int = 128
    depth: int = 3
    lr_train: float = 1e-3
    lr_place: float = 0.1
    place_iters: int = 50
    momentum: float = 0.9
    tol: float = 1e-3
    decision_aware: bool = True


def feature_size(cfg: DASOConfig) -> int:
    # worker utilization state + placement logits + split-decision one-hots
    return (cfg.num_workers * cfg.state_features
            + cfg.max_containers * cfg.num_workers
            + cfg.max_containers * 2)


def init_surrogate(cfg: DASOConfig, generator, device="cuda"):
    """θ: normal(0, 1)/√fan_in weights drawn from ``generator`` (on its own
    device), zero biases, placed on ``device``."""
    dev = resolve(device)
    dims = [feature_size(cfg)] + [cfg.hidden] * cfg.depth + [1]
    return [{"w": (torch.randn((a, b), generator=generator, dtype=f32,
                               device=generator.device)
                   / math.sqrt(a)).to(dev),
             "b": torch.zeros((b,), dtype=f32, device=dev)}
            for a, b in zip(dims[:-1], dims[1:])]


def surrogate_apply(theta, x):
    for i, layer in enumerate(theta):
        x = x @ layer["w"] + layer["b"]
        if i < len(theta) - 1:
            x = torch.tanh(x)
    return x[..., 0]


def pack_input(cfg: DASOConfig, state, placement, decisions, mask):
    """state (W, F); placement logits (C, W); decisions (C,) in {0,1};
    mask (C,) active containers."""
    d1 = F.one_hot(decisions.long(), 2).to(f32) * mask[:, None]
    p = torch.softmax(placement, dim=-1) * mask[:, None]
    if not cfg.decision_aware:
        d1 = torch.zeros_like(d1)
    return torch.cat([state.reshape(-1), p.reshape(-1), d1.reshape(-1)])


def _flat(theta):
    return [t for layer in theta for t in (layer["w"], layer["b"])]


def _unflat(flat):
    return [{"w": w, "b": b} for w, b in zip(flat[::2], flat[1::2])]


# --------------------------------------------------------------- training

def train_epoch(cfg: DASOConfig, theta, opt_state, xs, ys):
    """One epoch of MSE training (eq. 11) over a batch of packed inputs;
    returns (theta, opt_state, loss)."""
    params = [t.detach().requires_grad_() for t in _flat(theta)]
    with torch.enable_grad():
        pred = surrogate_apply(_unflat(params), xs)
        loss = torch.mean(torch.square(pred - ys))
        grads = torch.autograd.grad(loss, params)
    new, opt_state = adamw_update(list(grads), opt_state,
                                  [p.detach() for p in params], cfg.lr_train,
                                  weight_decay=0.0)
    return _unflat(new), opt_state, loss.detach()


def make_trainer(cfg: DASOConfig, generator, device="cuda"):
    theta = init_surrogate(cfg, generator, device)
    return theta, adamw_init(_flat(theta))


def trainer_from_numpy(layers, device="cuda"):
    """θ and a fresh AdamW state from the reference's θ given as NumPy
    arrays (a list of ``{"w", "b"}``)."""
    dev = resolve(device)
    theta = [{k: torch.from_numpy(np.array(layer[k], np.float32)).to(dev)
              for k in ("w", "b")} for layer in layers]
    return theta, adamw_init(_flat(theta))


# -------------------------------------------------------------- placement

def optimize_placement(cfg: DASOConfig, theta, state, placement0, decisions,
                       mask):
    """Gradient ascent of the surrogate w.r.t. placement logits (eq. 12).

    Iterates with momentum while ``i < place_iters`` and the L2 step norm
    exceeds ``tol`` (GOBI's converged-iteration rule); returns
    (placement, score, iterations).
    """
    def score(p):
        return surrogate_apply(theta, pack_input(cfg, state, p, decisions,
                                                 mask))

    p = placement0
    vel = torch.zeros_like(placement0)
    i = 0
    delta = torch.tensor(math.inf, dtype=f32)
    while i < cfg.place_iters and bool(delta > cfg.tol):
        pg = p.detach().requires_grad_()
        with torch.enable_grad():
            (g,) = torch.autograd.grad(score(pg), pg)
        vel = cfg.momentum * vel + g
        new_p = p + cfg.lr_place * vel          # ascent: maximize O^P
        delta = torch.linalg.norm(new_p - p)
        p = new_p
        i += 1
    with torch.no_grad():
        return p, score(p), i


def placement_to_assignment(placement_logits, mask):
    """Row argmax -> worker index per container (-1 for inactive rows)."""
    idx = torch.argmax(placement_logits, dim=-1)
    return torch.where(mask.bool(), idx, -1)


def warm_start_logits(cfg: DASOConfig, warm_workers, row_valid, dtype=f8):
    """(..., C) warm-start worker per container row -> (..., C, W)
    logits: 2.0 at the warm worker of each valid row, zeros elsewhere
    (eq. 12 iterates from the BestFit / current placement)."""
    w = torch.arange(cfg.num_workers, device=warm_workers.device)
    oh = (warm_workers[..., None] == w) & row_valid[..., None]
    return oh.to(dtype) * 2.0


# ------------------------------------------- grid-batched ascent (simulator)

def pack_input_grid(cfg: DASOConfig, state, placement, decisions, mask):
    """``pack_input`` for G cells at once, in ``placement``'s dtype:
    state (G, W, F), placement logits (G, C, W), decisions and mask
    (G, C) -> (G, feature_size)."""
    dt = placement.dtype
    m = mask.to(dt)[..., None]
    p = torch.softmax(placement, dim=-1) * m
    d1 = F.one_hot(decisions.long(), 2).to(dt) * m
    if not cfg.decision_aware:
        d1 = torch.zeros_like(d1)
    G = placement.shape[0]
    return torch.cat([state.to(dt).reshape(G, -1), p.reshape(G, -1),
                      d1.reshape(G, -1)], dim=1)


def _logit_grad(cfg: DASOConfig, theta, x, soft, mask):
    """Gradient of the surrogate score of packed inputs ``x`` (G,
    feature_size) w.r.t. the placement logits (G, C, W), whose softmax is
    ``soft``: the forward pass, then the chain rule written out — each
    tanh layer's VJP in JAX's form, the products transposed (the first
    one only over the placement rows), and the masked softmax VJP,
    y·g − y·Σ(y·g)."""
    G, C, W = soft.shape
    lo = cfg.num_workers * cfg.state_features
    hs = []
    h = x
    for i, layer in enumerate(theta):
        h = h @ layer["w"] + layer["b"]
        if i < len(theta) - 1:
            h = torch.tanh(h)
            hs.append(h)
    g = torch.ones_like(h)
    for i in range(len(theta) - 1, -1, -1):
        if i < len(theta) - 1:
            a = g * (1.0 - hs[i])
            g = a + a * hs[i]
        w = theta[i]["w"] if i else theta[i]["w"][lo:lo + C * W]
        g = g @ w.T
    g = g.reshape(G, C, W) * mask[..., None]
    y = soft * g
    return y - soft * y.sum(dim=-1, keepdim=True)


def optimize_placement_grid(cfg: DASOConfig, theta, state, placement0,
                            decisions, mask):
    """``optimize_placement`` for G cells at once: state (G, W, F),
    logits (G, C, W), decisions and mask (G, C).

    θ is cast once to the logits' dtype.  Each cell keeps its own step
    count and stop rule (``i < place_iters`` and its last L2 step
    ``> tol``); a cell that has stopped keeps its logits, momentum and
    count, as the reference's ``while_loop`` does under ``vmap``.  All
    ``place_iters`` steps run, masked, so nothing is read back from the
    device.  Returns (placement (G, C, W), score (G,), steps (G,) int32).
    """
    dt = placement0.dtype
    theta = [{k: v.to(dt) for k, v in layer.items()} for layer in theta]
    mask = mask.to(dt)
    G = placement0.shape[0]
    base = pack_input_grid(cfg, state, placement0, decisions, mask)
    lo = cfg.num_workers * cfg.state_features
    hi = lo + cfg.max_containers * cfg.num_workers

    def pack(p):
        soft = torch.softmax(p, dim=-1)
        x = torch.cat([base[:, :lo], (soft * mask[..., None]).reshape(G, -1),
                       base[:, hi:]], dim=1)
        return x, soft

    p = placement0
    vel = torch.zeros_like(p)
    steps = torch.zeros(G, dtype=torch.int32, device=p.device)
    delta = torch.full((G,), math.inf, dtype=dt, device=p.device)
    for _ in range(cfg.place_iters):
        active = delta > cfg.tol
        g = _logit_grad(cfg, theta, *pack(p), mask)
        vel_new = cfg.momentum * vel + g
        p_new = p + cfg.lr_place * vel_new      # ascent: maximize O^P
        d_new = torch.linalg.vector_norm((p_new - p).reshape(G, -1), dim=1)
        keep = active[:, None, None]
        p = torch.where(keep, p_new, p)
        vel = torch.where(keep, vel_new, vel)
        delta = torch.where(active, d_new, delta)
        steps = steps + active.to(torch.int32)
    x, _ = pack(p)
    return p, surrogate_apply(theta, x), steps
