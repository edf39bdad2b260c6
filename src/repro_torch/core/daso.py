"""DASO — Decision-Aware Surrogate Optimization placement (§4.2).

The port of ``repro.core.daso``: ``DASOConfig``, ``feature_size``,
``init_surrogate``, ``surrogate_apply``, ``pack_input``, ``train_epoch``,
``make_trainer``, ``optimize_placement``, ``placement_to_assignment``,
``warm_start_logits`` and the online-finetuning carry of the simulator's
train mode (``REPLAY_WINDOW``, ``window_init``, ``window_append``,
``op_objective``, ``train_epoch_weighted``, ``finetune_window``,
``window_loss``).  An FCN surrogate f([S_t, P_t, D_t]; θ) predicts
the QoS objective; it is trained with MSE (eq. 11, AdamW), and the
placement is found by gradient ascent of the surrogate output w.r.t.
relaxed placement logits (eq. 12), with momentum, until ``place_iters``
steps or an L2 step below ``tol``.

θ is a list of ``{"w", "b"}`` layers of float32 tensors, as in the
reference.  Two forms of the ascent:

  * the serving engine's ``optimize_placement``: one placement, float32,
    gradients from ``torch.autograd.grad``, a host read of the step norm
    per step but the first (a recording ledger counts the steps,
    ``daso.ascent_steps``, as ``train_epoch`` counts ``daso.train_epochs``,
    and each read under ``host.waits``);
  * the simulator's ``optimize_placement_grid``: one placement per grid
    cell (leading axis G), in the logits' dtype (float64 in the interval
    program, as the reference runs that stage under ``enable_x64``), the
    gradient by the chain rule written out, and ``place_iters`` masked
    steps that read nothing back from the device.  θ is shared by the
    cells (deploy mode) or one copy per cell (train mode: leaves with a
    leading G axis).

The train-mode carry keeps θ and the AdamW moments float32, one copy per
cell, and a float64 replay window; the forward and the loss run in
float64 (the window is float64 and the reference promotes ``x @ w``), and
the gradient is rounded to float32 at the leaf.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.obs import HOST_WAITS, get_ledger
from repro_torch.optim.optimizers import AdamWState, adamw_init, adamw_update

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
    get_ledger().count("daso.train_epochs")
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

    led = get_ledger()
    p = placement0
    vel = torch.zeros_like(placement0)
    i = 0
    while i < cfg.place_iters:
        if i:
            led.count(HOST_WAITS)               # the step norm's read
            if not bool(delta > cfg.tol):
                break
        pg = p.detach().requires_grad_()
        with torch.enable_grad():
            (g,) = torch.autograd.grad(score(pg), pg)
        vel = cfg.momentum * vel + g
        new_p = p + cfg.lr_place * vel          # ascent: maximize O^P
        delta = torch.linalg.norm(new_p - p)
        p = new_p
        i += 1
    led.count("daso.ascent_steps", i)
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


def _layer(h, layer):
    """h (G, d) through one layer: weights shared (w (d, e)) or one copy
    per cell (w (G, d, e))."""
    w, b = layer["w"], layer["b"]
    if w.dim() == 2:
        return h @ w + b
    return torch.bmm(h[:, None, :], w)[:, 0] + b


def _layer_t(g, w):
    """g (G, e) through the transpose of a shared (d, e) or per-cell
    (G, d, e) weight."""
    if w.dim() == 2:
        return g @ w.T
    return torch.bmm(g[:, None, :], w.transpose(1, 2))[:, 0]


def _score_grid(theta, x):
    """The surrogate at packed inputs x (G, feature_size) -> (G,)."""
    for i, layer in enumerate(theta):
        x = _layer(x, layer)
        if i < len(theta) - 1:
            x = torch.tanh(x)
    return x[..., 0]


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
        h = _layer(h, layer)
        if i < len(theta) - 1:
            h = torch.tanh(h)
            hs.append(h)
    g = torch.ones_like(h)
    for i in range(len(theta) - 1, -1, -1):
        if i < len(theta) - 1:
            a = g * (1.0 - hs[i])
            g = a + a * hs[i]
        w = theta[i]["w"] if i else theta[i]["w"][..., lo:lo + C * W, :]
        g = _layer_t(g, w)
    g = g.reshape(G, C, W) * mask[..., None]
    y = soft * g
    return y - soft * y.sum(dim=-1, keepdim=True)


def optimize_placement_grid(cfg: DASOConfig, theta, state, placement0,
                            decisions, mask):
    """``optimize_placement`` for G cells at once: state (G, W, F),
    logits (G, C, W), decisions and mask (G, C); θ shared or per cell.

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
    return p, _score_grid(theta, x), steps


# ------------------------------------------------- online finetuning carry
#
# The simulator's train mode threads the DASO trainer through the interval
# loop: a REPLAY_WINDOW-row rolling window of (packed placement input,
# O^P target) pairs per cell, and each cell's (θ, AdamW state).  Every
# cell appends one record per interval, so the window's fill is the same
# host-side count in every cell and both gates are host-side branches.

#: replay-window rows — the host ``SurrogatePlacer``'s 64-row window
REPLAY_WINDOW = 64

#: ascend the surrogate only once this many interval records exist, and
#: train only once ``TRAIN_MIN`` exist — the host placer's thresholds
PLACE_MIN, TRAIN_MIN = 32, 8


def _cells(x, grid: int, device):
    """One float32 copy of the array or tensor ``x`` per cell."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
    t = t.to(device=device, dtype=f32)
    return t.expand(grid, *t.shape).clone()


def theta_cells(theta, grid: int, device):
    """One float32 copy of θ per cell (leaves with a leading G axis), from
    the port's tensors or the reference's NumPy ``{"w", "b"}`` list."""
    return [{k: _cells(v, grid, device) for k, v in layer.items()}
            for layer in theta]


def opt_state_cells(opt_state, theta, grid: int, device):
    """The AdamW state of per-cell θ: fresh zeros when ``opt_state`` is
    None, else one copy per cell of the reference's ``(step, m, v)``,
    where m and v are ``{"w", "b"}`` lists (NumPy or tensors)."""
    if opt_state is None:
        return adamw_init(_flat(theta))
    step, m, v = opt_state
    return AdamWState(
        step=torch.as_tensor(step).to(device=device, dtype=torch.int32),
        m=[_cells(x, grid, device) for x in _flat(m)],
        v=[_cells(x, grid, device) for x in _flat(v)])


def window_init(cfg: DASOConfig, grid: int, device, dtype=f8):
    """Empty replay windows: xs (G, REPLAY_WINDOW, feature_size), ys (G,
    REPLAY_WINDOW) and the host-side record count."""
    dev = resolve(device)
    return {"xs": torch.zeros((grid, REPLAY_WINDOW, feature_size(cfg)),
                              dtype=dtype, device=dev),
            "ys": torch.zeros((grid, REPLAY_WINDOW), dtype=dtype,
                              device=dev),
            "count": 0}


def window_append(win, x, y):
    """Append one (x (G, F), y (G,)) record per cell, oldest first,
    dropping the oldest row once the window is full (the host placer's
    ``replay[-64:]``)."""
    count = win["count"]
    xs, ys = win["xs"], win["ys"]
    if count >= REPLAY_WINDOW:
        xs, ys = torch.roll(xs, -1, dims=1), torch.roll(ys, -1, dims=1)
    else:
        xs, ys = xs.clone(), ys.clone()
    idx = min(count, REPLAY_WINDOW - 1)
    xs[:, idx] = x.to(xs.dtype)
    ys[:, idx] = y.to(ys.dtype)
    return {"xs": xs, "ys": ys, "count": min(count + 1, REPLAY_WINDOW)}


def op_objective(resp, sla, acc, fin_mask, cpu_util, interval_s: float,
                 alpha: float = 0.5, beta: float = 0.5):
    """The per-interval training target O^P = O^MAB − α·AEC − β·ART
    (eq. 10) per cell: resp, sla, acc, fin_mask (G, K), cpu_util (G, n).
    ``fin_mask`` selects the tasks that finished this interval; an empty
    interval has O^MAB = ART = 0."""
    finf = fin_mask.to(resp.dtype)
    nfin = finf.sum(dim=1)
    d = torch.clamp(nfin, min=1.0)
    o_mab = (finf * ((resp <= sla).to(resp.dtype) + acc)).sum(dim=1)
    o_mab = torch.where(nfin > 0, 0.5 * o_mab / d, 0.0)
    aec = cpu_util.mean(dim=1)
    art = torch.where(nfin > 0,
                      (finf * resp).sum(dim=1) / d / (6.0 * interval_s), 0.0)
    return o_mab - alpha * aec - beta * torch.clamp(art, max=1.0)


def _weighted_loss(theta, xs, ys, w):
    """Per-cell weighted MSE of the surrogate over the window, in the
    window's dtype (θ promoted, as ``x @ w`` promotes in the reference)."""
    h = xs
    for i, layer in enumerate(theta):
        h = torch.matmul(h, layer["w"].to(xs.dtype)) \
            + layer["b"].to(xs.dtype)[:, None, :]
        if i < len(theta) - 1:
            h = torch.tanh(h)
    pred = h[..., 0]
    return (w * torch.square(pred - ys)).sum(dim=1) \
        / torch.clamp(w.sum(dim=1), min=1.0)


def _window_weights(win):
    R = win["ys"].shape[1]
    w = (torch.arange(R, device=win["ys"].device) < win["count"])
    return w.to(win["ys"].dtype).expand_as(win["ys"])


def train_epoch_weighted(cfg: DASOConfig, theta, opt_state, xs, ys, w):
    """One weighted MSE epoch per cell over its padded window (``w`` masks
    the real rows): per-cell θ (leaves (G, ...)), xs (G, R, F), ys and w
    (G, R).  The gradient of each cell's loss reaches its float32 leaves
    through the float64 forward; AdamW with ``weight_decay=0``.  Returns
    (theta, opt_state, loss (G,))."""
    params = [t.detach().requires_grad_() for t in _flat(theta)]
    with torch.enable_grad():
        loss = _weighted_loss(_unflat(params), xs, ys, w)
        grads = torch.autograd.grad(loss.sum(), params)
    new, opt_state = adamw_update(list(grads), opt_state,
                                  [p.detach() for p in params], cfg.lr_train,
                                  weight_decay=0.0)
    return _unflat(new), opt_state, loss.detach()


def finetune_window(cfg: DASOConfig, theta, opt_state, win,
                    train_steps: int = 4, train_min: int = TRAIN_MIN):
    """Advance (theta, opt_state) by ``train_steps`` weighted epochs over
    the replay window — a no-op until ``train_min`` records exist."""
    if win["count"] < train_min:
        return theta, opt_state
    w = _window_weights(win)
    for _ in range(train_steps):
        theta, opt_state, _ = train_epoch_weighted(
            cfg, theta, opt_state, win["xs"], win["ys"], w)
    return theta, opt_state


def window_loss(cfg: DASOConfig, theta, win):
    """The weighted window MSE ``train_epoch_weighted`` descends, without a
    step, per cell; 0 for an empty window."""
    with torch.no_grad():
        return _weighted_loss(theta, win["xs"], win["ys"],
                              _window_weights(win))
