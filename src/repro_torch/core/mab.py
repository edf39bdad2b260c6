"""Multi-Armed-Bandit split-decision module (paper §4.1, eqs. 2–9) and the
Gillis baseline's Q-learner.

The port of ``repro.core.mab``: UCB decisions (deploy), ε-greedy
decisions (train), the Algorithm-1 bookkeeping and the Gillis functions,
batched over a leading grid axis G: every leaf of
``MABState`` carries one row per grid cell, and the per-task arrays
carry (G, rows).  Two context-separated bandits:

  * ``h`` — high-SLA context: the task's deadline exceeds the EMA
    estimate R^a of the layer-split response time for its app;
  * ``l`` — low-SLA context: deadline below the estimate.

Each context holds Q-estimates and decision counts for the two arms
(L = layer split, S = semantic split).  Deployment uses UCB (eq. 9),
training ε-greedy (eq. 6) with JAX's threefry bits per row
(``repro_torch.kernels.threefry``).

Numerics follow the reference as XLA:CPU executes it, since that is the
oracle this port is checked against:

  * Q/N/R/eps/rho are float32, t int32, and the decision math float32;
  * the EMA ``phi·r + (1−phi)·R`` and the Q step ``Q + gamma·(O − Q)``
    are contracted into one fused multiply-add by XLA:CPU; ``_fma32``
    reproduces that single rounding;
  * the per-bucket reward sums accumulate in float32, row by row in
    admission order, the counts in float64, and the mean is taken in
    float64 before the float32 cast.  That is JAX's op-by-op result and
    XLA:CPU's jitted one for up to 14 rows; on wider slot arrays the
    jitted reference regroups the float32 sums, a last-ulp difference
    (ROADMAP queue 3);
  * the Gillis TD step ``Q + lr·(r − Q)`` is float64, and XLA:CPU
    contracts it into one fused multiply-add too (the reference's scan
    body is compiled even when called op by op); ``_fma64`` reproduces
    that single rounding with an exact product (Dekker's split).
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve
from repro_torch.kernels.threefry import threefry_rows
from repro_torch.obs import HOST_WAITS, get_ledger

LAYER, SEMANTIC = 0, 1        # arm indices
HIGH, LOW = 0, 1              # context indices

f32 = torch.float32


class MABState(NamedTuple):
    Q: torch.Tensor            # (G, 2 contexts, 2 arms) reward estimates
    N: torch.Tensor            # (G, 2, 2) decision counts
    R: torch.Tensor            # (G, num_apps) EMA layer-split response time
    eps: torch.Tensor          # (G,) exploration prob (train)
    rho: torch.Tensor          # (G,) reward threshold (RBED)
    t: torch.Tensor            # (G,) int32 scheduling-interval counter


_FIELDS = {"Q": np.float32, "N": np.float32, "R": np.float32,
           "eps": np.float32, "rho": np.float32, "t": np.int32}


def init_state(num_apps: int, eps0: float = 1.0, rho0: float = 0.05, *,
               grid: int = 1, device="cuda") -> MABState:
    """Fresh state, one copy per grid cell."""
    return mab_state_from_numpy(
        {"Q": np.zeros((2, 2)), "N": np.zeros((2, 2)),
         "R": np.zeros((num_apps,)), "eps": eps0, "rho": rho0, "t": 1},
        grid=grid, device=device)


def mab_state_from_numpy(d, *, grid: int = 1, device="cuda") -> MABState:
    """Build the port's state from the reference's ``MABState`` fields
    given as NumPy arrays (``{Q, N, R, eps, rho, t}``, unbatched), with
    one copy per grid cell on ``device``.  The values are cast to the
    reference dtypes (float32, t int32)."""
    dev = resolve(device)
    out = {}
    for k, dt in _FIELDS.items():
        a = np.asarray(d[k]).astype(dt)
        out[k] = torch.from_numpy(np.repeat(a[None], grid, axis=0)).to(dev)
    return MABState(**out)


def mab_state_to_numpy(state: MABState) -> dict:
    """The state's leaves as NumPy arrays with their leading grid axis."""
    return {k: getattr(state, k).cpu().numpy() for k in _FIELDS}


def _fma32(a, b, c):
    """float32 ``a*b + c`` with one rounding, as XLA:CPU contracts it:
    the float32 product is exact in float64, so the sum is rounded once
    in float64 and once more to float32."""
    return (a.double() * b.double() + c.double()).float()


def _gather_app(R, app):
    """R (G, apps) at app (G, M) -> (G, M)."""
    return torch.gather(R, 1, app.long())


def context_of(state: MABState, sla, app):
    """HIGH if sla >= R^app else LOW, per (G, M) row."""
    return torch.where(sla >= _gather_app(state.R, app),
                       HIGH, LOW).to(torch.int32)


def decide_ucb_batch(state: MABState, sla, app, c: float = 0.5):
    """UCB deployment decisions (eq. 9) for (G, M) rows against each
    cell's state; returns (arm, ctx), both (G, M) int32."""
    ctx = context_of(state, sla, app)
    logt = torch.log(torch.clamp(state.t.to(f32), min=2.0))       # (G,)
    idx = ctx.long()[..., None].expand(*ctx.shape, 2)
    Nc = torch.gather(state.N, 1, idx)                            # (G,M,2)
    Qc = torch.gather(state.Q, 1, idx)
    bonus = c * torch.sqrt(logt[:, None, None] / torch.clamp(Nc, min=1.0))
    return torch.argmax(Qc + bonus, dim=-1).to(torch.int32), ctx


def decide_ucb(state: MABState, sla, app, c: float = 0.5):
    """One UCB decision per grid cell: sla/app are (G,)."""
    d, ctx = decide_ucb_batch(state, sla[:, None], app[:, None], c)
    return d[:, 0], ctx[:, 0]


#: the caller's dict that ``timed_host_reads`` installs (per thread and
#: task), or None
_phase_s: contextvars.ContextVar[Optional[dict]] = \
    contextvars.ContextVar("mab_phase_s", default=None)


@contextlib.contextmanager
def timed_host_reads(phase_s: Optional[dict]):
    """While active, every host read of ``_masked_rows`` adds its wall
    seconds, after a device synchronize (so queued work is not counted),
    into ``phase_s["mab_host_read"]``, and every ``timed_share`` block its
    own into ``phase_s[name]``.  Does nothing when ``phase_s`` is None."""
    if phase_s is None:
        yield
        return
    phase_s.setdefault("mab_host_read", 0.0)
    token = _phase_s.set(phase_s)
    try:
        yield
    finally:
        _phase_s.reset(token)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed_share(name: str, device):
    """While ``timed_host_reads`` is active, add the wall seconds of the
    block, with the device synchronized before and after, into
    ``phase_s[name]`` (a share of the phase that runs it)."""
    phase_s = _phase_s.get()
    if phase_s is None:
        yield
        return
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t0


#: host reads ``_masked_rows`` has made in this process (``host_reads``)
_HOST_READS = [0]


def host_reads() -> int:
    """How many host reads ``_masked_rows`` has made in this process (one
    per call that has rows: the MAB's two per interval, Gillis's one)."""
    return _HOST_READS[0]


def _host_max(count) -> int:
    _HOST_READS[0] += 1
    get_ledger().count(HOST_WAITS)
    phase_s = _phase_s.get()
    if phase_s is None:
        return int(count.max())
    _sync(count.device)
    t0 = time.perf_counter()
    n = int(count.max())
    phase_s["mab_host_read"] += time.perf_counter() - t0
    return n


def _scalar32(x: float, device):
    """``x`` as a float32 scalar on ``device``: a blocking upload."""
    get_ledger().count(HOST_WAITS)
    return torch.tensor(x, dtype=f32, device=device)


def _masked_rows(mask):
    """Per-cell row indices of the True entries of ``mask`` (G, M), in row
    order, plus their count; one host read for the longest cell."""
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    count = mask.sum(dim=1)
    return order, count, _host_max(count) if mask.numel() else 0


def update_response_estimates(state: MABState, apps, resp, was_layer,
                              phi: float = 0.9) -> MABState:
    """EMA update of R^a (eq. 2), applied per leaving layer-split task in
    row order (the reference's scan).  apps (G, M) int, resp (G, M)
    float32, was_layer (G, M) bool."""
    R = state.R.clone()
    G = R.shape[0]
    gi = torch.arange(G, device=R.device)
    phi32 = _scalar32(phi, R.device)
    keep32 = _scalar32(1.0 - phi, R.device)
    order, count, n = _masked_rows(was_layer)
    for i in range(n):
        row = order[:, i]
        a = apps[gi, row].long()
        cur = R[gi, a]
        new = _fma32(phi32, resp[gi, row], keep32 * cur)
        R[gi, a] = torch.where(i < count, new, cur)
    return state._replace(R=R)


def interval_rewards_masked(state: MABState, apps, sla, resp, acc,
                            decisions, mask):
    """Per-(context, arm) mean rewards O^{c,d} and counts (eqs. 3–4) over
    masked (G, M) rows; rows with ``mask`` False are ignored.  Returns
    (O, cnt), each (G, 2, 2) float32."""
    G, M = sla.shape
    dev = sla.device
    ctx = torch.where(sla >= _gather_app(state.R, apps), HIGH, LOW)
    per_task = 0.5 * ((resp <= sla).to(f32) + acc)
    bucket = ctx * 2 + decisions.long()
    onehot = (bucket[..., None] == torch.arange(4, device=dev)) \
        & mask[..., None]
    cnt = onehot.to(torch.float64).sum(dim=1)                     # (G, 4)
    # float32 sums, one row at a time in row order
    O = torch.zeros((G, 4), dtype=f32, device=dev)
    gi = torch.arange(G, device=dev)
    order, count, n = _masked_rows(mask)
    for i in range(n):
        row = order[:, i]
        val = torch.where(i < count, per_task[gi, row], 0.0)
        O.scatter_add_(1, bucket[gi, row][:, None], val[:, None])
    O = torch.where(cnt > 0, O.double() / torch.clamp(cnt, min=1.0), 0.0)
    return O.to(f32).reshape(G, 2, 2), cnt.to(f32).reshape(G, 2, 2)


def interval_rewards(state: MABState, apps, sla, resp, acc, decisions):
    """Per-(context, arm) mean rewards O^{c,d} and counts (eqs. 3–4) of
    one interval, for a one-cell state (G=1) and (n,) rows, every row
    kept: ``interval_rewards_masked`` unbatched.  Returns (O (2, 2),
    cnt (2, 2)), float32."""
    rows = [t[None] for t in (apps, sla, resp, acc, decisions)]
    mask = torch.ones_like(rows[0], dtype=torch.bool)
    O, cnt = interval_rewards_masked(state, *rows, mask)
    return O[0], cnt[0]


def update_q(state: MABState, O, cnt, gamma: float = 0.3,
             fused: bool = True) -> MABState:
    """Q <- Q + gamma (O - Q) where data exists (eq. 5), N += counts.
    ``fused`` rounds the step once, as the jitted reference contracts it;
    without it the product and the sum round apart, as the reference's
    op-by-op host decider computes them."""
    g32 = _scalar32(gamma, O.device)
    step = _fma32(g32, O - state.Q, state.Q) if fused \
        else state.Q + g32 * (O - state.Q)
    Q = torch.where(cnt > 0, step, state.Q)
    return state._replace(Q=Q, N=state.N + cnt)


def rbed_update(state: MABState, O, cnt, k: float = 0.1) -> MABState:
    """Feedback-based ε decay / ρ increment (eqs. 7–8)."""
    have = (cnt > 0).reshape(cnt.shape[0], 4)
    Ow = torch.where(have, O.reshape(O.shape[0], 4), 0.0)
    total = Ow[:, 0]
    for j in range(1, 4):                   # float32, row-major order
        total = total + Ow[:, j]
    n_have = torch.clamp(have.sum(dim=1), min=1).to(f32)
    o_mab = torch.where(have.any(dim=1), total / n_have, 0.0)
    improve = o_mab > state.rho
    dec32 = _scalar32(1.0 - k, O.device)
    inc32 = _scalar32(1.0 + k, O.device)
    eps = torch.where(improve, dec32 * state.eps, state.eps)
    rho = torch.where(improve, inc32 * state.rho, state.rho)
    return state._replace(eps=eps, rho=rho)


def end_of_interval_masked(state: MABState, apps, sla, resp, acc, decisions,
                           mask, phi: float = 0.9, gamma: float = 0.3,
                           k: float = 0.1,
                           fused_q: bool = True) -> MABState:
    """Algorithm-1 end-of-interval bookkeeping over masked (G, M) rows.
    With an all-False mask this degrades to ``t += 1``.  ``fused_q`` is
    ``update_q``'s ``fused``."""
    state = update_response_estimates(
        state, apps, resp, mask & (decisions == LAYER), phi)
    O, cnt = interval_rewards_masked(state, apps, sla, resp, acc,
                                     decisions, mask)
    state = update_q(state, O, cnt, gamma, fused_q)
    state = rbed_update(state, O, cnt, k)
    return state._replace(t=state.t + 1)


def end_of_interval(state: MABState, apps, sla, resp, acc, decisions,
                    phi: float = 0.9, gamma: float = 0.3,
                    k: float = 0.1, fused_q: bool = True) -> MABState:
    """Algorithm-1 bookkeeping for the tasks leaving this interval, for a
    one-cell state (G=1) and (n,) rows: ``end_of_interval_masked`` with
    every row kept."""
    rows = [t[None] for t in (apps, sla, resp, acc, decisions)]
    mask = torch.ones_like(rows[0], dtype=torch.bool)
    return end_of_interval_masked(state, *rows, mask, phi, gamma, k,
                                  fused_q)


# ------------------------------------------------------- ε-greedy (train)


def decide_train_rows(state: MABState, key, t: int, sla, app):
    """ε-greedy training decisions (eq. 6) for one interval's (G, A) rows:
    row a of cell g draws from ``fold_in(fold_in(key[g], t), a)`` (the
    reference's ``fold_in(key_t, a)`` with ``key_t = fold_in(key, t)``),
    explores with probability ε (a float32 draw, as ``bernoulli`` of the
    float32 ε) and then takes a fair coin, else ``argmax Q[ctx]`` (the
    first arm on ties).  key (G, 2) int64 words; returns (arm, ctx),
    both (G, A) int32."""
    ctx = context_of(state, sla, app)
    idx = ctx.long()[..., None].expand(*ctx.shape, 2)
    greedy = torch.argmax(torch.gather(state.Q, 1, idx), dim=-1)
    with timed_share("draw", sla.device):
        explore, coin = threefry_rows(key, t, sla.shape[1],
                                      p=state.eps.to(torch.float64),
                                      width=32)
    return torch.where(explore, coin.long(), greedy).to(torch.int32), ctx


def decide_train(state: MABState, key, sla, app, coin_width: int = 64):
    """One ε-greedy decision per cell from its own key (G, 2): sla/app are
    (G,); the draws are ``split(key)`` as in the reference's
    ``decide_train``.  The coin is ``bernoulli(k2, 0.5)`` at
    ``coin_width`` bits: 64 under the reference's ``enable_x64``, 32
    without it (its host decider)."""
    ctx = context_of(state, sla[:, None], app[:, None])[:, 0]
    greedy = torch.argmax(state.Q[torch.arange(len(ctx)), ctx.long()], -1)
    k1, k2 = prng.split(key)
    explore = prng.bernoulli(k1, state.eps, 32)
    coin = prng.bernoulli(k2, 0.5, coin_width)
    return torch.where(explore, coin.long(), greedy).to(torch.int32), ctx


# ----------------------------------------------- Gillis baseline (arrays)

def gillis_init(num_apps: int, *, grid: int = 1, device="cuda",
                dtype=torch.float64):
    """Zero contextual Q-tables, (G, apps, 2 buckets, 2 arms)."""
    return torch.zeros((grid, num_apps, 2, 2), dtype=dtype,
                       device=resolve(device))


def gillis_bucket(sla, batch, app, layer_ref):
    """Deadline context bucket: 1 when the SLA undercuts 1.6× the
    batch-scaled unloaded layer-chain reference.  ``layer_ref`` (apps,)
    float64; sla, batch (float64) and app of one shape; int32."""
    ref = layer_ref[app.long()] * batch / 40000.0 * 1.6
    return (sla < ref).to(torch.int32)


def gillis_decide_rows(Q, eps, key, t: int, sla, batch, app, layer_ref):
    """ε-greedy Gillis arm decisions for one interval's (G, A) rows, with
    the same per-row keys as ``decide_train_rows``; ε (G,) float64 is a
    float64 draw.  Returns (arms, buckets), (G, A) int32; arm 0 is the
    layer split, arm 1 the compressed model."""
    bucket = gillis_bucket(sla, batch, app, layer_ref)
    G, A = sla.shape
    cell = (app.long() * 2 + bucket) * 2                   # (G, A)
    q = Q.reshape(G, -1)
    q2 = torch.stack([torch.gather(q, 1, cell),
                      torch.gather(q, 1, cell + 1)], dim=-1)
    greedy = torch.argmax(q2, dim=-1)
    with timed_share("draw", sla.device):
        explore, coin = threefry_rows(key, t, A, p=eps, width=64)
    return torch.where(explore, coin.long(), greedy).to(torch.int32), bucket


_SPLIT = 134217729.0                      # 2**27 + 1, Dekker's split


def _halves(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _fma64(a, b, c):
    """float64 ``a*b + c`` with one rounding, as XLA:CPU contracts it: the
    product is split exactly into p + e (Dekker), p + c into s + t
    (Knuth's two-sum), and s + (t + e) is rounded once more.  That equals
    the fused result except where t + e rounds across a rounding boundary
    of s, which needs an exact tie."""
    p = a * b
    ah, al = _halves(a)
    bh, bl = _halves(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def gillis_update_masked(Q, apps, buckets, arms, rewards, mask, lr: float):
    """Per-leaving-task sequential TD(0) update ``Q ← Q + lr·(r − Q)`` over
    masked (G, M) rows, in row order (later rows of one (app, bucket, arm)
    entry see earlier updates); masked-out rows no-op.  One host read per
    call (``_masked_rows``)."""
    G = Q.shape[0]
    q = Q.reshape(G, -1).clone()
    gi = torch.arange(G, device=Q.device)
    lr64 = torch.tensor(lr, dtype=torch.float64, device=Q.device)
    entry = (apps.long() * 2 + buckets.long()) * 2 + arms.long()
    order, count, n = _masked_rows(mask)
    for i in range(n):
        row = order[:, i]
        e = entry[gi, row]
        cur = q[gi, e]
        new = _fma64(lr64, rewards[gi, row] - cur, cur)
        q[gi, e] = torch.where(i < count, new, cur)
    return q.reshape(Q.shape)
