"""SplitPlace policy (Algorithm 1) + ablations/baselines on the host
simulator: the port of ``repro.core.splitplace``.

Deciders (split strategy per task)  ×  Placers (container -> worker):

    MAB (ε-greedy train / UCB deploy)    DASO (decision-aware surrogate)
    Fixed LAYER / SEMANTIC               GOBI (decision-blind surrogate)
    Random                               BestFit heuristic
    Gillis-style contextual Q-learning (layer vs compressed)
    MC (always compressed)

SplitPlace = MAB + DASO.  The paper's ablations: M+G, S+G, L+G, R+D; its
baselines: Gillis, MC.

The learners' state lives on ``device`` (default CUDA):

  * ``MABDecider`` keeps a one-cell ``mab.MABState`` (leaves with a grid
    axis of 1, the form ``run_grid_batched``'s ``mab_state`` takes) and
    draws each task's ε-greedy bits from ``prng.split`` of its key, JAX's
    non-partitionable threefry, as the reference's ``jax.random.split``.
    Its feedback is ``mab.end_of_interval`` with the Q step rounded
    twice, as the reference computes it op by op;
  * ``SurrogatePlacer`` keeps θ and the AdamW moments float32 with a grid
    axis of 1, ascends with ``daso.optimize_placement`` (float32, a host
    read per step) and finetunes with ``daso.train_epoch_weighted`` at
    G=1.  Its ``theta`` / ``opt_state`` are the reference's unbatched
    forms.  θ0 comes from a ``torch.Generator`` seeded on ``device``
    (other numbers than ``jax.random``'s), or from ``daso_theta0``.

``FixedDecider``, ``RandomDecider``, ``GillisDecider`` and
``BestFitPlacer`` are NumPy copies with the reference's ``RandomState``
draw order.  Each decision of the MAB is one host read (``int(d)``), each
ascent step another.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import daso as daso_mod
from repro_torch.core import mab as mab_mod
from repro_torch.core import prng
from repro_torch.core.policies import Decider, Placer, Policy  # noqa: F401 (re-export)
from repro_torch.device import resolve
from repro_torch.env.simulator import EdgeSim
from repro_torch.env.workload import (COMPRESSED, LAYER, SEMANTIC,
                                      layer_ref_response_s)
from repro_torch.optim.optimizers import AdamWState

NUM_APPS = 3

f32 = torch.float32


# ------------------------------------------------------------- deciders

def mab_state_on(state, device) -> mab_mod.MABState:
    """A one-cell ``MABState`` on ``device`` from a port state with a grid
    axis of 1 or the reference's fields as NumPy (``{Q, N, R, eps, rho,
    t}``)."""
    if isinstance(state, mab_mod.MABState):
        if state.Q.shape[0] != 1:
            raise ValueError(f"a host decider takes a one-cell MABState, "
                             f"got a grid axis of {state.Q.shape[0]}")
        return mab_mod.MABState(*[v.to(device) for v in state])
    return mab_mod.mab_state_from_numpy(state, device=device)


def interval_reward(finished) -> float:
    """O^MAB of one interval: the mean task reward (1[r <= sla] + p) / 2
    over the tasks that finished in it (0 for none)."""
    if not finished:
        return 0.0
    r = np.array([t.response_s for t in finished])
    s = np.array([t.sla_s for t in finished])
    p = np.array([t.accuracy for t in finished])
    return float(np.mean(((r <= s) + p) / 2.0))


class MABDecider:
    def __init__(self, seed=0, train=True, state=None, ucb_c=0.5,
                 phi=0.3, gamma=0.3, k=0.1, device="cuda"):
        self.device = resolve(device)
        self.state = mab_mod.init_state(NUM_APPS, device=self.device) \
            if state is None else mab_state_on(state, self.device)
        self.train = train
        self.key = prng.prng_key(seed, device=self.device)
        self.ucb_c, self.phi, self.gamma, self.k = ucb_c, phi, gamma, k

    @staticmethod
    def _norm(t):
        # batch-normalized SLA (the reference's context normalization)
        return t.sla_s * 40000.0 / max(t.batch, 1)

    def decide(self, tasks):
        out = []
        for t in tasks:
            sla = torch.tensor([self._norm(t)], dtype=f32,
                               device=self.device)
            app = torch.tensor([t.app], dtype=torch.int32,
                               device=self.device)
            if self.train:
                self.key, k = prng.split(self.key)
                d, _ = mab_mod.decide_train(self.state, k[None], sla, app,
                                            coin_width=32)
            else:
                d, _ = mab_mod.decide_ucb(self.state, sla, app, self.ucb_c)
            out.append(int(d[0]))
        return out

    def feedback(self, finished):
        if not finished:
            self.state = self.state._replace(t=self.state.t + 1)
            return
        dev = self.device

        def col(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=dev)

        apps = col([t.app for t in finished], torch.int32)
        sla = col([self._norm(t) for t in finished], f32)
        resp = col([t.response_s * 40000.0 / max(t.batch, 1)
                    for t in finished], f32)
        acc = col([t.accuracy for t in finished], f32)
        dec = col([min(t.decision, 1) for t in finished], torch.int32)
        self.state = mab_mod.end_of_interval(
            self.state, apps, sla, resp, acc, dec, self.phi, self.gamma,
            self.k, fused_q=False)

    def interval_reward(self, finished):
        return interval_reward(finished)


class FixedDecider:
    def __init__(self, decision):
        self.decision = decision

    def decide(self, tasks):
        return [self.decision] * len(tasks)

    def feedback(self, finished):
        pass


class RandomDecider:
    def __init__(self, seed=0):
        self.rng = np.random.RandomState(seed)

    def decide(self, tasks):
        return list(self.rng.randint(0, 2, len(tasks)))

    def feedback(self, finished):
        pass


class GillisDecider:
    """Contextual Q-learning between layer-split and model compression,
    the hybrid the Gillis baseline uses (§2.1); ε-greedy with decay."""

    def __init__(self, seed=0, eps=0.5, lr=0.3, decay=0.995):
        self.Q = np.zeros((NUM_APPS, 2, 2))   # (app, sla_bucket, arm)
        self.rng = np.random.RandomState(seed)
        self.eps, self.lr, self.decay = eps, lr, decay

    def _ctx(self, t):
        ref = layer_ref_response_s(t.app) * t.batch / 40000.0 * 1.6
        return t.app, int(t.sla_s < ref)

    def decide(self, tasks):
        out = []
        for t in tasks:
            a, b = self._ctx(t)
            if self.rng.rand() < self.eps:
                arm = self.rng.randint(2)
            else:
                arm = int(np.argmax(self.Q[a, b]))
            out.append(LAYER if arm == 0 else COMPRESSED)
        self.eps *= self.decay
        return out

    def feedback(self, finished):
        for t in finished:
            a, b = self._ctx(t)
            arm = 0 if t.decision == LAYER else 1
            r = ((t.response_s <= t.sla_s) + t.accuracy) / 2.0
            self.Q[a, b, arm] += self.lr * (r - self.Q[a, b, arm])


# -------------------------------------------------------------- placers

class BestFitPlacer:
    """Greedy: keep existing placements; new fragments go to the worker
    maximizing a free-RAM / low-load score (no migration)."""

    def place(self, sim) -> Dict:
        n = sim.cluster.n
        ram_cap = sim.cluster.ram()
        if hasattr(sim, "fragment_store"):
            # vectorized census over the SoA store
            st = sim.fragment_store()
            F, T = st.n_fragments, st.n_tasks
            worker = st.worker[:F]
            live = ~st.done[:F]
            placedm = live & (worker >= 0)
            pw = worker[placedm]
            ram_used = np.bincount(pw, weights=st.ram_mb[:F][placedm],
                                   minlength=n)
            load = np.bincount(pw, minlength=n).astype(np.float64)
            new_rows = np.nonzero(live & (worker < 0))[0]
            tids = st.task_id[:T][st.task_of[new_rows]].tolist()
            idxs = st.frag_idx[new_rows].tolist()
            rams = st.ram_mb[new_rows].tolist()
            new = list(zip(tids, idxs, rams))
        else:
            # per-object census (``env.legacy_sim.LegacyEdgeSim``): the
            # accumulation order matches the bincount above, so the
            # outputs are identical
            ram_used = np.zeros(n)
            load = np.zeros(n)
            new = []
            for task, f in sim.containers():
                if f.worker >= 0:
                    ram_used[f.worker] += f.ram_mb
                    load[f.worker] += 1
                else:
                    new.append((task.id, f.idx, f.ram_mb))
        # already-placed fragments are left out of the assignment:
        # apply_placement defaults each fragment to its current worker
        out = {}
        if not new:
            return out
        ram_free = ram_cap - ram_used
        mips = sim.cluster.mips()
        static = 0.3 * mips / mips.max()
        # least-loaded first, prefer fast workers, require RAM
        # feasibility; the score vector is maintained incrementally (each
        # greedy admit changes only the chosen worker's entry), scalar
        # state in Python lists with NumPy mirrors for the masked argmax
        score_np = -load + static + 0.1 * ram_free / ram_cap
        ram_free_l = ram_free.tolist()
        load_l = load.tolist()
        static_l = static.tolist()
        cap_l = ram_cap.tolist()
        buf = np.empty_like(score_np)
        cur_rmb = None
        for tid, idx, ram_mb in new:
            if ram_mb != cur_rmb:
                # feasibility-masked score buffer, rebuilt only when the
                # RAM demand changes (fragments of one task share it)
                np.copyto(buf, score_np)
                buf[ram_free < ram_mb] = -1e9
                cur_rmb = ram_mb
            w = int(buf.argmax())
            out[(tid, idx)] = w
            rf = ram_free_l[w] - ram_mb
            ram_free_l[w] = rf
            ram_free[w] = rf
            ld = load_l[w] + 1.0
            load_l[w] = ld
            sc = -ld + static_l[w] + 0.1 * rf / cap_l[w]
            score_np[w] = sc
            buf[w] = sc if rf >= ram_mb else -1e9
        return out

    def feedback(self, *a, **k):
        pass


def _unflat_cells(xs):
    """A flat one-cell (leaves (1, ...)) list -> unbatched ``{"w", "b"}``
    layers."""
    return [{"w": w[0], "b": b[0]} for w, b in zip(xs[::2], xs[1::2])]


class SurrogatePlacer:
    """DASO (decision-aware) or GOBI (decision-blind) placement: gradient
    ascent through an online-finetuned FCN surrogate of O^P (eqs. 10–12).
    ``daso_theta0`` replaces the seeded θ0 (the port's tensors or the
    reference's NumPy ``{"w", "b"}`` list)."""

    def __init__(self, n_workers, decision_aware=True, seed=0,
                 max_containers=64, alpha=0.5, beta=0.5,
                 replay_cap=512, train_steps=4, device="cuda",
                 daso_theta0=None):
        self.device = resolve(device)
        self.cfg = daso_mod.DASOConfig(
            num_workers=n_workers, max_containers=max_containers,
            state_features=4, decision_aware=decision_aware)
        if daso_theta0 is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            daso_theta0 = daso_mod.init_surrogate(self.cfg, gen,
                                                  self.device)
        # one-cell θ and AdamW state: train_epoch_weighted's G=1 form
        self._theta = daso_mod.theta_cells(daso_theta0, 1, self.device)
        self._opt = daso_mod.opt_state_cells(None, self._theta, 1,
                                             self.device)
        self.alpha, self.beta = alpha, beta
        self.replay_x, self.replay_y = [], []
        self.replay_cap = replay_cap
        self.train_steps = train_steps
        self._last_x = None
        self.rng = np.random.RandomState(seed)
        self._fallback = BestFitPlacer()

    @property
    def theta(self):
        """θ as unbatched float32 ``{"w", "b"}`` layers."""
        return [{k: v[0] for k, v in layer.items()} for layer in self._theta]

    @property
    def opt_state(self):
        """The AdamW state as the reference's ``(step, m, v)`` with m and v
        unbatched ``{"w", "b"}`` layers."""
        return AdamWState(step=self._opt.step, m=_unflat_cells(self._opt.m),
                          v=_unflat_cells(self._opt.v))

    def place(self, sim: EdgeSim) -> Dict:
        dev = self.device
        conts = sim.containers()
        C = self.cfg.max_containers
        head, tail = conts[:C], conts[C:]
        state = torch.from_numpy(
            sim.state_features().astype(np.float32)).to(dev)
        W = self.cfg.num_workers
        # warm start: existing placements + BestFit for new fragments
        # (the paper's eq. 12 iterates from P_{t-1})
        warm = self._fallback.place(sim)
        logits = np.asarray(self.rng.normal(0, 0.05, (C, W)), np.float32)
        decisions = np.zeros((C,), np.int32)
        mask = np.zeros((C,), np.float32)
        for i, (task, f) in enumerate(head):
            mask[i] = 1.0
            decisions[i] = min(task.decision, 1)
            w = f.worker if f.worker >= 0 else warm.get((task.id, f.idx), -1)
            if w >= 0:
                logits[i, w] = 2.0
        p0 = torch.from_numpy(logits).to(dev)
        dec_t = torch.from_numpy(decisions).to(dev)
        mask_t = torch.from_numpy(mask).to(dev)
        if len(self.replay_x) >= daso_mod.PLACE_MIN:
            # surrogate has enough trace data: gradient-ascend placement
            with mab_mod.timed_share("ascent", dev):
                p_opt, _, _ = daso_mod.optimize_placement(
                    self.cfg, self.theta, state, p0, dec_t, mask_t)
        else:
            # cold start: keep the warm-start placement, still record data
            p_opt = p0
        assign = daso_mod.placement_to_assignment(p_opt, mask_t)
        assign = assign.cpu().numpy()
        out = {}
        for i, (task, f) in enumerate(head):
            out[(task.id, f.idx)] = int(assign[i])
        if tail:
            # container overflow (> max_containers): fall back to BestFit
            # wholesale — greedy for unplaced fragments and current
            # workers for placed ones
            out.update(self._fallback.place(sim))
            for task, f in head:
                if f.worker >= 0:
                    out[(task.id, f.idx)] = f.worker
        self._last_x = daso_mod.pack_input(self.cfg, state, p_opt, dec_t,
                                           mask_t)
        return out

    def feedback(self, o_mab, stats, sim):
        """Record O^P = O^MAB − α·AEC − β·ART and finetune (eq. 11)."""
        if self._last_x is None:
            return
        aec = float(np.mean(stats.cpu_util))
        if stats.finished:
            art = float(np.mean([t.response_s for t in stats.finished])
                        / (6 * sim.interval_s))
        else:
            art = 0.0
        y = o_mab - self.alpha * aec - self.beta * min(art, 1.0)
        self.replay_x.append(self._last_x)
        self.replay_y.append(y)
        if len(self.replay_x) > self.replay_cap:
            self.replay_x.pop(0)
            self.replay_y.pop(0)
        if len(self.replay_x) >= daso_mod.TRAIN_MIN:
            # the newest REPLAY_WINDOW records, zero-weight padded to a
            # fixed window (one grid cell of train_epoch_weighted)
            R = daso_mod.REPLAY_WINDOW
            win_x = self.replay_x[-R:]
            k = len(win_x)
            dev = self.device
            xs = torch.zeros((1, R) + tuple(win_x[0].shape), dtype=f32,
                             device=dev)
            xs[0, :k] = torch.stack(win_x)
            ys_np = np.zeros((1, R), np.float32)
            ys_np[0, :k] = self.replay_y[-R:]
            w_np = np.zeros((1, R), np.float32)
            w_np[0, :k] = 1.0
            ys = torch.from_numpy(ys_np).to(dev)
            w = torch.from_numpy(w_np).to(dev)
            with mab_mod.timed_share("daso_train", dev):
                for _ in range(self.train_steps):
                    self._theta, self._opt, _ = \
                        daso_mod.train_epoch_weighted(
                            self.cfg, self._theta, self._opt, xs, ys, w)


# -------------------------------------------------------------- policies


def make_policy(name: str, n_workers: int, seed: int = 0,
                mab_state=None, train=False, device="cuda",
                daso_theta0=None) -> Policy:
    """One Table-4 row by name; its learners live on ``device``.
    ``daso_theta0`` seeds the surrogate placers' θ (see
    ``SurrogatePlacer``)."""
    def mk_mab():
        return MABDecider(seed=seed, train=train, state=mab_state,
                          device=device)

    def surrogate(aware):
        return SurrogatePlacer(n_workers, aware, seed, device=device,
                               daso_theta0=daso_theta0)

    table = {
        "splitplace": lambda: Policy("MAB+DASO", mk_mab(), surrogate(True)),
        "mab+gobi": lambda: Policy("MAB+GOBI", mk_mab(), surrogate(False)),
        "semantic+gobi": lambda: Policy("Semantic+GOBI",
                                        FixedDecider(SEMANTIC),
                                        surrogate(False)),
        "layer+gobi": lambda: Policy("Layer+GOBI", FixedDecider(LAYER),
                                     surrogate(False)),
        "random+daso": lambda: Policy("Random+DASO", RandomDecider(seed),
                                      surrogate(True)),
        "gillis": lambda: Policy("Gillis", GillisDecider(seed),
                                 BestFitPlacer()),
        "mc": lambda: Policy("MC", FixedDecider(COMPRESSED),
                             BestFitPlacer()),
    }
    return table[name]()


def run_experiment(policy_name: str, n_intervals: int = 100, lam: float = 6.0,
                   seed: int = 0, mab_state=None, train: bool = False,
                   cluster=None, apps=None, interval_s: float = 300.0,
                   substeps: int = 30, policy=None, device="cuda") -> dict:
    """Run one execution trace on the host simulator; returns the §6.4
    metric summary.  A thin wrapper over
    ``repro_torch.launch.experiments.run_trace``; pass ``policy`` to
    continue a pre-trained policy object."""
    from repro_torch.launch.experiments import run_trace
    return run_trace(policy_name, n_intervals=n_intervals, lam=lam,
                     seed=seed, mab_state=mab_state, train=train,
                     cluster=cluster, apps=apps, interval_s=interval_s,
                     substeps=substeps, policy=policy, device=device)


def pretrain_mab(n_intervals: int = 200, lam: float = 6.0, seed: int = 0,
                 substeps: int = 30, device="cuda"):
    """Paper §6.3: 200 intervals of feedback-based ε-greedy training."""
    res = run_experiment("splitplace", n_intervals, lam, seed, train=True,
                         substeps=substeps, device=device)
    return res["mab_state"], res
