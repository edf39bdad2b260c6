"""SLA-aware serving engine: SplitPlace's MAB policy driving real plan
selection over batched requests.

The port of ``repro.serving.engine``.  Per request:
  1. context = deadline vs the EMA estimate of the layer-pipeline latency
     (eq. 2 semantics, measured wall clock);
  2. the MAB (UCB at serve time) picks layer_pipeline or semantic_branch;
  3. DASO places the plan's fragments on device slices given their
     queue depths;
  4. the plan executes (really: ``pipeline_forward`` / ``branch_forward``);
  5. the monolithic forward gives the fidelity reference;
  6. reward couples deadline satisfaction with fidelity (agreement of the
     plan's argmax tokens with the monolithic forward, over the last axis
     of the logits: per codebook under codebooks), eqs. 3–5, and feeds
     Algorithm 1 and DASO's replay.

A request carries its tokens and, for the families that read them, the
batch's other entries (``Request.extras``: musicgen's ``cond``,
qwen2-vl's ``visual_embeds``, ``visual_mask`` and ``positions3``), which
go to both plans and the monolithic forward alike.  Everything runs on
``device`` (CUDA by default), for every model the port runs: the
hand-written kernels on the card, their eager twins on the CPU.  Timing synchronizes the
card where the reference calls ``block_until_ready``.

Under a recording ledger (``repro_torch.obs.use_ledger``) each request is
one ``engine.serve`` span whose children are, in order,
``engine.upload`` (``batch``), ``engine.decide`` (the UCB decision and
its read), ``engine.place`` (DASO's placement), ``engine.plan`` (``_run``;
its ``engine.plan.stage`` / ``engine.plan.branch`` spans come from
``serving/plans``), ``engine.mono``, ``engine.fidelity``,
``engine.update`` (Algorithm 1's bookkeeping) and, on the requests that
train DASO, ``engine.daso_train``.  The place, mono, update and train
spans synchronize the card at their end while recording, so that each
holds its own device work; ``_run`` synchronizes by itself.  Counters:
``engine.h2d_bytes`` (what ``_tensor`` and ``batch`` upload),
``host.waits`` (``repro_torch.obs.HOST_WAITS``: each upload, read and
synchronize, counted where it happens, here and in core/mab and
core/daso), and core/daso's ``daso.ascent_steps`` and
``daso.train_epochs``.  Off recording no span reads a clock or
synchronizes, and nothing the engine decides depends on whether it
records.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch.core import daso as daso_mod
from repro_torch.core import mab as mab_mod
from repro_torch.device import resolve
from repro_torch.models.model import forward
from repro_torch.obs import HOST_WAITS, get_ledger
from repro_torch.serving.plans import (LAYER_PLAN, SEMANTIC_PLAN, PlanSpec,
                                       branch_forward, optimal_stage_bounds,
                                       pipeline_forward)

f32 = torch.float32


@dataclasses.dataclass
class Request:
    tokens: np.ndarray          # (b, s), or (b, s, cb) under codebooks
    deadline_s: float
    app: int = 0
    extras: dict = None         # other batch entries, NumPy arrays


@dataclasses.dataclass
class ServeResult:
    plan: int
    latency_s: float
    fidelity: float             # argmax agreement with monolithic forward
    met_deadline: bool
    reward: float


class SplitPlaceEngine:
    def __init__(self, params, cfg, num_stages=2, num_branches=2,
                 phi=0.9, gamma=0.3, ucb_c=0.5, seed=0, num_slices=4,
                 device="cuda"):
        self.device = resolve(device)
        self.params = params
        self.cfg = cfg
        self.layer_plan = PlanSpec(LAYER_PLAN, num_stages=num_stages)
        self.sem_plan = PlanSpec(SEMANTIC_PLAN, num_branches=num_branches)
        self.state = mab_mod.init_state(num_apps=1, device=self.device)
        self.phi, self.gamma, self.ucb_c = phi, gamma, ucb_c
        self._stage_bounds = optimal_stage_bounds(cfg, seq=256, batch=1,
                                                  num_stages=num_stages)
        # DASO fragment->device-slice placement (the paper's placement
        # sub-problem): per-slice queue depth is the state; fragments are
        # pipeline stages or semantic branches
        self.num_slices = num_slices
        max_frag = max(num_stages, num_branches)
        self._daso_cfg = daso_mod.DASOConfig(
            num_workers=num_slices, max_containers=max_frag,
            state_features=1, hidden=32, depth=2, place_iters=25,
            lr_place=0.2)
        self._theta, self._daso_opt = daso_mod.make_trainer(
            self._daso_cfg, torch.Generator().manual_seed(seed),
            self.device)
        self.slice_load = np.zeros(num_slices)
        self._replay = []

    def _pipe(self, batch):
        return pipeline_forward(self.params, batch, self.cfg,
                                self.layer_plan.num_stages,
                                bounds=self._stage_bounds)

    def _branch(self, batch):
        return branch_forward(self.params, batch, self.cfg,
                              self.sem_plan.num_branches)

    def _mono(self, batch):
        return forward(self.params, batch, self.cfg)

    def _sync(self):
        get_ledger().count(HOST_WAITS)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a, dtype=None):
        """``a`` on the engine's device: a blocking upload."""
        t = torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)
        led = get_ledger()
        led.count(HOST_WAITS)
        led.count("engine.h2d_bytes", t.numel() * t.element_size())
        return t

    @staticmethod
    def _read(t):
        """``t`` on the host: the host waits for the card."""
        get_ledger().count(HOST_WAITS)
        return t.cpu()

    def batch(self, tokens, extras=None):
        """A model batch on the engine's device: int32 ``tokens`` and the
        ``extras`` entries, each in its own dtype."""
        b = {k: self._tensor(v) for k, v in (extras or {}).items()}
        b["tokens"] = self._tensor(tokens, torch.int32)
        return b

    def place_fragments(self, plan: int):
        """DASO placement of the plan's fragments onto device slices given
        the current per-slice queue depths; returns (assignment,
        queue_cost, packed DASO input)."""
        n = (self.layer_plan.num_stages if plan == LAYER_PLAN
             else self.sem_plan.num_branches)
        C = self._daso_cfg.max_containers
        mask = np.zeros(C, np.float32)
        mask[:n] = 1.0
        decisions = np.full(C, plan, np.int32)
        logits = np.zeros((C, self.num_slices), np.float32)
        # warm start: least-loaded slices
        order = np.argsort(self.slice_load)
        for i in range(n):
            logits[i, order[i % self.num_slices]] = 2.0
        state = self._tensor(self.slice_load[:, None] / 4.0, f32)
        mask_t = self._tensor(mask, f32)
        dec_t = self._tensor(decisions, torch.int32)
        if len(self._replay) >= 16:
            p_opt, _, _ = daso_mod.optimize_placement(
                self._daso_cfg, self._theta, state, self._tensor(logits, f32),
                dec_t, mask_t)
        else:
            p_opt = self._tensor(logits, f32)
        assign = self._read(daso_mod.placement_to_assignment(
            p_opt, mask_t)).numpy()[:n]
        if plan == LAYER_PLAN:
            # sequential stages: queue cost = sum of per-stage waits
            qcost = float(sum(self.slice_load[a] for a in assign))
        else:
            # parallel branches: straggler = max wait
            qcost = float(max(self.slice_load[a] for a in assign))
        for a in assign:
            self.slice_load[a] += 1.0
        self.slice_load *= 0.8                     # queues drain
        x = self._read(daso_mod.pack_input(self._daso_cfg, state, p_opt,
                                           dec_t, mask_t)).numpy()
        return assign, qcost, x

    def _daso_feedback(self, x, reward):
        self._replay.append((x, reward))
        if len(self._replay) >= 16 and len(self._replay) % 4 == 0:
            with get_ledger().span("engine.daso_train", sync=self.device):
                xs = self._tensor(
                    np.stack([r[0] for r in self._replay[-64:]]), f32)
                ys = self._tensor(np.array(
                    [r[1] for r in self._replay[-64:]], np.float32), f32)
                for _ in range(2):
                    self._theta, self._daso_opt, _ = daso_mod.train_epoch(
                        self._daso_cfg, self._theta, self._daso_opt, xs, ys)

    def warmup(self, tokens, extras=None):
        b = self.batch(tokens, extras)
        with torch.no_grad():
            self._pipe(b)
            self._branch(b)
            self._mono(b)
        self._sync()

    def _run(self, plan_kind: int, batch) -> tuple:
        """Run one plan; returns (logits, wall seconds).

        The semantic plan's wall time is divided by the branch count, as
        the reference does: the plan stands for B branches on B disjoint
        device slices running in parallel, and one card, like the
        reference's CPU, runs them one after another.  Keeping the
        division keeps the latency the MAB trades against fidelity the
        one the reference's engine sees.
        """
        fn = self._pipe if plan_kind == LAYER_PLAN else self._branch
        self._sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = fn(batch)
        self._sync()
        wall = time.perf_counter() - t0
        if plan_kind != LAYER_PLAN:
            wall /= self.sem_plan.num_branches
        return logits, wall

    def serve(self, req: Request) -> ServeResult:
        led = get_ledger()
        dev = self.device
        with led.span("engine.serve"):
            with led.span("engine.upload"):
                batch = self.batch(req.tokens, req.extras)
            with led.span("engine.decide"):
                d, _ = mab_mod.decide_ucb(
                    self.state, self._tensor([req.deadline_s], f32),
                    self._tensor([req.app], torch.int32), self.ucb_c)
                # 0=LAYER(pipeline) 1=SEMANTIC(branch)
                plan = int(self._read(d[0]))
            with led.span("engine.place", sync=dev):
                assign, qcost, daso_x = self.place_fragments(plan)
            with led.span("engine.plan", kind="layer" if plan == LAYER_PLAN
                          else "semantic"):
                logits, latency = self._run(plan, batch)
            latency = latency * (1.0 + 0.25 * qcost)  # queueing on slices
            with led.span("engine.mono", sync=dev):
                with torch.no_grad():
                    ref = self._mono(batch)
            with led.span("engine.fidelity"):
                fid = float(self._read((torch.argmax(logits, -1)
                                        == torch.argmax(ref, -1))
                                       .to(f32).mean()))
            met = latency <= req.deadline_s
            reward = 0.5 * (float(met) + fid)
            # Algorithm-1 bookkeeping (single leaving task)
            with led.span("engine.update", sync=dev):
                self.state = mab_mod.end_of_interval(
                    self.state,
                    self._tensor([req.app], torch.int32),
                    self._tensor([req.deadline_s], f32),
                    self._tensor([latency], f32),
                    self._tensor([fid], f32),
                    self._tensor([plan], torch.int32),
                    self.phi, self.gamma)
            self._daso_feedback(daso_x, reward)
        return ServeResult(plan, latency, fid, met, reward)

    def serve_many(self, reqs: List[Request]) -> List[ServeResult]:
        return [self.serve(r) for r in reqs]
