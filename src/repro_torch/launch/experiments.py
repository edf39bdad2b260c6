"""Experiment runner of the port — traces, the §6.3 pretraining pass and
(policy × seed × λ) grids over the edge simulator.

The port of ``repro.launch.experiments``.  Table 4 is one call:

    run_grid(POLICIES, seeds=(0, 1, 2), lams=(6.0,), n_intervals=100,
             substeps=10, pretrain_intervals=200, backend="torch")
    aggregate(records, by=("policy",))

Two simulator backends:

  * ``backend="soa"`` — the host interval loop (``run_trace``): the NumPy
    ``EdgeSim`` over the structure-of-arrays store with the host policy
    objects of ``repro_torch.core.splitplace``, whose learners (MAB state,
    DASO θ) live on ``device``.  It is the §6.3 pretraining substrate;
  * ``backend="torch"`` — the batched interval program
    (``repro_torch.env.torchsim``) with its hand-written CUDA kernels on
    ``device``: ``run_grid_batched`` runs a whole (seed × λ) grid of one
    policy as one program.  It takes the static BestFit policies, the MAB
    policies ``"mab"``, ``"splitplace"`` and ``"mab+gobi"`` in
    ``mode="deploy"`` (UCB) and ``mode="train"`` (ε-greedy decisions and
    online DASO finetuning), the Gillis baseline and the static-decider
    DASO arms ``"layer+gobi"``, ``"semantic+gobi"`` and ``"random+daso"``.

``run_stream`` is the always-on serving run
(``repro_torch.env.torchsim.stream``): Poisson arrivals streamed through
the chunked interval program until a task budget is offered.

``pretrain`` returns a ``PretrainState`` whose products feed either
backend and the stream as they are.  Every entry point runs on
``device="cuda"`` unless the caller asks for the CPU, and raises when CUDA
is asked for and absent.
"""
from __future__ import annotations

import itertools
from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence)

import numpy as np

from repro_torch.core import mab as mab_mod
from repro_torch.core import splitplace as sp
from repro_torch.core.policies import Policy
from repro_torch.device import resolve
from repro_torch.env import torchsim
from repro_torch.env.cluster import FLEET_SPEC, make_cluster
from repro_torch.env.metrics import TELEMETRY_COLS, MetricsAccumulator
from repro_torch.env.simulator import EdgeSim
from repro_torch.env.torchsim.driver import MAB_HP, TRAIN_HP, PhaseClock
from repro_torch.env.workload import COMPRESSED, LAYER

#: policies whose host decider consumes a pretrained MAB state
MAB_STATE_POLICIES = ("splitplace", "mab+gobi", "mab")

#: policies of the reference not ported yet, with the ROADMAP queue-1
#: item that brings each (none is left)
NOT_PORTED: dict = {}

_SCALARS = (int, float)


class PretrainState(NamedTuple):
    """Everything the §6.3 pretraining pass produces.

    ``mab_state`` (a one-cell ``mab.MABState`` on the pretraining device)
    seeds both the host deciders and the interval program's MAB;
    ``daso_theta``/``daso_cfg`` are the trained placement surrogate (θ as
    unbatched float32 ``{"w", "b"}`` layers) and ``daso_opt_state`` the
    AdamW state the pass ended on, so ``mode="train"`` grids continue its
    optimizer trajectory; ``gillis_policy`` is the continued Gillis
    baseline object (host backend only).  Fields are ``None`` when the
    requested policy set doesn't need them."""
    mab_state: Optional[object] = None
    gillis_policy: Optional[object] = None
    daso_theta: Optional[object] = None
    daso_cfg: Optional[object] = None
    daso_opt_state: Optional[object] = None


def _record(pol: str, seed: int, lam: float, summary: dict) -> dict:
    rec = {"policy": pol, "seed": seed, "lam": lam}
    rec.update({k: float(v) for k, v in summary.items()
                if isinstance(v, _SCALARS) and not isinstance(v, bool)})
    return rec


def _run_torch(policy: str, cells, *, n_intervals, substeps, interval_s,
               apps=None, cluster=None, mab_state=None, seed_offset=0,
               max_active=None, daso_theta=None, daso_cfg=None, mab_hp=None,
               mode="deploy", train_hp=None, gillis_state=None,
               daso_opt_state=None, device="cuda", phase_s=None,
               telemetry="summary", threads=None, devices=None) -> list:
    """One batched interval program for ``policy`` over the (λ, seed)
    ``cells``; one summary dict per cell (see ``run_grid_batched``)."""
    if mode not in ("deploy", "train"):
        raise ValueError(f"unknown mode {mode!r}")

    def dual(**kw):
        return [torchsim.compile_trace_dual(
            lam=lam, seed=seed + seed_offset, n_intervals=n_intervals,
            interval_s=interval_s, substeps=substeps, apps=apps,
            cluster=cluster, **kw) for lam, seed in cells]

    run_kw = dict(cluster=cluster, max_active=max_active, device=device,
                  phase_s=phase_s, telemetry=telemetry, threads=threads,
                  devices=devices)
    if policy == "gillis":
        return torchsim.run_grid_arrays_gillis(
            dual(variants=(LAYER, COMPRESSED)), gillis_state, **run_kw)
    if policy in torchsim.STATIC_DASO_ARMS:
        if daso_theta is None or daso_cfg is None:
            raise ValueError(f"policy {policy!r} needs daso_theta/daso_cfg "
                             "(see pretrain())")
        return torchsim.run_grid_arrays_static_daso(
            dual(), policy, daso_theta=daso_theta, daso_cfg=daso_cfg,
            **run_kw)
    if policy in torchsim.MAB_LEARNED_POLICIES:
        if mab_state is None:
            raise ValueError(f"policy {policy!r} needs a pretrained "
                             "mab_state (see pretrain())")
        use_daso = policy in torchsim.DASO_LEARNED_POLICIES
        if use_daso and (daso_theta is None or daso_cfg is None):
            raise ValueError(f"policy {policy!r} needs daso_theta/daso_cfg "
                             "(see pretrain())")
        cfg = daso_cfg._replace(decision_aware=False) \
            if policy == "mab+gobi" else daso_cfg
        daso_kw = dict(daso_theta=daso_theta if use_daso else None,
                       daso_cfg=cfg if use_daso else None,
                       mab_hp=tuple(mab_hp or MAB_HP))
        if mode == "train":
            return torchsim.run_grid_arrays_trained(
                dual(), mab_state,
                daso_opt_state=daso_opt_state if use_daso else None,
                train_hp=tuple(train_hp or TRAIN_HP), **daso_kw, **run_kw)
        return torchsim.run_grid_arrays_learned(dual(), mab_state,
                                                **daso_kw, **run_kw)
    if mode == "train":
        raise ValueError(f"policy {policy!r} is static — mode='train' "
                         f"needs a learned policy "
                         f"({torchsim.LEARNED_POLICIES})")
    dec = torchsim.make_static_decider(policy, mab_state=mab_state)
    traces = [torchsim.compile_trace(
        dec, lam=lam, seed=seed + seed_offset, n_intervals=n_intervals,
        interval_s=interval_s, substeps=substeps, apps=apps,
        cluster=cluster) for lam, seed in cells]
    return torchsim.run_grid_arrays(traces, **run_kw)


def run_trace(policy_name: Optional[str] = None, n_intervals: int = 100,
              lam: float = 6.0, seed: int = 0, mab_state=None,
              train: bool = False, cluster=None, apps=None,
              interval_s: float = 300.0, substeps: int = 30,
              policy: Optional[Policy] = None,
              backend: str = "soa", daso_theta=None, daso_cfg=None,
              daso_opt_state=None, mode: str = "deploy",
              telemetry: str = "summary", device="cuda",
              daso_theta0=None, phase_s: Optional[dict] = None) -> dict:
    """Run one execution trace on ``device``; returns the §6.4 metric
    summary.

    ``backend="soa"`` runs the host interval loop (Algorithm 1) with the
    policy object ``make_policy`` builds for ``policy_name`` (its learners
    on ``device``; ``daso_theta0`` seeds its surrogate placers' θ), or
    continues ``policy`` (used to pretrain the Gillis baseline's
    Q-learner).  ``mode="train"`` is the ε-greedy training flag there
    (same as ``train=True``).  The summary gains ``policy_obj`` and, for
    a MAB decider, ``mab_state``.  ``telemetry="interval"`` records the
    per-interval series: on the host loop the ``TELEMETRY_COLS`` and exact
    response/wait percentiles; on the interval program the engine's
    columns too, recorded on the device, and percentiles binned from the
    series within ``percentile_err_s``.

    ``backend="torch"`` compiles the workload and runs the batched
    interval program with one cell (see ``run_grid_batched`` for the
    policies, ``mode`` and the pretraining products each takes).

    ``phase_s`` collects wall seconds (the device synchronized at every
    boundary): on the host loop ``decide``, ``place`` (the surrogate's
    ``ascent`` a share of it), ``physics`` (placement repair and the
    interval's advance) and ``feedback`` (the finetune's ``daso_train``
    and the MAB's ``mab_host_read`` shares of it); on the interval
    program its ``driver.PHASES``."""
    if mode not in ("deploy", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    if telemetry not in ("summary", "interval"):
        raise ValueError(f"telemetry={telemetry!r} "
                         "(want 'summary' or 'interval')")
    dev = resolve(device)
    if backend == "torch":
        if policy is not None or train:
            raise ValueError("backend='torch' takes policy names only (no "
                             "policy objects; ε-greedy training is "
                             "mode='train' on the learned policies)")
        out = _run_torch(policy_name, [(lam, seed)],
                         n_intervals=n_intervals, substeps=substeps,
                         interval_s=interval_s, apps=apps, cluster=cluster,
                         mab_state=mab_state, daso_theta=daso_theta,
                         daso_cfg=daso_cfg, mode=mode,
                         daso_opt_state=daso_opt_state, device=dev,
                         phase_s=phase_s, telemetry=telemetry)[0]
        out["policy"] = policy_name
        return out
    if backend != "soa":
        raise ValueError(f"unknown backend {backend!r}")
    tel = telemetry == "interval"
    train = train or mode == "train"
    sim = EdgeSim(cluster=cluster, lam=lam, seed=seed, apps=apps,
                  interval_s=interval_s, substeps=substeps)
    policy = policy or sp.make_policy(policy_name, sim.cluster.n, seed=seed,
                                      mab_state=mab_state, train=train,
                                      device=dev, daso_theta0=daso_theta0)
    acc = MetricsAccumulator(interval_s=interval_s, telemetry=tel)
    surrogate = isinstance(policy.placer, sp.SurrogatePlacer)
    clock = PhaseClock(phase_s, dev)
    with mab_mod.timed_host_reads(phase_s):
        for _ in range(n_intervals):
            tasks = sim.new_interval_tasks()
            decisions = policy.decider.decide(tasks)
            clock.lap("decide")
            sim.admit(tasks, decisions)
            assignment = policy.placer.place(sim)
            clock.lap("place")
            sim.apply_placement(assignment)
            stats = sim.advance()
            clock.lap("physics")
            policy.decider.feedback(stats.finished)
            if surrogate:
                policy.placer.feedback(sp.interval_reward(stats.finished),
                                       stats, sim)
            acc.update(stats)
            clock.lap("feedback")
    out = acc.summary()
    if tel:
        # the host loop keeps every finished task, so the percentiles are
        # exact and the series carries the base columns only
        out.update(acc.percentiles())
        out["percentile_err_s"] = 0.0
        out["telemetry"] = {"cols": list(TELEMETRY_COLS),
                            "series": acc.telemetry_series()}
    out["policy"] = policy.name
    out["policy_obj"] = policy
    if isinstance(policy.decider, sp.MABDecider):
        out["mab_state"] = policy.decider.state
    return out


def pretrain(n_intervals: int, lam: float = 6.0, seed: int = 7,
             substeps: int = 30, interval_s: float = 300.0,
             policies: Sequence[str] = ("splitplace",), device="cuda",
             daso_theta0=None,
             phase_s: Optional[dict] = None) -> PretrainState:
    """§6.3 pretraining pass on the host loop: feedback-based ε-greedy MAB
    training with DASO online finetuning (and, when 'gillis' is requested,
    the Gillis Q-learner on the same budget).  Returns a
    ``PretrainState`` whose fields are None when not requested.

    The learners run on ``device``; ``daso_theta0`` replaces the
    surrogate's seeded θ0 (so two devices can start from one θ0);
    ``phase_s`` collects the splitplace trace's phases (``run_trace``)."""
    dev = resolve(device)
    out = PretrainState()
    if any(p in MAB_STATE_POLICIES for p in policies):
        r = run_trace("splitplace", n_intervals=n_intervals, lam=lam,
                      seed=seed, train=True, substeps=substeps,
                      interval_s=interval_s, device=dev,
                      daso_theta0=daso_theta0, phase_s=phase_s)
        placer = r["policy_obj"].placer
        out = out._replace(mab_state=r["mab_state"],
                           daso_theta=placer.theta, daso_cfg=placer.cfg,
                           daso_opt_state=placer.opt_state)
    if "gillis" in policies:
        r = run_trace("gillis", n_intervals=n_intervals, lam=lam, seed=seed,
                      substeps=substeps, interval_s=interval_s, device=dev)
        out = out._replace(gillis_policy=r["policy_obj"])
    return out


def _pretrained(pretrain_state, mab_state, daso_theta, daso_cfg,
                daso_opt_state):
    """Explicit products win over ``pretrain_state``'s."""
    if pretrain_state is None:
        return mab_state, daso_theta, daso_cfg, daso_opt_state
    pick = lambda a, b: a if a is not None else b       # noqa: E731
    return (pick(mab_state, pretrain_state.mab_state),
            pick(daso_theta, pretrain_state.daso_theta),
            pick(daso_cfg, pretrain_state.daso_cfg),
            pick(daso_opt_state, pretrain_state.daso_opt_state))


def run_grid_batched(policy: str = "mc", seeds: Sequence[int] = (0,),
                     lams: Sequence[float] = (6.0,), n_intervals: int = 100,
                     substeps: int = 30, interval_s: float = 300.0,
                     apps=None, cluster=None, mab_state=None, seed_offset=0,
                     max_active: Optional[int] = None,
                     pretrain_state: Optional[PretrainState] = None,
                     daso_theta=None, daso_cfg=None, mab_hp=None,
                     mode: str = "deploy", train_hp=None, gillis_state=None,
                     daso_opt_state=None, device="cuda",
                     telemetry: str = "summary",
                     phase_s: Optional[dict] = None,
                     threads: Optional[int] = None,
                     devices=None) -> List[dict]:
    """Run a whole (seed × λ) grid for one policy as ONE batched interval
    program on ``device``; one record per trace, in
    ``itertools.product(lams, seeds)`` order.  ``threads=n`` runs it as n
    contiguous chunks from a thread each, ``devices`` (``"auto"``, an int
    or a list of devices) sharded one slice per device
    (``torchsim.run_grid_engine``); the default is the one call, where
    the reference defaults to one chunk per CPU core.

    Static policies (``torchsim.STATIC_POLICIES``) compile single-variant
    traces.  The MAB policies (``torchsim.MAB_LEARNED_POLICIES``) compile
    dual traces and carry one copy of ``mab_state`` per cell; ``"mab"``
    places with BestFit, ``"splitplace"`` with the DASO stage ascending
    ``daso_theta`` under ``daso_cfg``, ``"mab+gobi"`` with the same cfg
    made decision-blind.  ``mode="deploy"`` decides by UCB;
    ``mode="train"`` runs the §6.3 training loop: ε-greedy decisions and,
    for the surrogate placers, online finetuning of a per-cell copy of θ
    (from ``daso_opt_state``'s AdamW moments, or fresh ones) under
    ``train_hp`` (default ``driver.TRAIN_HP``).  ``"gillis"`` compiles
    (LAYER, COMPRESSED) dual traces and learns its Q-table in the loop
    from ``gillis_state`` (zeros and ε₀ when None); it is online in either
    mode.  ``"layer+gobi"`` / ``"semantic+gobi"`` fix the split and
    ``"random+daso"`` draws it per row, each placed by the DASO stage; they
    need θ and cfg but no ``mab_state``, and ignore ``mode``.  Pass the
    pretraining products as ``pretrain_state`` (the ``pretrain()``
    result) or as the individual fields (which win).  ``phase_s``
    collects the wall seconds of the program's phases (see
    ``driver.PHASES``).  Records report ``dropped_tasks`` (0 unless
    ``max_active`` was forced too small).  ``telemetry="interval"`` runs
    the program with its per-interval series; the records keep only its
    scalar percentile fields (``_record`` drops the series: call the
    ``torchsim.run_grid_arrays*`` functions for it)."""
    mab_state, daso_theta, daso_cfg, daso_opt_state = _pretrained(
        pretrain_state, mab_state, daso_theta, daso_cfg, daso_opt_state)
    cells = list(itertools.product(lams, seeds))
    outs = _run_torch(policy, cells, n_intervals=n_intervals,
                      substeps=substeps, interval_s=interval_s, apps=apps,
                      cluster=cluster, mab_state=mab_state,
                      seed_offset=seed_offset, max_active=max_active,
                      daso_theta=daso_theta, daso_cfg=daso_cfg,
                      mab_hp=mab_hp, mode=mode, train_hp=train_hp,
                      gillis_state=gillis_state,
                      daso_opt_state=daso_opt_state, device=device,
                      phase_s=phase_s, telemetry=telemetry, threads=threads,
                      devices=devices)
    return [_record(policy, seed, lam, out)
            for (lam, seed), out in zip(cells, outs)]


def run_stream(policy: str = "mc", lam: float = 6.0, seed: int = 0,
               target_tasks: int = 10_000, chunk_intervals: int = 64,
               max_active: int = 512, interval_s: float = 300.0,
               substeps: int = 30, window_intervals: int = 256,
               apps=None, cluster=None,
               pretrain_state: Optional[PretrainState] = None,
               mab_state=None, daso_theta=None, daso_cfg=None,
               gillis_state=None, max_arrivals: Optional[int] = None,
               prefetch: int = 2, on_chunk: Optional[Callable] = None,
               device="cuda") -> dict:
    """The always-on serving run: stream Poisson arrivals through the
    chunked interval program on ``device`` until ``target_tasks`` tasks
    have been offered (``torchsim.stream.serve``); a host feeder thread
    fills the next chunk's tape while the current one runs.

    Takes ``run_grid_batched``'s policy names and pretraining products
    (the static BestFit policies run a host decider feeder; ``"mab"`` /
    ``"splitplace"`` / ``"mab+gobi"`` / ``"gillis"`` serve their in-loop
    engines, continuing ``pretrain_state`` when given and starting cold
    otherwise).  Returns the serving report (admission ledger, ring
    occupancy, rolling-window QPS / percentiles / violation rate, the
    cumulative §6.4 summary) with ``policy``, ``lam`` and ``seed``.  The
    reference's ``substep_impl`` has no counterpart: the substep physics
    is always ``repro_torch.kernels.edge_substep``'s dispatcher."""
    dev = resolve(device)
    cluster = cluster or make_cluster()
    mab_state, daso_theta, daso_cfg, _ = _pretrained(
        pretrain_state, mab_state, daso_theta, daso_cfg, None)
    engine, es0, feeder_kw = torchsim.stream.make_stream_policy(
        policy, cluster=cluster, seed=seed, mab_state=mab_state,
        daso_theta=daso_theta, daso_cfg=daso_cfg,
        gillis_state=gillis_state)
    feeder = torchsim.stream.StreamFeeder(
        lam=lam, seed=seed, interval_s=interval_s, substeps=substeps,
        cluster=cluster, apps=apps, max_arrivals=max_arrivals, **feeder_kw)
    rep = torchsim.stream.serve(
        engine, es0, feeder, chunk_intervals=chunk_intervals,
        max_active=max_active, target_tasks=target_tasks,
        window_intervals=window_intervals, prefetch=prefetch,
        on_chunk=on_chunk, device=dev)
    rep.update(policy=policy, lam=lam, seed=seed)
    return rep


def run_grid(policies: Sequence[str], seeds: Sequence[int] = (0,),
             lams: Sequence[float] = (6.0,), n_intervals: int = 100,
             substeps: int = 30, interval_s: float = 300.0, apps=None,
             cluster_factory: Optional[Callable[[], object]] = None,
             pretrain_intervals: int = 0, pretrain_lam: Optional[float] = None,
             pretrain_seed: int = 7, mab_state=None, gillis_policy=None,
             progress: Optional[Callable[[str], None]] = None,
             backend: str = "soa", daso_theta=None,
             daso_cfg=None, daso_opt_state=None,
             mode: str = "deploy", device="cuda") -> List[dict]:
    """Run the full (λ × policy × seed) grid on ``device``; one record per
    trace, in ``itertools.product(lams, policies, seeds)`` order.

    ``pretrain_intervals > 0`` runs the shared §6.3 pretraining pass once
    for the whole grid (skipped for strategies that don't consume it, or
    whose products were passed in).  A fresh cluster comes from
    ``cluster_factory`` per trace (default: the Table 3 50-worker fleet).

    ``backend="soa"`` runs each cell on the host loop; the Gillis policy
    object (``gillis_policy``, or the pretraining pass's) is continued
    across its grid cells, and the DASO placers start from their seeded
    θ0 in every cell, as in the reference.  ``backend="torch"`` routes
    every policy through ``run_grid_batched`` — one batched program per
    policy — with the pretraining products (``mab_state`` and the DASO
    θ, cfg and AdamW state); its Gillis cells start fresh in every grid.
    ``mode="train"`` selects the training loop of the learned policies
    (the host decider's ε-greedy flag on ``backend="soa"``)."""
    if mode not in ("deploy", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = resolve(device)
    pre_lam = pretrain_lam if pretrain_lam is not None else lams[0]
    if backend == "torch":
        # pretrain only for what the requested policies consume: the MAB
        # policies need mab_state, the surrogate placers the DASO products
        # and the interval program's Gillis baseline nothing
        needs_mab = any(p in torchsim.MAB_LEARNED_POLICIES
                        for p in policies) and mab_state is None
        needs_daso = any(p in torchsim.DASO_LEARNED_POLICIES
                         or p in torchsim.STATIC_DASO_ARMS
                         for p in policies) and daso_theta is None
        if pretrain_intervals and (needs_mab or needs_daso):
            pre = pretrain(pretrain_intervals, lam=pre_lam,
                           seed=pretrain_seed, substeps=substeps,
                           interval_s=interval_s, device=dev)
            mab_state, daso_theta, daso_cfg, daso_opt_state = _pretrained(
                pre, mab_state, daso_theta, daso_cfg, daso_opt_state)
        records = []
        for pol in policies:
            # mode applies to the learned policies only: static ones run
            # in deploy form, as train=True is a no-op for them on the
            # host loop
            records += run_grid_batched(
                pol, seeds=seeds, lams=lams, n_intervals=n_intervals,
                substeps=substeps, interval_s=interval_s, apps=apps,
                cluster=cluster_factory() if cluster_factory else None,
                mab_state=mab_state, daso_theta=daso_theta,
                daso_cfg=daso_cfg, daso_opt_state=daso_opt_state,
                mode=mode if pol in torchsim.LEARNED_POLICIES else "deploy",
                device=dev)
        # per-policy batches are (λ, seed); reorder to (λ, policy, seed)
        by_cell = {(r["lam"], r["policy"], r["seed"]): r for r in records}
        records = [by_cell[(lam, pol, seed)]
                   for lam, pol, seed in itertools.product(lams, policies,
                                                           seeds)]
        if progress:
            for rec in records:
                progress(f"lam={rec['lam']:g} {rec['policy']:15s} "
                         f"seed={rec['seed']} reward={rec['reward']:.4f} "
                         f"viol={rec['sla_violations']:.2f}")
        return records
    if backend != "soa":
        raise ValueError(f"unknown backend {backend!r}")
    if pretrain_intervals:
        pre = pretrain(pretrain_intervals, lam=pre_lam, seed=pretrain_seed,
                       substeps=substeps, interval_s=interval_s,
                       policies=[p for p in policies
                                 if (p in MAB_STATE_POLICIES
                                     and mab_state is None)
                                 or (p == "gillis"
                                     and gillis_policy is None)],
                       device=dev)
        mab_state = mab_state if mab_state is not None else pre.mab_state
        gillis_policy = gillis_policy if gillis_policy is not None \
            else pre.gillis_policy
    records = []
    for lam, pol, seed in itertools.product(lams, policies, seeds):
        ms = mab_state if pol in MAB_STATE_POLICIES else None
        r = run_trace(pol, n_intervals=n_intervals, lam=lam, seed=seed,
                      mab_state=ms, train=mode == "train",
                      substeps=substeps, interval_s=interval_s, apps=apps,
                      cluster=cluster_factory() if cluster_factory else None,
                      policy=gillis_policy if pol == "gillis" else None,
                      device=dev)
        records.append(_record(pol, seed, lam, r))
        if progress:
            rec = records[-1]
            progress(f"lam={lam:g} {pol:15s} seed={seed} "
                     f"reward={rec['reward']:.4f} "
                     f"viol={rec['sla_violations']:.2f}")
    return records


def aggregate(records: Iterable[dict],
              by: Sequence[str] = ("policy",)) -> Dict:
    """Group records and average every numeric metric; adds
    ``reward_std`` and ``n_runs``.  Keys are the ``by`` values (a scalar
    for a single key, else a tuple)."""
    groups: Dict = {}
    for rec in records:
        key = tuple(rec[k] for k in by)
        groups.setdefault(key[0] if len(by) == 1 else key, []).append(rec)
    out = {}
    # grid coordinates are labels, not metrics — never average them in
    skip = set(by) | {"policy", "seed", "lam"}
    for key, rs in groups.items():
        agg = {k: float(np.mean([r[k] for r in rs]))
               for k in rs[0] if k not in skip
               and isinstance(rs[0][k], _SCALARS)}
        agg["reward_std"] = float(np.std([r["reward"] for r in rs]))
        agg["n_runs"] = len(rs)
        out[key] = agg
    return out


def scaled_fleet(factor: int):
    """Scale the Table 3 fleet spec by an integer factor (2 → a
    100-worker cluster)."""
    return [(name, qty * factor) for name, qty in FLEET_SPEC]


def make_scaled_cluster(factor: int, **kw):
    return make_cluster(fleet=scaled_fleet(factor), **kw)
