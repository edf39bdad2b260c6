"""Task/workload model — Poisson arrivals of split-able DNN inference jobs.

Applications follow the paper's A = {MNIST, FashionMNIST, CIFAR100} with
AIoTBench-style models.  Each task = (batch in [16k, 64k], SLA deadline,
app).  A split decision realizes the task as containers:

  * LAYER (0):      n_frag sequential fragments (precedence chain);
  * SEMANTIC (1):   n_branch parallel branches;
  * COMPRESSED (2): one container with the whole compressed model.

A NumPy copy of the reference ``repro.env.workload``: the generator makes
the identical ``RandomState`` draws in the identical order, so a trace
compiled here is byte-equal to the reference's.  ``Task`` and
``Fragment`` are plain records until a host simulator's
structure-of-arrays store (``repro_torch.env.soa.SoAStore``) adopts them;
from then on their hot fields are views into the store's rows.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

LAYER, SEMANTIC, COMPRESSED = 0, 1, 2
APP_NAMES = ["mnist", "fashionmnist", "cifar100"]


@dataclasses.dataclass(frozen=True)
class AppProfile:
    name: str
    minstr_per_sample: float   # mega-instructions per input sample
    feat_kb_per_sample: float  # forwarded activation size (bzip2'd)
    model_mb: tuple            # container image size range (§6.2)
    n_frag: int                # layer-split fragment count
    n_branch: int              # semantic-split branch count
    acc_layer: float
    acc_semantic: float
    base_ram_mb: float         # per-container working set base


APP_PROFILES = [
    AppProfile("mnist",         95.0, 0.40, (8, 14),  4, 2, 0.989, 0.970, 250),
    AppProfile("fashionmnist", 240.0, 1.00, (34, 56), 6, 3, 0.926, 0.886, 420),
    AppProfile("cifar100",     475.0, 2.00, (47, 76), 8, 4, 0.880, 0.815, 600),
]
ACC_COMPRESS_DROP = 0.032     # MC/Gillis compressed-model accuracy penalty
COMPRESS_WORK = 1.00          # BottleNet++ compresses activations, not FLOPs
SEMANTIC_WORK = 0.85          # branches are 1/G-width nets
REF_MIPS = 4019.0             # median worker, for SLA reference times


def _frag_field(name, cast):
    """Property for a Fragment field: plain attribute until the fragment is
    adopted by a structure-of-arrays store, then a view into its row."""
    slot = "_" + name

    def get(self):
        if self._store is None:
            return getattr(self, slot)
        return cast(getattr(self._store, name)[self._row])

    def set_(self, value):
        if self._store is None:
            setattr(self, slot, value)
        else:
            getattr(self._store, name)[self._row] = value

    return property(get, set_)


class Fragment:
    """One container of a realized task.

    Construction-compatible with the former dataclass.  Hot per-substep
    state (``instr_left``, ``worker``, ``done``, ``transfer_left``, …)
    lives in ``repro_torch.env.soa.SoAStore`` arrays once the owning simulator
    adopts the fragment; the attributes here are thin views into that row,
    so object-level reads/writes (tests, placers) stay coherent with the
    vectorized kernels.
    """
    __slots__ = ("task_id", "idx", "_store", "_row", "_instr_left",
                 "_ram_mb", "_out_bytes", "_worker", "_done",
                 "_transfer_left")

    def __init__(self, task_id: int, idx: int, instr_left: float,
                 ram_mb: float, out_bytes: float, worker: int = -1,
                 done: bool = False, transfer_left: float = 0.0):
        self.task_id = task_id
        self.idx = idx
        self._store = None
        self._row = -1
        self._instr_left = instr_left
        self._ram_mb = ram_mb
        self._out_bytes = out_bytes
        self._worker = worker
        self._done = done
        self._transfer_left = transfer_left

    instr_left = _frag_field("instr_left", float)
    ram_mb = _frag_field("ram_mb", float)
    out_bytes = _frag_field("out_bytes", float)
    worker = _frag_field("worker", int)
    done = _frag_field("done", bool)
    transfer_left = _frag_field("transfer_left", float)

    def __repr__(self):
        return (f"Fragment(task_id={self.task_id}, idx={self.idx}, "
                f"instr_left={self.instr_left:.1f}, worker={self.worker}, "
                f"done={self.done})")


def _task_field(name, cast, slot=None):
    slot = slot or "_" + name

    def get(self):
        if self._store is None:
            return getattr(self, slot)
        return cast(getattr(self._store, name)[self._trow])

    def set_(self, value):
        if self._store is None:
            setattr(self, slot, value)
        else:
            getattr(self._store, name)[self._trow] = value

    return property(get, set_)


class Task:
    """A split-able inference job; construction-compatible with the former
    dataclass.  ``chain``/``stage``/``placed``/``done`` become views into
    the owning store once adopted (see ``Fragment``)."""

    def __init__(self, id: int, app: int, batch: int, sla_s: float,
                 arrival_s: float, decision: int = -1, fragments=None,
                 chain: bool = False, stage: int = 0, placed: bool = False,
                 wait_s: float = 0.0, done: bool = False,
                 response_s: float = 0.0, accuracy: float = 0.0):
        self.id = id
        self.app = app
        self.batch = batch
        self.sla_s = sla_s
        self.arrival_s = arrival_s
        self.decision = decision
        self.fragments: List[Fragment] = fragments if fragments is not None \
            else []
        self._store = None
        self._trow = -1
        self._chain = chain
        self._stage = stage            # active fragment in a layer chain
        self._placed = placed
        self._done = done
        self.wait_s = wait_s
        self.response_s = response_s
        self.accuracy = accuracy

    chain = _task_field("chain", bool)
    stage = _task_field("stage", int)
    placed = _task_field("placed", bool)
    done = _task_field("task_done", bool, slot="_done")

    def __repr__(self):
        return (f"Task(id={self.id}, app={self.app}, decision="
                f"{self.decision}, stage={self.stage}, done={self.done})")


def layer_ref_response_s(app: int) -> float:
    """Unloaded single-worker reference execution time of a layer chain
    (used for SLA sampling)."""
    p = APP_PROFILES[app]
    batch = 40000
    return p.minstr_per_sample * batch / REF_MIPS


class WorkloadGenerator:
    def __init__(self, lam: float = 6.0, seed: int = 0, apps=None,
                 tight_frac: float = 0.55, tight=(0.35, 1.15),
                 loose=(2.2, 3.5)):
        """SLA deadlines follow the Gillis-style bimodal mix: a
        latency-critical class and a loose class, in units of the app's
        unloaded reference execution time, batch-scaled."""
        self.lam = lam
        self.rng = np.random.RandomState(seed)
        self.apps = apps if apps is not None else [0, 1, 2]
        self.tight_frac = tight_frac
        self.tight, self.loose = tight, loose
        self._next_id = 0

    def arrivals(self, now_s: float) -> List[Task]:
        n = self.rng.poisson(self.lam)
        tasks = []
        for _ in range(n):
            app = int(self.rng.choice(self.apps))
            batch = int(self.rng.randint(16000, 64001))
            ref = layer_ref_response_s(app) * batch / 40000.0
            band = self.tight if self.rng.rand() < self.tight_frac \
                else self.loose
            sla = ref * self.rng.uniform(*band)
            tasks.append(Task(id=self._next_id, app=app, batch=batch,
                              sla_s=sla, arrival_s=now_s))
            self._next_id += 1
        return tasks

    def realize(self, task: Task, decision: int,
                img_mb: float = None) -> Task:
        """Materialize the container workflow for a split decision;
        ``img_mb`` overrides the image-size draw (the dual trace compiler
        draws it once per task and realizes both variants from it)."""
        p = APP_PROFILES[task.app]
        total_mi = p.minstr_per_sample * task.batch
        feat_bytes = p.feat_kb_per_sample * 1024.0 * task.batch
        if img_mb is None:
            img_mb = self.rng.uniform(*p.model_mb)
        ram_batch = p.base_ram_mb * task.batch / 40000.0
        task.decision = decision
        task.fragments = []
        if decision == LAYER:
            task.chain = True
            per = total_mi / p.n_frag
            for i in range(p.n_frag):
                out = feat_bytes if i < p.n_frag - 1 else feat_bytes * 0.05
                task.fragments.append(Fragment(
                    task.id, i, per, img_mb / p.n_frag + ram_batch / 2.0, out))
        elif decision == SEMANTIC:
            task.chain = False
            per = total_mi * SEMANTIC_WORK / p.n_branch
            for i in range(p.n_branch):
                task.fragments.append(Fragment(
                    task.id, i, per,
                    img_mb / p.n_branch + ram_batch / 2.5,
                    feat_bytes * 0.02))
        else:  # COMPRESSED
            task.chain = False
            task.fragments.append(Fragment(
                task.id, 0, total_mi * COMPRESS_WORK,
                img_mb * 0.5 + ram_batch * 3.0, feat_bytes * 0.02))
        return task

    def accuracy_of(self, task: Task) -> float:
        return accuracy_from_noise(task.app, task.decision,
                                   self.rng.normal(0, 0.003))


def accuracy_from_noise(app: int, decision: int, noise: float) -> float:
    """Accuracy of a (app, split decision) pair given a pre-drawn noise
    sample."""
    p = APP_PROFILES[app]
    base = {LAYER: p.acc_layer, SEMANTIC: p.acc_semantic,
            COMPRESSED: p.acc_layer - ACC_COMPRESS_DROP}[decision]
    return float(np.clip(base + noise, 0, 1))
