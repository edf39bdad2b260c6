"""Shared helpers of the port's tests: the JAX reference run in a child
interpreter, and the inputs both sides are fed.

``repro.env.jaxsim`` imports ``jax.experimental.enable_x64``, which the
installed JAX no longer has.  The alias that restores it is set only
inside the child process, never in the pytest process, whose workers
also run the JAX package's own tests.  The child gets ``PYTHONPATH=src``
and ``JAX_PLATFORMS=cpu``, runs ``code`` with ``OUT`` bound to an output
path, and the caller loads what it wrote there.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """\
import sys
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
OUT = sys.argv[1]
"""

#: the literal MAB state of tools/regen_golden.py, as the reference's
#: fields (NumPy) and as reference-side code
MAB_LITERAL = {"R": np.array([700.0, 1800.0, 3500.0]),
               "Q": np.array([[0.8, 0.6], [0.3, 0.7]]),
               "N": np.array([[20.0, 10.0], [5.0, 25.0]]),
               "eps": 0.4, "rho": 0.06, "t": 40}
MAB_LITERAL_JAX = """\
import jax.numpy as jnp
from repro.core import mab
MAB_STATE = mab.init_state(3)._replace(
    R=jnp.array([700.0, 1800.0, 3500.0], jnp.float32),
    Q=jnp.array([[0.8, 0.6], [0.3, 0.7]], jnp.float32),
    N=jnp.array([[20.0, 10.0], [5.0, 25.0]], jnp.float32),
    eps=jnp.asarray(0.4, jnp.float32),
    rho=jnp.asarray(0.06, jnp.float32),
    t=jnp.asarray(40, jnp.int32))
"""



def ref_mab_state(d):
    """The reference's ``MABState`` from its fields given as NumPy (such as
    ``MAB_LITERAL``), for reference code run in process."""
    import jax.numpy as jnp
    from repro.core import mab
    return mab.init_state(len(np.asarray(d["R"])))._replace(
        **{k: jnp.asarray(np.asarray(v),
                          jnp.int32 if k == "t" else jnp.float32)
           for k, v in d.items()})


def run_reference(code: str, out_path, timeout: float = 600) -> None:
    """Run ``code`` (reference-side Python) in a fresh interpreter; raise
    with its output if it fails."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", PRELUDE + textwrap.dedent(code),
         str(out_path)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference child failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")


def substep_fuzz(rng: np.random.RandomState, k: int = 12, f: int = 4,
                 n: int = 6) -> dict:
    """One consistent fuzzed slot state for the substep physics, drawn
    exactly as ``tests/test_edge_substep.py`` draws it: padding columns
    born done with worker −1, stages in [0, f] (f once a chain ran off its
    last column), positive physical quantities.  Keys are the kernel's
    operand names."""
    nfrag = rng.randint(1, f + 1, k).astype(np.int32)
    colpad = np.arange(f)[None, :] >= nfrag[:, None]
    done = rng.rand(k, f) < 0.35
    done |= colpad
    worker = rng.randint(0, n, (k, f)).astype(np.int32)
    worker[colpad] = -1
    placed = rng.rand(k) < 0.8
    worker[~placed] = -1
    task_done = done.all(axis=1) & (rng.rand(k) < 0.5)
    stage = np.minimum(done.argmin(axis=1).astype(np.int32), nfrag - 1)
    stage[done.all(axis=1)] = nfrag[done.all(axis=1)]
    return dict(
        instr=np.where(done, 0.0, rng.uniform(1e3, 5e4, (k, f))),
        done=done,
        transfer=np.where(done, 0.0, rng.uniform(0.0, 30.0, (k, f))),
        stage=stage,
        task_done=task_done,
        resp=np.where(task_done, rng.uniform(1.0, 50.0, k), 0.0),
        now=np.asarray([rng.uniform(0.0, 900.0)]),
        metrics=rng.uniform(0.0, 10.0, 9),
        worker=worker,
        ram_task=rng.uniform(0.5, 8.0, k),
        out_bytes=rng.uniform(0.1, 40.0, (k, f)),
        nfrag=nfrag,
        chain=rng.rand(k) < 0.5,
        placed=placed,
        sla=rng.uniform(5.0, 60.0, k),
        arrival=rng.uniform(0.0, 600.0, k),
        acc_t=rng.uniform(0.5, 1.0, k),
        wait_s=rng.uniform(0.0, 10.0, k),
        decision=rng.randint(0, 3, k).astype(np.int32),
        bw_mult=rng.uniform(0.3, 1.0, n),
        mips=rng.uniform(2e3, 8e3, n),
        cap=rng.uniform(4.0, 16.0, n),
        net_bw=rng.uniform(100.0, 1000.0, n),
    )


def repair_fuzz(rng: np.random.RandomState, g: int, k: int, f: int, n: int,
                trip=None, cap_lo: float = 2.0, cap_hi: float = 12.0):
    """Operands of ``placement.repair_scan`` for g cells of k slots, f
    fragments and n workers, as numpy arrays in operand order: each row of
    ``order`` a permutation of the slots, ``trip`` (g,) drawn in [0, k]
    unless given, requests in [-2, n + 2) (the kernel clamps them), chain
    stages in [0, f] and fragment RAM of 0.1–4 against capacities in
    [cap_lo, cap_hi), so that fallbacks and failed tasks occur."""
    order = np.stack([rng.permutation(k) for _ in range(g)]).astype(np.int64)
    if trip is None:
        trip = rng.randint(0, k + 1, g)
    return (order, np.asarray(trip, dtype=np.int64),
            rng.rand(g, k) < 0.8, rng.rand(g, k, f) < 0.3,
            rng.rand(g, k) < 0.4,
            rng.randint(0, f + 1, (g, k)).astype(np.int32),
            rng.randint(-2, n + 2, (g, k, f)).astype(np.int32),
            rng.uniform(0.1, 4.0, (g, k, f)),
            rng.uniform(cap_lo, cap_hi, n),
            rng.randint(-1, n, (g, k, f)).astype(np.int32),
            rng.rand(g, k) < 0.5)


def chip_smoke():
    """The repository's ``chip_smoke.py`` as a module (it imports numpy
    only at the top), whose case generators the GPU tests share."""
    mod = sys.modules.get("chip_smoke")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return mod


#: operands of ``placement.bestfit_scan`` (``chip_smoke.bestfit_fuzz``)
bestfit_fuzz = chip_smoke().bestfit_fuzz


#: csrc/moe_route.cu's launch constants
ROUTE_TILE, ROUTE_VPL, ROUTE_MAX_THREADS, ROUTE_MAX_ENT = 32, 4, 512, 2048


def route_plan(gs, E, k, tile=ROUTE_TILE, vpl=ROUTE_VPL):
    """``make_plan`` of ``csrc/moe_route.cu`` (``tile`` tokens per CTA and
    ``vpl`` logits per lane at most): (lanes per token, tokens per CTA,
    threads per CTA, ranking warps, chunks of 32 entries per ranking
    warp)."""
    V = vpl if E <= 32 * vpl else 32
    L = 1
    while L < -(-E // V):
        L *= 2
    tt = max(1, min(tile, ROUTE_MAX_THREADS // L, ROUTE_MAX_ENT // k, gs))
    chunks = -(-tt * k // 32)
    warps = -(-tt * L // 32)
    rank_warps = min(chunks, warps)
    return L, tt, 32 * warps, rank_warps, -(-chunks // rank_warps)
