"""Differential fuzzing of the port's interval program against the port's
host EdgeSim oracles (``repro_torch.env.torchsim.reference``), with no
JAX: ``tests/test_differential.py``'s contract on the port.

Every generated case draws one configuration (worker fleet, λ, RAM and
MIPS scales, workload seed, a handcrafted MAB state with its ε/UCB
hyperparameters, a DASO surrogate, telemetry on or off), runs it through
``run_trace_arrays*`` on the CPU and through the matching
``replay_trace_edgesim*``, and holds every summary metric at rtol 1e-4 /
atol 1e-9 (the final MAB scalars, the finetuned θ, the Gillis Q-table and
the per-interval series too; the binned percentiles within their error
bound).  Five oracle pairs: static, deploy (UCB MAB ± frozen DASO), gobi
(the decision-blind surrogate), train (ε-greedy MAB ± DASO finetuning)
and gillis.  Shape-setting parameters come from small quantized pools.

The generator, the comparison and the regression cases live in
``chip_smoke.py`` (``diff_*``), whose differential phase runs the same
contract with the program on the card.

  * ``test_differential_fuzz``: ``DIFF_FUZZ_CASES`` seeded cases (default
    30; ``DIFF_FUZZ_CASES=200`` for a full sweep);
  * ``test_differential_hypothesis``: the same space under hypothesis
    shrinking (skipped when hypothesis is absent);
  * ``test_regression``: the six shrunk regression cases (RAM-pressure
    repair, static and train; ε boundaries of the MAB and of Gillis;
    Gillis under RAM pressure; capacity-overflow drop counting).
"""
from __future__ import annotations

import os
import sys

import pytest

from _torch_ref import chip_smoke

SMOKE = chip_smoke()
N_CASES = int(os.environ.get("DIFF_FUZZ_CASES", "30"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These cases are many small CPU ops: one intra-op thread runs them
    about as fast and leaves the other cores to parallel test workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case_seed", range(N_CASES))
def test_differential_fuzz(case_seed):
    SMOKE.diff_check_case(SMOKE.diff_draw_case(case_seed), "cpu")


def test_fuzz_covers_every_mode():
    """The default budget reaches every oracle pair and both telemetry
    modes."""
    cases = [SMOKE.diff_draw_case(s) for s in range(30)]
    assert {c["mode"] for c in cases} == set(SMOKE.DIFF_MODES)
    assert {c["telemetry"] for c in cases} == {"summary", "interval"}


try:
    import hypothesis
    from hypothesis import strategies as hst
    HAVE_HYPOTHESIS = True
    hypothesis.settings.register_profile(
        "torch-ci", max_examples=20, deadline=None, print_blob=True)
    hypothesis.settings.register_profile(
        "torch-full", max_examples=200, deadline=None)
except ImportError:                                  # pragma: no cover
    HAVE_HYPOTHESIS = False


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
def test_differential_hypothesis():
    """The same property under hypothesis shrinking: a failing case
    minimizes to one integer seed whose configuration ``diff_draw_case``
    prints.  ``HYPOTHESIS_PROFILE=full`` draws 200 examples."""
    profile = "torch-full" if os.environ.get("HYPOTHESIS_PROFILE") == "full" \
        else "torch-ci"

    @hypothesis.settings(hypothesis.settings.get_profile(profile))
    @hypothesis.given(hst.integers(min_value=0, max_value=2**20))
    def prop(case_seed):
        SMOKE.diff_check_case(SMOKE.diff_draw_case(case_seed), "cpu")

    prop()


@pytest.mark.parametrize("name", SMOKE.DIFF_REGRESSIONS)
def test_regression(name):
    SMOKE.diff_regression(name, "cpu")


def test_no_jax_imported():
    """The fuzz runs on the port alone."""
    code = ("import sys\n"
            f"sys.path[:0] = [{os.path.join(SMOKE.ROOT, 'src')!r}, "
            f"{os.path.join(SMOKE.ROOT, 'tests')!r}]\n"
            "from _torch_ref import chip_smoke\n"
            "cs = chip_smoke()\n"
            "for s in range(3):\n"
            "    cs.diff_check_case(cs.diff_draw_case(s), 'cpu')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    import subprocess
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
