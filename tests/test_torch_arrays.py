"""The port's trace compiler against the JAX reference's.

``repro_torch.env.torchsim.arrays`` must draw the same NumPy random
numbers in the same order as ``repro.env.jaxsim.arrays``, so the compiled
arrays come out byte-equal: single-variant traces (``bestfit-rr``,
``mc`` and frozen-state ``bestfit-mab``), dual traces, stacked grids and
the default capacity.  The reference runs in a child interpreter
(``_torch_ref``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_ref import MAB_LITERAL, MAB_LITERAL_JAX, run_reference
from repro_torch.env.torchsim import (compile_trace, compile_trace_dual,
                                      default_capacity, make_static_decider,
                                      stack_traces, to_device)

CASES = [(5.0, 0), (6.0, 3), (24.0, 1)]
T, SUBSTEPS = 10, 4
KINDS = ("bestfit-rr", "mc", "bestfit-mab", "dual")


def _fields(tr):
    import dataclasses
    return {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr)
            if isinstance(getattr(tr, f.name), np.ndarray)}


def _compile(kind, lam, seed):
    if kind == "dual":
        return compile_trace_dual(lam=lam, seed=seed, n_intervals=T,
                                  substeps=SUBSTEPS)
    dec = make_static_decider(kind, mab_state=MAB_LITERAL)
    return compile_trace(dec, lam=lam, seed=seed, n_intervals=T,
                         substeps=SUBSTEPS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_arrays") / "arrays.npz"
    run_reference(MAB_LITERAL_JAX + f"""
import dataclasses
import numpy as np
from repro.env.jaxsim import (compile_trace, compile_trace_dual,
                              default_capacity, make_static_decider,
                              stack_traces)
res = {{}}
per_case = {{}}
for lam, seed in {CASES!r}:
    per = per_case[(lam, seed)] = {{}}
    for kind in {KINDS!r}:
        if kind == "dual":
            tr = compile_trace_dual(lam=lam, seed=seed, n_intervals={T},
                                    substeps={SUBSTEPS})
        else:
            tr = compile_trace(make_static_decider(kind, mab_state=MAB_STATE),
                               lam=lam, seed=seed, n_intervals={T},
                               substeps={SUBSTEPS})
        per[kind] = tr
        for f in dataclasses.fields(tr):
            v = getattr(tr, f.name)
            if isinstance(v, np.ndarray):
                res[f"{{lam}}/{{seed}}/{{kind}}/{{f.name}}"] = v
for kind in {KINDS!r}:
    traces = [per_case[(lam, seed)][kind] for lam, seed in {CASES!r}]
    for k, v in stack_traces(traces).items():
        res[f"stack/{{kind}}/{{k}}"] = v
    res[f"capacity/{{kind}}"] = np.asarray(default_capacity(traces))
np.savez(OUT, **res)
""", out)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _assert_bytes_equal(got, want, what):
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert got.tobytes() == want.tobytes(), f"{what}: bytes differ"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lam,seed", CASES)
def test_compiled_trace_byte_equal(ref, kind, lam, seed):
    fields = _fields(_compile(kind, lam, seed))
    prefix = f"{lam}/{seed}/{kind}/"
    assert set(fields) == {k[len(prefix):] for k in ref
                           if k.startswith(prefix)}
    for name, v in fields.items():
        _assert_bytes_equal(v, ref[prefix + name], f"{kind} {lam}/{seed} "
                            f"{name}")


@pytest.mark.parametrize("kind", KINDS)
def test_stacked_grid_and_capacity_equal(ref, kind):
    traces = [_compile(kind, lam, seed) for lam, seed in CASES]
    stacked = stack_traces(traces)
    prefix = f"stack/{kind}/"
    assert set(stacked) == {k[len(prefix):] for k in ref
                            if k.startswith(prefix)}
    for k, v in stacked.items():
        _assert_bytes_equal(v, ref[prefix + k], f"stack {kind} {k}")
    assert default_capacity(traces) == int(ref[f"capacity/{kind}"])


def test_to_device_keeps_dtypes_and_values():
    traces = [_compile("dual", lam, seed) for lam, seed in CASES]
    stacked = stack_traces(traces)
    leaves = to_device(stacked, "cpu")
    for k, v in stacked.items():
        t = leaves[k]
        assert t.device.type == "cpu"
        assert t.numpy().dtype == v.dtype and np.array_equal(t.numpy(), v)
        assert t.is_contiguous()
    assert leaves["valid"].dtype == torch.bool


def test_stack_rejects_mixed_grid():
    a = _compile("mc", 5.0, 0)
    b = compile_trace(make_static_decider("mc"), lam=5.0, seed=1,
                      n_intervals=T + 1, substeps=SUBSTEPS)
    with pytest.raises(ValueError, match="trace\\[1\\]"):
        stack_traces([a, b])
