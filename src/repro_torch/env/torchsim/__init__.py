"""The SplitPlace interval program in PyTorch (port of
``repro.env.jaxsim``).

Traces compile on the host (``arrays``), upload once per grid, and the
interval loop (``driver.run_program``) runs decide → admit → place →
repair → substep physics → feedback over all G grid cells at once on the
chosen device.  The substep physics is the hand-written CUDA kernel
``repro_torch.kernels.edge_substep`` on a CUDA grid.  Placement is BestFit,
or BestFit followed by the DASO stage (``splitplace``, ``mab+gobi`` and the
static-decider arms ``layer+gobi`` / ``semantic+gobi``).
"""
from repro_torch.env.torchsim import engines
from repro_torch.env.torchsim.arrays import (ClusterArrays, DualTraceArrays,
                                             TraceArrays, compile_trace,
                                             compile_trace_dual,
                                             default_capacity, stack_traces,
                                             to_device)
from repro_torch.env.torchsim.driver import (MAB_HP, METRIC_COLS,
                                             STATIC_DASO_ARMS,
                                             run_grid_arrays,
                                             run_grid_arrays_learned,
                                             run_grid_arrays_static_daso,
                                             run_grid_engine, run_program,
                                             run_trace_arrays,
                                             run_trace_arrays_learned,
                                             run_trace_arrays_static_daso,
                                             run_trace_engine)
from repro_torch.env.torchsim.policies import (DASO_LEARNED_POLICIES,
                                               MAB_LEARNED_POLICIES,
                                               STATIC_POLICIES,
                                               make_static_decider)

__all__ = [
    "ClusterArrays", "DualTraceArrays", "TraceArrays", "compile_trace",
    "compile_trace_dual", "default_capacity", "stack_traces", "to_device",
    "engines", "MAB_HP", "METRIC_COLS", "STATIC_DASO_ARMS",
    "run_grid_arrays", "run_grid_arrays_learned",
    "run_grid_arrays_static_daso", "run_grid_engine", "run_program",
    "run_trace_arrays", "run_trace_arrays_learned",
    "run_trace_arrays_static_daso", "run_trace_engine",
    "DASO_LEARNED_POLICIES", "MAB_LEARNED_POLICIES", "STATIC_POLICIES",
    "make_static_decider",
]
