"""The SplitPlace interval program in PyTorch (port of
``repro.env.jaxsim``).

Traces compile on the host (``arrays``), upload once per grid, and the
interval loop (``driver.run_program``) runs decide → admit → place →
repair → substep physics → feedback over all G grid cells at once on the
chosen device.  The substep physics is the hand-written CUDA kernel
``repro_torch.kernels.edge_substep`` on a CUDA grid.  Placement is BestFit,
or BestFit followed by the DASO stage (``splitplace``, ``mab+gobi`` and the
static-decider arms ``layer+gobi`` / ``semantic+gobi`` / ``random+daso``).
The learners run in deploy mode (UCB) or train mode (ε-greedy decisions
and online DASO finetuning), and the Gillis baseline learns its Q-table in
the loop; their draws are JAX's threefry bits
(``repro_torch.kernels.threefry``).  ``telemetry="interval"`` records a
per-interval series on the device.

``stream`` is the always-on serving mode: a host feeder streams Poisson
arrivals as chunk tapes (``arrays.chunk_tapes`` slices a compiled trace
the same way) into a fixed ring of device slots, and a carry-re-entrant
chunk program (``driver.run_chunk``) continues one episode from chunk to
chunk, with rolling QPS, percentile and violation metrics
(``stream.serve``, ``stream.replay_stream``).

``run_grid_engine`` and every ``run_grid_arrays*`` run a grid as one call
by default; ``threads`` cuts it into thread chunks and ``devices``
shards it over ``launch.mesh.make_grid_mesh``'s devices.

``reference`` holds the host oracles: the compiled trace replayed through
the NumPy ``EdgeSim`` with the same learner functions
(``replay_trace_edgesim*``).
"""
from repro_torch.env.torchsim import engines
from repro_torch.env.torchsim.arrays import (ClusterArrays, DualTraceArrays,
                                             TraceArrays, chunk_tapes,
                                             compile_trace,
                                             compile_trace_dual,
                                             default_capacity, stack_traces,
                                             to_device)
from repro_torch.env.torchsim.driver import (GILLIS_HP, MAB_HP,
                                             METRIC_COLS, STATIC_DASO_ARMS,
                                             TRAIN_HP, gillis_init_state,
                                             gillis_layer_ref,
                                             run_grid_arrays,
                                             run_grid_arrays_gillis,
                                             run_grid_arrays_learned,
                                             run_grid_arrays_static_daso,
                                             run_grid_arrays_trained,
                                             run_grid_engine, run_program,
                                             run_trace_arrays,
                                             run_trace_arrays_gillis,
                                             run_trace_arrays_learned,
                                             run_trace_arrays_static_daso,
                                             run_trace_arrays_trained,
                                             run_trace_engine,
                                             trace_train_key)
from repro_torch.env.torchsim.reference import (
    replay_trace_edgesim, replay_trace_edgesim_gillis,
    replay_trace_edgesim_learned, replay_trace_edgesim_static_daso,
    replay_trace_edgesim_trained)
from repro_torch.env.torchsim import stream
from repro_torch.env.torchsim.stream import (RollingMetrics, StreamFeeder,
                                             StreamRunner,
                                             make_stream_policy,
                                             replay_stream, serve)
from repro_torch.env.torchsim.policies import (DASO_LEARNED_POLICIES,
                                               LEARNED_POLICIES,
                                               MAB_LEARNED_POLICIES,
                                               STATIC_POLICIES,
                                               host_policy,
                                               make_static_decider)

__all__ = [
    "ClusterArrays", "DualTraceArrays", "TraceArrays", "chunk_tapes",
    "compile_trace",
    "compile_trace_dual", "default_capacity", "stack_traces", "to_device",
    "engines", "GILLIS_HP", "MAB_HP", "METRIC_COLS", "STATIC_DASO_ARMS",
    "TRAIN_HP", "gillis_init_state", "gillis_layer_ref", "run_grid_arrays",
    "run_grid_arrays_gillis", "run_grid_arrays_learned",
    "run_grid_arrays_static_daso", "run_grid_arrays_trained",
    "run_grid_engine", "run_program", "run_trace_arrays",
    "run_trace_arrays_gillis", "run_trace_arrays_learned",
    "run_trace_arrays_static_daso", "run_trace_arrays_trained",
    "run_trace_engine", "trace_train_key", "DASO_LEARNED_POLICIES",
    "LEARNED_POLICIES", "MAB_LEARNED_POLICIES", "STATIC_POLICIES",
    "host_policy", "make_static_decider", "replay_trace_edgesim",
    "replay_trace_edgesim_gillis", "replay_trace_edgesim_learned",
    "replay_trace_edgesim_static_daso", "replay_trace_edgesim_trained",
    "stream", "RollingMetrics", "StreamFeeder", "StreamRunner",
    "make_stream_policy", "replay_stream", "serve",
]
