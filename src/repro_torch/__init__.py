"""PyTorch/CUDA port of the SplitPlace edge-simulator interval program.

A second package beside the JAX reference ``repro``: the same seeded
traces, the same BestFit placement and MAB split decisions, and the same
float64 substep physics, batched over a leading grid axis G and run on
one NVIDIA H100.  The substep physics runs in a hand-written CUDA kernel
(``repro_torch.kernels.edge_substep``); on a CPU tensor it runs its eager
PyTorch twin instead.

Layout mirrors ``repro``: ``env/`` (workload, cluster, mobility),
``env/torchsim/`` (the counterpart of ``env/jaxsim/``), ``core/`` (MAB),
``kernels/`` and ``launch/``.  The package imports ``torch`` and numpy
only — never ``jax`` and nothing of ``repro``.
"""
