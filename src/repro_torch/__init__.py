"""PyTorch/CUDA port of SplitPlace for one NVIDIA H100.

A second package beside the JAX reference ``repro``:

* the edge-simulator interval program: the same seeded traces, BestFit
  placement, MAB split decisions and float64 substep physics, batched
  over a leading grid axis G (``env/``, ``launch.experiments``);
* model serving: the SLA-aware ``serving.engine.SplitPlaceEngine``
  choosing between layer-split and semantic-split plans of a dense
  decoder (``configs/``, ``models/``, ``serving/``, ``launch.serve``).

Every Pallas kernel of these paths is a hand-written CUDA kernel
(``kernels/``): on a CPU tensor each runs its eager PyTorch twin instead.
Layout mirrors ``repro``.  The package imports ``torch`` and numpy only
— never ``jax`` and nothing of ``repro``.
"""
