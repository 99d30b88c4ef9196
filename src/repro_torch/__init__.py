"""repro_torch — the TAMPI reproduction ported to PyTorch and CUDA.

A package of its own beside ``repro`` (the JAX reference): it imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Module names
mirror ``repro``'s so each module's counterpart is easy to find:

* :mod:`repro_torch.obs` — tracing and the metrics registry;
* :mod:`repro_torch.core` — the task runtime, TAC on CUDA events, the
  schedule IR, the Level-A collectives and the makespan simulator;
* :mod:`repro_torch.checkpoint` — mesh-agnostic and asynchronous
  checkpoints in the JAX package's on-disk format;
* :mod:`repro_torch.kernels` — hand-written Hopper kernels beside their
  plain-PyTorch versions;
* :mod:`repro_torch.configs`, :mod:`repro_torch.models` — the
  architecture configs and the dense attention + MLP language model;
* :mod:`repro_torch.serving`, :mod:`repro_torch.launch` — continuous-
  batching serving on the task runtime and its CLI;
* :mod:`repro_torch.bench` — the paper's benchmarks on the port
  (Gauss–Seidel and IFSKer: real, simulated, traced and elastic legs).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device a call that names none raises.
"""
