"""fetal_t2mapping_tpu_torch — the PyTorch + CUDA port of ``fetal_t2mapping_tpu``.

The JAX package beside this one is the reference; this package reproduces
its stage-3 voxel-wise T2 fit (gaussian model) on an NVIDIA GPU:

- ``core``     — ``Volume`` geometry, pure-Python NIfTI-1 I/O, ``EchoStack``
- ``models``   — signal model, log-linear init, batched damped-Newton solver,
                 and the fused fit (``fused_fit``) whose CUDA kernel lives in
                 ``csrc/gauss_fit.cu``
- ``analysis`` — convergence figures
- ``pipeline`` — ``process_t2maps`` over a BIDS derivative tree
- ``utils``    — BIDS paths, metadata CSV logs, map writers, stage timers
- ``cli``      — ``python -m fetal_t2mapping_tpu_torch.cli.t2mapping``

It imports ``torch`` and never ``jax`` or the JAX package (importing that
package imports ``jax``), so the host-only modules it shares with the
reference are copies, not imports.
"""

__version__ = "0.1.0"
