"""fetal_t2mapping_tpu_torch — the PyTorch + CUDA port of ``fetal_t2mapping_tpu``.

The JAX package beside this one is the reference; this package reproduces
its stage-3 voxel-wise T2 fit (all three noise models) and its stage 2
(resample, registration, fusion, denoising, SynthSeg, masks and labels) on
an NVIDIA GPU:

- ``core``     — ``Volume`` geometry, pure-Python NIfTI-1 I/O, ``EchoStack``
- ``models``   — signal model, log-linear init, batched damped-Newton solver,
                 and the fused fits (``fused_fit``) whose CUDA kernels live in
                 ``csrc/gauss_fit.cu``, ``gr_varpro_fit.cu`` and ``fit3.cu``
- ``labels``   — the SynthSeg U-Net (``unet3d``), its S2D conv
                 (``conv_s2d``, kernel ``csrc/conv_s2d.cu``), the runner,
                 masks, the FeTA remap and phantom sphere labels
- ``ops``      — trilinear/nearest sampling, Gaussian filtering, TV, morphology
- ``recon``    — resampling, rigid/affine registration, fusion, denoising
- ``build``    — the nvcc build and ctypes binding of ``csrc/*.cu``
- ``analysis`` — convergence figures
- ``pipeline`` — ``process_t2maps`` (stage 3) and ``process_qmri`` (stage 2)
                 over a BIDS tree
- ``utils``    — BIDS paths, metadata CSV logs, map writers, stage timers
- ``cli``      — ``python -m fetal_t2mapping_tpu_torch.cli.t2mapping`` and
                 ``.cli.qmri_reconstruction``

It imports ``torch`` and never ``jax`` or the JAX package (importing that
package imports ``jax``), so the host-only modules it shares with the
reference are copies, not imports.
"""

__version__ = "0.1.0"
