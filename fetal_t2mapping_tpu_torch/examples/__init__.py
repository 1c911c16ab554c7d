"""Runnable examples of the port, each a self-contained script that makes
its own data from a seed:

- ``invitro_phantom``: a NIST-layout phantom session through stage 3 and
  the phantom ROI table, against the NMR ground truth;
- ``invivo_analysis``: the stage-4 analysis layer (ROI tables, inter-session
  CoV, Wilcoxon, Pearson, violins) on synthetic maps and labels;
- ``serving``: per-request ``fit_volume`` on a 96^3 request;
- ``multichip``: ``fit_volume``, ``register_rigid`` and ``segment_volume``
  over a voxel mesh against one device;
- ``profile_unet``: the top device ops of one U-Net forward from
  ``torch.profiler``.

Run one as ``python -m fetal_t2mapping_tpu_torch.examples.<name>``; each
runs on the GPU (``--device cpu`` runs the plain CPU path). Importing a
script runs nothing.
"""
