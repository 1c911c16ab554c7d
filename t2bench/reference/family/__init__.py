"""The plain fits of the kernel families, one module each.

``family/<name>.py`` is the reference fit of a configuration whose
``counts`` key is ``<name>``: the family whose work ``counts/<name>.py``
counts. Each gives ``fit_block(config, s)``: the fit of (N, T) voxels ``s``
in their dtype, as the configuration states it, returning the per-voxel
k, t2, sigma, fun, converged and n_iter and, for each kernel the family
launches, ``steps.<kernel>``: the accepted steps summed over the voxels,
which ``counts/<name>.py`` reads. A new family is a new file here and one
under ``counts/``; nothing names it.
"""
