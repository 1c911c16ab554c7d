"""Work counts of the kernels whose roofline share the benchmark reports.

One module per counted kernel family, named by the configuration's
``counts`` key. Each gives ``KERNELS``, the pattern of the device kernel
names it counts, and ``bound_s(config, n, steps)``: the least time an
H100 could take for the work that ``n`` masked voxels need, with the
accepted steps ``steps`` (``{"steps.<kernel>": count}``) that the
benchmark's own reference took on them.
"""
