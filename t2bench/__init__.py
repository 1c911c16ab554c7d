"""The benchmark of ``fetal_t2mapping_tpu_torch`` (the PyTorch + CUDA port).

Run one cell from the root of a checkout::

    python3 -m t2bench.run --workload lf055_gauss.serve --seed 7 --seconds 45 --trace 0

``BENCHMARK.json`` names the cells; each cell names a configuration
(``configs/<config>.json``), a traffic mix (``traffic/<mix>.json``) and the
limits of its correctness check (``limits/<cell>.json``). Per-layer metrics
are read by ``metrics/<metric>.py`` and the roofline's work is counted by
``counts/<kernel>.py``, each found by its name. The reference that decides
``correct`` is ``reference/``: plain PyTorch that imports nothing of the
program.
"""
