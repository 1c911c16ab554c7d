"""Work of ``csrc/gr_varpro_fit.cu`` (the gaussian_rician VARPRO fit: head
and tail).

``gr_varpro_ops`` is copied from ``chip_smoke.py`` at commit f52ecbc
(``gr_varpro_ops``), and ``work`` from its ``gr_varpro_bound``, with the
bytes and operations of the masked voxels only and the accepted steps
taken from the benchmark's reference instead of the kernel's stats.
"""

import re

from .peaks import bound_s as _bound_s

KERNELS = re.compile(r"gr_varpro_(single|head|tail)_kernel")


def gr_varpro_ops(T: int, gtol: float):
    """fp32 operations of csrc/gr_varpro_fit.cu at T echoes, counted from
    the source as fit3_ops counts fit3.cu (free_of and proj_grad five each,
    rsqrtf one). Returns (prelude, iteration): the prelude once per voxel —
    the log-linear start 12 T + 14 and its clips 7, E at t2 1 + 2 T, two
    inner steps 2 (20 T + 43), the objective 8 T, the squares 2 T - 1, the
    12-point grid 132 T + 192, the polish 68 T + 133, at T = 3 the
    interpolant's start 426 + 51 T, and the outputs 6; one accepted outer
    iteration — gradient, Schur curvature and step 31 T + 56, E at the
    candidate 1 + 2 T, three inner steps 60 T + 129, the objective 8 T, the
    stop tests and update 29, and the gtol test 27 when gtol > 0."""
    prelude = (12 * T + 14) + 7 + (1 + 2 * T) + 2 * (20 * T + 43) + 8 * T + (2 * T - 1) \
        + (132 * T + 192) + (68 * T + 133) + (426 + 51 * T if T == 3 else 0) + 6
    iteration = (31 * T + 56) + (1 + 2 * T) + (60 * T + 129) + 8 * T + 29 + (27 if gtol > 0 else 0)
    return prelude, iteration


def work(config: dict, n: int, steps: dict):
    """(bytes, fp32 operations) of the fit of ``n`` voxels: the signal in;
    (k, t2, sigma) and (f, converged, n_iter) float32 out (24 bytes); every
    voxel's prelude plus its accepted outer iterations (rejected ones are
    not counted, so the bound is a lower one)."""
    T = len(config["te"])
    prelude, iteration = gr_varpro_ops(T, float(config["gtol"]))
    return n * (T * 4 + 24), n * prelude + steps["steps.gr_varpro_fit"] * iteration


def bound_s(config: dict, n: int, steps: dict) -> float:
    return _bound_s(*work(config, n, steps))
