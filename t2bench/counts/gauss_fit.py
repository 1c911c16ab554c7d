"""Work of ``csrc/gauss_fit.cu`` (the gaussian VARPRO fit: head and tail).

``gauss_ops`` is copied from ``chip_smoke.py`` at commit 69168b9
(``gauss_ops``), and ``bound_s`` from its ``gauss_bound``, with the bytes
and operations of the masked voxels only and the accepted steps taken from
the benchmark's reference instead of the kernel's ``n_iter``.
"""

import re

from .peaks import bound_s as _bound_s

KERNELS = re.compile(r"gauss_(single|head|tail)_kernel")


def gauss_ops(T: int, gtol: float):
    """fp32 operations of csrc/gauss_fit.cu at T echoes, counted from the
    source as fit3_ops counts fit3.cu (proj_grad five, a logical and/or
    one). Returns (prelude, iteration): the prelude once per voxel — the
    prior k box 2, the log-linear start 12 T + 14 and its clips 4, e at t2
    1 + 2 T, the objective 4 T, the 12-point grid (a dot, k, the objective,
    the compare and T + 4 selects) 84 T + 84; one accepted loop turn — the
    gradient and curvature sums 13 T - 4 and scalings 6, the Schur
    reduction 9, the KKT test 8, the damped step 10 and its clip 3, e at
    the candidate 1 + 2 T, k there 4 T + 2, the objective 4 T, the stop
    tests and update T + 53, and the gtol test 2 T + 14 when gtol > 0."""
    prelude = 2 + (12 * T + 14) + 4 + (1 + 2 * T) + 4 * T + (84 * T + 84)
    iteration = (13 * T - 4) + 6 + 9 + 8 + 10 + 3 + (1 + 2 * T) + (4 * T + 2) + 4 * T \
        + (T + 53) + (2 * T + 14 if gtol > 0 else 0)
    return prelude, iteration


def work(config: dict, n: int, steps: dict):
    """(bytes, fp32 operations) of the fit of ``n`` voxels: the signal in;
    k, t2, f float32, converged uint8 and n_iter int32 out (17 bytes); every
    voxel's prelude plus its accepted loop turns (rejected turns are not
    counted, so the bound is a lower one)."""
    T = len(config["te"])
    prelude, iteration = gauss_ops(T, float(config["gtol"]))
    return n * (T * 4 + 17), n * prelude + steps["steps.gauss_fit"] * iteration


def bound_s(config: dict, n: int, steps: dict) -> float:
    return _bound_s(*work(config, n, steps))
