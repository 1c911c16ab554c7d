"""Work of ``csrc/fit3.cu`` (the 3-start multistart prefix, then the
continuation of each voxel's winner: sweep and tail).

``fit3_ops`` is copied from ``chip_smoke.py`` at commit 69168b9
(``fit3_ops``), and ``work`` from its ``fit3_bound`` for the two launches,
with the bytes and operations of the masked voxels only and the accepted
steps taken from the benchmark's reference instead of the kernels' stats.
"""

import re

from .peaks import bound_s as _bound_s

KERNELS = re.compile(r"fit3_(multistart|sweep|tail)_kernel")


def fit3_ops(model: str, T: int):
    """fp32 operations of csrc/fit3.cu's pieces at T echoes, counted from
    the source: each add, sub, mul, div, sqrt, exp, log, fabs, compare and
    select one, a NaN-keeping max/min one and a clip two, loop invariants
    once, the cheaper side of every branch (i0e's x < 3.75 knee, R/x's
    series). Returns (value_e, step, inits, prepare): one objective
    evaluation; one accepted Newton step (fgh 7 + 115 T rician / 3 + 105 T
    gaussian_rician, masked_solve3 99, the stop tests and update 86 with
    gtol > 0, the trial value_e); the three starts' inits together (the
    log-linear 18 T + 29, the grid scan 72 T + 90, and the interpolant 446
    for gaussian_rician at T = 3, else the guess, 0); and the per-voxel
    hoisted logs."""
    if model == "rician":
        value_e, fgh, prepare, third = 3 + 36 * T, 7 + 115 * T, 2 * T, 0
    else:
        value_e, fgh, prepare, third = 3 + 9 * T, 3 + 105 * T, 0, (446 if T == 3 else 0)
    return value_e, fgh + 99 + 86 + value_e, (18 * T + 29) + (72 * T + 90) + third, prepare


def work(config: dict, n: int, steps: dict):
    """(bytes, fp32 operations) of the pruned multistart of ``n`` voxels.
    The multistart: signal in, (x, stats) out (T 4 + 24 bytes); each
    start's init, its clip (6) and first evaluation, plus the winning
    start's accepted steps. The continuation: signal and (x0, st0) in,
    (x, stats) out (T 4 + 48 bytes); one evaluation at x0 plus its own
    accepted steps. Rejected steps and the losing starts' steps are not
    counted, so the bound is a lower one."""
    T = len(config["te"])
    value_e, step, inits, prepare = fit3_ops(config["model"], T)
    n_bytes = n * (T * 4 + 24) + n * (T * 4 + 48)
    n_ops = (n * (prepare + inits + 3 * (6 + value_e)) + steps["steps.fit3_multistart"] * step
             + n * (prepare + 6 + value_e) + steps["steps.fit3_cont"] * step)
    return n_bytes, n_ops


def bound_s(config: dict, n: int, steps: dict) -> float:
    """The two launches' bounds added: each has to finish before the next."""
    T = len(config["te"])
    value_e, step, inits, prepare = fit3_ops(config["model"], T)
    multi = _bound_s(n * (T * 4 + 24),
                     n * (prepare + inits + 3 * (6 + value_e)) + steps["steps.fit3_multistart"] * step)
    cont = _bound_s(n * (T * 4 + 48), n * (prepare + 6 + value_e) + steps["steps.fit3_cont"] * step)
    return multi + cont
