"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W).

Copied from ``chip_smoke.py`` at commit 69168b9 (``HBM_BPS``, ``FP32_OPS``,
``bound``), with the bound in seconds.
"""

HBM_BPS = 3.35e12       # HBM3 bytes per second
FP32_OPS = 67e12        # float32 operations per second outside the tensor cores


def bound_s(n_bytes: float, n_ops: float, peak_ops: float = FP32_OPS) -> float:
    """The least time the card could take for work that moves ``n_bytes``
    (each input read once, each output written once) and does ``n_ops``
    operations at ``peak_ops`` per second."""
    return max(n_bytes / HBM_BPS, n_ops / peak_ops)
