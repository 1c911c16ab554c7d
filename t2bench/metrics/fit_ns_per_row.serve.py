"""Device ns of the fit kernels per row they ran over, over the traced
requests: the kernels that the configuration's ``counts`` family names
(``counts/<counts>.py`` ``KERNELS``), timed in the trace, over the
``live_rows`` the requests' root ``fit_volume`` spans record (the touched
blocks' rows, from the capacity check's read). Where ``fit_kernel_roofline``
divides by the reference's accepted steps, this divides by rows, so more
rows and longer chains a row read apart."""

from t2bench import spec
from t2bench.metrics import _spans


def read(run):
    got = _spans.requests(run)
    if got is None or run.trace is None:
        return None
    rows = [r.attrs.get("live_rows") for r in got[0]]
    if any(not isinstance(n, int) or n <= 0 for n in rows):
        return None
    counts = spec.counts(run.config["counts"])
    kernel_s = sum(s for name, s in run.trace.op_s.items() if counts.KERNELS.search(name))
    if kernel_s <= 0:
        return None
    return 1e9 * kernel_s / sum(rows)
