"""Device-idle time per traced request spent in the serving wrapper's own
host code, in ms: the idle gaps of the trace that it labels with one of
the program's span names (``profiling.SPAN_NAMES``; a gap is named by the
innermost host event over its middle, so these are gaps in which the host
ran Python of ``fit_volume`` between two traced ops; a request's root span
is the one that enters the trace)."""

from t2bench.metrics import _spans


def read(run):
    got = _spans.requests(run)
    if got is None or run.trace is None:
        return None
    names = _spans.program().SPAN_NAMES
    idle_s = sum(s for label, s in run.trace.gap_s.items() if label in names)
    return 1e3 * idle_s / len(got[0])
