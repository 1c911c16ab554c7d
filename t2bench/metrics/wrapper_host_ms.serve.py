"""Host time per traced request inside the root ``fit_volume`` span, less
its ``host_read`` spans (the host waiting for the device), in ms: the
host's own cost of enqueueing a request, from the program's spans."""

from t2bench.metrics import _spans


def read(run):
    got = _spans.requests(run)
    if got is None:
        return None
    roots, spans = got
    ids = {r.request_id for r in roots}
    read_ns = sum(s.end_ns - s.start_ns for s in spans
                  if s.name == "host_read" and s.request_id in ids)
    host_ns = sum(r.end_ns - r.start_ns for r in roots) - read_ns
    return host_ns / 1e6 / len(roots)
