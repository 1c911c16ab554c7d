"""Blocking host reads of the device per traced request: the program's
``host_read`` spans under the requests' root ``fit_volume`` spans."""

from t2bench.metrics import _spans


def read(run):
    got = _spans.requests(run)
    if got is None:
        return None
    roots, spans = got
    ids = {r.request_id for r in roots}
    return sum(s.name == "host_read" and s.request_id in ids for s in spans) / len(roots)
