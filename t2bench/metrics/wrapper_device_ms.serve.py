"""Device time per traced request of every operation that is not a fit
kernel (the serving wrapper's filler, partition sort, gather and scatter,
and its copies and fills), in ms, from the trace."""

from t2bench import spec


def read(run):
    if run.trace is None or not run.traced_items:
        return None
    counts = spec.counts(run.config["counts"])
    other_s = sum(s for name, s in run.trace.op_s.items() if not counts.KERNELS.search(name))
    return 1e3 * other_s / len(run.traced_items)
