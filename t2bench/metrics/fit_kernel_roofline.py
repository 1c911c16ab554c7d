"""Share of the fit kernels' roofline over the traced requests, in %.

The least time an H100 needs for the traced requests' fits (the masked
voxels' bytes and fp32 operations, with the accepted steps of the
benchmark's reference, counted by ``counts/<config counts>.py``) over the
device time of the kernels those counts cover, from the trace."""

from t2bench import spec


def read(run):
    if run.trace is None or not run.traced_items:
        return None
    counts = spec.counts(run.config["counts"])
    kernel_s = sum(s for name, s in run.trace.op_s.items() if counts.KERNELS.search(name))
    if kernel_s <= 0 or any(i not in run.item_work for i in run.traced_items):
        return None
    bound_s = sum(counts.bound_s(run.config, *run.item_work[i]) for i in run.traced_items)
    return 100.0 * bound_s / kernel_s
