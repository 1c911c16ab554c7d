"""The program's own spans, for the readers of ``program_span`` and
``program_counter`` metrics.

Found in the running process (``sys.modules``), not imported: the
yardstick imports nothing of the program, and a program that records no
spans (an older commit) gives nothing to read, so its readers return None.
"""

import sys

PROFILING = "fetal_t2mapping_tpu_torch.utils.profiling"


def program():
    """The program's tracing module, if this process holds one that
    records spans, else None."""
    module = sys.modules.get(PROFILING)
    if module is None or not hasattr(getattr(module, "profiler", None), "spans"):
        return None
    return module


def requests(run):
    """(the root ``fit_volume`` spans of the traced requests, every
    recorded span), or None where fewer roots than traced requests were
    recorded: the last ``len(run.traced_items)`` roots are the stretch's,
    since spans record only under the profiler."""
    module = program()
    if module is None or not run.traced_items:
        return None
    spans = module.profiler.spans()
    roots = [s for s in spans if s.name == "fit_volume" and s.parent_id is None]
    n = len(run.traced_items)
    if len(roots) < n:
        return None
    return roots[-n:], spans
