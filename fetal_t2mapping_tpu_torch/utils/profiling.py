"""Per-stage wall-time accumulator (``profiler.stage``) and device-trace
hooks (``trace``, ``annotate``).

The counterpart of ``fetal_t2mapping_tpu.utils.profiling``. Stages that
time device work must end in a host read or a synchronise: CUDA launches
return before the card finishes. The profiler is thread-safe: the writer
pool's threads add the ``io.*`` stages while the main thread adds its own.

Usage::

    from fetal_t2mapping_tpu_torch.utils.profiling import profiler, trace

    with profiler.stage("fit", items=n_voxels):
        result = fit_fused(...)
    print(profiler.report())

    with trace("trace_dir"):           # torch.profiler, Chrome trace format
        fit_fused(...)
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Dict, Iterator, Optional

log = logging.getLogger("fetal_t2mapping_tpu_torch.profiling")


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    items: int = 0

    @property
    def items_per_sec(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


class Profiler:
    """Thread-safe accumulator of per-stage wall time and throughput."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stages: Dict[str, StageStats] = {}

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, items)

    def add(self, name: str, seconds: float, items: int = 0) -> None:
        with self._lock:
            s = self._stages.setdefault(name, StageStats())
            s.calls += 1
            s.seconds += seconds
            s.items += items
        log.debug("stage %s: %.3f s (%d items)", name, seconds, items)

    def stats(self, name: str) -> Optional[StageStats]:
        """A copy of one stage's totals, or None if it never ran."""
        with self._lock:
            s = self._stages.get(name)
            return None if s is None else dataclasses.replace(s)

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()

    def report(self) -> str:
        """Human-readable per-stage table, sorted by total time."""
        with self._lock:
            rows = sorted(((k, dataclasses.replace(v)) for k, v in self._stages.items()),
                          key=lambda kv: -kv[1].seconds)
        lines = [f"{'stage':<28} {'calls':>6} {'total_s':>9} {'items':>10} {'items/s':>12}"]
        for name, s in rows:
            ips = f"{s.items_per_sec:,.0f}" if s.items else "-"
            items = f"{s.items:,}" if s.items else "-"
            lines.append(f"{name:<28} {s.calls:>6} {s.seconds:>9.3f} {items:>10} {ips:>12}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"calls": v.calls, "seconds": v.seconds, "items": v.items,
                        "items_per_sec": v.items_per_sec}
                    for k, v in self._stages.items()}


#: process-global profiler used by the pipeline
profiler = Profiler()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record a ``torch.profiler`` trace (CPU, and CUDA where available)
    around a block and write it to ``log_dir`` as a Chrome trace
    (``trace.json``). A profiler that cannot start is logged and the block
    runs untraced."""
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.start()
    except RuntimeError as e:
        log.warning("torch.profiler unavailable (%s); trace skipped", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range inside a ``torch.profiler`` trace."""
    import torch

    with torch.profiler.record_function(name):
        yield
