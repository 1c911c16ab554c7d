"""Per-stage wall-time accumulator (``profiler.stage``).

The stage timer of ``fetal_t2mapping_tpu.utils.profiling``. Stages that
time device work must end in a host read or a synchronise: CUDA launches
return before the card finishes.

Usage::

    from fetal_t2mapping_tpu_torch.utils.profiling import profiler

    with profiler.stage("fit", items=n_voxels):
        result = fit_fused(...)
    print(profiler.as_dict())
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Dict, Iterator

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

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"calls": v.calls, "seconds": v.seconds, "items": v.items,
                        "items_per_sec": v.items_per_sec}
                    for k, v in self._stages.items()}


#: process-global profiler used by the pipeline
profiler = Profiler()
