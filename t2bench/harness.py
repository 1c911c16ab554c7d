"""What every driver shares: the outcome of a run and the result line.

A driver (the module named by the traffic's ``driver``) makes its inputs, warms up, measures its window and judges what the window
produced; ``execute`` turns its ``Outcome`` into the result: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics, read by
``metrics/<name>.py`` (``--trace 1``), the device, the breakdown of the
trace, and each number that decides ``correct`` beside its limit.
"""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import spec
from .trace import Trace


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Outcome:
    """What a driver measured and judged; the metric readers read it."""
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    end_to_end: Dict[str, float] = field(default_factory=dict)
    checks: Dict[str, float] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)
    trace: Optional[Trace] = None
    #: items (requests) of the traced stretch, by index
    traced_items: List[int] = field(default_factory=list)
    #: item index -> (masked voxels, {"steps.<kernel>": accepted steps of the reference})
    item_work: Dict[int, Tuple[int, Dict[str, float]]] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    config: dict = field(default_factory=dict)

    def read_memory(self, device) -> None:
        import torch

        if torch.device(device).type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """Run ``cell`` once and return its result line as a dict, with the
    numbers that decide ``correct`` under the last key, ``checks``."""
    import torch

    driver = importlib.import_module(f"t2bench.{cell.traffic['driver']}")
    out: Outcome = driver.run(cell, seed, seconds, trace, device, t_start)
    out.config = cell.config
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.reader(m["name"])(out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = dict(out.end_to_end, setup_s=out.setup_s)
        for m in cell.end_to_end:
            if m["name"] not in measured:
                raise RuntimeError(f"{cell.name} measures no {m['name']}")
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": None, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": info}
    if trace and out.trace is not None:
        info["busy_s"] = out.trace.busy_s
        info["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": [list(kv) for kv in out.trace.top_ops()],
                               "idle_gaps": [list(kv) for kv in out.trace.top_gaps()]}
    checks = {name: {"value": out.checks.get(name), "limit": limit}
              for name, limit in cell.limits.items()}
    result["correct"] = set(out.checks) == set(cell.limits) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result["notes"] = out.notes + [
        f"seconds: set-up {out.setup_s:.1f}, window {out.window_s:.1f}, "
        f"the whole run {time.perf_counter() - t_start:.1f}"]
    result["checks"] = checks
    return result
