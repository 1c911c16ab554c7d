"""A device trace of a short stretch of a run, and its reduction.

``capture`` runs a function under ``torch.profiler`` (CPU and CUDA
activity), exports the Chrome trace and reduces it: the device operations
(kernels, copies, fills) and their time by name, the seconds in which any
ran (``busy_s``), the traced stretch's wall time (``window_s``) and the
idle gaps between device operations, each named by what the host was doing
(the innermost host event over the gap's middle).
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
MARK = "t2bench.traced"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    op_s: Dict[str, float] = field(default_factory=dict)      # device seconds by name
    gap_s: Dict[str, float] = field(default_factory=dict)     # idle seconds by host activity

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.op_s.items(), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.gap_s.items(), key=lambda kv: -kv[1])[:n]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def _host_labels(host: List[Tuple[float, float, str]], times: List[float]) -> List[str]:
    """For each of ``times``, the innermost (shortest) host event that spans
    it, in one sweep over the events sorted by start: a heap of the started
    events by length, from which those that ended before the time are
    dropped (the times come in increasing order, so they stay ended)."""
    events = sorted(host)
    started: List[Tuple[float, float, str]] = []
    labels, j = [], 0
    for t in times:
        while j < len(events) and events[j][0] <= t:
            start, end, name = events[j]
            heapq.heappush(started, (end - start, end, name))
            j += 1
        while started and started[0][1] < t:
            heapq.heappop(started)
        labels.append(started[0][2] if started else "host, no traced op")
    return labels


def reduce(events: List[dict], window_s: float) -> Trace:
    """Reduce Chrome-trace ``events`` (times in microseconds) of a stretch
    that ``MARK`` spans on the host."""
    device = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    host = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in _HOST_CATS and e["name"] != MARK]
    marks = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
             if e.get("ph") == "X" and e["name"] == MARK]
    op_s: Dict[str, float] = defaultdict(float)
    for start, end, name in device:
        op_s[name] += (end - start) * 1e-6
    busy = _union([(a, b) for a, b, _ in device])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gap_s: Dict[str, float] = defaultdict(float)
    if marks:
        lo, hi = marks[0]
        edges = [lo] + [x for a, b in busy for x in (a, b)] + [hi]
        gaps = [(max(a, lo), min(b, hi)) for a, b in zip(edges[0::2], edges[1::2])]
        gaps = [(a, b) for a, b in gaps if b > a]
        for (a, b), label in zip(gaps, _host_labels(host, [(a + b) / 2 for a, b in gaps])):
            gap_s[label] += (b - a) * 1e-6
    return Trace(window_s=window_s, busy_s=busy_s, op_s=dict(op_s), gap_s=dict(gap_s))


def capture(fn: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Run ``fn`` once under the profiler, ``sync`` before and after it,
    and reduce its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(MARK):
            fn()
            sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="t2bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events, window_s)
