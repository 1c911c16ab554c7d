"""The port's one system of spans, counters and stage totals, and its
device-trace hook.

- ``profiler.request(name, **attrs)``: a context manager that, with no
  span open on the calling thread and a ``torch.profiler`` session active
  there (``trace(dir)``, or any ``torch.profiler.profile``), opens a root
  span: a request, with a new request id from a process-wide counter. A
  root also enters ``torch.profiler.record_function(name)``, so it sits in
  the profiler's Chrome trace as a ``user_annotation`` event, on the
  device ops' timeline. Under an open span it opens an ordinary span.
- ``profiler.span(name, **attrs)``: a span under the one open on the
  thread, sharing its request id; with none open it records nothing. A
  span records its name, span id, parent's span id, request id, thread,
  start and end, and its attributes, in memory only: a ``record_function``
  costs 15-20 us of host time under the profiler (an H100 host), so one a
  request, its root's, labels the trace. With nothing recording, ``request`` costs a context-variable read
  and a flag read, ``span`` the read alone, and both return ``NO_SPAN``.
  Threads do not inherit the open span: a worker (the shards of
  ``parallel.mesh``) runs in a copy of its caller's ``contextvars``
  context, and its spans record under the caller's.
- ``profiler.spans()``: the recorded spans, oldest first, from a bounded
  buffer (``_SPAN_LIMIT``); the spans it dropped are counted in
  ``spans.dropped``.
- ``profiler.count(name, n)`` / ``profiler.counter(name)``: one locked
  registry of counters (kernel launches, graph captures and replays, host
  reads).
- ``profiler.host_read(tensor)``: the host's blocking read of a small
  device tensor, as a ``host_read`` span and one ``host_reads`` count.
- ``profiler.stage(name, items=...)``: a ``request`` that also keeps
  per-stage wall-time totals (``stats``, ``as_dict``, ``report``). Stages
  that time device work end in a host read or a synchronise: CUDA launches
  return before the card finishes.

Span start and end are ``time.time_ns()``, the clock of the exported
Chrome trace's host events (their ``ts`` plus ``baseTimeNanoseconds``).
The profiler is thread-safe: the writer pool's threads add the ``io.*``
stages while the main thread adds its own.

Usage::

    from fetal_t2mapping_tpu_torch.utils.profiling import profiler, trace

    with profiler.stage("fit", items=n_voxels):
        result = fit_fused(...)
    print(profiler.report())

    with trace("trace_dir"):           # torch.profiler, Chrome trace format
        fit_volume(...)
    roots = [s for s in profiler.spans() if s.parent_id is None]
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import logging
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

log = logging.getLogger("fetal_t2mapping_tpu_torch.profiling")

_profiler_enabled = torch.autograd._profiler_enabled

#: names of every span recorded in this process (an idle gap of a device
#: trace labelled with one of them was spent in the program's own code)
SPAN_NAMES = set()

#: the recording span open on this thread (threads start with none)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("ft2_span", default=None)
#: spans kept for ``spans()``; older ones are dropped and counted
_SPAN_LIMIT = 65536
_SPAN_IDS = itertools.count(1)
_REQUEST_IDS = itertools.count(1)


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    items: int = 0

    @property
    def items_per_sec(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


class Span:
    """One recorded span. ``parent_id`` is None for a root; ``thread`` is
    ``threading.get_ident()``; times in ns of ``time.time_ns()``."""

    __slots__ = ("name", "span_id", "parent_id", "request_id", "thread", "start_ns",
                 "end_ns", "attrs", "_owner", "_parent", "_token", "_rf")

    def __init__(self, owner: "Profiler", name: str, parent: Optional["Span"], attrs: dict):
        self.name = name
        self.attrs = attrs
        self._owner = owner
        self._parent = parent
        self._rf = None

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        parent = self._parent
        self.span_id = next(_SPAN_IDS)
        if parent is None:      # a root: ``request`` saw the profiler running
            self.parent_id, self.request_id = None, next(_REQUEST_IDS)
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self.parent_id, self.request_id = parent.span_id, parent.request_id
        self.thread = threading.get_ident()
        self._token = _CURRENT.set(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _CURRENT.reset(self._token)
        self._owner._keep(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.span_id}, parent={self.parent_id}, "
                f"request={self.request_id}, {(self.end_ns - self.start_ns) / 1e3:.1f} us)")


class _NoSpan:
    """What ``span`` and ``request`` return when nothing records."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class Profiler:
    """Thread-safe spans, counters and per-stage totals."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stages: Dict[str, StageStats] = {}
        self._counters: Dict[str, int] = {}
        self._spans: collections.deque = collections.deque(maxlen=_SPAN_LIMIT)

    # -------------------------------------------------------------- spans
    def request(self, name: str, **attrs):
        """A span named ``name`` under the span open on this thread, or,
        with none open and a profiler running on it, a root: a new
        request. Else ``NO_SPAN``."""
        parent = _CURRENT.get()
        if parent is None and not _profiler_enabled():
            return NO_SPAN
        return Span(self, name, parent, attrs)

    def span(self, name: str, **attrs):
        """A span named ``name`` under the span open on this thread, or
        ``NO_SPAN`` if none is open."""
        parent = _CURRENT.get()
        if parent is None:
            return NO_SPAN
        return Span(self, name, parent, attrs)

    def _keep(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._counters["spans.dropped"] = self._counters.get("spans.dropped", 0) + 1
            self._spans.append(span)
            SPAN_NAMES.add(span.name)

    def spans(self) -> List[Span]:
        """The recorded spans in the order they ended."""
        with self._lock:
            return list(self._spans)

    # ----------------------------------------------------------- counters
    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        """The counter ``name`` (0 if nothing counted it)."""
        with self._lock:
            return self._counters.get(name, 0)

    def host_read(self, value: torch.Tensor):
        """``value.item()`` of a one-element tensor, ``value.tolist()`` of a
        longer one (one copy either way): on a CUDA tensor the host waits
        for the device. Recorded as a ``host_read`` span and counted in
        ``host_reads``."""
        with self.span("host_read"):
            self.count("host_reads")
            return value.item() if value.numel() == 1 else value.tolist()

    # ------------------------------------------------------------- stages
    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with self.request(name, items=items):
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
        """Forget every stage total and recorded span (counters run for the
        life of the process: callers take differences)."""
        with self._lock:
            self._stages.clear()
            self._spans.clear()

    def report(self) -> str:
        """Human-readable per-stage table, sorted by total time, and the
        counters under it."""
        with self._lock:
            rows = sorted(((k, dataclasses.replace(v)) for k, v in self._stages.items()),
                          key=lambda kv: -kv[1].seconds)
            counters = sorted(self._counters.items())
        lines = [f"{'stage':<28} {'calls':>6} {'total_s':>9} {'items':>10} {'items/s':>12}"]
        for name, s in rows:
            ips = f"{s.items_per_sec:,.0f}" if s.items else "-"
            items = f"{s.items:,}" if s.items else "-"
            lines.append(f"{name:<28} {s.calls:>6} {s.seconds:>9.3f} {items:>10} {ips:>12}")
        if counters:
            lines.append(f"{'counter':<28} {'count':>6}")
            lines.extend(f"{name:<28} {n:>6}" for name, n in counters)
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"calls": v.calls, "seconds": v.seconds, "items": v.items,
                        "items_per_sec": v.items_per_sec}
                    for k, v in self._stages.items()}


#: process-global profiler used by the program
profiler = Profiler()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record a ``torch.profiler`` trace (CPU, and CUDA where available)
    around a block and write it to ``log_dir`` as a Chrome trace
    (``trace.json``); the block's spans record meanwhile. A profiler that
    cannot start is logged and the block runs untraced."""
    import os

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
