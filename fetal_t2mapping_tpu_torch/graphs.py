"""A solver loop's step captured once as a CUDA graph and replayed per iteration.

The JAX package compiles its solver loops into one device program each:
the registration levels (``lax.while_loop`` / the fixed-budget scan in
``recon.registration``), the convergence-trace sampler (``lax.scan`` in
``models.solver.fit_batch_traced``), the batch solver's early exit
(``models.solver.fit_batch``), TV, the hole fill and the N4 levels. Stepped from Python, one eager op at a
time, the same loops are bound by kernel launches on the card (a 192^3
rigid solve launched ~53,000 kernels and left the card ~94% idle). Here the
loop body is written as a step that reads and writes preallocated buffers
in place (iteration counters included), captured once with CUDA stream
capture and replayed once per iteration: one graph launch where the step
launched hundreds of kernels.

``capture`` runs the first step eagerly on a side stream before capturing
the step on that same stream. That warm-up is a real iteration of the loop:
it fills lazy caches (a host-to-device copy is not allowed during capture)
and sets up the stream's cuBLAS workspace, so the captured kernels are the
ones an eager step launches. Capture is thread-local, so threads that queue
downloads on their own streams (the asynchronous NIfTI writer) may run
meanwhile. A capture or replay that fails raises: no caller falls back to
the eager loop. ``stepper`` wraps a step as one call per iteration, the
graph's or the eager step's.

``CAPTURES`` and ``REPLAYS`` count this process's captures and replays,
``HOST_READS`` the stop flags that the graphed loops read (``read``).
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

#: graphs captured and replayed, and stop flags read, in this process (each
#: counted where it happens)
CAPTURES = 0
REPLAYS = 0
HOST_READS = 0
_COUNT_LOCK = threading.Lock()


def _count(counter: str) -> None:
    with _COUNT_LOCK:
        globals()[counter] += 1


def read(flag: torch.Tensor) -> bool:
    """``bool(flag)`` of a device flag: the host waits for the device."""
    _count("HOST_READS")
    return bool(flag)


class StepGraph:
    """A step captured by ``capture`` (a function of no arguments that
    updates CUDA buffers in place); call the object to replay it on the
    current stream."""

    def __init__(self, graph: torch.cuda.CUDAGraph):
        self._graph = graph

    def __call__(self) -> None:
        self._graph.replay()
        _count("REPLAYS")


def _make_room(device: torch.device) -> None:
    """Give the allocator's cached free blocks back to the device when they
    outweigh the device's free memory. The capture allocates from a pool
    of its own, about what the warm-up step allocated, and cannot free
    cached blocks while it runs; the warm-up's blocks are in the cache, so
    free memory at least as large as the cache leaves room. (A solver step
    over millions of rows takes tens of GiB: without this its capture ran
    out of memory. torch.cuda.graph empties the cache before every capture,
    which costs a device sync and re-allocations each time.)"""
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    if cached > torch.cuda.mem_get_info(device)[0]:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def capture(step: Callable[[], None], warm_up: Callable[[], None],
            device: torch.device) -> StepGraph:
    """Run ``warm_up()`` eagerly, then capture ``step()``, both on one side
    stream of ``device``; the caller's stream waits for the warm-up.
    Capturing launches nothing, so the buffers hold the warm-up's results
    afterwards."""
    caller = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(caller)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.stream(side):
        warm_up()
        _make_room(device)
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            step()
        except BaseException:
            # end the capture before the original error propagates
            try:
                graph.capture_end()
            except RuntimeError:
                pass
            raise
        graph.capture_end()
    caller.wait_stream(side)
    _count("CAPTURES")
    return StepGraph(graph)


def stepper(step: Callable[[], None], device: torch.device, graph: bool) -> Callable[[], None]:
    """A function that runs one iteration of a loop per call: ``step()``
    itself each time (``graph=False``), or, on the card, the first call as
    ``capture``'s warm-up and every later call as a replay of the graph."""
    if not graph:
        return step
    replay = None

    def run() -> None:
        nonlocal replay
        if replay is None:
            replay = capture(step, step, device)
        else:
            replay()

    return run
