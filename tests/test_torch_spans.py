"""The port's spans and counters (``utils.profiling``) on the serving path.

Under a CPU ``torch.profiler`` session one ``fit_volume`` request records
its span tree (one request id, each span under its parent, its
``host_read``s), two requests get two ids, a mesh's shard threads record
under the request, and each root span sits in the exported Chrome trace as
a ``user_annotation`` event at its recorded start. With no profiler
running nothing records and ``record_function`` is never entered. Port
only: the JAX package has no spans.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fetal_t2mapping_tpu_torch import graphs
from fetal_t2mapping_tpu_torch.models.volume_fit import fit_volume
from fetal_t2mapping_tpu_torch.parallel import voxel_mesh
from fetal_t2mapping_tpu_torch.utils import profiling
from fetal_t2mapping_tpu_torch.utils.profiling import Profiler, profiler

torch.set_num_threads(1)

TES = (114.0, 202.0, 299.0)
FITS = {  # model: (lo, hi, guess, the C entries a request launches)
    "gaussian": ((0.0, 10.0), (1e6, 2000.0), None, ["gauss_fit"]),
    "rician": ((1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0),
               ["fit3", "fit3_cont"]),
    "gaussian_rician": ((1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0),
                        ["gr_varpro_fit"]),
}


def _request(n=10, seed=0):
    """A small (n, n, n, 3) echo volume and its ellipsoid mask."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(600.0, 5000.0, (n, n, n)).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, (n, n, n)).astype(np.float32)
    sig = k[..., None] * np.exp(-np.asarray(TES, np.float32) / t2[..., None])
    sig = np.maximum(sig + rng.normal(0, 8.0, sig.shape), 1e-2).astype(np.float32)
    ax = (np.arange(n) - (n - 1) / 2) / (n / 2)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    return sig, zz ** 2 + yy ** 2 + xx ** 2 <= 0.8


def _serve(model="gaussian", compact=True, **kw):
    """One request on the CPU, the block buffer's capacity the whole grid
    (``compact=False`` sizes it so without a capacity check)."""
    sig, mask = _request()
    lo, hi, guess, _ = FITS[model]
    return fit_volume(sig, mask, TES, lo, hi, model=model, guess=guess, mask_frac=1.0,
                      compact=compact, device="cpu", **kw)


def _recorded(fn, trace_path=None):
    """The spans the global profiler records while ``fn()`` runs under a
    CPU torch.profiler session (and the exported trace's JSON)."""
    last = max((s.span_id for s in profiler.spans()), default=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = None
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
        events = json.loads(trace_path.read_text())
    return [s for s in profiler.spans() if s.span_id > last], events


def _tree(spans):
    """{name: [parent's name, ...]} over ``spans``, by span id."""
    by_id = {s.span_id: s for s in spans}
    tree = {}
    for s in spans:
        tree.setdefault(s.name, []).append(None if s.parent_id is None
                                           else by_id[s.parent_id].name)
    return tree


@pytest.mark.parametrize("model,layout,check", [("gaussian", "block", True),
                                                ("gaussian", "block", False),
                                                ("gaussian", "dense", True),
                                                ("rician", "block", True),
                                                ("gaussian_rician", "block", True)])
def test_fit_volume_records_its_span_tree(model, layout, check):
    # varpro3 pinned: gaussian_rician's VARPRO kernel whatever FT2_FIT3_VARPRO
    # says (the other models ignore it)
    spans, _ = _recorded(lambda: _serve(model, compact=layout == "block",
                                        check_capacity=check, varpro3=True))
    roots = [s for s in spans if s.parent_id is None]
    assert [r.name for r in roots] == ["fit_volume"]
    root = roots[0]
    assert {s.request_id for s in spans} == {root.request_id}
    assert {s.thread for s in spans} == {threading.get_ident()}
    kernels = FITS[model][3]
    want = {"fit_volume": [None], "fit_volume.prepare": ["fit_volume"],
            "fit_volume.compact": ["fit_volume"], "fit_fused": ["fit_volume"],
            "fit_fused.resolve": ["fit_fused"], "fit_fused.launch": ["fit_fused"] * len(kernels),
            "fit_volume.scatter": ["fit_volume"]}
    reads = int(check and layout == "block")     # compact=False has nothing to check
    if reads:
        # the read is of the compaction's touched-block count, before the fit
        want.update({"fit_volume.capacity_check": ["fit_volume"],
                     "host_read": ["fit_volume.capacity_check"]})
    assert _tree(spans) == want
    if reads:
        at = {s.name: s for s in spans}
        assert (at["fit_volume.compact"].end_ns <= at["fit_volume.capacity_check"].start_ns
                and at["fit_volume.capacity_check"].end_ns <= at["fit_fused"].start_ns)
    assert len(spans) <= 10
    assert [s.attrs["kernel"] for s in spans if s.name == "fit_fused.launch"] == kernels
    assert sum(s.name == "host_read" for s in spans) == reads
    n = 10 ** 3
    assert root.attrs["model"] == model and "layout" not in root.attrs
    assert root.attrs["grid_voxels"] == n
    assert root.attrs["capacity_rows"] == 1024
    assert all(s.end_ns >= s.start_ns for s in spans)
    assert {s.name for s in spans} <= profiling.SPAN_NAMES


def test_two_requests_get_distinct_request_ids():
    spans, _ = _recorded(lambda: (_serve(), _serve()))
    roots = [s for s in spans if s.parent_id is None]
    assert len(roots) == 2 and roots[0].request_id != roots[1].request_id
    for root in roots:
        assert sum(s.request_id == root.request_id for s in spans) == 9


def test_nothing_records_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    last = [s.span_id for s in profiler.spans()]
    reads = profiler.counter("host_reads")
    assert profiling._CURRENT.get() is None
    res = _serve()
    assert [s.span_id for s in profiler.spans()] == last
    assert profiler.counter("host_reads") == reads + 1      # counters count regardless
    assert int(res.n_masked) > 0
    for opened in (profiler.request("x", a=1), profiler.span("x", a=1)):
        with opened as span:
            span.set(b=2)
            assert span is profiling.NO_SPAN and profiling._CURRENT.get() is None


def test_chrome_trace_holds_each_root_span_at_its_recorded_start(tmp_path):
    """Roots enter ``record_function``; the spans under them stay in memory."""
    spans, trace = _recorded(lambda: (_serve(), _serve("rician")), tmp_path / "trace.json")
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    events = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            events.setdefault(e["name"], []).append(e["ts"] + base_us)
    roots = [s for s in spans if s.parent_id is None]
    assert len(roots) == 2 and len(events["fit_volume"]) == 2
    for s in roots:
        off_us = min(abs(ts - s.start_ns / 1e3) for ts in events[s.name])
        assert off_us <= 1000.0, (s, off_us)
    assert not {s.name for s in spans if s.parent_id is not None} & set(events)


def test_mesh_shards_record_under_the_request():
    mesh = voxel_mesh(devices=["cpu"] * 2)
    spans, _ = _recorded(lambda: _serve(mesh=mesh))
    roots = [s for s in spans if s.parent_id is None]
    assert [r.name for r in roots] == ["fit_volume"]
    assert {s.request_id for s in spans} == {roots[0].request_id}
    by_id = {s.span_id: s for s in spans}
    shard_spans = [s for s in spans if s.thread != threading.get_ident()]
    assert [s.name for s in shard_spans] == ["fit_fused.launch"] * 2
    for s in shard_spans:
        chain = [s]
        while chain[-1].parent_id is not None:
            chain.append(by_id[chain[-1].parent_id])
        assert [c.name for c in chain][-2:] == ["fit_fused", "fit_volume"]


def test_span_buffer_counts_the_spans_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_SPAN_LIMIT", 4)
    prof = Profiler()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with prof.request("s", i=i):
                pass
    assert [s.attrs["i"] for s in prof.spans()] == [2, 3, 4, 5]
    assert prof.counter("spans.dropped") == 2


def test_stage_is_a_span_and_keeps_its_totals():
    prof = Profiler()
    with prof.stage("t2map.fit", items=7):
        prof.count("gauss_fit.launches")
    with profile(activities=[ProfilerActivity.CPU]):
        with prof.stage("t2map.fit", items=3):
            with prof.span("inner"):
                prof.count("gauss_fit.launches", 2)
    stats = prof.stats("t2map.fit")
    assert (stats.calls, stats.items) == (2, 10)
    assert list(prof.as_dict()) == ["t2map.fit"]
    outer, = [s for s in prof.spans() if s.name == "t2map.fit"]
    inner, = [s for s in prof.spans() if s.name == "inner"]
    assert inner.parent_id == outer.span_id and outer.attrs == {"items": 3}
    assert inner.request_id == outer.request_id
    assert prof.counter("gauss_fit.launches") == 3
    lines = prof.report().splitlines()
    assert lines[1].startswith("t2map.fit") and lines[-1].split() == ["gauss_fit.launches", "3"]
    prof.reset()
    assert prof.stats("t2map.fit") is None and prof.spans() == []
    assert prof.counter("gauss_fit.launches") == 3


def test_graphs_read_is_a_counted_host_read():
    reads = profiler.counter("host_reads")
    assert graphs.read(torch.tensor(True)) is True
    assert graphs.read(torch.tensor(False)) is False
    assert profiler.counter("host_reads") == reads + 2
