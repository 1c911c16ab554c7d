"""The metrics that read the program's spans: a small traced CPU run reports
them beside the earlier ones, an idle gap inside a program span is named
by it, and a program that records no spans gives nothing to read."""

import sys
import types

import pytest

from t2bench import spec, trace
from t2bench.tests.test_t2bench_run import CELLS, run_small

SPAN_METRICS = ["wrapper_idle_ms.serve", "wrapper_host_ms.serve", "host_reads.serve"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_span_metrics(name):
    """All three, one capacity read a request, beside the earlier metric
    that reads on the CPU (the other two read the card's kernels)."""
    result = run_small(name, trace=True)
    metrics = result["metrics"]
    assert set(SPAN_METRICS) | {"wrapper_device_ms.serve"} <= set(metrics)
    assert metrics["host_reads.serve"] == {"value": 1.0, "unit": "reads"}
    assert metrics["wrapper_host_ms.serve"]["value"] > 0
    assert metrics["wrapper_idle_ms.serve"]["value"] >= 0
    assert result["correct"] is True


def test_reduce_names_a_gap_inside_a_program_span_by_the_span():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.MARK, "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "user_annotation", "name": "fit_volume", "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "user_annotation", "name": "fit_volume.compact", "ts": 35.0,
           "dur": 30.0},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 10.0, "dur": 20.0},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 70.0, "dur": 10.0}]
    t = trace.reduce(ev, 1e-4)
    assert t.gap_s == pytest.approx({"fit_volume.compact": 40e-6, "fit_volume": 30e-6})


def test_a_program_without_spans_gives_nothing_to_read(monkeypatch):
    """An older program (no ``profiler.spans``) or none loaded: None."""
    run = types.SimpleNamespace(traced_items=[0, 1], trace=trace.Trace(1.0, 0.5))
    old = types.ModuleType("profiling")
    old.profiler = types.SimpleNamespace(stats=lambda name: None)
    for module in (old, None):
        monkeypatch.setitem(sys.modules, "fetal_t2mapping_tpu_torch.utils.profiling", module)
        for name in SPAN_METRICS:
            assert spec.reader(name)(run) is None
