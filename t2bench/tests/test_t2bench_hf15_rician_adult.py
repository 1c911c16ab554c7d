"""The ``hf15_rician_adult.serve_adult`` cell's files: the driver's tissue
layers hold the configuration's shares, CSF beyond the prior box fits to
its T2 bound in the reference and the program alike, a small run on the
CPU is ``correct`` where it should be and not where it should not (the
bfloat16 control, the planted faults), and the rows-per-fit metric reads
the root span's ``live_rows``, all without loading JAX."""

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from t2bench import harness, reference, serve_adult, spec, trace
from t2bench.tests.test_t2bench_run import (DRY_RUN, KEYS, ROOT, _answer_altered,
                                            _half_left_out, _state_unchanged, small)
from t2bench.tests.test_t2bench_spans import SPAN_METRICS

CELL = "hf15_rician_adult.serve_adult"
SEED = 2**31 + 26
#: the capacity a 24^3 grid's partly filled blocks need for masks of 8.5-12%
SMALL_MASK_FRAC = 0.6


def small_adult(side: int = 24, items: int = 2) -> spec.Cell:
    cell = small(CELL, side, items)
    cell.traffic["mask_frac"] = SMALL_MASK_FRAC
    return cell


def run_small(trace_on: bool = False, seed: int = 2**31 + 11) -> dict:
    return harness.execute(small_adult(), seed, 4.0, trace_on, "cpu", time.perf_counter())


def test_files_state_the_rician_row_and_the_tissue_table():
    cell = spec.load(ROOT, CELL)
    rician = spec.load(ROOT, "hf15_rician.serve").config
    for key in ("model", "low_field", "te", "initial_guess", "lower", "upper", "ftol", "gtol",
                "max_iters", "prefix3", "grid", "counts", "precision"):
        assert cell.config[key] == rician[key], key
    rows = serve_adult._rows(cell.config["data"])
    assert sum(r["share"] for r in rows) == pytest.approx(1.0)
    assert rows[2]["t2"][0] > cell.config["upper"][1]          # CSF lies beyond the box
    assert cell.traffic["driver"] == "serve_adult" and cell.traffic["mask_frac"] == 0.2
    assert cell.limits == spec.load(ROOT, "hf15_rician.serve").limits


@pytest.mark.parametrize("share", [0.085, 0.12])
def test_tissue_shares_match_the_configuration(share):
    """At 64^3 each tissue's share of the mask is the table's within 3
    points (CSF: its outer shell and the ventricles); every masked voxel
    has a tissue and the head outside it has none."""
    from t2bench.generate import ellipsoid_mask

    config = dict(spec.load(ROOT, CELL).config, grid=[64] * 3)
    lab = serve_adult.labels(config, share, (2, -3, 1), "cpu")
    mask = ellipsoid_mask(config["grid"], share, (2, -3, 1), "cpu")
    rows = serve_adult._rows(config["data"])
    n = int(mask.sum())
    for j, row in enumerate(rows[:3]):
        assert abs(int((lab[mask] == j).sum()) / n - row["share"]) < 0.03, row["name"]
    assert bool((lab[mask] < 3).all()) and bool((lab[~mask] == 3).all())


def test_items_are_the_seeds_and_layered():
    """The same seed gives the same bits; the tissues' T2 ranges show in
    the echoes' decay (CSF hardly decays over the echoes)."""
    cell = small_adult(side=32, items=2)
    a, lab = serve_adult.item_labels(cell.config, cell.traffic, SEED, 1, "cpu")
    b, _ = serve_adult.item_labels(cell.config, cell.traffic, SEED, 1, "cpu")
    assert torch.equal(a.signal, b.signal) and torch.equal(a.mask, b.mask)
    s = a.signal[a.mask]
    decay = (s[:, -1] / s[:, 0])
    tissue = lab[a.mask]
    assert decay[tissue == 2].min() > decay[tissue == 0].max()
    assert a.n_masked == int(a.mask.sum()) > 0


def test_csf_fits_to_the_bound_in_the_reference_and_the_program():
    """On the CSF voxels of a small item: the reference's maps bitwise
    ``fit_fused``'s (the plain fit3 kernels on the CPU) under the
    configuration, and T2 on the box's 600 ms bound for most of them."""
    from fetal_t2mapping_tpu_torch.models import fused_fit

    cell = small_adult(side=32, items=2)
    it, lab = serve_adult.item_labels(cell.config, cell.traffic, SEED, 0, "cpu")
    s = it.signal[it.mask & (lab == 2)]
    assert s.shape[0] > 100
    got = reference.fit(cell.config, s)
    te, lo, hi, guess = reference.fit_args(cell.config)
    want = fused_fit.fit_fused(s, te, lo, hi, model="rician", guess=guess,
                               max_iters=int(cell.config["max_iters"]),
                               ftol=float(cell.config["ftol"]), gtol=float(cell.config["gtol"]),
                               prefix3=4, device="cpu")
    assert torch.equal(torch.stack([got["k"], got["t2"], got["sigma"]], 1), want.x)
    assert torch.equal(got["fun"], want.fun) and torch.equal(got["converged"], want.converged)
    assert torch.equal(got["n_iter"], want.n_iter)
    pinned = float((got["t2"] == cell.config["upper"][1]).double().mean())
    assert pinned > 0.9, pinned


def test_sound_run_is_correct():
    result = run_small()
    assert result["correct"] is True, (result["checks"], result["attempted"], result["notes"])
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"voxel_fits_per_s", "request_p95_ms", "setup_s"}


def test_control_is_not_correct():
    """The reference in bfloat16 in the program's place reads an off_share
    above the cell's limit."""
    cell = small_adult()
    assert serve_adult.control(cell, 2**31 + 11, "cpu") > cell.limits["off_share"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered])
def test_a_broken_fit_is_not_correct(fault, monkeypatch):
    """The timed path broken under the harness, as for the other cells."""
    from fetal_t2mapping_tpu_torch.models import volume_fit

    real = volume_fit.fit_fused
    monkeypatch.setattr(volume_fit, "fit_fused",
                        lambda *a, **k: fault(real(*a, **k), k["guess"]))
    result = run_small()
    assert result["correct"] is False
    assert result["checks"]["off_share"]["value"] > result["checks"]["off_share"]["limit"]


def test_traced_run_reports_the_span_metrics():
    """One capacity read a request; on the CPU no fit kernel is in the
    device trace, so the rows-per-fit metric has nothing to read."""
    result = run_small(trace_on=True)
    metrics = result["metrics"]
    assert set(SPAN_METRICS) | {"wrapper_device_ms.serve"} <= set(metrics)
    assert metrics["host_reads.serve"] == {"value": 1.0, "unit": "reads"}
    assert "fit_ns_per_row.serve" not in metrics
    assert result["correct"] is True


def _roots(rows):
    return [types.SimpleNamespace(name="fit_volume", parent_id=None, request_id=i,
                                  attrs={} if n is None else {"live_rows": n})
            for i, n in enumerate(rows)]


def test_fit_ns_per_row_reads_the_family_kernels_over_the_live_rows(monkeypatch):
    """The family's kernels' device ns over the summed ``live_rows`` of the
    traced requests' roots; None where a root has no ``live_rows`` (an
    older program) or the trace holds no fit kernel."""
    read = spec.reader("fit_ns_per_row.serve")
    module = types.ModuleType("profiling")
    roots = _roots([2000, 3000])
    module.profiler = types.SimpleNamespace(spans=lambda: roots)
    monkeypatch.setitem(sys.modules, "fetal_t2mapping_tpu_torch.utils.profiling", module)
    ops = {"void (anonymous namespace)::fit3_multistart_kernel<3>(P)": 3e-6,
           "void (anonymous namespace)::fit3_tail_kernel<3>(P)": 2e-6,
           "layout_scatter_kernel(unsigned char const*)": 7e-6}
    run = types.SimpleNamespace(traced_items=[0, 1], trace=trace.Trace(1.0, 0.5, op_s=ops),
                                config={"counts": "fit3"})
    assert read(run) == pytest.approx(1e9 * 5e-6 / 5000)
    roots[1:] = _roots([None])
    assert read(run) is None
    roots[:] = _roots([2000, 3000])
    run.trace = trace.Trace(1.0, 0.5, op_s={"layout_scatter_kernel": 1e-6})
    assert read(run) is None
    monkeypatch.setitem(sys.modules, "fetal_t2mapping_tpu_torch.utils.profiling", None)
    assert read(run) is None


@pytest.mark.parametrize("trace_on", [0, 1])
def test_dry_run_loads_no_jax(trace_on):
    """In a fresh process: the result's keys in order and no JAX module."""
    proc = subprocess.run([sys.executable, "-c", DRY_RUN, CELL, str(trace_on)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["keys"] == KEYS + (["breakdown"] if trace_on else []) + ["notes", "checks"]
    assert out["forbidden"] == []
    assert "fetal_t2mapping_tpu_torch" in out["held"]
    assert not {"jax", "jaxlib", "flax", "fetal_t2mapping_tpu"} & set(out["held"])
