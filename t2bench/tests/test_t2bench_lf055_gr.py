"""The ``lf055_gr.serve`` cell's files: the frozen VARPRO reference gives the
bits of the program's plain VARPRO fit, its work counts are
``chip_smoke.py``'s, and a small run on the CPU is ``correct`` where it
should be and not where it should not (the bfloat16 control, the planted
faults), without loading JAX."""

import json
import os
import subprocess
import sys

import pytest
import torch

from t2bench import control, generate, reference
from t2bench.counts import gr_varpro_fit
from t2bench.tests.test_t2bench_run import (DRY_RUN, KEYS, ROOT, _answer_altered,
                                            _half_left_out, _state_unchanged, run_small,
                                            small)
from t2bench.tests.test_t2bench_spans import SPAN_METRICS

CELL = "lf055_gr.serve"
SEED = 2**31 + 22


def test_reference_is_the_programs_plain_varpro_fit():
    """At 24^3, one seed: every map bitwise ``fit_fused``'s on the CPU with
    the VARPRO kernel's plain version, and a positive steps sum."""
    from fetal_t2mapping_tpu_torch.models import fused_fit

    cell = small(CELL)
    s = torch.cat([it.signal[it.mask] for it in generate.items(cell.config, cell.traffic,
                                                               SEED, "cpu")])
    got = reference.fit(cell.config, s)
    te, lo, hi, guess = reference.fit_args(cell.config)
    want = fused_fit.fit_fused(s, te, lo, hi, model="gaussian_rician", guess=guess,
                               max_iters=int(cell.config["max_iters"]),
                               ftol=float(cell.config["ftol"]), gtol=float(cell.config["gtol"]),
                               varpro3=True, device="cpu")
    assert sorted(got) == sorted(["k", "t2", "sigma", "fun", "converged", "n_iter",
                                  "steps.gr_varpro_fit"])
    assert torch.equal(torch.stack([got["k"], got["t2"], got["sigma"]], 1), want.x)
    assert torch.equal(got["fun"], want.fun) and torch.equal(got["converged"], want.converged)
    assert got["n_iter"].dtype == torch.int32 and torch.equal(got["n_iter"], want.n_iter)
    assert got["steps.gr_varpro_fit"] == float(want.n_iter.double().sum()) > 0


def test_reference_refuses_another_kernel():
    cell = small(CELL)
    s = torch.ones(4, 3)
    for config in (dict(cell.config, varpro3=0), dict(cell.config, model="rician")):
        with pytest.raises(ValueError):
            reference.fit(config, s)


@pytest.mark.parametrize("T,gtol", [(3, 0.0), (3, 1e-2), (6, 0.0), (6, 1e-2)])
def test_counts_equal_chip_smoke(T, gtol):
    import chip_smoke as cs

    assert gr_varpro_fit.gr_varpro_ops(T, gtol) == cs.gr_varpro_ops(T, gtol)
    n, steps = 123_457, 987_654
    config = {"te": list(range(100, 100 + 10 * T, 10)), "gtol": gtol}
    ms, _, ops = cs.gr_varpro_bound(n, T, steps, gtol)
    work = {"steps.gr_varpro_fit": steps}
    assert gr_varpro_fit.work(config, n, work) == (n * (T * 4 + 24), ops)
    assert gr_varpro_fit.bound_s(config, n, work) == pytest.approx(ms * 1e-3)
    assert gr_varpro_fit.KERNELS.search("void gr_varpro_tail_kernel<3>(GrParams)")
    assert not gr_varpro_fit.KERNELS.search("gauss_tail_kernel")


def test_sound_run_is_correct():
    result = run_small(CELL)
    assert result["correct"] is True, (result["checks"], result["attempted"], result["notes"])
    assert result["failed"] == 0 and result["attempted"] >= 1


def test_control_is_not_correct():
    """The reference in bfloat16 in the program's place reads an off_share
    above the cell's limit."""
    cell = small(CELL)
    assert control.off_share(cell, 2**31 + 11, "cpu") > cell.limits["off_share"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered])
def test_a_broken_fit_is_not_correct(fault, monkeypatch):
    """The timed path broken under the harness, as for the other cells."""
    from fetal_t2mapping_tpu_torch.models import volume_fit

    real = volume_fit.fit_fused
    monkeypatch.setattr(volume_fit, "fit_fused",
                        lambda *a, **k: fault(real(*a, **k), k["guess"]))
    result = run_small(CELL)
    assert result["correct"] is False
    assert result["checks"]["off_share"]["value"] > result["checks"]["off_share"]["limit"]


def test_traced_run_reports_the_span_metrics():
    """The span metrics read this model's requests as the other cells':
    one capacity read a request, host time inside the root span."""
    result = run_small(CELL, trace=True)
    metrics = result["metrics"]
    assert set(SPAN_METRICS) | {"wrapper_device_ms.serve"} <= set(metrics)
    assert metrics["host_reads.serve"] == {"value": 1.0, "unit": "reads"}
    assert metrics["wrapper_host_ms.serve"]["value"] > 0
    assert result["correct"] is True


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_loads_no_jax(trace):
    """In a fresh process: the result's keys in order and no JAX module."""
    proc = subprocess.run([sys.executable, "-c", DRY_RUN, CELL, str(trace)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["keys"] == KEYS + (["breakdown"] if trace else []) + ["notes", "checks"]
    assert out["forbidden"] == []
    assert "fetal_t2mapping_tpu_torch" in out["held"]
    assert not {"jax", "jaxlib", "flax", "fetal_t2mapping_tpu"} & set(out["held"])
