"""A run of each driver on the CPU at a small size: the result line, the
modules it loads, and ``correct`` against the control and planted faults.

The command refuses to run without CUDA; these tests call the harness
below that check (``harness.execute`` on the CPU, where the program runs
its kernels' plain versions), with the grid and the number of items cut
down so that a run takes seconds.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from t2bench import control, harness, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ["lf055_gauss.serve", "hf15_rician.serve"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# the plain fits' many small operations slow down by tens of times when
# parallel test workers each run a thread per core
torch.set_num_threads(2)


def small(name: str, side: int = 24, items: int = 2) -> spec.Cell:
    """``name`` at a side of ``side`` voxels and ``items`` items; the block
    layout's capacity raised to hold a small grid's partly filled blocks."""
    cell = spec.load(ROOT, name)
    cell.config["grid"] = [side] * 3
    cell.traffic.update(items=items, mask_frac=0.2, trace_requests=4)
    return cell


def run_small(name: str, trace: bool = False, seed: int = 2**31 + 11) -> dict:
    """A run of ``name`` at the small size, its window long enough that
    every item of the pool is answered on a loaded CPU."""
    return harness.execute(small(name), seed, 4.0, trace, "cpu", time.perf_counter())


DRY_RUN = """
import json, sys, time
from t2bench import harness, run
from t2bench.tests.test_t2bench_run import small
result = harness.execute(small(sys.argv[1]), 5, 0.3, bool(int(sys.argv[2])), "cpu",
                         time.perf_counter())
print(json.dumps({"keys": list(result), "forbidden": run.forbidden_modules(),
                  "held": sorted({m.split(".")[0] for m in sys.modules})}))
"""


@pytest.mark.parametrize("name,trace", [(CELLS[0], 0), (CELLS[0], 1), (CELLS[1], 0),
                                        (CELLS[1], 1)])
def test_dry_run_loads_no_jax_and_prints_the_contract_keys(name, trace):
    """In a fresh process (the tests' own process holds JAX): the result's
    keys, in order, and no module whose top-level name is jax, jaxlib,
    flax or the JAX package, compared whole."""
    proc = subprocess.run([sys.executable, "-c", DRY_RUN, name, str(trace)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["notes", "checks"]
    assert out["keys"] == want
    assert out["forbidden"] == []
    assert "fetal_t2mapping_tpu_torch" in out["held"]
    assert not {"jax", "jaxlib", "flax", "fetal_t2mapping_tpu"} & set(out["held"])


def test_forbidden_names_compare_whole_names(monkeypatch):
    from t2bench import run

    monkeypatch.setitem(sys.modules, "fetal_t2mapping_tpu_torch_x", sys)
    assert "fetal_t2mapping_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fetal_t2mapping_tpu.models", sys)
    assert "fetal_t2mapping_tpu" in run.forbidden_modules()


def test_command_refuses_without_cuda(capsys):
    from t2bench import run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run_small(name)
    assert result["correct"] is True, (result["checks"], result["attempted"], result["notes"])
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in bfloat16 in the program's place reads an off_share
    above the cell's limit."""
    cell = small(name)
    share = control.off_share(cell, 2**31 + 11, "cpu")
    assert share > cell.limits["off_share"]


def _state_unchanged(res, guess):
    """The fit returns every voxel at its start, the configuration's guess,
    with no step taken."""
    start = torch.as_tensor(guess, dtype=res.x.dtype).reshape(1, -1)[:, :res.x.shape[1]]
    return res._replace(x=start.expand_as(res.x).clone(), n_iter=torch.zeros_like(res.n_iter))


def _half_left_out(res, guess):
    """Every other row of the batch left unfitted (a compacted batch holds
    its masked voxels first, then filler, so its first half may hold them
    all)."""
    n = res.x.shape[0]
    keep = (torch.arange(n) % 2 == 0)[:, None]
    return res._replace(x=torch.where(keep, res.x, torch.zeros_like(res.x)))


def _answer_altered(res, guess):
    x = res.x.clone()
    x[:, 1] = x[:, 1] * 1.01
    return res._replace(x=x)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_fit_is_not_correct(name, fault, monkeypatch):
    """The timed path broken under the harness: the fit's state left at its
    start, half of each batch left unfitted, or every T2 altered where the
    fit produces it."""
    from fetal_t2mapping_tpu_torch.models import volume_fit

    real = volume_fit.fit_fused
    monkeypatch.setattr(volume_fit, "fit_fused",
                        lambda *a, **k: fault(real(*a, **k), k["guess"]))
    result = run_small(name)
    assert result["correct"] is False
    assert result["checks"]["off_share"]["value"] > result["checks"]["off_share"]["limit"]


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell through the command, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    proc = subprocess.run([sys.executable, "-m", "t2bench.run", "--workload", CELLS[0],
                           "--seed", "3", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
