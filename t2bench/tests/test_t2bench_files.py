"""The benchmark's files: BENCHMARK.json against the contract's shape, the
files it names found by name, a new cell added as files alone, and the
reference kept apart from the program."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from t2bench import spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PKG = os.path.join(ROOT, "t2bench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["t2bench"] and 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = spec.load(ROOT, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)


def test_configs_are_the_reference_protocols(bench):
    """Each configuration's box, start and echo times are the reference's
    table row (the program's copy of run_t2mapping.py:29-111, :540-545)."""
    from fetal_t2mapping_tpu_torch import config as C

    for c in bench["configs"]:
        cfg = spec._json(os.path.join(ROOT, c["file"]))
        row = C.fit_config(cfg["model"], cfg["low_field"])
        assert tuple(cfg["lower"]) == row.lower and tuple(cfg["upper"]) == row.upper
        assert tuple(cfg["initial_guess"]) == row.initial_guess
        assert (cfg["ftol"], cfg["gtol"], cfg["max_iters"]) == (row.ftol, row.gtol, row.max_iters)
        assert cfg["te"] == C.default_tes(cfg["low_field"]) and c["reduced"] == []


def test_a_new_cell_is_files_and_entries(tmp_path, bench):
    """A configuration, a traffic mix, a limit file and a metric added as
    new files are found by their names, with no edit to what is there."""
    pkg = tmp_path / "t2bench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = json.loads((pkg / "configs" / "lf055_gauss.json").read_text())
    (pkg / "configs" / "new_cfg.json").write_text(json.dumps(dict(base, name="new_cfg")))
    (pkg / "traffic" / "new_mix.json").write_text(json.dumps({"driver": "serve", "items": 2}))
    (pkg / "limits" / "new_cfg.new_mix.json").write_text(json.dumps({"off_share": 0.5}))
    (pkg / "metrics" / "new_metric.x.py").write_text("def read(run):\n    return 42.0\n")
    bench = dict(bench)
    bench["configs"] = bench["configs"] + [{"name": "new_cfg", "source": "s",
                                            "file": "t2bench/configs/new_cfg.json",
                                            "reduced": [], "why": "w"}]
    bench["workloads"] = bench["workloads"] + [{"name": "new_cfg.new_mix", "config": "new_cfg",
                                                "traffic": "new_mix", "chips": 1, "why": "w"}]
    bench["per_layer"] = bench["per_layer"] + [{
        "name": "new_metric.x", "unit": "ms", "better": "lower", "source": "program_span",
        "layer": "l", "moves": "voxel_fits_per_s", "workloads": ["new_cfg.new_mix"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load(str(tmp_path), "new_cfg.new_mix", pkg_dir=str(pkg))
    assert cell.config["name"] == "new_cfg" and cell.traffic["items"] == 2
    assert cell.limits == {"off_share": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["new_metric.x"]
    assert spec.reader("new_metric.x", pkg_dir=str(pkg))(None) == 42.0
    with pytest.raises(KeyError):
        spec.load(str(tmp_path), "no_such.cell", pkg_dir=str(pkg))


#: a kernel family of one log-linear pass: its plain fit and its work count
NEW_FAMILY_FIT = """
import torch

from .. import fit_args
from ..fits import _fl, _loglin_tiles


def fit_block(config, s):
    te, _, _, _ = fit_args(config)
    k, t2 = _loglin_tiles(list(s.t().contiguous()), _fl(te))
    ones = torch.ones_like(k, dtype=torch.int32)
    return {"k": k, "t2": t2, "sigma": torch.zeros_like(k), "fun": torch.zeros_like(k),
            "converged": ones.bool(), "n_iter": ones, "steps.loglin": ones.double().sum()}
"""
NEW_FAMILY_COUNTS = """
import re

KERNELS = re.compile(r"loglin_kernel")


def bound_s(config, n, steps):
    return n * 1e-9 + steps["steps.loglin"] * 1e-12
"""
NEW_FAMILY_RUN = """
import json, os, sys
import torch
from t2bench import reference, spec

config = spec.load(os.getcwd(), "new_family.new_mix").config
te = torch.tensor(config["te"], dtype=torch.float32)
k = torch.linspace(700.0, 4000.0, 64)
t2 = torch.linspace(30.0, 400.0, 64)
s = k[:, None] * torch.exp(-te[None, :] / t2[:, None])
out = reference.fit(config, s)
try:
    reference.fit(dict(config, counts="no_such_family"), s)
    missing = None
except KeyError as exc:
    missing = str(exc)
print(json.dumps({
    "reference": reference.__file__, "keys": sorted(out),
    "t2_err": float(((out["t2"] - t2).abs() / t2).max()), "steps": out["steps.loglin"],
    "bound_s": spec.counts(config["counts"]).bound_s(config, s.shape[0], out),
    "missing": missing}))
"""


def _hashes(root):
    """sha256 of every file under ``root`` but caches, by relative path."""
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_a_new_kernel_family_is_files_and_entries(tmp_path, bench):
    """A configuration whose ``counts`` names a new kernel family brings
    ``counts/<family>.py`` and ``reference/family/<family>.py`` as new
    files: the copied benchmark runs that family's reference fit and counts
    its steps, and no file that was there changes; a family with no file
    raises KeyError, naming the path."""
    shutil.copytree(PKG, tmp_path / "t2bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = _hashes(tmp_path)
    pkg = tmp_path / "t2bench"
    base = json.loads((pkg / "configs" / "lf055_gauss.json").read_text())
    (pkg / "configs" / "new_family.json").write_text(
        json.dumps(dict(base, name="new_family", counts="loglin")))
    (pkg / "traffic" / "new_mix.json").write_text(json.dumps({"driver": "serve", "items": 2}))
    (pkg / "limits" / "new_family.new_mix.json").write_text(json.dumps({"off_share": 0.001}))
    (pkg / "counts" / "loglin.py").write_text(NEW_FAMILY_COUNTS)
    (pkg / "reference" / "family" / "loglin.py").write_text(NEW_FAMILY_FIT)
    bench = dict(bench)
    bench["configs"] = bench["configs"] + [{"name": "new_family", "source": "s",
                                            "file": "t2bench/configs/new_family.json",
                                            "reduced": [], "why": "w"}]
    bench["workloads"] = bench["workloads"] + [{"name": "new_family.new_mix",
                                                "config": "new_family", "traffic": "new_mix",
                                                "chips": 1, "why": "w"}]
    # the root's BENCHMARK.json stands for the repository's: its entries
    # grow, the benchmark's own files do not change
    before.pop("BENCHMARK.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    proc = subprocess.run([sys.executable, "-c", NEW_FAMILY_RUN], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["reference"].startswith(str(pkg))
    assert out["keys"] == sorted(["k", "t2", "sigma", "fun", "converged", "n_iter",
                                  "steps.loglin"])
    assert out["t2_err"] < 1e-3 and out["steps"] == 64.0
    assert out["bound_s"] == pytest.approx(64 * 1e-9 + 64 * 1e-12)
    assert "no_such_family" in out["missing"]
    assert os.path.join("reference", "family", "no_such_family.py") in out["missing"]
    after = _hashes(tmp_path)
    assert {path: after.get(path) for path in before} == before
    assert set(after) - set(before) == {
        "BENCHMARK.json", os.path.join("t2bench", "configs", "new_family.json"),
        os.path.join("t2bench", "traffic", "new_mix.json"),
        os.path.join("t2bench", "limits", "new_family.new_mix.json"),
        os.path.join("t2bench", "counts", "loglin.py"),
        os.path.join("t2bench", "reference", "family", "loglin.py")}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("sub", ["reference", "reference/family", "counts", "metrics"])
def test_yardstick_imports_nothing_of_the_program(sub):
    """The reference, the counts and the metric readers import only torch,
    numpy, the standard library and the benchmark itself."""
    for name in sorted(os.listdir(os.path.join(PKG, sub))):
        if name.endswith(".py"):
            for mod in _imports(os.path.join(PKG, sub, name)):
                assert mod.split(".")[0] not in {"fetal_t2mapping_tpu_torch", "fetal_t2mapping_tpu",
                                                 "jax", "chip_smoke"}, (name, mod)


def test_no_file_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, name)):
                    assert mod.split(".")[0] not in {"jax", "jaxlib", "flax", "fetal_t2mapping_tpu"}
