"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<cell>.json``; a per-layer metric
``<name>`` is read by ``metrics/<name>.py``; the kernel family of a
configuration, its ``counts`` key, names two files: ``counts/<counts>.py``,
which counts the family's roofline work, and ``reference/family/<counts>.py``,
the plain fit that decides ``correct`` and takes the steps that the counts
read. Adding any of them is adding files and entries: nothing here names
one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str, cell: str, pkg_dir: str = HERE) -> Cell:
    """The cell ``cell`` of ``root``/BENCHMARK.json; raises KeyError for a
    name the file does not list."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; known: {sorted(work)}")
    w = work[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(pkg_dir, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(pkg_dir, "limits", f"{cell}.json"))
    return Cell(name=cell, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, cell)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, cell)])


def reader(metric: str, pkg_dir: str = HERE) -> Callable[[object], Optional[float]]:
    """``read`` of ``metrics/<metric>.py``, loaded by its path (a metric's
    name may hold dots)."""
    path = os.path.join(pkg_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"t2bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def counts(name: str):
    """The module ``counts/<name>.py``."""
    return importlib.import_module(f"t2bench.counts.{name}")
