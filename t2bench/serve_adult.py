"""The serve driver at adult sizes: one client calling ``fit_volume`` back
to back on intracranial masks with tissue in layers.

An item is made as ``generate.item`` makes one (the same derived seeds,
mask shares, shifts, head region and ``Item``), with two differences: the
mask covers an adult intracranial volume, and the echoes are drawn per
tissue instead of uniformly. The configuration's ``data['tissues']``
gives each tissue its share of the mask, T2 range and proton density; the
tissues are nested ellipsoids of the mask's own shape, scaled to their
shares: white matter in the core, grey matter in the shell around it,
CSF in the outer shell and in two ventricles inside the white matter
(``data['ventricles']`` of the mask together), and the head outside the
mask. So voxels whose fit ends on a bound of the prior box (CSF, whose
T2 lies above the box) and voxels that converge fast come in runs along
the layout's blocks, as they do in a scan.

The window and the judge are ``serve.run``'s: the same closed loop, the
same ``Outcome`` and the same checks, so every metric reader of the serve
cells reads this one.
"""

from __future__ import annotations

import math
import time
from typing import List

import numpy as np
import torch

from . import reference
from .control import maps
from .generate import HALF_AXES, Item, derive, ellipsoid_mask, mask_shares, shifts
from .harness import Outcome, sync
from .serve import MAPS, _call, _slices
from .trace import capture

#: where each row of ``data['tissues']`` lies, in the order of the labels
WHERE = ("core", "shell", "outer shell and ventricles", "head outside the mask")


def _rows(data: dict) -> List[dict]:
    """The tissue table's rows in ``WHERE``'s order."""
    by_where = {row["where"]: row for row in data["tissues"]}
    if sorted(by_where) != sorted(WHERE) or len(data["tissues"]) != len(WHERE):
        raise ValueError(f"the tissue table needs one row for each of {WHERE}")
    return [by_where[w] for w in WHERE]


def labels(config: dict, share: float, shift, device) -> torch.Tensor:
    """(Z, Y, X) uint8: each voxel's row of ``WHERE`` (0 core, 1 shell,
    2 outer shell and ventricles, 3 outside the mask of ``share``)."""
    data, grid = config["data"], config["grid"]
    core, shell, _, _ = _rows(data)
    vent = float(data["ventricles"])
    r_core = (core["share"] + vent) ** (1.0 / 3.0)
    r_shell = (core["share"] + vent + shell["share"]) ** (1.0 / 3.0)
    out = torch.full(tuple(grid), 3, dtype=torch.uint8, device=device)
    out[ellipsoid_mask(grid, share, shift, device)] = 2
    out[ellipsoid_mask(grid, share, shift, device, grow=r_shell)] = 1
    out[ellipsoid_mask(grid, share, shift, device, grow=r_core)] = 0
    # two ventricles of the mask's shape, each half of ``vent``, left and
    # right of the centre at half the core's half-axis along x
    scale = (6.0 * share / (math.pi * math.prod(HALF_AXES))) ** (1.0 / 3.0)
    off = 0.5 * r_core * HALF_AXES[2] * scale * grid[2] / 2
    for side in (-1.0, 1.0):
        at = (float(shift[0]), float(shift[1]), float(shift[2]) + side * off)
        out[ellipsoid_mask(grid, share, at, device, grow=(vent / 2) ** (1.0 / 3.0))] = 2
    return out


def echoes(config: dict, lab: torch.Tensor, gen: torch.Generator, device) -> torch.Tensor:
    """(Z, Y, X, T) float32 echoes: each voxel's k its tissue's proton
    density times U(``data['k']``), its T2 uniform over its tissue's range,
    ``k exp(-te / T2)`` as the magnitude of the signal plus complex
    Gaussian noise of ``data['sigma']``."""
    data, te = config["data"], config["te"]
    if data["noise"] != "rician":
        raise ValueError(f"the adult tissue table draws rician data, not {data['noise']!r}")
    rows = _rows(data)
    table = torch.tensor([[r["pd"], r["t2"][0], r["t2"][1]] for r in rows],
                         dtype=torch.float32, device=device)[lab.long()]
    shape = tuple(lab.shape)
    k = torch.empty(shape, dtype=torch.float32, device=device).uniform_(*data["k"], generator=gen)
    k.mul_(table[..., 0])
    t2 = torch.rand(shape, generator=gen, device=device)
    t2 = table[..., 1] + (table[..., 2] - table[..., 1]) * t2
    del table
    out = torch.empty(shape + (len(te),), dtype=torch.float32, device=device)
    sigma = float(data["sigma"])
    for j, t in enumerate(te):
        re = k * torch.exp(-float(t) / t2) + sigma * torch.randn(shape, generator=gen,
                                                                 device=device)
        out[..., j] = torch.hypot(re, sigma * torch.randn(shape, generator=gen, device=device))
    return out


def item_labels(config: dict, traffic: dict, seed: int, index: int, device):
    """(item ``index`` of run ``seed``, its tissue labels): the same call
    gives the same bits. The echoes are zero outside the head region."""
    n = int(traffic["items"])
    share = mask_shares(traffic["mask_share"], n)[index]
    shift = shifts(n, int(traffic["center_jitter"]), seed)[index]
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, 3, index))
    grid = config["grid"]
    mask = ellipsoid_mask(grid, share, shift, device)
    lab = labels(config, share, shift, device)
    signal = echoes(config, lab, gen, device)
    head = ellipsoid_mask(grid, share, shift, device, grow=float(traffic["head_scale"]))
    signal.mul_(head[..., None])
    return Item(signal, mask, int(mask.sum()), share), lab


def items(config: dict, traffic: dict, seed: int, device) -> List[Item]:
    """Every item of run ``seed``, in the order the traffic sends them."""
    return [item_labels(config, traffic, seed, i, device)[0]
            for i in range(int(traffic["items"]))]


def control(cell, seed: int, device, dtype=torch.bfloat16) -> float:
    """``control.off_share`` on this driver's items: the judge's off_share
    of the reference in ``dtype`` against the reference in float32."""
    off = masked = 0
    for i in range(int(cell.traffic["items"])):
        it = item_labels(cell.config, cell.traffic, seed, i, device)[0]
        off += reference.off_voxels(maps(cell.config, it, MAPS, dtype),
                                    maps(cell.config, it, MAPS, torch.float32))
        masked += it.n_masked
    return off / masked


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Outcome:
    pool = items(cell.config, cell.traffic, seed, device)
    return serve_pool(cell, pool, seed, seconds, trace, device, t_start)


def serve_pool(cell, pool: List[Item], seed: int, seconds: float, trace: bool, device,
               t_start: float) -> Outcome:
    """``serve.run``'s warm-up, window and judge over ``pool``."""
    config, traffic = cell.config, cell.traffic
    order = np.random.default_rng(derive(seed, 4)).permutation(len(pool))
    call = _call(config, traffic, device)
    kept = {}
    for i in order:
        kept[int(i)] = call(pool[i])
    sync(device)
    setup_s = time.perf_counter() - t_start

    attempted, failed, voxels, times, answered, done_at = 0, 0, 0, [], set(), []
    t0 = time.perf_counter()
    while True:
        i = int(order[attempted % len(pool)])
        attempted += 1
        t_call = time.perf_counter()
        try:
            res = call(pool[i])
            sync(device)
            times.append(time.perf_counter() - t_call)
        except Exception as exc:          # a failed request counts, the loop goes on
            failed += 1
            last_error = repr(exc)
        else:
            kept[i] = res
            answered.add(i)
            voxels += pool[i].n_masked
        window_s = time.perf_counter() - t0
        done_at.append((window_s, voxels))
        if window_s >= seconds:
            break

    out = Outcome(setup_s=setup_s, window_s=window_s, attempted=attempted, failed=failed)
    out.end_to_end["voxel_fits_per_s"] = voxels / window_s
    if times:
        q = np.percentile(np.asarray(times) * 1e3, [5, 50, 95, 99, 100])
        out.end_to_end["request_p95_ms"] = float(q[2])
        out.notes.append("request ms p5/p50/p95/p99/max: " + "/".join(f"{v:.3f}" for v in q))
    out.notes.append("voxels/s by 5 s slice: " + ", ".join(f"{r:.4e}" for r in _slices(done_at)))
    if failed:
        out.notes.append(f"{failed} requests raised; the last: {last_error}")
    if trace:
        n_traced = int(traffic["trace_requests"])
        traced = [int(order[j % len(pool)]) for j in range(n_traced)]

        def stretch():
            for i in traced:
                call(pool[i])

        out.trace = capture(stretch, lambda: sync(device))
        out.traced_items = traced
    out.read_memory(device)

    # the judge: every answer kept from the window against the reference
    # fit of its request
    off, masked, bad_counts = 0, 0, 0
    for i, it in enumerate(pool):
        res = kept.pop(i)
        if i not in answered:
            continue
        ref = reference.fit(config, it.signal[it.mask])
        out.item_work[i] = (it.n_masked, {k: v for k, v in ref.items() if k.startswith("steps.")})
        ref_maps = {key: reference.to_grid(ref[key], it.mask) for key in MAPS}
        off += reference.off_voxels({key: getattr(res, key) for key in MAPS}, ref_maps)
        masked += it.n_masked
        bad_counts += int(int(res.n_masked) != it.n_masked) + int(int(res.n_overflow) != 0)
        del res, ref, ref_maps
    out.checks["off_share"] = off / max(masked, 1)
    out.checks["bad_counts"] = bad_counts
    out.checks["unanswered"] = len(pool) - len(out.item_work)
    out.checks["failed"] = failed
    return out
