"""The serve driver: one client calling ``fit_volume`` back to back.

Set-up makes the request pool on the device from the seed and warms up
the call on every request of it once (so that the allocator holds what
the window needs). The window sends requests round the pool in the seed's
order, each call waiting until its maps are complete on the device (a
closed loop), until ``seconds`` have passed and the request in flight has
finished: ``voxel_fits_per_s`` is the masked voxels of the answered
requests over the window, ``request_p95_ms`` the 95th percentile of the
requests' host times. The last answer to each request of the pool is
kept and, once the window has closed, judged voxel by voxel against the
reference fit of the same request.
"""

from __future__ import annotations

import time

import numpy as np

from . import generate, reference
from .harness import Outcome, sync
from .trace import capture

#: what a ``fit_volume`` answer is judged on
MAPS = ("t2", "k", "sigma", "fun", "converged", "n_iter")


def _call(config: dict, traffic: dict, device):
    from fetal_t2mapping_tpu_torch.models.volume_fit import fit_volume

    te, lo, hi, guess = reference.fit_args(config)
    # the kernels the configuration states: no FT2_FIT3_* variable of the
    # environment picks the multistart prefix or the VARPRO kernel
    kw = dict(model=config["model"], guess=guess, max_iters=int(config["max_iters"]),
              ftol=float(config["ftol"]), gtol=float(config["gtol"]),
              prefix3=int(config["prefix3"]), varpro3=bool(config.get("varpro3", 0)),
              mask_frac=float(traffic["mask_frac"]), device=device)

    def call(it: generate.Item):
        return fit_volume(it.signal, it.mask, te, lo, hi, **kw)

    return call


def _slices(done_at, width: float = 5.0) -> list:
    """Voxels per second over each whole ``width``-second slice of the
    window, from (seconds since the window opened, voxels done) after
    each request."""
    rates, edge, last = [], width, 0
    for t, v in done_at:
        if t >= edge:
            rates.append((v - last) / width)
            edge, last = edge + width, v
    return rates


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Outcome:
    config, traffic = cell.config, cell.traffic
    pool = generate.items(config, traffic, seed, device)
    order = np.random.default_rng(generate.derive(seed, 4)).permutation(len(pool))
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
