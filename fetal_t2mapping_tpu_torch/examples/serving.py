"""The serving path: one ``fit_volume`` call per T2-mapping request.

The file pipeline (``cli.t2mapping``) reads NIfTIs and writes maps and
CSVs. A deployment serving many requests keeps the echo stack on the card
and runs mask compaction (or the dense layout), the fused fit and the map
scatter there (``models.fit_volume``), with nothing crossing the host link
but the input upload and whatever maps the caller downloads.

This example makes a brain-like request (an ellipsoid mask over a
96^3 grid, noise sigma 5) from a seeded numpy generator, serves it and
prints the per-request latency and accuracy.

Run:  python -m fetal_t2mapping_tpu_torch.examples.serving [n_requests] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import fit_config
from ..device import resolve_device
from ..models.volume_fit import fit_volume

TES = (114.0, 201.9, 299.3)          # the low-field HASTE protocol (config.py)
N_SIDE = 96                           # a real deployment serves the full 240^3 FOV


def make_request(seed: int, n_side: int = N_SIDE):
    """One request: (signal (n, n, n, 3) float32, mask (n, n, n) bool,
    truth T2): k ~ U(600, 3000), T2 ~ U(40, 400), noise sigma 5 clipped at
    1e-2, and an ellipsoid of semi-axes 0.8 / 0.85 / 0.7 of the half-side."""
    rng = np.random.default_rng(seed)
    te = np.asarray(TES, np.float32)
    shape = (n_side, n_side, n_side)
    k = rng.uniform(600.0, 3000.0, shape).astype(np.float32)
    t2 = rng.uniform(40.0, 400.0, shape).astype(np.float32)
    sig = k[..., None] * np.exp(-te / t2[..., None])
    sig = np.maximum(sig + 5.0 * rng.standard_normal(sig.shape, np.float32), 1e-2)
    ax = (np.arange(n_side, dtype=np.float32) - (n_side - 1) / 2) / (n_side / 2)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    mask = (zz / 0.8) ** 2 + (yy / 0.85) ** 2 + (xx / 0.7) ** 2 <= 1.0
    return sig.astype(np.float32), mask, t2


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(n_requests: int = 4, device="cuda") -> list:
    """Serve ``n_requests`` requests on ``device``; returns one stats dict
    per request (ms, n_masked, median_rel_err, converged, n_overflow)."""
    dev = resolve_device(device)
    cfg = fit_config("gaussian", low_field=True)   # the reference fit table's bounds
    stats, times = [], []
    for i in range(n_requests):
        sig, mask, t2 = make_request(i)
        sig_d, mask_d = torch.from_numpy(sig).to(dev), torch.from_numpy(mask).to(dev)
        _sync(dev)                                  # the request is on the device
        t0 = time.perf_counter()
        res = fit_volume(sig_d, mask_d, TES, cfg.lower, cfg.upper, model="gaussian",
                         mask_frac=0.6, device=dev)
        n_masked = int(res.n_masked)                # waits for the device
        dt = time.perf_counter() - t0
        times.append(dt)
        got = res.t2.cpu().numpy()[mask]
        rel = np.abs(got - t2[mask]) / t2[mask]
        stats.append({"ms": dt * 1e3, "n_masked": n_masked,
                      "median_rel_err": float(np.median(rel)),
                      "converged": float(res.converged.cpu().numpy()[mask].mean()),
                      "n_overflow": int(res.n_overflow)})
        print(f"request {i}: {dt * 1e3:7.1f} ms  ({n_masked} masked voxels, "
              f"median rel T2 err {np.median(rel):.3%}, "
              f"converged {stats[-1]['converged']:.4f}, "
              f"overflow {stats[-1]['n_overflow']})", flush=True)
    warm = times[1:] or times
    print(f"\nwarm latency: {np.median(warm) * 1e3:.1f} ms/request on {dev} "
          f"(the first request pays the kernels' loading)", flush=True)
    return stats


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_requests", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n_requests, device=args.device)
