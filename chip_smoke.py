"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA fit kernel from ``fetal_t2mapping_tpu_torch/csrc``,
holds it against its plain PyTorch version, gates the headline 256^3 fit
against scipy ``curve_fit``, and drives the main path — the port's
``process_t2maps`` over a synthetic 240^3 BIDS session — on the card.
Each phase prints one line; any failed gate or error exits non-zero. The
last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
Exits non-zero before doing anything where ``torch.cuda.is_available()``
is False, and fails to import outside a checkout of the repository.
"""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.core import EchoStack, Volume, nifti
from fetal_t2mapping_tpu_torch.models import fused_fit
from fetal_t2mapping_tpu_torch.models.oracle import curve_fit_t2
from fetal_t2mapping_tpu_torch.pipeline.t2map_pipeline import process_t2maps
from fetal_t2mapping_tpu_torch.utils.bids import get_img_path
from fetal_t2mapping_tpu_torch.utils.metadata import set_metadata
from fetal_t2mapping_tpu_torch.utils.profiling import profiler

TES3 = (114.0, 202.0, 299.0)
TES6 = (114.0, 150.0, 202.0, 250.0, 299.0, 350.0)
TES_SESSION = (114, 202, 299)                # C.DEFAULT_TES_LF
LO, HI = (0.0, 10.0), (1e6, 2000.0)          # bench.py:234
NOISE = 8.0
FIT_KW = dict(max_iters=60, ftol=1e-9, gtol=0.0, full_budget=False,
              stall_iters=3, stall_tol=1e-3)


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: GATE FAILED: {what}")


def make_data(n, tes, seed):
    """bench.py:120-127: k ~ U(600, 5000), T2 ~ U(20, 500), noise sigma 8."""
    rng = np.random.default_rng(seed)
    te = np.asarray(tes, np.float32)
    k = rng.uniform(600.0, 5000.0, n).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, n).astype(np.float32)
    sig = (k[:, None] * np.exp(-te[None, :] / t2[:, None])).astype(np.float32)
    sig = np.maximum(sig + rng.normal(0, NOISE, sig.shape).astype(np.float32), 1e-2)
    ident = k * np.exp(-tes[-1] / t2) >= 3 * NOISE   # bench.py:612
    return sig, k, t2, ident


def cuda_ms(fn, reps):
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after one warm run."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase0_environment():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run([fused_fit._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    mods = {}
    for name in ("triton", "pandas", "matplotlib"):
        try:
            __import__(name)
            mods[name] = True
        except ImportError:
            mods[name] = False
    print(f"phase 0 environment: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA runtime {torch.version.cuda}, nvcc '{nvcc}', "
          f"imports {mods}, device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    return smi, mods["matplotlib"]


def phase1_build() -> float:
    t0 = time.perf_counter()
    fused_fit.build_kernel()
    fused_fit._load_lib()
    dt = time.perf_counter() - t0
    print(f"phase 1 build: {fused_fit.KERNEL_SOURCE} -> sm_90a "
          f"({' '.join(fused_fit.NVCC_FLAGS)}) in {dt:.2f} s", flush=True)
    return dt


def compare(s, tes, ident, no_prior=False):
    """Kernel vs plain version on one (N, T) CUDA batch, gated by the
    bench.py:638-652 bands on identifiable voxels (params 1e-3 and
    objective 1e-2 relative, convergence rate within 0.01). Returns
    (summary text, largest absolute (k, T2) difference there). The
    kernel launch made here is not part of the main path's count."""
    idv = torch.from_numpy(ident).cuda()
    kk, tk, fk, ck, _ = fused_fit._gauss_fit(s, tes, LO, HI, no_prior=no_prior, **FIT_KW)
    kp, tp, fp, cp, _ = fused_fit._gauss_fit_plain(s, tes, LO, HI, no_prior=no_prior, **FIT_KW)
    xk, xp = torch.stack([kk, tk]), torch.stack([kp, tp])
    rel_x = ((xk - xp).abs() / xp.abs().clamp(min=1.0))[:, idv].max().item()
    rel_f = ((fk - fp).abs() / fp.abs().clamp(min=1.0))[idv].max().item()
    dconv = abs(ck.float().mean().item() - cp.float().mean().item())
    bitwise = (xk == xp).all(0).float().mean().item()
    name = f"{s.shape[0]} x T={len(tes)}{' no_prior' if no_prior else ''}"
    gate(rel_x <= 1e-3 and rel_f <= 1e-2 and dconv <= 0.01,
         f"kernel vs plain {name}: rel x {rel_x:.3e} (> 1e-3) / f {rel_f:.3e} "
         f"(> 1e-2) / dconv {dconv:.4f} (> 0.01)")
    text = (f" {name}: x {rel_x:.2e} f {rel_f:.2e} dconv {dconv:.4f}"
            f" bitwise {bitwise:.4f};")
    return text, (xk - xp).abs()[:, idv].max().item()


def phase2_parity() -> float:
    """Kernel vs plain version at 1,048,576 voxels, 3 and 6 TEs, prior and
    no_prior. Returns the largest absolute (k, T2) difference."""
    worst_abs, lines = 0.0, ""
    before = fused_fit.KERNEL_LAUNCHES
    for tes in (TES3, TES6):
        sig, _, _, ident = make_data(1 << 20, tes, seed=5)
        s = torch.from_numpy(sig).cuda()
        for no_prior in (False, True):
            text, diff = compare(s, tes, ident, no_prior)
            lines += text
            worst_abs = max(worst_abs, diff)
    gate(fused_fit.KERNEL_LAUNCHES == before + 4, "kernel launches did not advance")
    print(f"phase 2 kernel vs plain (identifiable voxels):{lines} max abs "
          f"diff {worst_abs:.3e}", flush=True)
    return worst_abs


def phase3_headline():
    """Dense 256^3 x 3 TEs: accuracy + convergence gates (bench.py:265-309),
    kernel vs plain, and the kernel's / plain version's times."""
    n = 256 ** 3
    sig, k, t2, ident = make_data(n, TES3, seed=0)
    s = torch.from_numpy(sig).cuda()
    res = fused_fit.fit_fused(s, TES3, LO, HI, max_iters=60, ftol=1e-9, device=s.device)
    idx = np.random.default_rng(1).choice(np.flatnonzero(ident), 256, replace=False)
    x_idx = res.x[torch.from_numpy(idx).cuda()].cpu().numpy()
    ref = curve_fit_t2(sig[idx], np.asarray(TES3, np.float32), lo=LO, hi=HI)
    interior = (ref[:, 1] > 15.0) & (ref[:, 1] < 1900.0)
    max_rel = float((np.abs(x_idx[interior, 1] - ref[interior, 1]) / ref[interior, 1]).max())
    conv = res.converged.float().mean().item()
    unconv_ident = ((~res.converged) & torch.from_numpy(ident).cuda()).float().mean().item()
    mean_iter = res.n_iter.float().mean().item()
    gate(bool(torch.isfinite(res.x).all()), "non-finite parameters at 256^3")
    gate(max_rel <= 1e-3, f"max rel T2 err vs curve_fit {max_rel:.3e} > 1e-3")
    gate(conv >= 0.98 and unconv_ident <= 1e-4,
         f"converged {conv:.4f} (< 0.98) or unconverged-identifiable {unconv_ident:.2e} (> 1e-4)")
    text, diff = compare(s, TES3, ident)

    kernel_ms = cuda_ms(lambda: fused_fit._gauss_fit(s, TES3, LO, HI, no_prior=False, **FIT_KW), 3)
    full_ms = cuda_ms(lambda: fused_fit._gauss_fit(
        s, TES3, LO, HI, no_prior=False, **dict(FIT_KW, full_budget=True)), 3)
    plain_ms = cuda_ms(lambda: fused_fit._gauss_fit_plain(s, TES3, LO, HI, no_prior=False, **FIT_KW), 3)
    print(f"phase 3 headline 256^3 x 3 TEs: kernel {kernel_ms:.3f} ms "
          f"({n / kernel_ms * 1e3:.4g} voxel-fits/s), full 60-iteration budget "
          f"{full_ms:.3f} ms, plain {plain_ms:.1f} ms; max rel T2 err vs "
          f"curve_fit {max_rel:.3e} ({int(interior.sum())} voxels), converged "
          f"{conv:.5f}, unconverged-identifiable {unconv_ident:.2e}, mean "
          f"accepted steps {mean_iter:.3f}; kernel vs plain{text}", flush=True)
    return kernel_ms, plain_ms, diff


def _write_session(root: str, n_side: int, seed: int):
    """A 240^3 1 mm session: 3 recon echoes + masks + the metadata CSV.
    Returns the paths, the mask, the true maps and the EchoStack the
    pipeline will build from these files."""
    rng = np.random.default_rng(seed)
    shape = (n_side,) * 3
    k = rng.uniform(600.0, 5000.0, shape).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, shape).astype(np.float32)
    ax = (np.arange(n_side, dtype=np.float32) - (n_side - 1) / 2) / (n_side / 2)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    mask = ((zz / 0.75) ** 2 + (yy / 0.85) ** 2 + (xx / 0.65) ** 2 <= 1.0)  # bench.py:438-440
    bids = os.path.join(root, "projects/")
    logs = os.path.join(root, "dicom/logs/")
    os.makedirs(logs)
    rows, writes, recons = [], [], []
    mask_vol = Volume(mask.astype(np.uint8))
    for te in TES_SESSION:
        sig = k * np.exp(-te / t2)
        sig = np.maximum(sig + rng.normal(0, NOISE, shape).astype(np.float32), 1e-2)
        acq = {"prj": "prj-smoke", "sub": "sub-01", "ses": "ses-01",
               "run": f"run-{te}", "EchoTime": te / 1000.0, "CoilString": "Body"}
        recons.append(Volume(sig.astype(np.float32)))
        writes.append((get_img_path(bids, acq, C.RECON_DIRNAME), recons[-1]))
        writes.append((get_img_path(bids, acq, C.MASK_DIRNAME), mask_vol))
        rows.append(acq)
    with ThreadPoolExecutor(max_workers=6) as ex:
        for fut in [ex.submit(nifti.write, p, v) for p, v in writes]:
            fut.result()
    with open(os.path.join(logs, "smoke.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    stack = EchoStack.from_volumes(recons, [mask_vol] * len(recons), TES_SESSION)
    return bids, logs, mask, k, t2, stack


def phase4_main_path(make_plots: bool):
    """The port's process_t2maps over one 240^3 session on the card; then
    kernel vs plain on the very batch that session fitted."""
    with tempfile.TemporaryDirectory(prefix="ft2_smoke_") as root:
        t0 = time.perf_counter()
        bids, logs, mask, k_true, t2_true, stack = _write_session(root, 240, seed=11)
        setup_s = time.perf_counter() - t0
        rows = set_metadata(logs, ["smoke.csv"], low_field=True)
        cfg = C.fit_config("gaussian", low_field=True)
        profiler.reset()
        fused_fit.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        summaries = process_t2maps(rows, bids, list(TES_SESSION), cfg, phantom=False,
                                   low_field=True, sim="smoke", make_plots=make_plots,
                                   device="cuda")
        session_s = time.perf_counter() - t0
        launches = fused_fit.KERNEL_LAUNCHES
        gate(launches > 0, "the main path launched no fit kernel")
        gate(len(summaries) == 1, f"expected one session, got {len(summaries)}")
        s = summaries[0]
        maps = {name: nifti.read(path).data for name, path in s["maps"].items()}
        for name, data in maps.items():
            gate(data.shape == mask.shape and bool(np.isfinite(data).all()),
                 f"map {name}: shape {data.shape} / non-finite values")
        t2_fit = maps["t2"][mask]
        med_rel = float(np.median(np.abs(t2_fit - t2_true[mask]) / t2_true[mask]))
        gate(s["n_voxels"] == int(mask.sum()), "masked voxel count differs")
        gate(med_rel <= 5e-2, f"median rel T2 err vs truth {med_rel:.3e} > 5e-2")
        gate(s["converged_frac"] >= 0.98, f"converged {s['converged_frac']:.4f} < 0.98")
        stages = {k: round(v["seconds"], 4) for k, v in profiler.as_dict().items()}

        batch, flat_idx, n = stack.gather()
        ident_vox = (k_true * np.exp(-TES_SESSION[-1] / t2_true)).reshape(-1)[flat_idx] >= 3 * NOISE
        ident = np.concatenate([ident_vox, np.full(batch.shape[0] - n, ident_vox[-1])])
        text, diff = compare(torch.from_numpy(batch).cuda(),
                             tuple(float(t) for t in TES_SESSION), ident)
        print(f"phase 4 main path (process_t2maps, 240^3, {s['n_voxels']} masked "
              f"voxels, make_plots={make_plots}): session {session_s:.3f} s "
              f"(fit_stack {s['fit_seconds']:.3f} s), data set-up {setup_s:.1f} s, "
              f"median rel T2 err vs truth {med_rel:.3e}, converged "
              f"{s['converged_frac']:.5f}, kernel launches {launches}, stages "
              f"{stages}; kernel vs plain on its batch{text}", flush=True)
        return launches, diff


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    smi, has_mpl = phase0_environment()
    phase1_build()
    diff2 = phase2_parity()
    kernel_ms, plain_ms, diff3 = phase3_headline()
    launches, diff4 = phase4_main_path(make_plots=has_mpl)
    print(json.dumps({"kernels": [{
        "name": "gauss_fit", "route": "cuda",
        "source": "fetal_t2mapping_tpu_torch/csrc/gauss_fit.cu",
        "replaces": "fetal_t2mapping_tpu/models/pallas_fit.py:103",
        "launches": launches, "max_abs_err": max(diff2, diff3, diff4),
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
