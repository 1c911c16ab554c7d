"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA fit kernels from ``fetal_t2mapping_tpu_torch/csrc``
(one nvcc per source, in parallel), holds each against its plain PyTorch
version, gates the headline 256^3 fits — gaussian against scipy
``curve_fit``, gaussian_rician and rician against the truth and the
same-model L-BFGS-B oracle — and drives the main path of each noise
model, the port's ``process_t2maps`` over a synthetic 240^3 BIDS session,
on the card. Each phase prints one line with its wall time; any failed
gate or error exits non-zero. The last line is ``{"ok": true, "device":
{...}}``. Imports nothing of JAX. Exits non-zero before doing anything
where ``torch.cuda.is_available()`` is False, and fails to import outside
a checkout of the repository.
"""

from __future__ import annotations

import csv
import json
import os
import re
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
from fetal_t2mapping_tpu_torch.models.oracle import _objective, curve_fit_t2, fit_batch_scipy
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
# the 3-parameter bench rows (bench.py:242-243): bounds, protocol guess and
# the reference's production tolerances for these objectives
LO3, HI3, GUESS3 = (1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0)
LO3_RICIAN = LO3[:2] + (max(LO3[2], 1e-2),)        # validate_fused_args' clamp
TOL3 = dict(ftol=1e-2, gtol=1e-2)
VARPRO_KW = dict(max_iters=60, full_budget=False, stall_iters=3, stall_tol=1e-2, **TOL3)
FIT3_KW = dict(stall_tol=1e-2, **TOL3)
PREFIX3 = 4
N_PARITY3, N_HEADLINE3, SIDE3 = 1 << 20, 256 ** 3, 240   # phases 5, 6, 7


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
    """Build every kernel (one nvcc per source, all at once), print build
    time and registers/spills per instance, and check that the VARPRO
    kernel's reciprocal square root is torch.rsqrt's on this card."""
    t0 = time.perf_counter()
    libs = fused_fit.build_kernel()
    for name in libs:
        fused_fit._load_lib(name)
    dt = time.perf_counter() - t0
    regs = {}
    for name in libs:
        log = fused_fit.build_log(name)
        for entry, body in re.findall(r"Compiling entry function '(\S+)'.*?\n(.*?Used \d+ registers[^\n]*)",
                                      log, re.S):
            inst = re.search(r"(Rician|GaussRician)?E?Li(\d)E", entry)
            key = f"{name}{'/' + inst.group(1) if inst and inst.group(1) else ''}/T{inst.group(2)}" \
                if inst else name
            spill = re.search(r"(\d+) bytes spill stores", body)
            regs[key] = (int(re.search(r"Used (\d+) registers", body).group(1)),
                         int(spill.group(1)) if spill else 0)
    print(f"phase 1 build: {sorted(libs)} -> sm_90a ({' '.join(fused_fit.NVCC_FLAGS)}) "
          f"in {dt:.2f} s; registers/spill bytes at T=3 and 8: "
          f"{ {k: v for k, v in sorted(regs.items()) if k.endswith(('T3', 'T8'))} }", flush=True)
    lib = fused_fit._load_lib("gr_varpro_fit")
    x = torch.cat([torch.rand(1 << 22, device="cuda") * 1e4 + 1e-6,
                   torch.logspace(-6, 30, 1 << 20, device="cuda")])
    a, b = torch.empty_like(x), torch.empty_like(x)
    gate(lib.ft2_rsqrt_probe(x.data_ptr(), x.numel(), a.data_ptr(), b.data_ptr(),
                             torch.cuda.current_stream().cuda_stream) == 0, "rsqrt probe launch")
    ref = torch.rsqrt(x)
    same_rsqrtf = (a == ref).float().mean().item()
    gate(same_rsqrtf == 1.0, f"the kernel's rsqrtf differs from torch.rsqrt on {1 - same_rsqrtf:.3e} of inputs")
    print(f"phase 1 rsqrt: torch.rsqrt == rsqrtf on {same_rsqrtf:.6f} of {x.numel()} inputs, "
          f"== 1/sqrtf on {(b == ref).float().mean().item():.6f}", flush=True)
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


# ------------------------------------------------ the 3-parameter models
def make_data3(n, tes, seed, k_range=(600.0, 5000.0), t2_range=(20.0, 500.0)):
    """bench.py's generator (additive Gaussian noise sigma 8, clipped at
    1e-2) and the identifiable voxels (last echo >= 3 sigma)."""
    rng = np.random.default_rng(seed)
    te = np.asarray(tes, np.float32)
    k = rng.uniform(*k_range, n).astype(np.float32)
    t2 = rng.uniform(*t2_range, n).astype(np.float32)
    sig = (k[:, None] * np.exp(-te[None, :] / t2[:, None])).astype(np.float32)
    sig = np.maximum(sig + rng.normal(0, NOISE, sig.shape).astype(np.float32), 1e-2)
    return sig, k, t2, k * np.exp(-tes[-1] / t2) >= 3 * NOISE


def bands3(out_k, out_p, ident, what):
    """Kernel vs plain version, the bench.py:638-652 bands of a 3-parameter
    kernel on identifiable voxels: k and T2 1e-2, objective 3e-2,
    convergence rate 0.01. Returns (text, bitwise-equal fraction over all
    outputs of all voxels, largest absolute (k, T2) difference there)."""
    (xk, sk), (xp, sp) = out_k, out_p
    idv = torch.as_tensor(ident, device=xk.device)
    rel_x = ((xk[:2] - xp[:2]).abs() / xp[:2].abs().clamp(min=1.0))[:, idv].max().item()
    rel_f = ((sk[0] - sp[0]).abs() / sp[0].abs().clamp(min=1.0))[idv].max().item()
    dconv = abs(sk[1].mean().item() - sp[1].mean().item())
    both_k, both_p = torch.cat([xk, sk]), torch.cat([xp, sp])
    bitwise = ((both_k == both_p) | (both_k.isnan() & both_p.isnan())).all(0).float().mean().item()
    gate(rel_x <= 1e-2 and rel_f <= 3e-2 and dconv <= 0.01,
         f"kernel vs plain {what}: rel k/T2 {rel_x:.3e} (> 1e-2) / f {rel_f:.3e} (> 3e-2) "
         f"/ dconv {dconv:.4f} (> 0.01)")
    return (f" {what}: k/T2 {rel_x:.2e} f {rel_f:.2e} dconv {dconv:.4f} bitwise {bitwise:.6f};",
            bitwise, (xk[:2] - xp[:2]).abs()[:, idv].max().item())


def compare3(s, tes, ident):
    """gr_varpro, the fit3 multistart prefix (both models) and the fit3
    continuation (from the kernel's own prefix) against their plain
    versions on one CUDA batch. Returns (text, {kernel: (min bitwise
    fraction, max abs diff)})."""
    text, worst = "", {}

    def note(name, res):
        nonlocal text
        text += res[0]
        b, d = worst.get(name, (1.0, 0.0))
        worst[name] = (min(b, res[1]), max(d, res[2]))

    t = f"T={len(tes)}"
    note("gr_varpro", bands3(fused_fit._gr_varpro_fit_cuda(s, tes, LO3, HI3, GUESS3, **VARPRO_KW),
                             fused_fit._gr_varpro_fit_plain(s, tes, LO3, HI3, GUESS3, **VARPRO_KW),
                             ident, f"gr_varpro {t}"))
    for model, lo in (("rician", LO3_RICIAN), ("gaussian_rician", LO3)):
        pre = fused_fit._fit3_cuda(s, model, tes, lo, HI3, GUESS3, max_iters=PREFIX3, **FIT3_KW)
        note("fit3", bands3(pre, fused_fit._fit3_plain(s, model, tes, lo, HI3, GUESS3,
                                                         max_iters=PREFIX3, **FIT3_KW),
                            ident, f"fit3 {model} {t}"))
        cont = dict(max_iters=60 - PREFIX3, **FIT3_KW)
        note("fit3_cont", bands3(
            fused_fit._fit3_cont_cuda(s, model, tes, lo, HI3, GUESS3, *pre, **cont),
            fused_fit._fit3_cont_plain(s, model, tes, lo, HI3, GUESS3, *pre, **cont),
            ident, f"fit3_cont {model} {t}"))
    return text, worst


def phase5_parity3():
    """The three 3-parameter kernels vs their plain versions at 1,048,576
    voxels, 3 and 6 TEs (bench bounds, guess and tolerances)."""
    t0 = time.perf_counter()
    lines, worst = "", {}
    for tes in (TES3, TES6):
        sig, _, _, ident = make_data3(N_PARITY3, tes, seed=5)
        text, w = compare3(torch.from_numpy(sig).cuda(), tes, ident)
        lines += text
        for name, (b, d) in w.items():
            b0, d0 = worst.get(name, (1.0, 0.0))
            worst[name] = (min(b0, b), max(d0, d))
    print(f"phase 5 3-parameter kernels vs plain (identifiable voxels), "
          f"{time.perf_counter() - t0:.1f} s:{lines}", flush=True)
    return worst


def oracle_gap(model, sig, x, idx, lo):
    """bench.py:315-366: the kernel's objective above the same-model
    L-BFGS-B oracle (tight), relative, on the sampled voxels."""
    cfg = C.FitConfig(model=model, initial_guess=GUESS3, lower=lo, upper=HI3, **TOL3)
    te64 = np.asarray(TES3, np.float64)
    x_scipy = fit_batch_scipy(sig[idx].astype(np.float64), te64, cfg, tight=True)
    objf = _objective(model)
    f_k = np.array([objf(x[j].astype(np.float64), te64, sig[i].astype(np.float64))
                    for j, i in enumerate(idx)])
    f_s = np.array([objf(x_scipy[j], te64, sig[i].astype(np.float64))
                    for j, i in enumerate(idx)])
    return (f_k - f_s) / np.maximum(np.abs(f_s), 1.0)


def phase6_headline3():
    """Dense 256^3 x 3 TEs per 3-parameter model with bench.py's generator
    (seed 0): gates of bench.py:310-366, kernel vs plain, and the times of
    each kernel and its plain version (CUDA events)."""
    sig, k_true, t2_true, ident = make_data3(N_HEADLINE3, TES3, seed=0)
    s = torch.from_numpy(sig).cuda()
    idx = np.random.default_rng(1).choice(np.flatnonzero(ident), 256, replace=False)
    idv = torch.from_numpy(ident).cuda()
    t2_dev = torch.from_numpy(t2_true).cuda()
    times, worst = {}, {}
    for model, lo in (("gaussian_rician", LO3), ("rician", LO3_RICIAN)):
        t0 = time.perf_counter()
        res = fused_fit.fit_fused(s, TES3, LO3, HI3, model=model, guess=GUESS3, max_iters=60,
                                  device=s.device, **TOL3)
        x = res.x
        gate(bool(torch.isfinite(x).all()) and bool(torch.isfinite(res.fun).all()),
             f"{model}: non-finite parameters or objective at 256^3")
        for j in range(3):
            gate(x[:, j].min().item() >= np.float32(lo[j]) and x[:, j].max().item() <= np.float32(HI3[j]),
                 f"{model}: parameter {j} outside its box")
        gate(res.n_overflow == 0, f"{model}: n_overflow {res.n_overflow}")
        med_rel = (x[:, 1] - t2_dev).abs().div(t2_dev).median().item()
        gate(med_rel <= 5e-2, f"{model}: median rel T2 err vs truth {med_rel:.3e} > 5e-2")
        gap = oracle_gap(model, sig, x[torch.from_numpy(idx).cuda()].cpu().numpy(), idx, lo)
        gate(gap.max() <= 2e-2, f"{model}: objective gap vs L-BFGS-B {gap.max():.3e} > 2e-2")
        conv = res.converged.float().mean().item()
        unconv_ident = ((~res.converged) & idv).float().mean().item()
        if model == "gaussian_rician":
            runs = {"gr_varpro": (
                lambda: fused_fit._gr_varpro_fit_cuda(s, TES3, lo, HI3, GUESS3, **VARPRO_KW),
                lambda: fused_fit._gr_varpro_fit_plain(s, TES3, lo, HI3, GUESS3, **VARPRO_KW))}
        else:
            pre = fused_fit._fit3_cuda(s, model, TES3, lo, HI3, GUESS3, max_iters=PREFIX3, **FIT3_KW)
            cont = dict(max_iters=60 - PREFIX3, **FIT3_KW)
            runs = {"fit3": (
                lambda: fused_fit._fit3_cuda(s, model, TES3, lo, HI3, GUESS3, max_iters=PREFIX3, **FIT3_KW),
                lambda: fused_fit._fit3_plain(s, model, TES3, lo, HI3, GUESS3, max_iters=PREFIX3, **FIT3_KW)),
                "fit3_cont": (
                lambda: fused_fit._fit3_cont_cuda(s, model, TES3, lo, HI3, GUESS3, *pre, **cont),
                lambda: fused_fit._fit3_cont_plain(s, model, TES3, lo, HI3, GUESS3, *pre, **cont))}
        text = ""
        for name, (kern, plain) in runs.items():
            r_t, b, d = bands3(kern(), plain(), ident, f"{name} 256^3")
            text += r_t
            worst[name] = (b, d)
            times[name] = (cuda_ms(kern, 3), cuda_ms(plain, 1))
            text += f" {name} kernel {times[name][0]:.3f} ms, plain {times[name][1]:.1f} ms;"
        print(f"phase 6 headline 256^3 x 3 TEs {model} ({time.perf_counter() - t0:.1f} s): median "
              f"rel T2 err vs truth {med_rel:.3e}, L-BFGS-B objective gap max {gap.max():.3e} "
              f"median {np.median(gap):.3e} (256 identifiable voxels), converged {conv:.5f}, "
              f"unconverged-identifiable {unconv_ident:.2e}, mean accepted steps "
              f"{res.n_iter.float().mean().item():.3f}, n_overflow {res.n_overflow};{text}",
              flush=True)
    return times, worst


def _write_session3(root, n_side, seed, tes, k_range, t2_range):
    """A 240^3 session like _write_session's, with Rician noise: the
    magnitude of the signal plus complex Gaussian noise of sigma 8."""
    rng = np.random.default_rng(seed)
    shape = (n_side,) * 3
    k = rng.uniform(*k_range, shape).astype(np.float32)
    t2 = rng.uniform(*t2_range, shape).astype(np.float32)
    ax = (np.arange(n_side, dtype=np.float32) - (n_side - 1) / 2) / (n_side / 2)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    mask = ((zz / 0.75) ** 2 + (yy / 0.85) ** 2 + (xx / 0.65) ** 2 <= 1.0)  # bench.py:438-440
    bids = os.path.join(root, "projects/")
    logs = os.path.join(root, "dicom/logs/")
    os.makedirs(logs)
    rows, writes = [], []
    mask_vol = Volume(mask.astype(np.uint8))
    for te in tes:
        a = k * np.exp(-te / t2)
        sig = np.hypot(a + rng.normal(0, NOISE, shape).astype(np.float32),
                       rng.normal(0, NOISE, shape).astype(np.float32)).astype(np.float32)
        acq = {"prj": "prj-smoke", "sub": "sub-01", "ses": "ses-01",
               "run": f"run-{te}", "EchoTime": te / 1000.0, "CoilString": "Body"}
        writes.append((get_img_path(bids, acq, C.RECON_DIRNAME), Volume(sig)))
        writes.append((get_img_path(bids, acq, C.MASK_DIRNAME), mask_vol))
        rows.append(acq)
    with ThreadPoolExecutor(max_workers=6) as ex:
        for fut in [ex.submit(nifti.write, p, v) for p, v in writes]:
            fut.result()
    with open(os.path.join(logs, "smoke.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return bids, logs, mask, t2


SESSIONS3 = {
    # model: (low field, TEs, k range, T2 range, kernels its main path must launch)
    "gaussian_rician": (True, (114, 202, 299), (600.0, 5000.0), (20.0, 500.0),
                        ("GR_VARPRO_LAUNCHES",)),
    # the high-field row: the low-field rician row caps k at 900 (config.py:136-137)
    "rician": (False, (115, 202, 299), (900.0, 5000.0), (30.0, 500.0),
               ("FIT3_LAUNCHES", "FIT3_CONT_LAUNCHES")),
}
COUNTERS = ("KERNEL_LAUNCHES", "GR_VARPRO_LAUNCHES", "FIT3_LAUNCHES", "FIT3_CONT_LAUNCHES")


def phase7_sessions3(make_plots: bool):
    """One 240^3 process_t2maps session per 3-parameter model on the card:
    the main path of each noise model, with the launches of each kernel
    counted from 0 around the session."""
    launches = {}
    for model, (low_field, tes, k_range, t2_range, needed) in SESSIONS3.items():
        with tempfile.TemporaryDirectory(prefix="ft2_smoke3_") as root:
            t0 = time.perf_counter()
            bids, logs, mask, t2_true = _write_session3(root, SIDE3, 13, tes, k_range, t2_range)
            setup_s = time.perf_counter() - t0
            rows = set_metadata(logs, ["smoke.csv"], low_field=low_field)
            cfg = C.fit_config(model, low_field=low_field)
            profiler.reset()
            for name in COUNTERS:
                setattr(fused_fit, name, 0)
            t0 = time.perf_counter()
            summaries = process_t2maps(rows, bids, list(tes), cfg, phantom=False,
                                       low_field=low_field, sim="smoke3",
                                       make_plots=make_plots, device="cuda")
            session_s = time.perf_counter() - t0
            counts = {name: getattr(fused_fit, name) for name in COUNTERS}
            for name in needed:
                gate(counts[name] >= 1, f"{model} session launched no {name}")
            launches[model] = counts
            gate(len(summaries) == 1, f"expected one session, got {len(summaries)}")
            summ = summaries[0]
            maps = {name: nifti.read(path).data for name, path in summ["maps"].items()}
            gate(set(maps) == {"t2", "k", "sigma", "res"}, f"maps {sorted(maps)}")
            for name, data in maps.items():
                gate(data.shape == mask.shape and bool(np.isfinite(data).all()),
                     f"{model} map {name}: shape {data.shape} / non-finite values")
            gate(bool((maps["sigma"][mask] >= np.float32(cfg.lower[2])).all()),
                 f"{model}: sigma map below its bound")
            med_rel = float(np.median(np.abs(maps["t2"][mask] - t2_true[mask]) / t2_true[mask]))
            gate(med_rel <= 5e-2, f"{model}: median rel T2 err vs truth {med_rel:.3e} > 5e-2")
            stages = {k: round(v["seconds"], 4) for k, v in profiler.as_dict().items()}
            io_s = stages.get("t2map.load", 0.0) + stages.get("t2map.save", 0.0)
            fit_s = stages.get("t2map.fit", 0.0)
            print(f"phase 7 main path {model} (process_t2maps, 240^3, "
                  f"{'low' if low_field else 'high'} field, TEs {tes}, {summ['n_voxels']} masked "
                  f"voxels): session {session_s:.3f} s (fit_stack {summ['fit_seconds']:.3f} s), "
                  f"fit {fit_s / session_s:.1%} of the session vs gzip I/O {io_s / session_s:.1%}, "
                  f"data set-up {setup_s:.1f} s, median rel T2 err vs truth {med_rel:.3e}, "
                  f"converged {summ['converged_frac']:.5f}, launches {counts}, stages {stages}",
                  flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    wall = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        wall[name] = round(time.perf_counter() - t0, 1)
        return out

    smi, has_mpl = timed("phase 0", phase0_environment)
    timed("phase 1", phase1_build)
    diff2 = timed("phase 2", phase2_parity)
    kernel_ms, plain_ms, diff3 = timed("phase 3", phase3_headline)
    launches, diff4 = timed("phase 4", phase4_main_path, has_mpl)
    worst5 = timed("phase 5", phase5_parity3)
    times6, worst6 = timed("phase 6", phase6_headline3)
    launches3 = timed("phase 7", phase7_sessions3, has_mpl)
    print(f"phase wall times (s): {wall}, total {time.perf_counter() - t_start:.1f} s", flush=True)
    kernels = [{
        "name": "gauss_fit", "route": "cuda",
        "source": "fetal_t2mapping_tpu_torch/csrc/gauss_fit.cu",
        "replaces": "fetal_t2mapping_tpu/models/pallas_fit.py:103",
        "launches": launches, "max_abs_err": max(diff2, diff3, diff4),
        "ms": kernel_ms, "plain_ms": plain_ms}]
    for name, source, replaces, session, counter in (
            ("gr_varpro", "gr_varpro_fit.cu", 537, "gaussian_rician", "GR_VARPRO_LAUNCHES"),
            ("fit3", "fit3.cu", 848, "rician", "FIT3_LAUNCHES"),
            ("fit3_cont", "fit3.cu", 887, "rician", "FIT3_CONT_LAUNCHES")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fetal_t2mapping_tpu_torch/csrc/{source}",
            "replaces": f"fetal_t2mapping_tpu/models/pallas_fit.py:{replaces}",
            "launches": launches3[session][counter],
            "max_abs_err": max(worst5[name][1], worst6[name][1]),
            "ms": times6[name][0], "plain_ms": times6[name][1]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
