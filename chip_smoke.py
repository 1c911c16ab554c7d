"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``fetal_t2mapping_tpu_torch/csrc``
(one nvcc per source, in parallel) and holds each against its plain
PyTorch version. Phases 2-7, the T2 fits: gates the headline 256^3 fits —
gaussian against scipy ``curve_fit``, gaussian_rician and rician against
the truth and the same-model L-BFGS-B oracle — and drives the main path of
each noise model, the port's ``process_t2maps`` over a synthetic 240^3
BIDS session. Phases 8-9, the SynthSeg U-Net: the S2D conv kernel against
its plain version at the 160^3 level-0 shape and two ragged ones, then the
segmentation step ``run_segmentation`` with ``SynthSegRunner(mode="torch")``
and ``FT2_UNET_S2D=kernel`` over a synthetic 160^3 recon, at the full
SynthSeg width with random weights. Phase 10, the start from the protocol
guess: ``fit_stack`` with ``loglinear_init=False`` (the two-phase solver)
per model at 2^20 voxels, held against the same call on the CPU on a
subset. Phases 11-12, stage 2 (torch ops on the card, no hand kernel):
``register_rigid`` on bench.py's 192^3 blob scene (gated at 0.01 rad and
0.5 mm), the multi-pair and cross-contrast affine solves, the card against
the CPU at 48^3; then one in-vivo session (3 TEs x ax/cor/sag slab stacks
fusing to 240^3) through ``process_qmri`` and ``process_t2maps`` on it,
gated on the recon and the T2 map against the simulation's truth, and one
240^3 in-vitro phantom through ``process_qmri``, card equal to CPU. Phase
13, the serving path: ``fit_volume`` per model on bench.py's 240^3 x 3-TE
request (and ~5% and ~50% ellipsoid masks), its dense, block and
voxel-exact layouts timed, bitwise equal to each other and to
``fit_fused`` on the gathered voxels, the model's kernels launched once
per request. Phase 14: N4 bias correction at 240^3 (two card runs bitwise,
card vs CPU at 48^3, the shared-field variant and the stage-2 step), the
ROI tables on a 240^3 T2 map (card equal to CPU) and the LUT estimate at
256^3. Each phase prints one line with its wall time; any failed gate or
error exits non-zero. The second-to-last lines are the kernels' JSON
record and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX. Exits non-zero
before doing anything where ``torch.cuda.is_available()`` is False, and
fails to import outside a checkout of the repository.
"""

from __future__ import annotations

import csv
import ctypes
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fetal_t2mapping_tpu_torch import build
from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.core import EchoStack, Volume, nifti
from fetal_t2mapping_tpu_torch.core.stack import pad_bucket
from fetal_t2mapping_tpu_torch.labels import SynthSegRunner, conv_s2d, unet3d
from fetal_t2mapping_tpu_torch.models import fused_fit
from fetal_t2mapping_tpu_torch.models.oracle import _objective, curve_fit_t2, fit_batch_scipy
from fetal_t2mapping_tpu_torch.models.t2map import fit_stack
from fetal_t2mapping_tpu_torch.pipeline import run_segmentation
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
# the pipeline's tolerances (config.FitConfig's defaults, what process_t2maps
# runs) beside the bench's
TOLERANCES = {"bench": TOL3, "pipeline": dict(ftol=1e-9, gtol=0.0)}
TAIL_KS = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
N_PARITY3, N_HEADLINE3, SIDE3 = 1 << 20, 256 ** 3, 240   # phases 5, 6, 7
# H100 SXM published peaks (NVIDIA's data sheet, dense, 700 W): HBM
# bytes/s, fp32 outside the tensor cores and dense bf16 tensor-core FLOP/s
HBM_BPS, FP32_OPS, BF16_OPS = 3.35e12, 67e12, 989e12


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


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    """(ms, 'bytes' or 'operations'): the least time the card could take for
    work that moves ``n_bytes`` (each input read once, each output written
    once) and does ``n_ops`` operations at ``peak_ops`` per second."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fit_bound(n, T, out_bytes, steps, starts=1, in_extra=0):
    """Bound of a fit kernel on n voxels x T echoes (float32 signal in,
    ``out_bytes`` per voxel out, ``in_extra`` more bytes in per voxel).
    Operations: only the transcendentals this run's data needs, one
    operation each at the fp32 rate — T logs of the init, T exps per start
    and T per accepted Newton step (``steps`` summed over voxels) — so the
    bound is a lower one."""
    return bound(n * (T * 4 + in_extra + out_bytes), n * T * (1 + starts) + T * steps, FP32_OPS)


def gauss_ops(T: int, gtol: float):
    """fp32 operations of csrc/gauss_fit.cu at T echoes, counted from the
    source as fit3_ops counts fit3.cu (proj_grad five, a logical and/or
    one). Returns (prelude, iteration): the prelude once per voxel — the
    prior k box 2, the log-linear start 12 T + 14 and its clips 4, e at t2
    1 + 2 T, the objective 4 T, the 12-point grid (a dot, k, the objective,
    the compare and T + 4 selects) 84 T + 84; one accepted loop turn — the
    gradient and curvature sums 13 T - 4 and scalings 6, the Schur
    reduction 9, the KKT test 8, the damped step 10 and its clip 3, e at
    the candidate 1 + 2 T, k there 4 T + 2, the objective 4 T, the stop
    tests and update T + 53, and the gtol test 2 T + 14 when gtol > 0."""
    prelude = 2 + (12 * T + 14) + 4 + (1 + 2 * T) + 4 * T + (84 * T + 84)
    iteration = (13 * T - 4) + 6 + 9 + 8 + 10 + 3 + (1 + 2 * T) + (4 * T + 2) + 4 * T \
        + (T + 53) + (2 * T + 14 if gtol > 0 else 0)
    return prelude, iteration


def gauss_bound(n, T, steps, gtol):
    """Bound of ft2_gauss_fit on n voxels x T echoes: the larger of the
    bytes (signal in; k, t2, f float32, converged uint8, n_iter int32 out:
    17 bytes) and the fp32 operations of every voxel's prelude plus its
    accepted loop turns (``steps``, n_iter summed; rejected turns are not
    counted, so the bound is a lower one). Returns (ms, by, operations)."""
    prelude, iteration = gauss_ops(T, gtol)
    n_ops = n * prelude + steps * iteration
    ms, by = bound(n * (T * 4 + 17), n_ops, FP32_OPS)
    return ms, by, n_ops


def fit3_ops(model: str, T: int):
    """fp32 operations of csrc/fit3.cu's pieces at T echoes, counted from
    the source: each add, sub, mul, div, sqrt, exp, log, fabs, compare and
    select one, a NaN-keeping max/min one and a clip two, loop invariants
    once, the cheaper side of every branch (i0e's x < 3.75 knee, R/x's
    series). Returns (value_e, step, inits, prepare): one objective
    evaluation; one accepted Newton step (fgh 7 + 115 T rician / 3 + 105 T
    gaussian_rician, masked_solve3 99, the stop tests and update 86 with
    gtol > 0, the trial value_e); the three starts' inits together (the
    log-linear 18 T + 29, the grid scan 72 T + 90, and the interpolant 446
    for gaussian_rician at T = 3, else the guess, 0); and the per-voxel
    hoisted logs."""
    if model == "rician":
        value_e, fgh, prepare, third = 3 + 36 * T, 7 + 115 * T, 2 * T, 0
    else:
        value_e, fgh, prepare, third = 3 + 9 * T, 3 + 105 * T, 0, (446 if T == 3 else 0)
    return value_e, fgh + 99 + 86 + value_e, (18 * T + 29) + (72 * T + 90) + third, prepare


def fit3_bound(model, n, T, steps, cont=False):
    """Bound of ft2_fit3_multistart (``cont`` False) or ft2_fit3_cont on n
    voxels x T echoes: the larger of the bytes (signal in, (x, stats) out,
    and (x0, st0) in for the continuation) and the fp32 operations these
    inputs need at the least: for the multistart, each start's init, its
    clip (6) and first evaluation, plus the winning start's accepted steps
    (``steps``, stats row 2 summed; the other starts' steps are not
    counted); for the continuation, one evaluation at x0 plus its own
    accepted steps. Rejected steps are not counted either, so the bound is
    a lower one. Returns (ms, by, operations)."""
    value_e, step, inits, prepare = fit3_ops(model, T)
    per_voxel = prepare + (6 + value_e if cont else inits + 3 * (6 + value_e))
    n_ops = n * per_voxel + steps * step
    ms, by = bound(n * (T * 4 + 24 + (24 if cont else 0)), n_ops, FP32_OPS)
    return ms, by, n_ops


def gr_varpro_ops(T: int, gtol: float):
    """fp32 operations of csrc/gr_varpro_fit.cu at T echoes, counted from
    the source as fit3_ops counts fit3.cu (free_of and proj_grad five each,
    rsqrtf one). Returns (prelude, iteration): the prelude once per voxel —
    the log-linear start 12 T + 14 and its clips 7, E at t2 1 + 2 T, two
    inner steps 2 (20 T + 43), the objective 8 T, the squares 2 T - 1, the
    12-point grid 132 T + 192, the polish 68 T + 133, at T = 3 the
    interpolant's start 426 + 51 T, and the outputs 6; one accepted outer
    iteration — gradient, Schur curvature and step 31 T + 56, E at the
    candidate 1 + 2 T, three inner steps 60 T + 129, the objective 8 T, the
    stop tests and update 29, and the gtol test 27 when gtol > 0."""
    prelude = (12 * T + 14) + 7 + (1 + 2 * T) + 2 * (20 * T + 43) + 8 * T + (2 * T - 1) \
        + (132 * T + 192) + (68 * T + 133) + (426 + 51 * T if T == 3 else 0) + 6
    iteration = (31 * T + 56) + (1 + 2 * T) + (60 * T + 129) + 8 * T + 29 + (27 if gtol > 0 else 0)
    return prelude, iteration


def gr_varpro_bound(n, T, steps, gtol):
    """Bound of ft2_gr_varpro_fit on n voxels x T echoes: the larger of the
    bytes (signal in, (x, stats) out) and the fp32 operations of every
    voxel's prelude plus its accepted outer iterations (``steps``, stats
    row 2 summed; rejected iterations are not counted, so the bound is a
    lower one). Returns (ms, by, operations)."""
    prelude, iteration = gr_varpro_ops(T, gtol)
    n_ops = n * prelude + steps * iteration
    ms, by = bound(n * (T * 4 + 24), n_ops, FP32_OPS)
    return ms, by, n_ops


def phase0_environment():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
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
    time, flags and registers/spills/stack per instance (a spill fails the
    run at its end, after the measurements), and check that the
    VARPRO kernel's reciprocal square root is torch.rsqrt's on this card."""
    t0 = time.perf_counter()
    libs = build.build_kernels()
    for name in libs:
        build.load_lib(name)
    dt = time.perf_counter() - t0
    regs = {}
    for name in libs:
        log = build.build_log(name)
        for entry, body in re.findall(r"Compiling entry function '(\S+)'.*?\n(.*?Used \d+ registers[^\n]*)",
                                      log, re.S):
            inst = re.search(r"(Rician|GaussRician)?E?Li(\d)E", entry)
            kind = re.search(r"(?:gauss|gr_varpro|fit3)_([a-z]+)_kernel", entry)
            if name == "conv_s2d":
                key = f"conv_s2d/{'bf16' if 'conv_s2d_bf16' in entry else 'fp32'}"
            elif inst:
                key = (f"{name}{'/' + kind.group(1) if kind else ''}"
                       f"{'/' + inst.group(1) if inst.group(1) else ''}/T{inst.group(2)}")
            else:
                key = name
            spill = re.search(r"(\d+) bytes spill stores", body)
            stack = re.search(r"(\d+) bytes stack frame", body)
            regs[key] = (int(re.search(r"Used (\d+) registers", body).group(1)),
                         int(spill.group(1)) if spill else 0, int(stack.group(1)) if stack else 0)
    spills = {k: v[1] for k, v in regs.items() if v[1]}
    gauss_regs = {k[len("gauss_fit/"):]: v[:2] for k, v in sorted(regs.items())
                  if k.startswith("gauss_fit/")}
    flags = {name: " ".join(build.SOURCE_FLAGS[name]) or "-" for name in libs}
    print(f"phase 1 build: {sorted(libs)} -> sm_90a ({' '.join(build.COMMON_FLAGS)}; per source "
          f"{flags}) in {dt:.2f} s; registers/spill bytes/stack bytes at T=3 and 8 and of the conv: "
          f"{ {k: v for k, v in sorted(regs.items()) if k.endswith(('T3', 'T8', 'bf16', 'fp32'))} }",
          flush=True)
    print(f"phase 1 gauss_fit registers/spill bytes per kernel and T: {gauss_regs}", flush=True)
    cuobjdump = shutil.which("cuobjdump", path=os.path.dirname(build.nvcc())) \
        or shutil.which("cuobjdump")
    if cuobjdump:
        sass = subprocess.run([cuobjdump, "-sass", build.lib_path("conv_s2d")], capture_output=True,
                              text=True, check=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "UTMASTG")}
        print(f"phase 1 sass: libconv_s2d.so instructions {counts} (wgmma, TMA load, TMA store)",
              flush=True)
    else:
        print("phase 1 sass: cuobjdump not found, instruction counts not taken", flush=True)
    lib = build.load_lib("gr_varpro_fit")
    x = torch.cat([torch.rand(1 << 22, device="cuda") * 1e4 + 1e-6,
                   torch.logspace(-6, 30, 1 << 20, device="cuda")])
    a, b = torch.empty_like(x), torch.empty_like(x)
    gate(lib.ft2_rsqrt_probe(x.data_ptr(), x.numel(), a.data_ptr(), b.data_ptr(),
                             torch.cuda.current_stream().cuda_stream) == 0, "rsqrt probe launch")
    ref = torch.rsqrt(x)
    same_rsqrtf = (a == ref).float().mean().item()
    gate(same_rsqrtf == 1.0, f"the kernel's rsqrtf differs from torch.rsqrt on {1 - same_rsqrtf:.3e} of inputs")
    print(f"phase 1 rsqrt: torch.rsqrt == rsqrtf on {same_rsqrtf:.6f} of {x.numel()} inputs, "
          f"== 1/sqrtf on {(b == ref).float().mean().item():.6f}; kernel instances that spill "
          f"(bytes): {spills or 'none'}", flush=True)
    return spills


def compare(s, tes, ident, no_prior=False):
    """Kernel (head + tail) vs plain version on one (N, T) CUDA batch,
    gated bitwise on every output of every voxel (k, t2, f, converged,
    n_iter) and by the bench.py:638-652 bands on identifiable voxels
    (params 1e-3 and objective 1e-2 relative, convergence rate within
    0.01). Returns (summary text, largest absolute (k, T2) difference
    there). The kernel launch made here is not part of the main path's
    count."""
    idv = torch.from_numpy(ident).cuda()
    out_k = fused_fit._gauss_fit(s, tes, LO, HI, no_prior=no_prior, **FIT_KW)
    out_p = fused_fit._gauss_fit_plain(s, tes, LO, HI, no_prior=no_prior, **FIT_KW)
    (kk, tk, fk, ck, _), (kp, tp, fp, cp, _) = out_k, out_p
    xk, xp = torch.stack([kk, tk]), torch.stack([kp, tp])
    rel_x = ((xk - xp).abs() / xp.abs().clamp(min=1.0))[:, idv].max().item()
    rel_f = ((fk - fp).abs() / fp.abs().clamp(min=1.0))[idv].max().item()
    dconv = abs(ck.float().mean().item() - cp.float().mean().item())
    all_k = torch.stack([t.float() for t in out_k])
    all_p = torch.stack([t.float() for t in out_p])
    bitwise = ((all_k == all_p) | (all_k.isnan() & all_p.isnan())).all(0).float().mean().item()
    name = f"{s.shape[0]} x T={len(tes)}{' no_prior' if no_prior else ''}"
    gate(rel_x <= 1e-3 and rel_f <= 1e-2 and dconv <= 0.01,
         f"kernel vs plain {name}: rel x {rel_x:.3e} (> 1e-3) / f {rel_f:.3e} "
         f"(> 1e-2) / dconv {dconv:.4f} (> 0.01)")
    gate(bitwise == 1.0, f"gauss kernel vs plain {name}: bitwise on {bitwise:.6f} of the voxels")
    text = (f" {name}: x {rel_x:.2e} f {rel_f:.2e} dconv {dconv:.4f}"
            f" bitwise {bitwise:.6f};")
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

    nit = fused_fit._gauss_fit(s, TES3, LO, HI, no_prior=False, **FIT_KW)[4]
    g_bound = gauss_bound(n, 3, nit.double().sum().item(), FIT_KW["gtol"])
    kernel_ms = cuda_ms(lambda: fused_fit._gauss_fit(s, TES3, LO, HI, no_prior=False, **FIT_KW), 3)
    full_ms = cuda_ms(lambda: fused_fit._gauss_fit(
        s, TES3, LO, HI, no_prior=False, **dict(FIT_KW, full_budget=True)), 3)
    plain_ms = cuda_ms(lambda: fused_fit._gauss_fit_plain(s, TES3, LO, HI, no_prior=False, **FIT_KW), 3)
    print(f"phase 3 headline 256^3 x 3 TEs: kernel {kernel_ms:.3f} ms "
          f"({n / kernel_ms * 1e3:.4g} voxel-fits/s), full 60-iteration budget "
          f"{full_ms:.3f} ms, plain {plain_ms:.1f} ms; max rel T2 err vs "
          f"curve_fit {max_rel:.3e} ({int(interior.sum())} voxels), converged "
          f"{conv:.5f}, unconverged-identifiable {unconv_ident:.2e}, mean "
          f"accepted steps {mean_iter:.3f}; bound {g_bound[0]:.4f} ms ({g_bound[1]}: "
          f"{g_bound[2]:.4g} fp32 operations); "
          f"kernel vs plain{text}", flush=True)
    return kernel_ms, plain_ms, diff, g_bound


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
    voxels, 3 and 6 TEs (bench bounds, guess and tolerances): within the
    bench's bands, and bitwise equal."""
    t0 = time.perf_counter()
    lines, worst = "", {}
    for tes in (TES3, TES6):
        sig, _, _, ident = make_data3(N_PARITY3, tes, seed=5)
        text, w = compare3(torch.from_numpy(sig).cuda(), tes, ident)
        lines += text
        for name, (b, d) in w.items():
            b0, d0 = worst.get(name, (1.0, 0.0))
            worst[name] = (min(b0, b), max(d0, d))
    for name, (b, _) in worst.items():
        gate(b == 1.0, f"{name} is bitwise its plain version on {b:.6f} of the voxels, not all")
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


def warp_profile(s):
    """What warp divergence costs the fit kernels at 256^3 x 3 TEs, under the
    bench's and the pipeline's tolerances. Per kernel (gauss, gr_varpro, the
    rician fit3_cont from the kernel's own prefix): the share of voxels
    still unconverged after K iterations (for fit3_cont K = 0 is what the
    prefix left), from runs at max_iters = K, and from them each voxel's
    iterations; its time, and its time on the same input sorted by its own
    result (converged, iterations, accepted steps), gated to give the sorted
    output bitwise; the mean iterations per voxel and per warp (the most of
    its 32 lanes) as made and sorted; the share a split kernel sends to its
    tail; its bound; gauss's and gr_varpro's time at max_iters = 0 (the
    prelude alone) and fit3_cont's (the sweep alone: every voxel written
    with its objective at x0); and a split kernel's time on the sorted
    input with its tail's voxels shuffled among their own places (lanes
    mixed as in the input as made, memory as contiguous as sorted). Prints
    one line per tolerances."""
    n = s.shape[0]
    gauss_head = build.load_lib("gauss_fit").ft2_gauss_head_iters()
    head_iters = build.load_lib("gr_varpro_fit").ft2_gr_head_iters()
    shuffle = torch.Generator(device=s.device).manual_seed(0)
    for tname, tol in TOLERANCES.items():
        rows = {}
        ftol, gtol = tol["ftol"], tol["gtol"]
        two = dict(ftol=ftol, gtol=gtol, full_budget=False, stall_iters=3, stall_tol=max(ftol, 1e-3))
        three = dict(ftol=ftol, gtol=gtol, stall_tol=max(ftol, 1e-6))
        pre = fused_fit._fit3_cuda(s, "rician", TES3, LO3_RICIAN, HI3, GUESS3, max_iters=PREFIX3,
                                   **three)
        pre_steps = torch.nan_to_num(pre[1][2]).double().sum().item()
        runs = {  # name: (call(signal, max_iters, (x0, st0)), budget, converged row,
                  #        steps row, iterations in the head (None: not split), bound(steps))
            "gauss": (lambda sig, it, p0: fused_fit._gauss_fit(
                sig, TES3, LO, HI, max_iters=it, no_prior=False, **two), 60, 3, 4, gauss_head,
                lambda st: gauss_bound(n, 3, st, gtol)),
            "gr_varpro": (lambda sig, it, p0: fused_fit._gr_varpro_fit_cuda(
                sig, TES3, LO3, HI3, GUESS3, max_iters=it, **two), 60, 4, 5, head_iters,
                lambda st: gr_varpro_bound(n, 3, st, gtol)),
            "fit3_cont": (lambda sig, it, p0: fused_fit._fit3_cont_cuda(
                sig, "rician", TES3, LO3_RICIAN, HI3, GUESS3, *p0, max_iters=it, **three),
                60 - PREFIX3, 4, 5, 0,
                lambda st: fit3_bound("rician", n, 3, st - pre_steps, cont=True)),
        }
        for name, (call, budget, ci, ni, head, bound_of) in runs.items():
            def fn(sig, it, p0, call=call):  # every output as one float (rows, n) tensor
                return torch.cat([v.float().reshape(-1, n) for v in call(sig, it, p0)])
            out = fn(s, budget, pre)
            iters = torch.zeros(n, dtype=torch.int32, device=s.device)
            unconverged = {}
            for k in range(budget):
                running = ~(fn(s, k, pre)[ci] > 0.5)
                iters += running
                unconverged[k] = running.float().mean().item()
                if unconverged[k] == 0.0:
                    break
            key = ((out[ci] > 0.5).long() << 20) + (iters.long() << 10) \
                + torch.nan_to_num(out[ni]).long()
            perm = torch.argsort(key, stable=True)
            s_p = s[perm].contiguous()
            pre_p = tuple(t[:, perm].contiguous() for t in pre)
            want, got = out[:, perm], fn(s_p, budget, pre_p)
            gate(bool(((got == want) | (got.isnan() & want.isnan())).all()),
                 f"{name}, {tname} tolerances: sorted input did not give the sorted output bitwise")
            row = {"ms": cuda_ms(lambda: call(s, budget, pre), 5),
                   "sorted_ms": cuda_ms(lambda: call(s_p, budget, pre_p), 5),
                   "unconverged": {k: v for k, v in unconverged.items() if k in TAIL_KS},
                   "voxel_iters": iters.float().mean().item(),
                   "warp_iters": iters.view(-1, 32).amax(1).float().mean().item(),
                   "sorted_warp_iters": iters[perm].view(-1, 32).amax(1).float().mean().item(),
                   "bound": bound_of(torch.nan_to_num(out[ni]).double().sum().item())}
            if head is not None:
                row["tail_share"] = unconverged.get(head, 0.0)
                row["alone_ms"] = cuda_ms(lambda: call(s, 0, pre), 5)
                places = torch.nonzero(iters[perm] > head).squeeze(1)
                mixed = perm.clone()
                mixed[places] = perm[places[torch.randperm(places.numel(), generator=shuffle,
                                                           device=s.device)]]
                s_m = s[mixed].contiguous()
                pre_m = tuple(t[:, mixed].contiguous() for t in pre)
                row["mixed_ms"] = cuda_ms(lambda: call(s_m, budget, pre_m), 5)
                del s_m, pre_m
            rows[name] = row
            del out, s_p, pre_p, want, got, iters
        text = "; ".join(
            f"{name} {r['ms']:.3f} ms, sorted input {r['sorted_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]})"
            + (f", {'sweep' if name == 'fit3_cont' else 'prelude'} alone {r['alone_ms']:.3f} ms, "
               f"sent to the tail {r['tail_share']:.5f}, sorted with the tail's voxels shuffled "
               f"in place {r['mixed_ms']:.3f} ms" if "tail_share" in r else "")
            + f", iterations per voxel {r['voxel_iters']:.3f}, per warp {r['warp_iters']:.3f} "
            f"(sorted {r['sorted_warp_iters']:.3f}), unconverged after K iterations {{"
            + ", ".join(f"{k}: {v:.5f}" for k, v in r["unconverged"].items()) + "}"
            for name, r in rows.items())
        print(f"phase 6 warps 256^3 x 3 TEs, {tname} tolerances (ftol {ftol:g}, gtol {gtol:g}): "
              f"{text}", flush=True)


GAUSS_HEADS = (0, 1, 2, 4)   # the head lengths gauss_head_lengths builds and times


def gauss_head_lengths(s, rounds=5):
    """The gaussian fit's head length (``kHeadIters`` in csrc/gauss_fit.cu)
    on this card: the source built once per length in GAUSS_HEADS (the line
    that sets it replaced; one nvcc each, all at once), each build held
    bitwise to the plain version on ``s`` and timed on ``s`` as made under
    the bench's and the pipeline's tolerances, in ``rounds`` rounds that
    take the lengths in turn (reversed every other round). Prints one line
    per tolerances: each length's median time over the rounds and its
    range, and the head and tail kernels' registers at T = 3."""
    line = f"constexpr int kHeadIters = {build.load_lib('gauss_fit').ft2_gauss_head_iters()};"
    with open(build.KERNEL_SOURCES["gauss_fit"]) as f:
        src = f.read()
    gate(src.count(line) == 1, f"gauss_head_lengths: {line!r} is not in gauss_fit.cu once")
    out_dir = tempfile.mkdtemp(prefix="ft2_gauss_heads_")
    t0 = time.perf_counter()
    procs = {}
    for k in GAUSS_HEADS:
        path = os.path.join(out_dir, f"gauss_fit_k{k}.cu")
        with open(path, "w") as f:
            f.write(src.replace(line, f"constexpr int kHeadIters = {k};"))
        cmd = [build.nvcc(), *build.nvcc_flags("gauss_fit"), f"-I{build.CSRC}", "-o",
               path[:-3] + ".so", path]
        procs[k] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
    libs, regs = {}, {}
    for k, proc in procs.items():
        log = proc.communicate()[0]
        gate(proc.returncode == 0, f"gauss_head_lengths: build of kHeadIters {k}: {log[-2000:]}")
        libs[k] = ctypes.CDLL(os.path.join(out_dir, f"gauss_fit_k{k}.so"))
        for fn, argtypes in build.SIGNATURES["gauss_fit"].items():
            getattr(libs[k], fn).argtypes = argtypes
            getattr(libs[k], fn).restype = ctypes.c_int
        gate(libs[k].ft2_gauss_head_iters() == k, f"gauss_head_lengths: build {k} reports "
             f"{libs[k].ft2_gauss_head_iters()}")
        regs[k] = {kind: int(used) for kind, used in re.findall(
            r"Compiling entry function '\S*gauss_(head|tail)_kernelILi3E\S*'.*?Used (\d+) registers",
            log, re.S)}
    built_s = time.perf_counter() - t0

    def fit(k, **kw):  # the wrapper, with build k's library in place of the product's
        load = build.load_lib
        build.load_lib = lambda name: libs[k] if name == "gauss_fit" else load(name)
        try:
            return fused_fit._gauss_fit_cuda(s, TES3, LO, HI, max_iters=60, no_prior=False,
                                             full_budget=False, stall_iters=3, **kw)
        finally:
            build.load_lib = load

    for tname, tol in TOLERANCES.items():
        kw = dict(ftol=tol["ftol"], gtol=tol["gtol"], stall_tol=max(tol["ftol"], 1e-3))
        want = torch.stack([t.float() for t in fused_fit._gauss_fit_plain(
            s, TES3, LO, HI, max_iters=60, no_prior=False, full_budget=False, stall_iters=3,
            **kw)])
        for k in GAUSS_HEADS:
            got = torch.stack([t.float() for t in fit(k, **kw)])
            gate(bool(((got == want) | (got.isnan() & want.isnan())).all()),
                 f"gauss_head_lengths, {tname} tolerances: kHeadIters {k} is not bitwise the "
                 f"plain version")
        times = {k: [] for k in GAUSS_HEADS}
        for r in range(rounds):
            for k in (GAUSS_HEADS if r % 2 == 0 else GAUSS_HEADS[::-1]):
                times[k].append(cuda_ms(lambda: fit(k, **kw), 3))
        print(f"phase 6 gauss head lengths 256^3 x 3 TEs, {tname} tolerances (ftol "
              f"{tol['ftol']:g}, gtol {tol['gtol']:g}), median ms over {rounds} rounds (range): "
              + ", ".join(f"kHeadIters {k} {np.median(v):.3f} ({min(v):.3f}-{max(v):.3f})"
                          for k, v in times.items())
              + f"; every build bitwise the plain version; built in {built_s:.1f} s, registers "
              f"at T=3 {regs}; the product's kHeadIters is "
              f"{build.load_lib('gauss_fit').ft2_gauss_head_iters()}", flush=True)
        del want
    shutil.rmtree(out_dir, ignore_errors=True)


def phase6_headline3():
    """Dense 256^3 x 3 TEs per 3-parameter model with bench.py's generator
    (seed 0): gates of bench.py:310-366, kernel vs plain, and the times of
    each kernel and its plain version (CUDA events); then warp_profile."""
    sig, k_true, t2_true, ident = make_data3(N_HEADLINE3, TES3, seed=0)
    s = torch.from_numpy(sig).cuda()
    idx = np.random.default_rng(1).choice(np.flatnonzero(ident), 256, replace=False)
    idv = torch.from_numpy(ident).cuda()
    t2_dev = torch.from_numpy(t2_true).cuda()
    times, worst, bounds = {}, {}, {}
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
            unpruned_ms = cuda_ms(lambda: fused_fit._fit3_cuda(s, model, TES3, lo, HI3, GUESS3,
                                                               max_iters=60, **FIT3_KW), 3)
            runs = {"fit3": (
                lambda: fused_fit._fit3_cuda(s, model, TES3, lo, HI3, GUESS3, max_iters=PREFIX3, **FIT3_KW),
                lambda: fused_fit._fit3_plain(s, model, TES3, lo, HI3, GUESS3, max_iters=PREFIX3, **FIT3_KW)),
                "fit3_cont": (
                lambda: fused_fit._fit3_cont_cuda(s, model, TES3, lo, HI3, GUESS3, *pre, **cont),
                lambda: fused_fit._fit3_cont_plain(s, model, TES3, lo, HI3, GUESS3, *pre, **cont))}
        text = ""
        for name, (kern, plain) in runs.items():
            out_k = kern()
            r_t, b, d = bands3(out_k, plain(), ident, f"{name} 256^3")
            gate(b == 1.0, f"{name} at 256^3 is bitwise its plain version on {b:.6f} of the voxels")
            text += r_t
            worst[name] = (b, d)
            times[name] = (cuda_ms(kern, 3), cuda_ms(plain, 1))
            # out: (x, stats) = 2 x 3 float32; the continuation also reads
            # its start (x0, st0); stats row 2 is the accepted steps, the
            # continuation's counted on from the prefix's
            steps = torch.nan_to_num(out_k[1][2]).double().sum().item()
            is_cont = name == "fit3_cont"
            if is_cont:
                steps -= torch.nan_to_num(pre[1][2]).double().sum().item()
            if name == "gr_varpro":
                bounds[name] = gr_varpro_bound(N_HEADLINE3, 3, steps, TOL3["gtol"])
            else:
                bounds[name] = fit3_bound(model, N_HEADLINE3, 3, steps, cont=is_cont)
            old = fit_bound(N_HEADLINE3, 3, out_bytes=24, in_extra=24 if is_cont else 0,
                            steps=steps, starts=3 if name == "fit3" else 1)
            detail = (f": {bounds[name][2]:.4g} fp32 operations, {steps:.6g} accepted steps; "
                      f"transcendentals-and-bytes bound {old[0]:.4f} ms")
            text += (f" {name} kernel {times[name][0]:.3f} ms, plain {times[name][1]:.1f} ms, "
                     f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}{detail});")
        if model == "rician":
            text += f" fit3 unpruned (60 iterations, every start) {unpruned_ms:.3f} ms;"
        print(f"phase 6 headline 256^3 x 3 TEs {model} ({time.perf_counter() - t0:.1f} s): median "
              f"rel T2 err vs truth {med_rel:.3e}, L-BFGS-B objective gap max {gap.max():.3e} "
              f"median {np.median(gap):.3e} (256 identifiable voxels), converged {conv:.5f}, "
              f"unconverged-identifiable {unconv_ident:.2e}, mean accepted steps "
              f"{res.n_iter.float().mean().item():.3f}, n_overflow {res.n_overflow};{text}",
              flush=True)
    warp_profile(s)
    gauss_head_lengths(s)
    return times, worst, bounds


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


# ------------------------------------------------ the SynthSeg U-Net
# the 160^3 level-0 shape (Q = 80, C = C' = 8 x 24), a ragged one that fills
# no tile evenly with C < 64 and C' < 64, and a small ragged one at C = 64,
# C' = 192 whose tile count does not divide over the card
CONV_SHAPES = (((80, 80, 80), 192, 192), ((17, 23, 29), 24, 40), ((5, 7, 9), 64, 192))


def full_fp32():
    """fp32 on the card in full fp32 from here on: cuBLAS matmuls and cuDNN
    convs without TF32 (every fp32 comparison of phases 8-9 needs it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 steps between two bf16 tensors (+0 == -0)."""
    def order(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (order(a) - order(b)).abs()


def conv_inputs(q, c, c_out, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(tuple(v + 1 for v in q) + (c,), device="cuda", generator=g)
    w = torch.randn(8 * c, c_out, device="cuda", generator=g) / math.sqrt(8 * c)
    b = 0.1 * torch.randn(c_out, device="cuda", generator=g)
    r = torch.randn(tuple(q) + (c_out,), device="cuda", generator=g)
    return x, w, b, r


def phase8_conv():
    """conv_s2d.cu against its plain version in bf16 and fp32 (TF32 off),
    with and without the residual, at the 160^3 level-0 shape and two
    ragged ones. Gates: fp32 max |d| <= 1e-5 of the output's largest magnitude;
    bf16 within one ulp of the element on >= 99.9% of elements and within
    two ulps of the output's largest magnitude everywhere (an output near 0
    can differ by many of its own ulps through the order of the fp32 sums
    alone). Then the bf16 times at 160^3: kernel, plain version, and one
    cuDNN F.conv3d of the same conv (no epilogue) as the library yardstick.
    Returns (largest |d|, times, bound)."""
    full_fp32()
    worst, text = 0.0, ""
    for q, c, c_out in CONV_SHAPES:
        x, w, b, r = conv_inputs(q, c, c_out, seed=1)
        for dt in (torch.bfloat16, torch.float32):
            for res in (None, r):
                k = conv_s2d.conv_s2d(x, w, b, res, compute_dtype=dt)
                torch.cuda.synchronize()
                p = conv_s2d._conv_s2d_plain(x, w, b, res, compute_dtype=dt)
                diff = (k.float() - p.float()).abs().max().item()
                scale = p.float().abs().max().item()
                what = (f"{'x'.join(map(str, q))} C {c}->{c_out} {str(dt)[6:]}"
                        f"{' +res' if res is not None else ''}")
                if dt == torch.float32:
                    gate(diff <= 1e-5 * scale, f"conv_s2d {what}: |d| {diff:.3e} > 1e-5 of {scale:.3e}")
                    text += f" {what}: rel {diff / scale:.2e};"
                else:
                    u = bf16_ulps(k, p)
                    one = (u <= 1).float().mean().item()
                    scale_ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
                    gate(one >= 0.999 and diff <= 2 * scale_ulp,
                         f"conv_s2d {what}: within 1 ulp {one:.6f} (< 0.999) or |d| {diff:.3e} "
                         f"> 2 ulps of the scale ({2 * scale_ulp:.3e})")
                    text += (f" {what}: <=1 ulp {one:.6f} (max {int(u.max())} of the element's own),"
                             f" |d| {diff / scale_ulp:.2f} scale-ulps;")
                worst = max(worst, diff)
        del x, w, b, r
    q, c, c_out = CONV_SHAPES[0]
    x, w, b, r = (t.bfloat16() if t.dim() > 1 else t for t in conv_inputs(q, c, c_out, seed=2))
    xc = x[None].permute(0, 4, 1, 2, 3)
    wc = w.reshape(2, 2, 2, c, c_out).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    times = {
        "kernel": cuda_ms(lambda: conv_s2d.conv_s2d(x, w, b), 20),
        "kernel_res": cuda_ms(lambda: conv_s2d.conv_s2d(x, w, b, r), 20),
        "plain": cuda_ms(lambda: conv_s2d._conv_s2d_plain(x, w, b), 5),
        "library": cuda_ms(lambda: torch.nn.functional.conv3d(xc, wc), 20),
    }
    m = q[0] * q[1] * q[2]
    n_bytes = (x.numel() + w.numel() + m * c_out) * 2 + b.numel() * 4
    b_conv = bound(n_bytes, 2.0 * m * 8 * c * c_out, BF16_OPS)
    b_res = bound(n_bytes + m * c_out * 2, 2.0 * m * 8 * c * c_out, BF16_OPS)
    print(f"phase 8 conv_s2d kernel vs plain:{text} 160^3 level 0 bf16 (M {m}, K {8 * c}, "
          f"N {c_out}): kernel {times['kernel']:.3f} ms (+residual {times['kernel_res']:.3f}), "
          f"plain {times['plain']:.3f} ms, cuDNN F.conv3d {times['library']:.3f} ms, bound "
          f"{b_conv[0]:.4f} ms ({b_conv[1]}; +residual {b_res[0]:.4f}), "
          f"{2.0 * m * 8 * c * c_out / times['kernel'] / 1e9:.1f} TFLOP/s", flush=True)
    return worst, times, b_conv


def brain_volume(n: int, seed: int) -> np.ndarray:
    """A synthetic 1 mm T2-weighted head of n^3 voxels: an ellipsoidal brain
    (white matter, a cortical grey-matter shell, two bright ventricles) in
    bright CSF, a dark background, a smooth bias field and noise everywhere."""
    rng = np.random.default_rng(seed)
    ax = (np.arange(n, dtype=np.float32) - (n - 1) / 2) / (n / 2)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt((zz / 0.7) ** 2 + (yy / 0.85) ** 2 + (xx / 0.75) ** 2)
    vol = np.full((n,) * 3, 30.0, np.float32)
    vol[r < 1.0] = 900.0                                  # CSF
    vol[r < 0.9] = 550.0                                  # cortical grey matter
    vol[r < 0.78] = 380.0                                 # white matter
    for side in (-1, 1):                                  # lateral ventricles
        rv = np.sqrt((zz / 0.15) ** 2 + (yy / 0.4) ** 2 + ((xx - side * 0.18) / 0.08) ** 2)
        vol[rv < 1.0] = 1000.0
    vol *= 1.0 + 0.1 * np.sin(2.0 * zz + 1.0) * np.cos(1.5 * yy)
    vol += rng.normal(0.0, 25.0, vol.shape).astype(np.float32)
    return np.abs(vol).astype(np.float32)


def phase9_segmentation():
    """The segmentation step on the card as a user runs it: a 160^3 recon
    in a BIDS tree, random SynthSeg-layout weights (batch_norm, seed 0) in
    an .npz named by FT2_SYNTHSEG_WEIGHTS, FT2_UNET_S2D=kernel, and
    run_segmentation with SynthSegRunner(mode="torch"), conv_s2d's count
    set to 0 just before. Gates: 3 launches, the label map's shape and
    values, agreement with the fp32 dense program (TF32 off) >= 0.97 and,
    for the fp32 kernel program, >= 0.999. Then the forward times."""
    full_fp32()
    n = 160
    cfg = unet3d.UNetConfig(batch_norm=True)
    params = unet3d.random_params(cfg, seed=0)
    vol = brain_volume(n, seed=21)
    acq = {"prj": "prj-smoke", "sub": "sub-01", "ses": "ses-01", "run": "run-114",
           "EchoTime": 0.114, "CoilString": "Body"}
    env = {}
    with tempfile.TemporaryDirectory(prefix="ft2_smoke_seg_") as root:
        bids = os.path.join(root, "projects/")
        nifti.write(get_img_path(bids, acq, C.RECON_DIRNAME), Volume(vol))
        env["FT2_SYNTHSEG_WEIGHTS"] = os.path.join(root, "synthseg_random.npz")
        np.savez(env["FT2_SYNTHSEG_WEIGHTS"], **params)
        env["FT2_UNET_S2D"] = "kernel"
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            profiler.reset()
            torch.cuda.reset_peak_memory_stats()
            conv_s2d.CONV_S2D_LAUNCHES = 0
            t0 = time.perf_counter()
            with profiler.stage("recon.synthseg"):
                run_segmentation([acq], bids, SynthSegRunner(mode="torch"))
            stage_s = time.perf_counter() - t0
            launches = conv_s2d.CONV_S2D_LAUNCHES
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        out = nifti.list_volumes(os.path.join(bids, acq["prj"], "derivatives",
                                              C.SYNTHSEG_DIRNAME, acq["sub"], acq["ses"], "anat"))
        gate(len(out) == 1 and out[0].endswith("_te-114_recon_1mm_synthseg.nii.gz"),
             f"segmentation outputs {out}")
        labels = np.asarray(nifti.read(out[0]).data)
    gate(launches == 3, f"the segmentation step launched conv_s2d {launches} times, not 3")
    gate(labels.shape == vol.shape and labels.dtype == np.int16,
         f"label map {labels.shape} {labels.dtype}")
    gate(set(np.unique(labels).tolist()) <= set(unet3d.SYNTHSEG_LABELS), "labels outside SYNTHSEG_LABELS")
    dense32 = unet3d.segment_volume(params, vol, use_s2d=False, compute_dtype=torch.float32)
    kernel32 = unet3d.segment_volume(params, vol, use_s2d="kernel", compute_dtype=torch.float32)
    dense16 = unet3d.segment_volume(params, vol, use_s2d=False)
    agree16 = float((labels == dense32).mean())
    agree32 = float((kernel32 == dense32).mean())
    gate(agree16 >= 0.97, f"bf16 kernel labels agree with fp32 dense on {agree16:.5f} < 0.97")
    gate(agree32 >= 0.999, f"fp32 kernel labels agree with fp32 dense on {agree32:.5f} < 0.999")

    # forward times (CUDA events) on the normalized, padded volume
    norm = np.clip(vol / np.percentile(vol[vol > 0], 99.5), 0.0, 1.0).astype(np.float32)
    x = torch.from_numpy(norm)[None, ..., None].cuda()
    dev = x.device
    fwd = {}
    with torch.inference_mode():
        for name, dt, s2d in (("kernel bf16", torch.bfloat16, "kernel"),
                              ("S2D F.conv3d bf16", torch.bfloat16, "torch"),
                              ("dense bf16", torch.bfloat16, None),
                              ("dense fp32", torch.float32, None)):
            tp, ts = unet3d._params_cached(params, cfg, dev, dt, s2d is not None)

            def forward():
                if s2d:
                    return unet3d.unet_apply_s2d(tp, ts, x, cfg, dt, conv_impl=s2d)
                return torch.argmax(unet3d.unet_apply(tp, x, cfg, dt), dim=-1)
            fwd[name] = cuda_ms(forward, 5)
    kinds = {int(v): int(c) for v, c in zip(*np.unique(labels, return_counts=True))}
    print(f"phase 9 segmentation (run_segmentation, SynthSegRunner(mode='torch'), "
          f"FT2_UNET_S2D=kernel, {n}^3, SynthSeg 1.0 topology + BN, random weights): stage "
          f"{stage_s:.3f} s ({profiler.as_dict()['recon.synthseg']['seconds']:.3f} s in "
          f"recon.synthseg), peak device memory {peak_gib:.2f} GiB, conv_s2d launches {launches}, "
          f"label agreement vs fp32 dense: bf16 kernel {agree16:.5f}, fp32 kernel {agree32:.5f}, "
          f"bf16 dense {float((dense16 == dense32).mean()):.5f}; {len(kinds)} labels present; "
          f"forward ms {{{', '.join(f'{k}: {v:.3f}' for k, v in fwd.items())}}}", flush=True)
    return launches


# ------------------------------------------------ the guess start (two-phase solver)
GUESS_SHAPE, GUESS_SUB = (64, 128, 128), 16   # 2^20 voxels; the first 16^3 of them
GUESS_MODELS = {  # model: (low field, TEs, k range, T2 range), as phases 4 and 7
    "gaussian": (True, TES_SESSION, (600.0, 5000.0), (20.0, 500.0)),
    **{model: row[:4] for model, row in SESSIONS3.items()},
}
BANDS = {"gaussian": (1e-3, 1e-2), "gaussian_rician": (1e-2, 3e-2), "rician": (1e-2, 3e-2)}


def guess_echoes(model, seed):
    """GUESS_SHAPE echoes of one model's data (additive noise for gaussian,
    the magnitude of complex noise for the 3-parameter models, sigma 8) and
    the identifiable voxels (last echo >= 3 sigma)."""
    _, tes, k_range, t2_range = GUESS_MODELS[model]
    rng = np.random.default_rng(seed)
    k = rng.uniform(*k_range, GUESS_SHAPE).astype(np.float32)
    t2 = rng.uniform(*t2_range, GUESS_SHAPE).astype(np.float32)
    echoes = []
    for te in tes:
        a = k * np.exp(-te / t2)
        noise = rng.normal(0, NOISE, GUESS_SHAPE).astype(np.float32)
        if model == "gaussian":
            echoes.append(np.maximum(a + noise, 1e-2).astype(np.float32))
        else:
            echoes.append(np.hypot(a + noise, rng.normal(0, NOISE, GUESS_SHAPE)).astype(np.float32))
    return echoes, k * np.exp(-tes[-1] / t2) >= 3 * NOISE


def fully_masked(echoes, tes):
    mask = Volume(np.ones(echoes[0].shape, np.uint8))
    return EchoStack.from_volumes([Volume(np.ascontiguousarray(e)) for e in echoes],
                                  [mask] * len(tes), tes)


def guess_cols(o):
    """(x (k, T2, sigma), fun, converged, n_overflow) of a fit_stack output,
    voxels in the volume's flat order."""
    x = np.stack([o.k.data.ravel(), o.t2.data.ravel(), o.sigma.data.ravel()], axis=1)
    return x, o.fun.data.ravel(), o.converged.data.ravel() > 0.5, o.n_overflow


def guess_outside(model, a, b, ident):
    """The ``ident`` voxels where fits a and b (guess_cols) leave the
    bench.py:638-652 bands (k and T2, objective)."""
    bx, bf = BANDS[model]
    rel_x = (np.abs(a[0] - b[0]) / np.maximum(np.abs(b[0]), 1.0))[:, :2].max(axis=1)
    rel_f = np.abs(a[1] - b[1]) / np.maximum(np.abs(b[1]), 1.0)
    return ident & ~((rel_x <= bx) & (rel_f <= bf))


def guess_bands(model, fit, echoes, tes, ident, what):
    """fit(echoes, device) on the card against the CPU: the convergence
    rates within 0.01, and the bands on every identifiable voxel both
    converged (gaussian) or, for the 3-parameter models, on every such
    voxel but those with a witness: the float64 objectives at the two
    answers within each other's objective band (two equally good minima),
    or rounding-sensitive (one side's own answer leaves the bands when the
    echoes move by one float32 ulp, up or down). n_overflow equal, or, where
    one side's own count moves under such a change, within 0.01 of the
    voxels. Returns the summary text, with the witness of each voxel
    outside the bands (the first 8)."""
    a, b = (guess_cols(fit(echoes, dev)) for dev in ("cuda", "cpu"))
    ident = ident.ravel()
    both = ident & a[2] & b[2]
    dconv = abs(float(a[2].mean()) - float(b[2].mean()))
    out = np.flatnonzero(guess_outside(model, a, b, both))
    sig = np.stack([e.ravel() for e in echoes], axis=1).astype(np.float64)
    objective, te = _objective(model), np.asarray(tes, np.float64)
    f64 = np.array([[objective(x[i].astype(np.float64), te, sig[i]) for x in (a[0], b[0])]
                    for i in out]).reshape(-1, 2)
    equal = np.abs(f64[:, 0] - f64[:, 1]) <= BANDS[model][1] * np.maximum(
        np.abs(f64).min(axis=1), 1.0)
    sensitive, counts, moved = np.zeros(ident.size, bool), {}, False
    for own, dev in ((a, "cuda"), (b, "cpu")):
        for towards, way in ((np.inf, "up"), (0.0, "down")):
            other = guess_cols(fit([np.nextafter(e, np.float32(towards)) for e in echoes], dev))
            sensitive |= guess_outside(model, other, own, ident)
            counts[f"{dev} {way}"] = other[3]
            moved |= other[3] != own[3]
    witness = "; ".join(
        f"voxel {i}: float64 objective card {f[0]:.6g} / CPU {f[1]:.6g}, "
        f"{'equally good' if eq else ''}{'; ' if eq and sensitive[i] else ''}"
        f"{'rounding-sensitive' if sensitive[i] else ''}"
        for i, f, eq in list(zip(out, f64, equal))[:8])
    unexplained = out[~equal & ~sensitive[out]]
    ovf_ok = a[3] == b[3] or (moved and abs(a[3] - b[3]) <= 0.01 * ident.size)
    text = (f"{what}: {out.size} of {int(both.sum())} outside the bands ({int(equal.sum())} "
            f"equally good minima, {int(sensitive[out].sum())} rounding-sensitive"
            f"{': ' + witness if witness else ''}), dconv {dconv:.4f}, n_overflow card "
            f"{a[3]} / CPU {b[3]} (echoes one ulp up or down: {counts})")
    gate(both.sum() >= 16 and dconv <= 0.01 and ovf_ok
         and (out.size == 0 if model == "gaussian" else unexplained.size == 0),
         f"{model} guess start, {text}; without a witness: {unexplained[:8]}")
    return text


def phase10_guess_start():
    """fit_stack with loglinear_init=False — the two-phase solver from the
    protocol guess clipped into each voxel's box, torch ops on the device,
    no hand kernel — once per model on the card over a fully masked
    GUESS_SHAPE stack (2^20 voxels): finite maps, n_overflow and the time;
    then the same call on the card and on the CPU over its first 16^3
    voxels, held together by guess_bands."""
    text = ""
    for model, (low_field, tes, _, _) in GUESS_MODELS.items():
        echoes, ident = guess_echoes(model, seed=17)
        cfg = C.fit_config(model, low_field, loglinear_init=False)
        stack = fully_masked(echoes, tes)
        t0 = time.perf_counter()
        out = fit_stack(stack, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name in ("t2", "k", "sigma", "res", "fun"):
            data = getattr(out, name).data
            gate(data.shape == GUESS_SHAPE and bool(np.isfinite(data).all()),
                 f"{model} guess start: map {name} {data.shape} / non-finite values")
        sub = [e[:GUESS_SUB, :GUESS_SUB, :GUESS_SUB] for e in echoes]
        bands = guess_bands(model, lambda e, dev: fit_stack(fully_masked(e, tes), cfg, device=dev),
                            sub, tes, ident[:GUESS_SUB, :GUESS_SUB, :GUESS_SUB],
                            f"card vs CPU on {GUESS_SUB ** 3} voxels")
        text += (f" {model}: {wall:.3f} s (fit_stack {out.fit_seconds:.3f} s), converged "
                 f"{float((out.converged.data > 0.5).mean()):.5f}, n_overflow {out.n_overflow} "
                 f"of the {pad_bucket(out.n_voxels)} gathered rows; {bands};")
    print(f"phase 10 guess start (fit_stack, loglinear_init=False, two-phase solver, "
          f"{GUESS_SHAPE[0]}x{GUESS_SHAPE[1]}x{GUESS_SHAPE[2]} on cuda):{text}", flush=True)


# ------------------------------------------------ stage 2: registration and the session
def rigid_matrix(rx, ry, rz, t, center):
    """World transform of an ITK Euler3D pose (Rz @ Rx @ Ry) about ``center``."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    R = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
         @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
         @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = center - R @ center + np.asarray(t, np.float64)
    return T


def blob_scene(n: int, T: np.ndarray, device, seed: int = 9) -> np.ndarray:
    """bench.py:686-720's scene: 40 Gaussian blobs in an n^3 1 mm grid
    (world xyz = voxel index), sampled at T @ w; made on ``device``. Centres
    and widths are scaled by n / 192 below 192^3."""
    rng = np.random.default_rng(seed)
    f = min(1.0, n / 192.0)
    centers = torch.as_tensor(rng.uniform(25 * f, n - 25 * f, (40, 3)), dtype=torch.float32,
                              device=device)
    widths = rng.uniform(3.0, 8.0, 40) * max(f, 0.4)
    amps = rng.uniform(50.0, 150.0, 40)
    ax = torch.arange(n, dtype=torch.float32, device=device)
    zz, yy, xx = torch.meshgrid(ax, ax, ax, indexing="ij")
    pts = torch.stack([xx, yy, zz], -1)
    Tt = torch.as_tensor(T, dtype=torch.float32, device=device)
    w = pts @ Tt[:3, :3].T + Tt[:3, 3]
    img = torch.zeros((n, n, n), dtype=torch.float32, device=device)
    for i in range(40):
        d2 = torch.sum(torch.square(w - centers[i]), -1)
        img += float(amps[i]) * torch.exp(-d2 / (2.0 * float(widths[i]) ** 2))
    return img.cpu().numpy()


def pose_error(T_true, matrix, center):
    """(rotation error rad, translation error mm) of T_true @ matrix."""
    comp = T_true @ matrix
    rot = float(np.arccos(np.clip((np.trace(comp[:3, :3]) - 1) / 2, -1, 1)))
    return rot, float(np.abs(comp[:3, 3] - center + comp[:3, :3] @ center).max())


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed_solves(fn, reps=3):
    """Median wall time of ``fn()`` over ``reps`` solves (after one warm
    solve), each synced on the solved parameters; returns (ms, last)."""
    out = fn()
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        out = fn()
        for r in (out if isinstance(out, list) else [out]):
            r.params_device.sum().item()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def phase11_registration(n: int = 192, device: str = "cuda"):
    """register_rigid(ncc) at the default settings on bench.py's 192^3 blob
    scene and its moved copy (rx 0.05, ry -0.04, rz 0.04 rad, t (4, -3, 3)
    mm): gated at 0.01 rad and 0.5 mm (bench.py:722-729). Then the fusion's
    call (register_rigid_multi, 2 movings), register_affine(cr) on a
    cross-contrast pair, a profile of one rigid solve, and the card against
    the CPU at 48^3 (stop_tol=None, the CPU tests' REG_FAST levels and
    1e-4 of max(1, |p|))."""
    from fetal_t2mapping_tpu_torch.recon import registration

    center = np.full(3, (n - 1) / 2.0)
    T1 = rigid_matrix(0.05, -0.04, 0.04, [4.0, -3.0, 3.0], center)
    T2 = rigid_matrix(-0.03, 0.05, -0.02, [-3.0, 2.0, -4.0], center)
    t0 = time.perf_counter()
    fixed = Volume(blob_scene(n, np.eye(4), device))
    moving, moving2 = Volume(blob_scene(n, T1, device)), Volume(blob_scene(n, T2, device))
    # cross contrast: a nonlinear intensity map of the moved scene
    moving_cc = moving.with_data((200.0 * np.sqrt(moving.data / 150.0)).astype(np.float32))
    setup_s = time.perf_counter() - t0

    rigid_ms, res = timed_solves(lambda: registration.register_rigid(fixed, moving, metric="ncc",
                                                                     device=device))
    rot, tr = pose_error(T1, res.matrix, center)
    gate(rot < 0.01 and tr < 0.5, f"{n}^3 rigid recovery {rot:.4f} rad / {tr:.3f} mm "
                                  "(gates 0.01 rad, 0.5 mm)")
    multi_ms, regs = timed_solves(
        lambda: registration.register_rigid_multi(fixed, [moving, moving2], metric="ncc",
                                                  device=device))
    multi_err = [pose_error(T, r.matrix, center) for T, r in zip((T1, T2), regs)]
    for r_, t_ in multi_err:
        gate(r_ < 0.01 and t_ < 0.5, f"{n}^3 multi-pair recovery {r_:.4f} rad / {t_:.3f} mm")
    affine_ms, aff = timed_solves(
        lambda: registration.register_affine(fixed, moving_cc, metric="cr", device=device), reps=1)
    aff_err = pose_error(T1, aff.matrix, center)

    # one rigid solve under the profiler: the card's busy time by kernel
    prof_line = "not measured"
    try:
        from torch.profiler import ProfilerActivity, profile

        _sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            registration.register_rigid(fixed, moving, metric="ncc",
                                        device=device).params_device.sum().item()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
                and str(e.device_type).endswith("CUDA")]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
        prof_line = (f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms (idle share "
                     f"{1 - busy_ms / wall_ms:.3f}), {sum(e.count for e in kern)} kernel launches; top "
                     + ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                                 for e in top))
    except Exception as exc:   # the profiler is untried on this machine: report, do not fail
        prof_line = f"profiler unavailable ({type(exc).__name__}: {exc})"

    # the card against the CPU at 48^3
    m = 48
    c48 = np.full(3, (m - 1) / 2.0)
    T48 = rigid_matrix(0.05, -0.04, 0.04, [2.0, -1.5, 1.5], c48)
    f48, m48 = Volume(blob_scene(m, np.eye(4), "cpu")), Volume(blob_scene(m, T48, "cpu"))
    worst = 0.0
    for metric in ("ncc", "mi"):
        kw = dict(levels=(2, 1), sigmas=(1.0, 0.0), iters=(8, 4), samples=(512, 512),
                  metric=metric, stop_tol=None)
        a = registration.register_rigid(f48, m48, device="cpu", **kw).params
        b = registration.register_rigid(f48, m48, device=device, **kw).params
        worst = max(worst, float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max())))
    gate(worst <= 1e-4, f"48^3 card vs CPU params differ by {worst:.3e} of max(1,|p|) > 1e-4")
    # how far the CPU's own answer moves when the moving image moves by one ulp
    kw = dict(levels=(2, 1), sigmas=(1.0, 0.0), iters=(8, 4), samples=(512, 512), metric="ncc",
              stop_tol=None)
    a = registration.register_rigid(f48, m48, device="cpu", **kw).params
    m48_ulp = m48.with_data(np.nextafter(m48.data, np.float32(np.inf)).astype(np.float32))
    b = registration.register_rigid(f48, m48_ulp, device="cpu", **kw).params
    ulp_move = float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max()))
    kw = dict(metric="ncc", stop_tol=None)
    a = registration.register_rigid(f48, m48, device="cpu", **kw).params
    b = registration.register_rigid(f48, m48, device=device, **kw).params
    default_diff = float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max()))
    print(f"phase 11 registration {n}^3 (scene set-up {setup_s:.1f} s): register_rigid ncc median "
          f"{rigid_ms:.1f} ms, iters_run {res.iters_run.tolist()}, host syncs per solve "
          f"{res.host_syncs}, recovery {rot:.5f} rad / {tr:.4f} mm; register_rigid_multi (2 "
          f"movings) median {multi_ms:.1f} ms, iters_run {regs[0].iters_run.tolist()}, host syncs "
          f"{regs[0].host_syncs}, recovery {[(round(r_, 5), round(t_, 4)) for r_, t_ in multi_err]}; "
          f"register_affine cr (cross contrast) {affine_ms:.1f} ms, iters_run "
          f"{aff.iters_run.tolist()}, recovery {aff_err[0]:.5f} rad / {aff_err[1]:.4f} mm; "
          f"profile of one rigid solve: {prof_line}; 48^3 card vs CPU (REG_FAST, stop_tol=None, "
          f"ncc and mi) {worst:.2e} of max(1,|p|) (the CPU's ncc answer moves {ulp_move:.2e} under "
          f"a one-ulp change of the moving image), at the default levels {default_diff:.2e}",
          flush=True)
    return rigid_ms


SESSION_TES = (114, 202, 299)
SESSION_N = 240
# small known rigid offsets of the cor and sag stacks: (angle rad, axis pair, shift mm)
SESSION_MOTION = {"cor": (0.02, (0, 2), (1.2, -0.8, 1.0)),
                  "sag": (-0.02, (1, 2), (-1.0, 0.9, -1.1))}


def session_truth(n: int = SESSION_N):
    """bench.py:1213-1223: the brain ellipsoid (half-axes 0.75, 0.85, 0.65),
    its T2 field and proton density, as functions of world (x, y, z) in mm
    (the truth grid is 1 mm, origin 0)."""
    def fields(x, y, z):
        g = lambda v: -1.0 + 2.0 * v / (n - 1)
        gx, gy, gz = g(x), g(y), g(z)
        support = (gz / 0.75) ** 2 + (gy / 0.85) ** 2 + (gx / 0.65) ** 2
        t2 = 140.0 + 30.0 * np.sin(2 * gx) * np.cos(2 * gy) * np.cos(2 * gz)
        pd = np.where(support <= 1.0, 900.0 * (1 + 0.2 * np.sin(5 * gx) * np.cos(4 * gy)), 0.0)
        return support, t2.astype(np.float32), pd.astype(np.float32)
    return fields


def _write_invivo_session(root: str, n: int, seed: int = 12):
    """3 TEs x ax/cor/sag acquisitions, 240 x 240 at 1 mm in plane with
    4 mm slabs of 60 slices (bench.py:1198-1260's geometry), cor and sag
    rigidly offset (SESSION_MOTION), noise sigma 4, as NIfTI inputs of a
    BIDS tree with its metadata CSV."""
    rng = np.random.default_rng(seed)
    fields = session_truth(n)
    ax = np.arange(n, dtype=np.float32)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    _, t2, pd = fields(xx, yy, zz)
    del zz, yy, xx
    geo = {   # (origin, row-major direction) of the slab stacks, spacing (1, 1, 4)
        "ax": ((0.0, 0.0, 1.5), (1, 0, 0, 0, 1, 0, 0, 0, 1)),
        "cor": ((0.0, 1.5, n - 1.0), (1, 0, 0, 0, 0, 1, 0, -1, 0)),
        "sag": ((n - 2.5, 0.0, n - 1.0), (0, 0, -1, 1, 0, 0, 0, -1, 0)),
    }
    bids = os.path.join(root, "projects/")
    logs = os.path.join(root, "dicom/logs/")
    os.makedirs(logs)
    rows, writes = [], []
    for te in SESSION_TES:
        vol = pd * np.exp(-te / t2)
        stacks = {"ax": vol.reshape(n // 4, 4, n, n).mean(1),
                  "cor": vol.reshape(n, n // 4, 4, n).mean(2).transpose(1, 0, 2)[:, ::-1],
                  "sag": vol.reshape(n, n, n // 4, 4).mean(3).transpose(2, 0, 1)[::-1, ::-1]}
        for otype, data in stacks.items():
            origin, direction = geo[otype]
            v = Volume(np.ascontiguousarray(data, np.float32), spacing=(1.0, 1.0, 4.0),
                       origin=origin, direction=direction)
            if otype in SESSION_MOTION:
                ang, (i, j), shift = SESSION_MOTION[otype]
                R = np.eye(3)
                R[i, i] = R[j, j] = np.cos(ang)
                R[i, j], R[j, i] = -np.sin(ang), np.sin(ang)
                c = v.center_world()
                v = Volume(v.data, spacing=v.spacing,
                           origin=tuple(c + R @ (np.asarray(v.origin) - c) + np.asarray(shift)),
                           direction=tuple((R @ v.direction_matrix).reshape(-1)))
            noisy = v.data + rng.normal(0.0, 4.0, v.data.shape).astype(np.float32)
            acq = {"prj": "prj-smoke", "sub": "sub-01", "ses": "ses-01",
                   "run": f"run-{otype}-{te}", "EchoTime": te / 1000.0,
                   "ImageOrientationPatientSTR": otype, "CoilString": "Body"}
            writes.append((get_img_path(bids, acq, C.IN_DIRNAME), v.with_data(noisy)))
            rows.append(acq)
    with ThreadPoolExecutor(max_workers=8) as ex:
        for fut in [ex.submit(nifti.write, p, v) for p, v in writes]:
            fut.result()
    with open(os.path.join(logs, "smoke.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return bids, logs, fields


def _phantom_recon(n: int = SESSION_N, seed: int = 13) -> np.ndarray:
    """A 240^3 NIST-phantom recon: a cylindrical body, vials along z at the
    default seed set, a dark closed hole, noise."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.ogrid[:n, :n, :n]
    disk = (yy - 178) ** 2 + (xx - 184) ** 2
    vol = np.where((disk < 62 ** 2) & (zz > 40) & (zz < 200), 250.0, 8.0).astype(np.float32)
    for sx, sy, _ in C.PHANTOM_SEEDS[C.DEFAULT_PHANTOM_SEEDS_KEY]:
        vol[:, ((yy - sy) ** 2 + (xx - sx) ** 2 < 25)[0]] = 700.0
    vol[(disk < 5 ** 2) & (zz > 90) & (zz < 120)] = 30.0
    return vol + rng.normal(0, 6.0, vol.shape).astype(np.float32)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase12_session(n: int = SESSION_N, device: str = "cuda"):
    """One in-vivo session at clinical size through process_qmri on the
    card (SynthSeg 'fake'), then stage 3 (process_t2maps, gaussian) on the
    same tree; then one in-vitro session on a 240^3 phantom recon, on the
    card and on the CPU."""
    from fetal_t2mapping_tpu_torch.pipeline import process_qmri

    stage_names = ("recon.resample", "recon.fuse", "fuse.fuse", "fuse.reg_echo", "fuse.denoise",
                   "fuse.write", "recon.synthseg", "recon.masks_bet", "recon.feta",
                   "recon.atlas", "t2map.load", "t2map.fit", "t2map.save")
    records = _Records()
    logging.getLogger("fetal_t2mapping_tpu_torch.recon").addHandler(records)
    with tempfile.TemporaryDirectory(prefix="ft2_smoke_s2_") as root:
        os.environ["FSLDIR"] = os.path.join(root, "no_fsl")       # no atlases: the step skips
        t0 = time.perf_counter()
        bids, logs, fields = _write_invivo_session(root, n)
        setup_s = time.perf_counter() - t0
        rows = set_metadata(logs, ["smoke.csv"], low_field=True)
        profiler.reset()
        fused_fit.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        process_qmri(bids, rows, in_vivo=True, low_field=True,
                     synthseg=SynthSegRunner(mode="fake"), device=device)
        stage2_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        summaries = process_t2maps(rows, bids, list(SESSION_TES), C.fit_config("gaussian", True),
                                   low_field=True, sim="smoke", make_plots=False, device=device)
        stage3_s = time.perf_counter() - t0
        launches = fused_fit.KERNEL_LAUNCHES
        gate(launches > 0, "the chained stage-3 run launched no gauss_fit kernel")
        gate(any("skipping atlas labels" in m for m in records.messages),
             "the atlas step did not warn and skip")
        stages = {k: round(v["seconds"], 3) for k, v in profiler.as_dict().items()
                  if k in stage_names}

        errs = {}
        union = np.zeros((n,) * 3, bool)
        for te in SESSION_TES:
            acq = next(r for r in rows if r["EchoTime"] == te / 1000.0)
            recon = nifti.read(get_img_path(bids, acq, C.RECON_DIRNAME))
            mask = nifti.read(get_img_path(bids, acq, C.MASK_DIRNAME))
            bet = nifti.read(get_img_path(bids, acq, C.BET_DIRNAME))
            feta = nifti.read(get_img_path(bids, acq, C.FETA_DIRNAME))
            gate((recon.data.dtype, mask.data.dtype, bet.data.dtype, feta.data.dtype)
                 == (np.float32, np.uint8, np.float32, np.int16),
                 "recon/mask/BET/FeTA dtypes")
            gate(recon.shape == (n,) * 3, f"recon shape {recon.shape}")
            union = union | (mask.data > 0)
            gate(np.array_equal(bet.data, recon.data * (mask.data > 0)), "BET != recon x mask")
            w = recon.world_grid()
            support, t2_true, pd = fields(w[..., 0], w[..., 1], w[..., 2])
            truth = pd * np.exp(-te / t2_true)
            core = support <= 0.85 ** 2
            errs[te] = float(np.median(np.abs(recon.data[core] - truth[core]) / truth[core]))
            gate(errs[te] < 0.06, f"TE {te}: fused recon median rel err {errs[te]:.4f} >= 0.06")
        t2_fit = nifti.read(summaries[0]["maps"]["t2"]).data
        inside = union & (support <= 1.0)
        t2_err = float(np.median(np.abs(t2_fit[inside] - t2_true[inside]) / t2_true[inside]))
        gate(t2_err <= 5e-2, f"stage-3 median rel T2 err {t2_err:.4f} > 5e-2 inside the mask")
        mask_frac = float(union.mean())

    # in vitro: the card against the CPU, exactly
    vol = _phantom_recon(n)
    out = {}
    vitro_s = {}
    for dev in (device, "cpu"):
        with tempfile.TemporaryDirectory(prefix="ft2_smoke_vitro_") as root:
            bids = os.path.join(root, "projects/")
            acq = {"prj": "prj-003", "sub": "sub-01", "ses": "ses-01", "run": "run-114",
                   "EchoTime": 0.114, "ImageOrientationPatientSTR": "ax", "CoilString": "Body"}
            nifti.write(get_img_path(bids, acq, C.RECON_DIRNAME), Volume(vol))
            t0 = time.perf_counter()
            process_qmri(bids, [acq], in_vivo=False, low_field=True, device=dev)
            vitro_s[dev] = round(time.perf_counter() - t0, 2)
            out[dev] = [nifti.read(get_img_path(bids, acq, d)).data
                        for d in (C.MASK_DIRNAME, C.PHANTOM_LABELS_DIRNAME)]
    for a, b, what in zip(out[device], out["cpu"], ("mask", "labels")):
        gate(a.dtype == b.dtype == np.uint8 and np.array_equal(a, b),
             f"in-vitro {what}: card != CPU ({int((a != b).sum())} voxels)")
    n_labels = len(np.unique(out[device][1])) - 1
    in_grid = sum(max(sd) < n for sd in C.PHANTOM_SEEDS[C.DEFAULT_PHANTOM_SEEDS_KEY])
    gate(n_labels == in_grid, f"{n_labels} sphere labels for {in_grid} seeds in the grid")
    print(f"phase 12 session (process_qmri in vivo, 3 TEs x ax/cor/sag {n}x{n}x{n // 4} at 1x1x4 "
          f"mm -> {n}^3, SynthSeg fake; data set-up {setup_s:.1f} s): stage 2 {stage2_s:.2f} s, "
          f"stage 3 (process_t2maps gaussian) {stage3_s:.2f} s, gauss_fit launches {launches}; "
          f"fused recon median rel err vs truth on the core {errs}; mask share {mask_frac:.3f}; "
          f"stage-3 median rel T2 err vs truth in mask and brain {t2_err:.4f}; stage seconds "
          f"{stages}; in vitro ({n}^3 phantom, masks + labels) card {vitro_s[device]} s, CPU "
          f"{vitro_s['cpu']} s, equal", flush=True)
    return launches


# ------------------------------------------------ the serving path (fit_volume)
SERVING_N = 240
# axis scales of bench.py:438-440's ellipsoid (0.75 / 0.85 / 0.65: 21.7% of
# a 240^3 grid) for masks of ~5%, that 21.7% (the bench's request) and ~50%
SERVING_MASKS = {"5%": 0.613, "22%": 1.0, "50%": 1.329}
# per fit: bounds, guess and tolerances of the bench's rows (the serving row
# runs fit_volume's defaults, the 3-parameter rows bench.py:242-243), and
# the kernels one request launches
SERVING_FITS = {
    "gaussian": dict(model="gaussian", lo=LO, hi=HI, guess=None, ftol=1e-9, gtol=0.0,
                     varpro3=None, kernels=("KERNEL_LAUNCHES",)),
    "gaussian_rician": dict(model="gaussian_rician", lo=LO3, hi=HI3, guess=GUESS3, varpro3=True,
                            kernels=("GR_VARPRO_LAUNCHES",), **TOL3),
    "gaussian_rician multistart": dict(model="gaussian_rician", lo=LO3, hi=HI3, guess=GUESS3,
                                       varpro3=False, kernels=("FIT3_LAUNCHES",
                                                               "FIT3_CONT_LAUNCHES"), **TOL3),
    "rician": dict(model="rician", lo=LO3, hi=HI3, guess=GUESS3, varpro3=None,
                   kernels=("FIT3_LAUNCHES", "FIT3_CONT_LAUNCHES"), **TOL3),
}
LAYOUTS = {"dense": dict(compact=False), "block": dict(compact=True),
           "voxel": dict(compact=True, block=1)}
VF_MAPS = ("t2", "k", "sigma", "fun", "converged", "n_iter")


def serving_request(n: int, scale: float, seed: int, device: str):
    """bench.py:431-440's request made on the card from a seeded generator:
    k ~ U(600, 5000), T2 ~ U(20, 500), noise sigma 8 (clipped at 1e-2),
    the 0.75 / 0.85 / 0.65 ellipsoid mask with its axes scaled by ``scale``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (n, n, n)
    k = torch.rand(shape, generator=g, device=dev) * (5000.0 - 600.0) + 600.0
    t2 = torch.rand(shape, generator=g, device=dev) * (500.0 - 20.0) + 20.0
    te = torch.tensor(TES3, device=dev)
    sig = k[..., None] * torch.exp(-te / t2[..., None])
    sig = torch.clamp_min(sig + NOISE * torch.randn(sig.shape, generator=g, device=dev), 1e-2)
    ax = (torch.arange(n, dtype=torch.float32, device=dev) - (n - 1) / 2) / (n / 2)
    zz, yy, xx = torch.meshgrid(ax, ax, ax, indexing="ij")
    mask = ((zz / (0.75 * scale)) ** 2 + (yy / (0.85 * scale)) ** 2
            + (xx / (0.65 * scale)) ** 2) <= 1.0
    return sig.contiguous(), mask, t2


def serving_ms(call, rounds=3, per_round=4):
    """Median over ``rounds`` of the host-to-host ms per request of
    ``per_round`` requests issued back to back, then one CUDA sync."""
    times = []
    for _ in range(rounds):
        _sync()
        t0 = time.perf_counter()
        outs = [call() for _ in range(per_round)]
        _sync()
        times.append((time.perf_counter() - t0) / per_round * 1e3)
        del outs
    return float(np.median(times))


def crossover(points):
    """Mask fraction where the dense layout starts to beat block compaction,
    by linear interpolation of (block ms - dense ms) over mask_frac (and
    extrapolation from the nearest two points outside them), clipped to
    [0, 1]."""
    points = sorted(points)
    d = [(mf, blk - den) for mf, den, blk in points]
    for (m0, d0), (m1, d1) in zip(d, d[1:]):
        if d0 < 0 <= d1 or d0 >= 0 > d1:
            return float(np.clip(m0 - d0 * (m1 - m0) / (d1 - d0), 0.0, 1.0))
    (m0, d0), (m1, d1) = (d[-2], d[-1]) if d[-1][1] < 0 else (d[0], d[1])
    if d1 == d0:
        return 1.0 if d1 < 0 else 0.0
    return float(np.clip(m0 - d0 * (m1 - m0) / (d1 - d0), 0.0, 1.0))


def phase13_serving(n: int = SERVING_N, device: str = "cuda"):
    """fit_volume, the serving path, on 240^3 x 3-TE requests per model:
    the dense, block (32) and voxel-exact layouts, each for 3 rounds of 4
    requests; all three bitwise equal per voxel and equal to fit_fused on
    the gathered voxels; the 22% request gated; launches per request
    counted from 0 around one compact='auto' request."""
    from fetal_t2mapping_tpu_torch.models import volume_fit

    launches, times = {}, {}
    for fit_name, fit in SERVING_FITS.items():
        model, lo, hi = fit["model"], fit["lo"], fit["hi"]
        kw = dict(model=model, guess=fit["guess"], ftol=fit["ftol"], gtol=fit["gtol"],
                  varpro3=fit["varpro3"], check_capacity=False, device=device)
        points, text = [], []
        for name, scale in SERVING_MASKS.items():
            sig, mask, t2 = serving_request(n, scale, seed=21, device=device)
            n_vox = mask.numel()
            n_blocks = int(volume_fit._count_touched_blocks(mask, n_vox, 32))
            mask_frac = math.ceil(106 * n_blocks * 32 / n_vox) / 100   # 6% over the touched blocks
            res = {lay: volume_fit.fit_volume(sig, mask, TES3, lo, hi, mask_frac=mask_frac,
                                              **lk, **kw)
                   for lay, lk in LAYOUTS.items()}
            _sync()
            d = res["dense"]
            n_masked = int(d.n_masked)
            gate(n_masked == int(mask.sum()), f"serving {fit_name} {name}: n_masked {n_masked}")
            for lay, r in res.items():
                gate(int(r.n_overflow) == 0, f"serving {fit_name} {name} {lay}: n_overflow "
                     f"{int(r.n_overflow)}")
                for m in VF_MAPS:
                    gate(torch.equal(getattr(r, m), getattr(d, m)),
                         f"serving {fit_name} {name}: layout {lay} map {m} differs from dense")
                    gate(not bool(getattr(r, m)[~mask].any()),
                         f"serving {fit_name} {name} {lay}: map {m} not 0 outside the mask")
            ff = fused_fit.fit_fused(sig.reshape(-1, 3)[mask.reshape(-1)], TES3, lo, hi,
                                     model=model, guess=fit["guess"], ftol=fit["ftol"],
                                     gtol=fit["gtol"], varpro3=fit["varpro3"], device=device)
            sigma = ff.x[:, 2] if ff.x.shape[1] == 3 else torch.zeros_like(ff.fun)
            for m, want in (("t2", ff.x[:, 1]), ("k", ff.x[:, 0]), ("sigma", sigma),
                            ("fun", ff.fun), ("converged", ff.converged), ("n_iter", ff.n_iter)):
                gate(torch.equal(getattr(d, m)[mask], want),
                     f"serving {fit_name} {name}: map {m} differs from fit_fused on the gathered voxels")
            med_rel = ((d.t2[mask] - t2[mask]).abs() / t2[mask]).median().item()
            conv = d.converged[mask].float().mean().item()
            if name == "22%":
                gate(med_rel <= 5e-2, f"serving {fit_name}: median rel T2 err {med_rel:.3e} > 5e-2")
                if model == "gaussian":
                    gate(conv >= 0.98, f"serving gaussian: converged {conv:.5f} < 0.98")
                for c in COUNTERS:
                    setattr(fused_fit, c, 0)
                volume_fit.fit_volume(sig, mask, TES3, lo, hi, mask_frac=mask_frac, **kw)
                _sync()
                counts = {c: getattr(fused_fit, c) for c in COUNTERS}
                for c in COUNTERS:
                    # the plain versions (device "cpu", a rehearsal) count nothing
                    want = int(c in fit["kernels"] and device == "cuda")
                    gate(counts[c] == want, f"serving {fit_name}: {c} {counts[c]} per request, "
                         f"expected {want}")
                launches[fit_name] = counts
            del res, d, ff
            ms = {lay: serving_ms(lambda lk=lk: volume_fit.fit_volume(
                sig, mask, TES3, lo, hi, mask_frac=mask_frac, **lk, **kw))
                for lay, lk in LAYOUTS.items()}
            times[(fit_name, name)] = (mask_frac, ms)
            points.append((mask_frac, ms["dense"], ms["block"]))
            compact = volume_fit.resolve_compact("auto", model, mask_frac, fit["varpro3"])
            pick = "block" if compact else "dense"
            text.append(f"{name} mask ({n_masked} voxels, mask_frac {mask_frac}, auto -> {pick}): "
                        + ", ".join(f"{lay} {t:.3f} ms ({n_masked / t * 1e3:.4g} voxels/s)"
                                    for lay, t in ms.items())
                        + f", median rel T2 err {med_rel:.3e}, converged {conv:.5f}")
            del sig, mask, t2
        print(f"phase 13 serving {fit_name} (fit_volume, {n}^3 x 3 TEs, 3 rounds of 4 "
              f"requests, bitwise across layouts and with fit_fused): " + "; ".join(text)
              + f"; dense/block crossover at mask_frac {crossover(points):.3f}; launches per "
              f"request {launches[fit_name]}", flush=True)
    return launches, times


# ------------------------------------------------ N4 and the stage-4 analysis
def n4_scene(n: int, seed: int = 0, bias_strength: float = 0.6):
    """tests/test_biasfield.py's scene (two tissue classes with 2% noise in
    a sphere under a known smooth multiplicative field), its 128 mm box
    centred in a 240 mm field of view of n^3 voxels: a 122 mm brain."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(-1, 1, n, dtype=np.float32) * np.float32(240.0 / 128.0)
    z, y, x = ax[:, None, None], ax[None, :, None], ax[None, None, :]
    r = np.sqrt(z * z + y * y + x * x)
    tissue = np.where(r < 0.6, np.float32(1000.0), np.float32(600.0))
    tissue = tissue * (1 + 0.02 * rng.standard_normal(tissue.shape, dtype=np.float32))
    field = np.exp(np.float32(bias_strength) * (0.7 * z + 0.5 * y * y - 0.3 * x))
    mask = r < 0.95
    img = np.where(mask, tissue * field, 0.0).astype(np.float32)
    return img, mask, field.astype(np.float32), tissue


def n4_gates(res, img, mask, field, tissue, what):
    err_before = float(np.std(np.log(img[mask] / tissue[mask])))
    err_after = float(np.std(np.log(np.maximum(res.corrected.data[mask], 1e-6) / tissue[mask])))
    corr = float(np.corrcoef(np.log(res.field.data[mask]).ravel(),
                             np.broadcast_to(np.log(field), mask.shape)[mask])[0, 1])
    gate(err_after < 0.5 * err_before, f"n4 {what}: residual log-field error {err_after:.4f} "
         f"not below half of {err_before:.4f}")
    gate(corr > 0.9, f"n4 {what}: field correlation {corr:.4f} <= 0.9")
    return f"log-field error {err_before:.4f} -> {err_after:.4f}, field correlation {corr:.4f}"


def n4_held(a, b, mask, what):
    """Card against CPU: corrected and field within 1e-4 relative on the
    mask, |mean| / std of each update within 5e-3 (tests/test_torch_biasfield.py)."""
    rel = max(float(np.max(np.abs(x.data[mask] - y.data[mask]) / np.abs(y.data[mask])))
              for x, y in ((a.corrected, b.corrected), (a.field, b.field)))
    inv = float(np.max(np.abs(1 / a.field_cv - 1 / b.field_cv)))
    gate(rel <= 1e-4 and inv <= 5e-3, f"n4 {what}: card vs CPU rel {rel:.3e} (> 1e-4) or "
         f"|mean|/std {inv:.3e} (> 5e-3)")
    return rel, inv


def roi_scene(n: int, seed: int = 31):
    """A T2 map U(40, 400) with FeTA tissues 1-7 in shells (5% of the
    brain's voxels set to 0) and 50 atlas labels in blocks of (n / 12)^3."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    r = np.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2)
    feta = np.where(r < 0.9, np.minimum((r / 0.9 * 7).astype(np.int16) + 1, 7), 0).astype(np.int16)
    feta[(rng.random(feta.shape) < 0.05) & (feta > 0)] = 0
    atlas = np.kron(rng.integers(0, 51, (12, 12, 12)).astype(np.int16),
                    np.ones((n // 12,) * 3, np.int16))
    return rng.uniform(40.0, 400.0, feta.shape).astype(np.float32), feta, atlas


def timed_s(fn):
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return time.perf_counter() - t0, out


def phase14_n4_analysis(n: int = SESSION_N, n_lut: int = N_HEADLINE3, device: str = "cuda"):
    """N4 at 240^3 (the defaults and three levels, two card runs bitwise,
    card vs CPU at 48^3, shared_log_bias over 3 echoes,
    run_biasfield_correction per acquisition and shared on a small tree);
    the ROI tables on a 240^3 T2 map, card equal to CPU; lut_t2 at 256^3."""
    import pandas as pd

    from fetal_t2mapping_tpu_torch.analysis.roi import (roi_stats_per_label, t2_per_atlas_roi,
                                                        t2_per_tissue_feta)
    from fetal_t2mapping_tpu_torch.models.lut import lut_t2
    from fetal_t2mapping_tpu_torch.pipeline.recon_pipeline import run_biasfield_correction
    from fetal_t2mapping_tpu_torch.recon.biasfield import n4_bias_correction, shared_log_bias

    img, mask, field, tissue = n4_scene(n)
    mm = (240.0 / n,) * 3                           # a 240 mm field of view: 1 mm at 240^3
    vol, mvol = Volume(img, spacing=mm), Volume(mask.astype(np.uint8), spacing=mm)
    s1, a = timed_s(lambda: n4_bias_correction(vol, mvol, device=device))
    s1b, b = timed_s(lambda: n4_bias_correction(vol, mvol, device=device))
    gate(np.array_equal(a.corrected.data, b.corrected.data) and np.array_equal(a.field.data, b.field.data)
         and np.array_equal(a.field_cv, b.field_cv), "n4: two card runs differ")
    single = n4_gates(a, img, mask, field, tissue, "single level")
    s3, c = timed_s(lambda: n4_bias_correction(vol, mvol, ctrl_spacing_mm=(200.0, 100.0, 50.0),
                                               device=device))
    multi = n4_gates(c, img, mask, field, tissue, "three levels")
    gate(c.field_cv.shape == (120,), f"n4 three levels: field_cv {c.field_cv.shape}")
    echoes = [vol.with_data((img * np.float32(np.exp(-te / 150.0))).astype(np.float32))
              for te in TES_SESSION]
    s_sh, (corrected, shared) = timed_s(lambda: shared_log_bias(echoes, [mvol] * 3, device=device))
    corr_sh = float(np.corrcoef(np.log(shared.data[mask]),
                                np.broadcast_to(np.log(field), mask.shape)[mask])[0, 1])
    gate(corr_sh > 0.9 and len(corrected) == 3, f"shared_log_bias: field correlation {corr_sh:.4f}")
    # card against CPU at 48^3 (5 mm voxels: the same 240 mm field of view)
    img48, mask48, *_ = n4_scene(48, seed=1)
    v48 = Volume(img48, spacing=(5.0, 5.0, 5.0))
    m48 = Volume(mask48.astype(np.uint8), spacing=(5.0, 5.0, 5.0))
    s_cpu, on_cpu = timed_s(lambda: n4_bias_correction(v48, m48, device="cpu"))
    rel, inv = n4_held(n4_bias_correction(v48, m48, device=device), on_cpu, mask48, "48^3")
    # the stage-2 step on a small tree: 2 orientations x 2 TEs at 48^3
    with tempfile.TemporaryDirectory(prefix="ft2_smoke_n4_") as root:
        bids = os.path.join(root, "projects/")
        rows = []
        for otype in ("ax", "cor"):
            for te in (114, 202):
                acq = {"prj": "prj-004", "sub": "sub-001", "ses": "ses-01",
                       "run": f"run-{otype}-{te}", "EchoTime": te / 1000.0,
                       "ImageOrientationPatientSTR": otype, "CoilString": "Body"}
                nifti.write(get_img_path(bids, acq, C.RESAMP_DIRNAME),
                            v48.with_data((img48 * np.float32(np.exp(-te / 150.0))).astype(np.float32)),
                            dtype=np.float32)
                rows.append(acq)
        outs = {}
        for shared_flag in (False, True):
            run_biasfield_correction(rows, bids, shared=shared_flag, overwrite=True, device=device)
            outs[shared_flag] = [nifti.read(get_img_path(bids, a, C.N4_DIRNAME)).data for a in rows]
        for shared_flag, datas in outs.items():
            for a, d in zip(rows, datas):
                gate(d.shape == img48.shape and bool(np.isfinite(d).all()),
                     f"run_biasfield_correction shared={shared_flag}: {a['run']} output")
        one = n4_bias_correction(v48.with_data((img48 * np.float32(np.exp(-114 / 150.0))).astype(
            np.float32)), device=device)
        gate(np.array_equal(outs[False][0], one.corrected.data),
             "run_biasfield_correction: output differs from n4_bias_correction on its input")
    print(f"phase 14 n4 ({n}^3, {mm[0]:g} mm, known field; {single}): defaults {s1:.3f} s and {s1b:.3f} s, "
          f"bitwise equal; (200, 100, 50) mm {s3:.3f} s ({multi}); shared_log_bias x 3 echoes "
          f"{s_sh:.3f} s (field correlation {corr_sh:.4f}); card vs CPU at 48^3 rel {rel:.3e}, "
          f"|mean|/std {inv:.3e} (CPU {s_cpu:.2f} s); run_biasfield_correction per acquisition "
          f"and shared on 2 x 2 volumes at 48^3: written", flush=True)

    # ROI tables on a 240^3 T2 map (timed on the card), card against CPU at 96^3
    labels = [{"index": i, "name": f"roi_{i}"} for i in range(1, 51)]
    gt = {"gm": 150.0, "wm": 200.0}

    def roi_tables(scene, dev):
        t2map, feta, atlas = scene
        return (t2_per_atlas_roi(t2map, feta, atlas, labels, tissue_class=3, device=dev),
                t2_per_tissue_feta(t2map, feta, gt=gt, device=dev),
                roi_stats_per_label(t2map, atlas, n_labels=51, device=dev))

    scene = tuple(torch.from_numpy(x).to(device) for x in roi_scene(n))
    roi_s, tables = timed_s(lambda: roi_tables(scene, device))
    again = roi_stats_per_label(scene[0], scene[2], n_labels=51, device=device)
    gate(again.equals(tables[2]), "roi_stats_per_label: two card runs differ")
    n_roi = int((tables[0]["nvoxel"] > 0).sum())
    small = roi_scene(96)
    card, host = roi_tables(small, device), roi_tables(small, "cpu")
    for i, what in enumerate(("t2_per_atlas_roi", "t2_per_tissue_feta")):
        try:
            pd.testing.assert_frame_equal(card[i], host[i])
        except AssertionError as e:
            gate(False, f"{what}: card differs from CPU: {e}")
    gate(np.array_equal(card[2]["n"], host[2]["n"]), "roi_stats_per_label: counts differ from CPU")
    ok = host[2]["n"].to_numpy() > 0
    mean_rel = float(np.max(np.abs(card[2]["mean"][ok] - host[2]["mean"][ok]) / host[2]["mean"][ok]))
    gate(mean_rel <= 1e-9, f"roi_stats_per_label: means {mean_rel:.3e} from the CPU's")
    print(f"phase 14 roi ({n}^3 T2 map, 7 FeTA tissues, 50 atlas labels in tissue 3 with "
          f"{n_roi} non-empty; per-label moments of 51 labels): {roi_s:.3f} s, two runs of the "
          f"moments bitwise; card vs CPU at 96^3: atlas and tissue tables equal, moment counts "
          f"equal, means {mean_rel:.1e} apart", flush=True)

    # the LUT at 256^3 x 3 TEs
    sig, k_true, t2_true, _ = make_data3(n_lut, TES3, seed=33)
    sig_dev = torch.from_numpy(sig).to(device)
    out = lut_t2(sig_dev, te=TES3, device=device)
    t2_true = torch.from_numpy(t2_true).to(device)
    gate(tuple(out.shape) == (n_lut, 2) and bool(torch.isfinite(out).all()),
         "lut_t2: output shape / non-finite values")
    lut_rel = ((out[:, 1] - t2_true).abs() / t2_true).median().item()
    lut_ms = (cuda_ms(lambda: lut_t2(sig_dev, te=TES3, device=device), 5) if device == "cuda"
              else timed_s(lambda: lut_t2(sig_dev, te=TES3, device=device))[0] * 1e3)
    print(f"phase 14 lut_t2 ({n_lut} voxels x 3 TEs, noise sigma 8): {lut_ms:.3f} ms, median rel T2 err "
          f"vs truth {lut_rel:.3e}", flush=True)
    return {"n4_s": s1, "n4_3lvl_s": s3, "shared_s": s_sh, "roi_s": roi_s,
            "lut_ms": lut_ms}


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
    spills = timed("phase 1", phase1_build)
    diff2 = timed("phase 2", phase2_parity)
    kernel_ms, plain_ms, diff3, g_bound = timed("phase 3", phase3_headline)
    launches, diff4 = timed("phase 4", phase4_main_path, has_mpl)
    worst5 = timed("phase 5", phase5_parity3)
    times6, worst6, bounds6 = timed("phase 6", phase6_headline3)
    launches3 = timed("phase 7", phase7_sessions3, has_mpl)
    conv_err, conv_times, conv_bound = timed("phase 8", phase8_conv)
    seg_launches = timed("phase 9", phase9_segmentation)
    timed("phase 10", phase10_guess_start)
    timed("phase 11", phase11_registration)
    timed("phase 12", phase12_session)
    timed("phase 13", phase13_serving)
    timed("phase 14", phase14_n4_analysis)
    print(f"phase wall times (s): {wall}, total {time.perf_counter() - t_start:.1f} s", flush=True)
    gate(not spills, f"kernel instances spill registers (bytes of spill stores): {spills}")
    kernels = [{
        "name": "gauss_fit", "route": "cuda",
        "source": "fetal_t2mapping_tpu_torch/csrc/gauss_fit.cu",
        "replaces": "fetal_t2mapping_tpu/models/pallas_fit.py:103",
        "launches": launches, "max_abs_err": max(diff2, diff3, diff4),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": g_bound[0], "bound_by": g_bound[1],
        "library_ms": None}]
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
            "ms": times6[name][0], "plain_ms": times6[name][1],
            "bound_ms": bounds6[name][0], "bound_by": bounds6[name][1], "library_ms": None})
    kernels.append({
        "name": "conv_s2d", "route": "cuda",
        "source": "fetal_t2mapping_tpu_torch/csrc/conv_s2d.cu",
        "replaces": "fetal_t2mapping_tpu/labels/pallas_conv.py:94",
        "launches": seg_launches, "max_abs_err": conv_err,
        "ms": conv_times["kernel"], "plain_ms": conv_times["plain"],
        "bound_ms": conv_bound[0], "bound_by": conv_bound[1],
        "library_ms": conv_times["library"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
