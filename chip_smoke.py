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
240^3 in-vitro phantom through ``process_qmri``, card equal to CPU. The
two solver loops run as CUDA graphs of one step, replayed per iteration:
the trace sampler of phases 4 and 7 (its replays counted in the sessions,
then held bitwise against the eager loop on the card, each timed) and the
registration levels of phases 11-12 (bitwise against the eager loops,
ms, graph captures and replays, and the host's launches under the
profiler). So do the batch solver ``fit_batch`` (phase 10's fit_stack per
model and the no-prior 3-parameter fit at the 240^3 session's mask, each
graphed against the eager loop: s, bitwise, graphs and host reads, peak
MiB; phase 17's sharded solvers), TV, ``fill_holes`` and
``build_slice_mask`` (phase 12, on one of the session's recons: ms graphed
and eager, bitwise) and each N4 level (phase 14: s graphed and eager,
bitwise with field_cv, the host's launches per level). Phase
13, the serving path: ``fit_volume`` per model on bench.py's 240^3 x 3-TE
request (and ~5% and ~50% ellipsoid masks), its block layout with a
buffer over every block, at mask_frac and voxel-exact timed, bitwise
equal to each other and to
``fit_fused`` on the gathered voxels, the model's kernels launched once
per request, the layout's kernels bitwise their plain versions, and for
the 3-start multistart the gather's row list the plain list and fit3's
prefix and in-place continuation over it bitwise their plain versions.
Phase 14: N4 bias correction at 240^3 (two card runs bitwise,
card vs CPU at 48^3, the shared-field variant and the stage-2 step), the
ROI tables on a 240^3 T2 map (card equal to CPU) and the LUT estimate at
256^3. Phase 15, stage 1 (host code): one 240 x 240 slice read through
``utils.dicom.read_dcm`` in each transfer syntax (ms per slice, lossless
ones exact), then phase 12's session written as nine multi-frame DICOMs
and taken through the port's three CLIs, ``dcm2csv``,
``qmri_reconstruction`` and ``t2mapping``, gated on the pixels and
geometry written and on the truth. Phase 16, the host I/O layer: phase
12's session written once as a BIDS tree of int16 inputs and taken through
stage 2 in fresh processes (``qmri_reconstruction.main``): (a) with the
volume cache, the async writer and the native gzip off, (b) with the
defaults, (c) with the defaults and ``--prewarm``; before them, another
fresh process prints what the context, a large allocation, the host
library, cuBLAS and each stage-2 entry point at 32^3 cost the first time
against the second; the trees hold the same decompressed payloads, no
write is left pending, the prewarm finishes with no step and no error,
stage 3 (``t2mapping --gaussian``, which launches gauss_fit.cu) on (b)'s
tree meets the truth,
and a process that queues writes of CUDA volumes and exits without a flush
leaves complete files. Phase 17, the voxel mesh (two cards when two are
visible, else two streams of one) and ``strategy='twophase'``:
``fit_fused_sharded`` and ``fit_fused(strategy='twophase')`` at 256^3 x 3
TEs per model against ``fit_fused``, bitwise but for the voxels twophase
counts in ``n_overflow`` (equal to a host count from the phase-1 flags),
``process_t2maps(mesh=)`` on phase 4's session (maps equal),
``register_rigid(mesh=)`` on phase 11's scene (within 5e-3 rad / 0.3 mm of
one device, and the recovery gate), ``segment_volume(mesh=)`` at 160^3
(labels equal) and ``mesh_from_flag`` with one card too many. Phase 18,
the last pieces: (a) phase 13's 240^3 request per model through
``fit_volume(mesh=)`` on phase 17's mesh, every layout bitwise equal to the
single-device call (a starved ``mask_frac`` too), 'twophase' bitwise on the
voxels its rounds handle with ``n_overflow`` equal to the host count, ms
per request, launches (one per shard) and peak memory; (b) ``entry()``
against the same call on the CPU; (c) ``dryrun_multichip(2)`` on the mesh;
(d) the five example scripts with ``figures=False`` against their truth
gates.
Each phase prints one line with its wall time; any failed gate or
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
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fetal_t2mapping_tpu_torch import build, graphs
from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.core import EchoStack, Volume, nifti, volcache
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
REPO = os.path.dirname(os.path.abspath(__file__))


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


def card_name_and_power_limit() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def phase0_environment():
    smi = card_name_and_power_limit()
    print(smi, flush=True)
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    mods = {}
    for name in ("triton", "pandas", "matplotlib", "PIL", "h5py"):
        try:
            __import__(name)
            mods[name] = True
        except ImportError:
            mods[name] = False
    mods["dcm2niix"] = shutil.which("dcm2niix") is not None
    zlib_h = subprocess.run([build.gxx(), "-E", "-x", "c++", "-"], input="#include <zlib.h>\n",
                            capture_output=True, text=True).returncode == 0
    t0 = time.perf_counter()
    build.load_gzio_lib()
    gzio_s = time.perf_counter() - t0
    print(f"phase 0 environment: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA runtime {torch.version.cuda}, nvcc '{nvcc}', "
          f"imports {mods}, zlib.h {'found' if zlib_h else 'NOT found'} by {build.gxx()} "
          f"(csrc/gzio_host.cpp built and loaded in {gzio_s:.2f} s), device "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
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
    before = profiler.counter("gauss_fit.launches")
    for tes in (TES3, TES6):
        sig, _, _, ident = make_data(1 << 20, tes, seed=5)
        s = torch.from_numpy(sig).cuda()
        for no_prior in (False, True):
            text, diff = compare(s, tes, ident, no_prior)
            lines += text
            worst_abs = max(worst_abs, diff)
    gate(profiler.counter("gauss_fit.launches") == before + 4, "kernel launches did not advance")
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
    mask = session_mask(n_side)
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
        launches0 = profiler.counter("gauss_fit.launches")
        replays0 = profiler.counter("graphs.replays")
        t0 = time.perf_counter()
        summaries = process_t2maps(rows, bids, list(TES_SESSION), cfg, phantom=False,
                                   low_field=True, sim="smoke", make_plots=make_plots,
                                   device="cuda")
        session_s = time.perf_counter() - t0
        launches = profiler.counter("gauss_fit.launches") - launches0
        trace_replays = profiler.counter("graphs.replays") - replays0
        gate(launches > 0, "the main path launched no fit kernel")
        gate(trace_replays >= cfg.max_iters - 1,
             f"the session's traces ran {trace_replays} graph replays < {cfg.max_iters - 1}")
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
        traces = traces_graph_vs_eager("gaussian", cfg, TES_SESSION)
        print(f"phase 4 main path (process_t2maps, 240^3, {s['n_voxels']} masked "
              f"voxels, make_plots={make_plots}): session {session_s:.3f} s "
              f"(fit_stack {s['fit_seconds']:.3f} s), data set-up {setup_s:.1f} s, "
              f"median rel T2 err vs truth {med_rel:.3e}, converged "
              f"{s['converged_frac']:.5f}, kernel launches {launches}, traces "
              f"(t2map.fit.traces) {stages.get('t2map.fit.traces', 0.0):.4f} s through "
              f"{trace_replays} graph replays; {traces}; stages "
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


def _write_echo_tree(root, echoes, mask, tes):
    """One session's tree as the pipeline reads it: the echoes as recons
    and ``mask`` as each echo's mask under root/projects/, the metadata
    CSV root/dicom/logs/smoke.csv. Returns (bids, logs)."""
    bids = os.path.join(root, "projects/")
    logs = os.path.join(root, "dicom/logs/")
    os.makedirs(logs)
    rows, writes = [], []
    mask_vol = Volume(mask.astype(np.uint8))
    for te, sig in zip(tes, echoes):
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
    return bids, logs


def _write_session3(root, n_side, seed, tes, k_range, t2_range):
    """A 240^3 session like _write_session's, with Rician noise: the
    magnitude of the signal plus complex Gaussian noise of sigma 8."""
    rng = np.random.default_rng(seed)
    shape = (n_side,) * 3
    k = rng.uniform(*k_range, shape).astype(np.float32)
    t2 = rng.uniform(*t2_range, shape).astype(np.float32)
    mask = session_mask(n_side)
    echoes = []
    for te in tes:
        a = k * np.exp(-te / t2)
        echoes.append(np.hypot(a + rng.normal(0, NOISE, shape).astype(np.float32),
                               rng.normal(0, NOISE, shape).astype(np.float32)).astype(np.float32))
    bids, logs = _write_echo_tree(root, echoes, mask, tes)
    return bids, logs, mask, t2


SESSIONS3 = {
    # model: (low field, TEs, k range, T2 range, kernels its main path must launch)
    "gaussian_rician": (True, (114, 202, 299), (600.0, 5000.0), (20.0, 500.0),
                        ("gr_varpro_fit.launches",)),
    # the high-field row: the low-field rician row caps k at 900 (config.py:136-137)
    "rician": (False, (115, 202, 299), (900.0, 5000.0), (30.0, 500.0),
               ("fit3.launches", "fit3_cont.launches")),
}
#: the fit kernels' launch counters in ``utils.profiling.profiler``
COUNTERS = ("gauss_fit.launches", "gr_varpro_fit.launches", "fit3.launches",
            "fit3_cont.launches")


def launches_since(before=None):
    """Each of COUNTERS now (``before`` None), or its launches since ``before``."""
    return {c: profiler.counter(c) - (0 if before is None else before[c]) for c in COUNTERS}


def dynamo_import_s() -> float:
    """Seconds a fresh process takes to import torch._dynamo, which
    torch.func imports at the first gradient of a process (the 3-parameter
    trace sampler's first call pays it)."""
    code = ("import time, torch; t = time.perf_counter(); import torch._dynamo; "
            "print(time.perf_counter() - t)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    return float(out.stdout.strip().splitlines()[-1])


def phase7_sessions3(make_plots: bool):
    """One 240^3 process_t2maps session per 3-parameter model on the card:
    the main path of each noise model, with the launches of each kernel
    counted from 0 around the session, the trace sampler's graph replays
    and its graph against the eager loop on the card."""
    print(f"phase 7 import torch._dynamo in a fresh process: {dynamo_import_s():.3f} s", flush=True)
    launches = {}
    for model, (low_field, tes, k_range, t2_range, needed) in SESSIONS3.items():
        with tempfile.TemporaryDirectory(prefix="ft2_smoke3_") as root:
            t0 = time.perf_counter()
            bids, logs, mask, t2_true = _write_session3(root, SIDE3, 13, tes, k_range, t2_range)
            setup_s = time.perf_counter() - t0
            rows = set_metadata(logs, ["smoke.csv"], low_field=low_field)
            cfg = C.fit_config(model, low_field=low_field)
            profiler.reset()
            counts0 = launches_since()
            replays0 = profiler.counter("graphs.replays")
            t0 = time.perf_counter()
            summaries = process_t2maps(rows, bids, list(tes), cfg, phantom=False,
                                       low_field=low_field, sim="smoke3",
                                       make_plots=make_plots, device="cuda")
            session_s = time.perf_counter() - t0
            counts = launches_since(counts0)
            trace_replays = profiler.counter("graphs.replays") - replays0
            gate(trace_replays >= cfg.max_iters - 1,
                 f"{model} session: {trace_replays} trace-graph replays < {cfg.max_iters - 1}")
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
            # the gzip the session waits for: the reads, the queueing of the
            # map writes and the wait for the writer pool at the end
            io_s = sum(stages.get(k, 0.0) for k in ("t2map.load", "t2map.save", "io.flush_wait"))
            fit_s = stages.get("t2map.fit", 0.0)
            traces = traces_graph_vs_eager(model, cfg, tes)
            print(f"phase 7 main path {model} (process_t2maps, 240^3, "
                  f"{'low' if low_field else 'high'} field, TEs {tes}, {summ['n_voxels']} masked "
                  f"voxels): session {session_s:.3f} s (fit_stack {summ['fit_seconds']:.3f} s), "
                  f"fit {fit_s / session_s:.1%} of the session vs gzip I/O {io_s / session_s:.1%}, "
                  f"data set-up {setup_s:.1f} s, median rel T2 err vs truth {med_rel:.3e}, "
                  f"converged {summ['converged_frac']:.5f}, launches {counts}, traces "
                  f"(t2map.fit.traces) {stages.get('t2map.fit.traces', 0.0):.4f} s through "
                  f"{trace_replays} graph replays; {traces}; stages {stages}", flush=True)
    return launches


def traces_graph_vs_eager(model, cfg, tes, n=50, seed=17, reps=5):
    """fit_batch_traced (one CUDA graph step, replayed per iteration) on
    ``n`` of the session's kind of voxels against the eager loop on the
    card, gated bitwise (fit and trace planes); ms per call of each, the
    graph's from its cache (the session captured it)."""
    from fetal_t2mapping_tpu_torch.models import init, solver

    lo, hi = np.asarray(cfg.lower, np.float32), np.asarray(cfg.upper, np.float32)
    k_range, t2_range = SESSIONS3[model][2:4] if model in SESSIONS3 else ((600.0, 5000.0),
                                                                         (20.0, 500.0))
    sig = torch.from_numpy(make_data3(n, tes, seed, k_range, t2_range)[0]).cuda()
    x0 = init.loglinear_init(sig, tes, lo, hi)
    kw = dict(model=model, max_iters=cfg.max_iters, ftol=cfg.ftol, gtol=cfg.gtol)
    times = {}
    for name, fn in (("graph", solver.fit_batch_traced), ("eager", solver._fit_batch_traced_loop)):
        out = fn(sig, tes, x0, lo, hi, **kw)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(sig, tes, x0, lo, hi, **kw)
        out[1]["f_val"].sum().item()
        times[name] = ((time.perf_counter() - t0) * 1e3 / reps, out)
    (ga, ta), (ea, tea) = times["graph"][1], times["eager"][1]
    planes = [(getattr(ga, f), getattr(ea, f)) for f in ("x", "fun", "converged", "n_iter")]
    planes += [(ta[f], tea[f]) for f in ta]
    same = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
               for a, b in planes)
    gate(same, f"{model}: graphed traces differ from the eager loop's on the card")
    return (f"fit_batch_traced {n} voxels x {cfg.max_iters} iterations: graph "
            f"{times['graph'][0]:.2f} ms, eager {times['eager'][0]:.2f} ms a call, bitwise equal")


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
            launches0 = profiler.counter("conv_s2d.launches")
            t0 = time.perf_counter()
            with profiler.stage("recon.synthseg"):
                run_segmentation([acq], bids, SynthSegRunner(mode="torch"))
            stage_s = time.perf_counter() - t0
            launches = profiler.counter("conv_s2d.launches") - launches0
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


def guess_echoes(model, seed, shape=GUESS_SHAPE):
    """``shape`` echoes of one model's data (additive noise for gaussian,
    the magnitude of complex noise for the 3-parameter models, sigma 8) and
    the identifiable voxels (last echo >= 3 sigma)."""
    _, tes, k_range, t2_range = GUESS_MODELS[model]
    rng = np.random.default_rng(seed)
    k = rng.uniform(*k_range, shape).astype(np.float32)
    t2 = rng.uniform(*t2_range, shape).astype(np.float32)
    echoes = []
    for te in tes:
        a = k * np.exp(-te / t2)
        noise = rng.normal(0, NOISE, shape).astype(np.float32)
        if model == "gaussian":
            echoes.append(np.maximum(a + noise, 1e-2).astype(np.float32))
        else:
            echoes.append(np.hypot(a + noise, rng.normal(0, NOISE, shape)).astype(np.float32))
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


# the ATen ops whose results the card rounds differently from the CPU for
# the same inputs, as the op log of phase 10's no-prior fit shows (the
# reductions over the echoes, in another association order, the mean a
# multiply by 1/T; the float32 exponential): every other op of that fit
# gives the same bits on both
ROUNDING_OPS = ("aten.sum.dim_IntList", "aten.mean.dim", "aten.exp.default")


def guess_bands(model, fit, echoes, tes, ident, what, label="guess start", gated=True,
                per_voxel=False, allowed=0, show=8):
    """fit(echoes, device) on the card against the CPU: the convergence
    rates within 0.01, and the bands on every identifiable voxel both
    converged (gaussian) or, for the 3-parameter models, on every such
    voxel but those with a witness:
    (a) equally good: the float64 objectives at the two answers lie within
        each other's objective band (two equally good minima);
    (b) rounding-sensitive: one side's own answer leaves the bands when the
        echoes move by one float32 ulp, up or down;
    (c) card-rounded (``per_voxel`` only): the CPU's fit of the voxel, rerun
        with the ``ROUNDING_OPS`` evaluated on the card (``OnCard``: their
        CPU arguments copied there, the card's results copied back; every
        other op the CPU's), lands in the bands of the card's answer.
        Where the float32 objective cannot resolve the descent (a start
        near a saddle on the sigma bound), the accept test of the first
        steps turns on those ops' bits.
    n_overflow equal, or, where one side's own count moves under a one-ulp
    change, within 0.01 of the voxels. The one-ulp fits and (c) run only
    where a voxel is outside the bands or the counts differ. ``per_voxel``
    says a voxel's answer does not depend on the rest of the batch (the
    no-prior multistart), so those fits run on the voxels that need them
    alone, as echoes of shape (m, 1, 1), their own answers refitted the
    same way. With ``gated=False`` the voxels outside the bands are
    reported, not gated (the rates and counts still are); a 3-parameter
    model passes with at most ``allowed`` of them without a witness.
    Returns the summary text, with the witness of each voxel outside the
    bands (the first ``show``; None: all) and those without one."""
    a, b = (guess_cols(fit(echoes, dev)) for dev in ("cuda", "cpu"))
    ident = ident.ravel()
    both = ident & a[2] & b[2]
    dconv = abs(float(a[2].mean()) - float(b[2].mean()))
    out = np.flatnonzero(guess_outside(model, a, b, both))
    sig = np.stack([e.ravel() for e in echoes], axis=1)
    objective, te = _objective(model), np.asarray(tes, np.float64)
    f64 = np.array([[objective(x[i].astype(np.float64), te, sig[i].astype(np.float64))
                     for x in (a[0], b[0])] for i in out]).reshape(-1, 2)
    equal = np.abs(f64[:, 0] - f64[:, 1]) <= BANDS[model][1] * np.maximum(
        np.abs(f64).min(axis=1), 1.0)
    sensitive, counts, moved = np.zeros(ident.size, bool), {}, False
    card_rounded = np.zeros(ident.size, bool)
    if per_voxel and out.size:
        sub = [c[:, None, None] for c in sig[out].T]
        for dev in ("cuda", "cpu"):
            own = guess_cols(fit(sub, dev))
            for towards in (np.inf, 0.0):
                other = guess_cols(fit([np.nextafter(e, np.float32(towards)) for e in sub], dev))
                sensitive[out] |= guess_outside(model, other, own, np.ones(out.size, bool))
        rest = out[~equal & ~sensitive[out]]
        if rest.size:
            with OnCard(ROUNDING_OPS):
                r = guess_cols(fit([c[:, None, None] for c in sig[rest].T], "cpu"))
            card_rounded[rest] = ~guess_outside(model, r, (a[0][rest], a[1][rest]),
                                                np.ones(rest.size, bool))
    for own, dev in ((a, "cuda"), (b, "cpu")) if (
            out.size and not per_voxel) or a[3] != b[3] else ():
        for towards, way in ((np.inf, "up"), (0.0, "down")):
            other = guess_cols(fit([np.nextafter(e, np.float32(towards)) for e in echoes], dev))
            sensitive |= guess_outside(model, other, own, ident)
            counts[f"{dev} {way}"] = other[3]
            moved |= other[3] != own[3]
    kinds = [[k for k, on in (("equally good", eq), ("rounding-sensitive", sensitive[i]),
                              ("card-rounded", card_rounded[i])) if on]
             for i, eq in zip(out, equal)]
    witness = "; ".join(
        f"voxel {i}: card {a[0][i].tolist()} / CPU {b[0][i].tolist()}, float64 objective "
        f"card {f[0]:.6g} / CPU {f[1]:.6g}, {', '.join(k) or 'no witness'}"
        for i, f, k in list(zip(out, f64, kinds))[:show])
    unexplained = out[~equal & ~sensitive[out] & ~card_rounded[out]]
    ovf_ok = a[3] == b[3] or (moved and abs(a[3] - b[3]) <= 0.01 * ident.size)
    text = (f"{what}: {out.size} of {int(both.sum())} outside the bands ({int(equal.sum())} "
            f"equally good minima, {int(sensitive[out].sum())} rounding-sensitive"
            f"{f', {int(card_rounded[out].sum())} card-rounded' if per_voxel else ''}"
            f"{': ' + witness if witness else ''}), dconv {dconv:.4f}, n_overflow card "
            f"{a[3]} / CPU {b[3]} (echoes one ulp up or down: {counts})")
    text += f"; without a witness: {unexplained.size} {unexplained[:8].tolist()}"
    gate(both.sum() >= 16 and dconv <= 0.01 and ovf_ok
         and (not gated or (out.size == 0 if model == "gaussian" else unexplained.size <= allowed)),
         f"{model} {label}, {text}")
    return text


MAP_NAMES = ("t2", "k", "sigma", "res", "fun", "converged", "n_iter")


def same_maps(a, b) -> bool:
    """Two fit_stack outputs with the same bits in every map and count."""
    return a.n_overflow == b.n_overflow and all(
        np.array_equal(getattr(a, m).data.view(np.uint8), getattr(b, m).data.view(np.uint8))
        for m in MAP_NAMES)


def peak_mib(dev: torch.device) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2 ** 20 if dev.type == "cuda" else math.nan


def stack_graph_vs_eager(stack, cfg, device="cuda", again=True):
    """fit_stack on the card with its batch solver as the replayed graph,
    then with the eager loop (a host read every iteration), then (with
    ``again``) graphed again, gated bitwise: (output, (first, second or
    nan) graphed s, eager s, (captures, replays, host reads) of a graphed
    call, (graphed, eager) peak MiB)."""
    dev = torch.device(device)
    runs = []
    for route in ("graph", "eager", "graph")[:3 if again else 2]:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        before = graph_counts()
        with eager_loops(*(("fit_batch",) if route == "eager" else ())):
            t0 = time.perf_counter()
            out = fit_stack(stack, cfg, device=dev)
            _sync()
            wall = time.perf_counter() - t0
        runs.append((out, wall, counts_since(before), peak_mib(dev)))
    gate(all(same_maps(runs[0][0], r[0]) for r in runs[1:]),
         f"{cfg.model} fit_stack: the graphed batch solver differs from the eager loop")
    (out, g_s, counts, g_mib), (_, e_s, _, e_mib) = runs[:2]
    g2_s = runs[2][1] if again else math.nan
    return out, (g_s, g2_s), e_s, counts, (g_mib, e_mib)


def phase10_guess_start():
    """fit_stack with loglinear_init=False — the two-phase solver from the
    protocol guess clipped into each voxel's box, torch ops on the device,
    no hand kernel — once per model on the card over a fully masked
    GUESS_SHAPE stack (2^20 voxels): finite maps, n_overflow and the time,
    the batch solver as a replayed graph against the eager loop (bitwise);
    then the same call on the card and on the CPU over its first 16^3
    voxels, held together by guess_bands. Then the no-prior 3-parameter
    fit (phase10_no_prior)."""
    text = ""
    for model, (low_field, tes, _, _) in GUESS_MODELS.items():
        echoes, ident = guess_echoes(model, seed=17)
        cfg = C.fit_config(model, low_field, loglinear_init=False)
        stack = fully_masked(echoes, tes)
        out, wall, eager_s, counts, _ = stack_graph_vs_eager(stack, cfg)
        for name in ("t2", "k", "sigma", "res", "fun"):
            data = getattr(out, name).data
            gate(data.shape == GUESS_SHAPE and bool(np.isfinite(data).all()),
                 f"{model} guess start: map {name} {data.shape} / non-finite values")
        sub = [e[:GUESS_SUB, :GUESS_SUB, :GUESS_SUB] for e in echoes]
        bands = guess_bands(model, lambda e, dev: fit_stack(fully_masked(e, tes), cfg, device=dev),
                            sub, tes, ident[:GUESS_SUB, :GUESS_SUB, :GUESS_SUB],
                            f"card vs CPU on {GUESS_SUB ** 3} voxels")
        text += (f" {model}: {wall[0]:.3f} s graphed, {wall[1]:.3f} s a second time (fit_stack "
                 f"{out.fit_seconds:.3f} s; graphs "
                 f"captured / replayed / host reads {counts}), {eager_s:.3f} s eager (a host "
                 f"read every iteration), bitwise equal; converged "
                 f"{float((out.converged.data > 0.5).mean()):.5f}, n_overflow {out.n_overflow} "
                 f"of the {pad_bucket(out.n_voxels)} gathered rows; {bands};")
    print(f"phase 10 guess start (fit_stack, loglinear_init=False, two-phase solver, "
          f"{GUESS_SHAPE[0]}x{GUESS_SHAPE[1]}x{GUESS_SHAPE[2]} on cuda):{text} "
          f"{card_name_and_power_limit()}", flush=True)
    phase10_cli_sessions(phase10_no_prior())


def session_mask(n: int) -> np.ndarray:
    """bench.py:438-440's ellipsoid (half-axes 0.75 / 0.85 / 0.65) in n^3."""
    ax = (np.arange(n, dtype=np.float32) - (n - 1) / 2) / (n / 2)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    return (zz / 0.75) ** 2 + (yy / 0.85) ** 2 + (xx / 0.65) ** 2 <= 1.0


def no_prior_sample(echoes, candidates, n_sample=32768, seed=29):
    """Phase 10's wide sample: ``n_sample`` voxels (a multiple of 1024)
    drawn without replacement, by a generator seeded with ``seed``, from
    the flat indices ``candidates``, in flat order, as echoes of shape
    (n_sample / 1024, 32, 32)."""
    pick = np.sort(np.random.default_rng(seed).choice(candidates, n_sample, replace=False))
    shape = (n_sample // 1024, 32, 32)
    return [np.ascontiguousarray(e.ravel()[pick].reshape(shape)) for e in echoes]


def phase10_no_prior(n: int = 240, device: str = "cuda", n_sample: int = 32768):
    """The no-prior 3-parameter fit (fit_stack with prior=False:
    fit_batch_multistart over the log-linear, grid and guess starts) per
    model at the 240^3 session's mask (bench.py:438-440, ~3.0M voxels x 3
    starts): s with the batch solver graphed and eager (bitwise), peak MiB
    of each; then card against CPU (guess_bands, every witness, the voxels
    alone refitted) on the first 16^3 voxels, no voxel outside the bands
    without a witness, and on ``n_sample`` voxels drawn from the mask's
    identifiable ones (no_prior_sample), at most 1e-4 of them without a
    witness (the JAX bench's unconverged-identifiable limit), every voxel
    outside the bands printed with its witness, and the sample's CPU
    seconds. Returns {model: (echoes, the graphed fit_stack output)} for
    phase10_cli_sessions."""
    text, fits = "", {}
    inside = session_mask(n)
    mask = Volume(inside.astype(np.uint8))
    for model in ("gaussian_rician", "rician"):
        low_field, tes = GUESS_MODELS[model][:2]
        cfg = C.fit_config(model, low_field, prior=False)
        echoes, ident = guess_echoes(model, seed=23, shape=(n,) * 3)
        stack = EchoStack.from_volumes([Volume(e) for e in echoes], [mask] * len(tes), tes)
        out, g_s, e_s, counts, mib = stack_graph_vs_eager(stack, cfg, device, again=False)
        for name in ("t2", "k", "sigma", "fun"):
            data = getattr(out, name).data
            gate(bool(np.isfinite(data[inside]).all()), f"{model} no prior: non-finite {name}")
        fits[model] = (echoes, out)
        seconds = {"cuda": 0.0, "cpu": 0.0}

        def fit(e, dev, tes=tes, cfg=cfg, seconds=seconds):
            t0 = time.perf_counter()
            o = fit_stack(fully_masked(e, tes), cfg, device=dev)
            seconds[dev] += time.perf_counter() - t0
            return o

        b = (slice(0, GUESS_SUB),) * 3
        block = guess_bands(model, fit, [e[b] for e in echoes], tes, ident[b],
                            f"card vs CPU on the first {GUESS_SUB ** 3} voxels", label="no prior",
                            per_voxel=True, show=None)
        seconds.update(cuda=0.0, cpu=0.0)
        sample = no_prior_sample(echoes, np.flatnonzero(inside & ident), n_sample)
        wide = guess_bands(model, fit, sample, tes, np.ones(n_sample, bool),
                           f"card vs CPU on {n_sample} voxels drawn from the mask's identifiable "
                           f"ones", label="no prior sample", per_voxel=True,
                           allowed=int(1e-4 * n_sample), show=None)
        text += (f" {model}: {out.n_voxels} voxels x 3 starts, {g_s[0]:.3f} s graphed (fit_stack "
                 f"{out.fit_seconds:.3f} s; graphs captured / replayed / host reads {counts}), "
                 f"{e_s:.3f} s eager, bitwise equal; peak {mib[0]:.0f} MiB graphed, {mib[1]:.0f} "
                 f"MiB eager; converged {float((out.converged.data[inside] > 0.5).mean()):.5f}; "
                 f"{block}; {wide} (the sample's fits: card {seconds['cuda']:.2f} s, CPU "
                 f"{seconds['cpu']:.2f} s);")
    card = card_name_and_power_limit() if device == "cuda" else device
    print(f"phase 10 no prior (fit_stack prior=False, fit_batch_multistart, {n}^3 session mask "
          f"on {device}):{text} {card}", flush=True)
    return fits


# t2mapping's CLI module run as __main__ in this fresh process (what
# ``python -m`` does), then one JSON line: its exit code, the process's
# seconds from here to the end, the profiler's stages and the kernel
# launches counted in the process
_CLI_RUN = """
import json, runpy, sys, time
t0 = time.perf_counter()
from fetal_t2mapping_tpu_torch.utils.profiling import profiler
sys.argv = ["fetal_t2mapping_tpu_torch.cli.t2mapping"] + sys.argv[1:]
try:
    runpy.run_module("fetal_t2mapping_tpu_torch.cli.t2mapping", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as exc:
    rc = exc.code
print(json.dumps({"rc": rc, "seconds": time.perf_counter() - t0,
                  "stages": {k: v["seconds"] for k, v in profiler.as_dict().items()},
                  "launches": {name: profiler.counter(name) for name in
                               ("gauss_fit.launches", "gr_varpro_fit.launches",
                                "fit3.launches", "fit3_cont.launches")}}))
"""


def guess_truth(model, seed, shape):
    """The true T2 of ``guess_echoes(model, seed, shape)`` (its second draw)."""
    _, _, k_range, t2_range = GUESS_MODELS[model]
    rng = np.random.default_rng(seed)
    rng.uniform(*k_range, shape)
    return rng.uniform(*t2_range, shape).astype(np.float32)


def phase10_cli_sessions(fits, n: int = 240, device: str = "cuda"):
    """One 240^3 --no_prior session per model through ``python -m
    fetal_t2mapping_tpu_torch.cli.t2mapping`` in a fresh process each
    (``_CLI_RUN``), on a tree written as phase 7 writes its sessions
    (``_write_echo_tree``) from phase 10's seed-23 echoes and the session
    mask; the gaussian session fits the gaussian_rician tree (the same
    low-field TEs). Gates: the maps finite in the mask, the median relative
    T2 error against the truth <= 5e-2, gauss_fit.cu launched once in the
    gaussian session, and every map (t2, k, sigma, res) bitwise the same
    session's fit_stack(prior=False) in this process (phase 10's for the
    3-parameter models). Prints each process's wall seconds and its
    t2map.fit stage."""
    inside = session_mask(n)
    mask = Volume(inside.astype(np.uint8))
    rows = []
    for tree_model, models in (("gaussian_rician", ("gaussian", "gaussian_rician")),
                               ("rician", ("rician",))):
        low_field, tes = GUESS_MODELS[tree_model][:2]
        echoes, out3 = fits[tree_model]
        t2_true = guess_truth(tree_model, 23, (n,) * 3)
        with tempfile.TemporaryDirectory(prefix="ft2_smoke_np_") as root:
            t0 = time.perf_counter()
            _write_echo_tree(root, echoes, inside, tes)
            tree_s = time.perf_counter() - t0
            for model in models:
                if model == tree_model:
                    out = out3
                else:
                    stack = EchoStack.from_volumes([Volume(e) for e in echoes],
                                                   [mask] * len(tes), tes)
                    out = fit_stack(stack, C.fit_config(model, low_field, prior=False),
                                    device=device)
                argv = ["--path", root, "--csv", "smoke.csv", "--in_vivo", f"--{model}",
                        "--lf" if low_field else "--hf", "--sim", "np", "--no_prior",
                        "--TEs", *map(str, tes), "--device", device]
                t0 = time.perf_counter()
                proc = subprocess.run([sys.executable, "-c", _CLI_RUN, *argv], cwd=REPO,
                                      capture_output=True, text=True, timeout=900)
                wall = time.perf_counter() - t0
                gate(proc.returncode == 0, f"{model} --no_prior CLI failed ({proc.returncode}): "
                                           f"{proc.stderr[-4000:]}")
                res = json.loads(proc.stdout.strip().splitlines()[-1])
                gate(res["rc"] in (0, None), f"{model} --no_prior CLI exited {res['rc']}")
                for name in ("t2", "k", "sigma", "res"):
                    found = [os.path.join(d, f) for d, _, files in os.walk(root) for f in files
                             if f.endswith(f"_sim-np_{name}map_ada-{model}.nii.gz")]
                    gate(len(found) == 1, f"{model} --no_prior: {len(found)} {name} maps")
                    data = np.ascontiguousarray(nifti.read(found[0]).data)
                    gate(bool(np.isfinite(data[inside]).all()),
                         f"{model} --no_prior CLI: non-finite {name}")
                    gate(_same(data, np.ascontiguousarray(getattr(out, name).data)),
                         f"{model} --no_prior CLI: map {name} differs from fit_stack(prior=False)")
                    if name == "t2":
                        med = float(np.median(np.abs(data[inside] - t2_true[inside])
                                              / t2_true[inside]))
                gate(med <= 5e-2, f"{model} --no_prior CLI: median rel T2 err {med:.3e} > 5e-2")
                launches = res["launches"]
                gate(model != "gaussian" or device != "cuda" or launches["gauss_fit.launches"] == 1,
                     f"gaussian --no_prior CLI: gauss_fit.cu launches {launches}")
                rows.append(f"{model} ({tree_model} tree, written in {tree_s:.1f} s): process "
                            f"{wall:.2f} s (script {res['seconds']:.2f} s, t2map.fit "
                            f"{res['stages'].get('t2map.fit', math.nan):.3f} s, t2map.fit.traces "
                            f"{res['stages'].get('t2map.fit.traces', math.nan):.3f} s), median rel "
                            f"T2 err {med:.3e}, launches {launches}, maps bitwise "
                            f"fit_stack(prior=False)")
    card = card_name_and_power_limit() if device == "cuda" else device
    print(f"phase 10 --no_prior CLI sessions ({n}^3 session mask, python -m "
          f"fetal_t2mapping_tpu_torch.cli.t2mapping in a fresh process each): "
          f"{'; '.join(rows)} ({card})", flush=True)


# ------------------------------------------------ the no-prior multistart, step by step
def no_prior_block(model, seed=23, n=240):
    """The first GUESS_SUB^3 block of phase 10's no-prior data (``guess_echoes``
    at n^3): (echoes, identifiable voxels, TEs)."""
    echoes, ident = guess_echoes(model, seed=seed, shape=(n,) * 3)
    b = (slice(0, GUESS_SUB),) * 3
    return [np.ascontiguousarray(e[b]) for e in echoes], ident[b], GUESS_MODELS[model][1]


class OpLog(TorchDispatchMode):
    """Records every arithmetic ATen op run under it: (name, input tensors,
    output tensors), tensors as host numpy copies (None where one cannot
    be copied). Copies, detaches and views (``OpLog.SKIP``) are not
    recorded: a copy to the host dispatches an op on the card and none on
    the CPU, and none of them changes a bit."""

    SKIP = frozenset(f"aten.{n}.default" for n in (
        "_to_copy", "detach", "lift_fresh", "alias", "clone", "_local_scalar_dense", "view",
        "_unsafe_view", "expand", "unsqueeze", "squeeze", "permute", "t", "transpose",
        "as_strided", "copy_"))

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if str(func) in self.SKIP:
            return out

        def host(tree):
            leaves = []
            for t in torch.utils._pytree.tree_leaves(tree):
                if isinstance(t, torch.Tensor):
                    try:
                        leaves.append(t.detach().cpu().numpy().copy())
                    except (RuntimeError, TypeError):
                        leaves.append(None)
            return leaves

        self.ops.append((str(func), host((args, kwargs)), host(out)))
        return out


class OnCard(TorchDispatchMode):
    """Runs the ATen ops named in ``names`` on the card: their CPU tensor
    arguments are copied there and the results copied back, so a CPU
    computation takes the card's rounding at those ops alone."""

    def __init__(self, names, device="cuda"):
        super().__init__()
        self.names, self.device = set(names), torch.device(device)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if str(func) not in self.names:
            return func(*args, **kwargs)
        tm = torch.utils._pytree.tree_map
        move = lambda d: lambda t: t.to(d) if isinstance(t, torch.Tensor) else t  # noqa: E731
        out = func(*tm(move(self.device), args), **tm(move(self.device), kwargs))
        return tm(move(torch.device("cpu")), out)


def multistart_steps(batch, tes, cfg, device):
    """fit_stack's no-prior 3-parameter fit of the (N, T) ``batch`` on
    ``device``, as its eager loop (``solver._fit_batch_loop`` over the
    three starts, then the argmin), recording each iteration: the state
    before the step (x, f, lam, conv), g and H, the trial point x_new and
    its objective f_new, rows start-major (row s * N + i). Returns a dict:
    x0s (S, N, P), steps (a list of dicts of numpy arrays), x (S, N, P),
    f (S, N), best (N,)."""
    from fetal_t2mapping_tpu_torch.models import solver, t2map
    from fetal_t2mapping_tpu_torch.models.init import grid_init, loglinear_init
    from fetal_t2mapping_tpu_torch.models.signal import make_objective, make_value_grad_hess

    dev = torch.device(device)
    s = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(dev)
    te = torch.from_numpy(np.asarray(tes, np.float32)).to(dev)
    lo, hi = (torch.from_numpy(b).to(dev) for b in t2map._bounds_for(cfg, batch))
    x0s = torch.stack([loglinear_init(s, te, lo, hi), grid_init(s, te, lo, hi),
                       t2map._guess_start(cfg, lo, hi)])
    n_s, n, p = x0s.shape
    obj0, fgh0 = make_objective(cfg.model), make_value_grad_hess(cfg.model)
    seen = {}

    def fgh(x, te_, s_):
        out = fgh0(x, te_, s_)
        seen.update(g=out[1], H=out[2])
        return out

    def obj(x, te_, s_):
        f_new = obj0(x, te_, s_)
        seen.update(x_new=x, f_new=f_new)
        return f_new

    rep = lambda a: a.repeat(n_s, 1)  # noqa: E731
    sig, te, x, lo, hi, lam, conv, nit = solver._prep(rep(s), te, x0s.reshape(n_s * n, p),
                                                      rep(lo), rep(hi))
    f = obj0(x, te, sig)
    steps = []
    for _ in range(cfg.max_iters):
        if bool(conv.all()):
            break
        state = dict(x=x, f=f, lam=lam, conv=conv)
        x, f, lam, conv, nit, _ = solver._step(fgh, obj, x, f, lam, conv, nit, te, sig, lo, hi,
                                               cfg.ftol, cfg.gtol)
        steps.append({k: v.detach().cpu().numpy() for k, v in {**state, **seen}.items()})
    fun = f.reshape(n_s, n)
    return dict(x0s=x0s.cpu().numpy(), steps=steps, x=x.reshape(n_s, n, p).cpu().numpy(),
                f=fun.cpu().numpy(), best=torch.argmin(fun, dim=0).cpu().numpy())


def _bits(a):
    return None if a is None else np.ascontiguousarray(a).view(np.uint8)


def _same(a, b) -> bool:
    return (a is None and b is None) or (
        a is not None and b is not None and a.shape == b.shape and a.dtype == b.dtype
        and np.array_equal(_bits(a), _bits(b)))


def rounding_ops(card_ops, cpu_ops):
    """Op by op over two OpLog records of one computation: the first index
    whose op names differ (or None), and [(index, name)] of the ops whose
    inputs have the same bits on both sides and whose outputs do not."""
    split = None
    ops = []
    for i, (a, b) in enumerate(zip(card_ops, cpu_ops)):
        if a[0] != b[0]:
            split = i
            break
        if all(_same(x, y) for x, y in zip(a[1], b[1])) and len(a[1]) == len(b[1]) and not all(
                _same(x, y) for x, y in zip(a[2], b[2])):
            ops.append((i, a[0]))
    return split, ops


def branches(step, lo, hi):
    """(free mask, accept) of one recorded step: the KKT-free coordinates
    (solver._step's rule) and whether the trial point was taken."""
    x, g = step["x"], step["g"]
    tol_b = 1e-8 * np.maximum(hi - lo, 1.0)
    free = ~(((x <= lo + tol_b) & (g > 0)) | ((x >= hi - tol_b) & (g < 0)))
    return free, step["f_new"] <= step["f"]


# the exponents recompute_on_cpu tries for pow's recorded calls
POW_EXPONENTS = (2, 1, 0, 3, -1, -2, 0.5)


def recompute_on_cpu(ops) -> dict:
    """Each op of a card's ``OpLog`` record that can be redone from its
    recorded tensors alone, redone on the CPU from the card's own inputs:
    {name: (calls redone, calls whose CPU bits differ from the card's)}.
    The unary ops, the sum and the mean (the reduced dimension read off
    the shapes), pow (an exponent in POW_EXPONENTS gives the card's bits,
    else the call counts as differing) and the two-tensor arithmetic."""
    unary = {f"aten.{n}.default": getattr(torch, n) for n in ("exp", "log", "sqrt", "abs", "neg")}
    binary = {f"aten.{n}.Tensor": getattr(torch, n) for n in ("mul", "add", "sub", "div")}
    reductions = {"aten.sum.dim_IntList": torch.sum, "aten.mean.dim": torch.mean}
    counts = {}
    for name, ins, outs in ops:
        if not ins or not outs or ins[0] is None or outs[0] is None:
            continue
        x, want = torch.from_numpy(ins[0]), outs[0]
        if name in unary:
            got = [unary[name](x)]
        elif name in binary and len(ins) >= 2 and ins[1] is not None:
            got = [binary[name](x, torch.from_numpy(ins[1]))]
        elif name in reductions:
            got = [reductions[name](x, dim=d, keepdim=k) for k in (True, False)
                   for d in range(x.dim())]
        elif name == "aten.pow.Tensor_Scalar":
            got = [torch.pow(x, e) for e in POW_EXPONENTS]
        else:
            continue
        same = any(tuple(g.shape) == want.shape and _same(g.numpy(), want) for g in got)
        done, differ = counts.get(name, (0, 0))
        counts[name] = (done + 1, differ + (not same))
    return counts



def card_bits(ops) -> dict:
    """The card's results at the ``ROUNDING_OPS`` of an ``OpLog`` record, as
    arrays for an .npz: the exponential per element (exp_in / exp_out, the
    float32 bits of each distinct input and its result), each reduction
    per call (red_kind 0 sum, 1 mean; red_in_shape / red_out_shape padded
    with -1 to 4 dimensions; red_in / red_out the calls' values
    concatenated)."""
    exp, red = {}, []
    for name, ins, outs in ops:
        if name == "aten.exp.default":
            exp.update(zip(ins[0].ravel().view(np.int32).tolist(),
                           outs[0].ravel().view(np.int32).tolist()))
        elif name in ROUNDING_OPS:
            red.append((ROUNDING_OPS.index(name), ins[0], outs[0]))
    pad = lambda shape: list(shape) + [-1] * (4 - len(shape))  # noqa: E731
    return dict(exp_in=np.array(list(exp), np.int32), exp_out=np.array(list(exp.values()), np.int32),
                red_kind=np.array([k for k, _, _ in red], np.int8),
                red_in_shape=np.array([pad(i.shape) for _, i, _ in red], np.int32),
                red_out_shape=np.array([pad(o.shape) for _, _, o in red], np.int32),
                red_in=np.concatenate([i.ravel() for _, i, _ in red]).astype(np.float32),
                red_out=np.concatenate([o.ravel() for _, _, o in red]).astype(np.float32))


def _step_table(a, b, j, n, lo, hi, last=None) -> list:
    """Per start of voxel j of two ``multistart_steps`` records (card a, CPU
    b): the starts bit for bit, the first iteration whose state (x, f, lam,
    conv) differs and the first whose branch (KKT free set, accept,
    converged) differs, the ends; with ``last``, every iteration's state,
    g, H, trial point and branch up to two past the first branch."""
    lines = []
    for s in range(3):
        row = s * n + j
        first_state = first_branch = None
        for it in range(min(len(a["steps"]), len(b["steps"]))):
            sa, sb = ({k: w[row] for k, w in r["steps"][it].items()} for r in (a, b))
            if first_state is None and not all(_same(sa[k], sb[k])
                                               for k in ("x", "f", "lam", "conv")):
                first_state = it
            (fa, aa), (fb, ab) = branches(sa, lo[row], hi[row]), branches(sb, lo[row], hi[row])
            if not (np.array_equal(fa, fb) and aa == ab and sa["conv"] == sb["conv"]):
                first_branch = it
                break
        lines.append(f"start {s}: x0 card {a['x0s'][s, j].tolist()} / CPU {b['x0s'][s, j].tolist()}"
                     f" ({'bitwise equal' if _same(a['x0s'][s, j], b['x0s'][s, j]) else 'differ'}); "
                     f"state first differs at iteration {first_state}, branch at {first_branch}; "
                     f"end card {a['x'][s, j].tolist()} f {a['f'][s, j]:.6g} / CPU "
                     f"{b['x'][s, j].tolist()} f {b['f'][s, j]:.6g}")
        for it in range(min(len(a["steps"]), len(b["steps"]), (first_branch or 0) + 3)
                        if last else 0):
            for side, r in (("card", a), ("CPU", b)):
                st = {k: w[row] for k, w in r["steps"][it].items()}
                free, acc = branches(st, lo[row], hi[row])
                lines.append(f"  it {it} {side}: x {st['x'].tolist()} f {st['f']!r} g "
                             f"{st['g'].tolist()} H {st['H'].ravel().tolist()} lam {st['lam']!r} "
                             f"free {free.astype(int).tolist()} x_new {st['x_new'].tolist()} "
                             f"f_new {st['f_new']!r} accept {bool(acc)} conv {bool(st['conv'])}")
    return lines


def localise_no_prior(model="gaussian_rician", voxel=127, out_dir="tests/data", card="cuda"):
    """Where the card's and the CPU's no-prior multistart part on phase 10's
    first 16^3 block (seed 23). fit_stack on the card (graph and eager loop,
    gated bitwise) and on the CPU; the voxels outside the bands and
    ``voxel`` refitted through the recorded eager loop on both sides
    (``multistart_steps``, gated bitwise against fit_stack): per voxel the
    winning start on each side and ``_step_table`` (``voxel``'s with every
    iteration up to the branch). ``voxel`` alone under ``OpLog`` on both
    sides: the first ops whose inputs have the same bits and whose outputs
    do not (``rounding_ops``), the card's ops redone on the CPU from the
    card's inputs (``recompute_on_cpu``), and the card's results at the
    ``ROUNDING_OPS`` written to ``out_dir/no_prior_card_bits_<model>_<voxel>
    .npz`` (``card_bits``; the test data of tests/test_torch_no_prior.py).
    Last, the CPU's fits of those voxels with the ``ROUNDING_OPS`` on the
    card (``OnCard``, guess_bands' third witness): the voxels that then
    give the card's answer bit for bit, and those in its bands.
    ``card="cpu"`` rehearses it on the CPU alone."""
    from fetal_t2mapping_tpu_torch.models import t2map

    os.makedirs(out_dir, exist_ok=True)
    echoes, ident, tes = no_prior_block(model)
    cfg = C.fit_config(model, GUESS_MODELS[model][0], prior=False)
    stack = fully_masked(echoes, tes)
    with eager_loops("fit_batch"):
        eager = guess_cols(fit_stack(stack, cfg, device=card))
    fits = {"cuda": guess_cols(fit_stack(stack, cfg, device=card)),
            "cpu": guess_cols(fit_stack(stack, cfg, device="cpu"))}
    gate(all(_same(x, y) for x, y in zip(fits["cuda"][:3], eager[:3])),
         f"{model} block: graph differs from eager")
    out = np.flatnonzero(guess_outside(model, fits["cuda"], fits["cpu"],
                                       ident.ravel() & fits["cuda"][2] & fits["cpu"][2]))
    vox = sorted(set(out.tolist()) | {voxel})
    n = len(vox)
    batch = np.stack([e.ravel() for e in echoes], axis=1)[vox]
    runs = {"cuda": multistart_steps(batch, tes, cfg, card),
            "cpu": multistart_steps(batch, tes, cfg, "cpu")}
    best = {dev: (r["x"][r["best"], np.arange(n)], r["f"][r["best"], np.arange(n)])
            for dev, r in runs.items()}
    same = {dev: sum(_same(best[dev][0][j], fits[dev][0][v]) for j, v in enumerate(vox))
            for dev in runs}
    gate(all(k == n for k in same.values()), f"recorded loop differs from fit_stack: {same}")
    print(f"localise {model}: {out.size} voxels of the block outside the bands {out.tolist()}, "
          f"each recorded loop bitwise its fit_stack", flush=True)
    lo, hi = (np.tile(t, (3, 1)) for t in t2map._bounds_for(cfg, batch))
    a, b = runs["cuda"], runs["cpu"]
    for j, v in enumerate(vox):
        head = (f"voxel {v} signal {batch[j].tolist()}: winner card {a['best'][j]} "
                f"f {best['cuda'][1][j]:.6g} / CPU {b['best'][j]} f {best['cpu'][1][j]:.6g}")
        print("localise " + "\n  ".join([head] + _step_table(a, b, j, n, lo, hi, v == voxel)),
              flush=True)
    one = {}
    for dev, where in (("cuda", card), ("cpu", "cpu")):
        with OpLog() as log:
            multistart_steps(batch[[vox.index(voxel)]], tes, cfg, where)
        one[dev] = log.ops
    split, rops = rounding_ops(one["cuda"], one["cpu"])
    print(f"localise {model} voxel {voxel} alone: {len(one['cuda'])} card / {len(one['cpu'])} CPU "
          f"ops, names part at {split}; the first ops with equal inputs and other outputs: "
          f"{[r for r in rops if 'zerotensor' not in r[1]][:4]}; the card's ops redone on the "
          f"CPU from the card's inputs (calls, calls with other bits): "
          f"{recompute_on_cpu(one['cuda'])}; the CPU's own: {recompute_on_cpu(one['cpu'])}",
          flush=True)
    j = vox.index(voxel)
    np.savez_compressed(os.path.join(out_dir, f"no_prior_card_bits_{model}_{voxel}.npz"),
                        signal=batch[[j]], tes=np.asarray(tes, np.float32),
                        card_x=best["cuda"][0][j], card_f=best["cuda"][1][j],
                        **card_bits(one["cuda"]))
    with OnCard(ROUNDING_OPS, card):
        r = multistart_steps(batch, tes, cfg, "cpu")
    xb, fb = r["x"][r["best"], np.arange(n)], r["f"][r["best"], np.arange(n)]
    inb = ~guess_outside(model, (xb, fb), best["cuda"], np.ones(n, bool))
    print(f"localise {model}: the CPU with {ROUNDING_OPS} on the card gives the card's answer "
          f"bitwise on {[v for i, v in enumerate(vox) if _same(xb[i], best['cuda'][0][i])]}, in "
          f"its bands on {[v for i, v in enumerate(vox) if inb[i]]} of {vox}", flush=True)


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


def _eager_routes(name):
    """(module, attribute, eager replacement) for each graph-replaying
    function of the loop ``name``: the replacement runs the eager loop that
    the graph replaces."""
    from fetal_t2mapping_tpu_torch.models import solver
    from fetal_t2mapping_tpu_torch.ops import morphology, tv
    from fetal_t2mapping_tpu_torch.recon import biasfield
    from fetal_t2mapping_tpu_torch.recon import registration as reg

    return {
        "levels": [(reg, "_level_while_steps", lambda *a, graph: reg._level_while(*a)),
                   (reg, "_level_scan_steps", lambda *a, graph: reg._level_scan(*a))],
        "fit_batch": [(solver, "_fit_batch_steps",
                       lambda *a, graph, **k: solver._fit_batch_loop(*a, **k))],
        "tv": [(tv, "_tv2d_steps", lambda img, w, eps, n, *, graph: tv._tv2d(img, w, eps, n))],
        "fill": [(morphology, "_fill_holes_steps",
                  lambda m, axes, *, graph: morphology._fill_holes_loop(m, axes))],
        "n4": [(biasfield, "_n4_level_steps",
                lambda v, m, *, graph, **k: biasfield._n4_level_loop(v, m, **k))],
    }[name]


class eager_loops:
    """Within the block the named loops ('levels', 'fit_batch', 'tv',
    'fill', 'n4') run as their eager loops on the card too (the graphs'
    plain versions), through the modules' private step functions; for
    comparison only."""

    def __init__(self, *names):
        self._names = names

    def __enter__(self):
        self._saved = []
        for name in self._names:
            for module, attr, eager in _eager_routes(name):
                self._saved.append((module, attr, getattr(module, attr)))
                setattr(module, attr, eager)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        return False


def graph_counts():
    """(graphs captured, replayed, stop flags read) so far in this process."""
    return (profiler.counter("graphs.captures"), profiler.counter("graphs.replays"),
            profiler.counter("host_reads"))


def counts_since(before):
    return tuple(a - b for a, b in zip(graph_counts(), before))


# the host's launch calls in a torch.profiler trace: kernels and graphs
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def profile_solve(fn, done=lambda out: out.params_device.sum().item()):
    """One call of ``fn`` (a solve; ``done`` syncs on its result, by
    default on the solved parameters) under torch.profiler: wall ms,
    device busy ms, idle share, device kernels, the host's kernel launches
    and graph launches; a string if the profiler is unavailable."""
    try:
        from torch.profiler import ProfilerActivity, profile

        _sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            done(fn())
            _sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
    except Exception as exc:   # the profiler is untried on this machine: report, do not fail
        return f"profiler unavailable ({type(exc).__name__}: {exc})"
    kern = [e for e in events if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    host = {e.key: e.count for e in events if e.key in HOST_LAUNCHES + ("cudaGraphLaunch",)}
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:3]
    return dict(wall_ms=round(wall_ms, 1), busy_ms=round(busy_ms, 1),
                idle=round(1 - busy_ms / wall_ms, 3), device_kernels=sum(e.count for e in kern),
                host_kernel_launches=sum(host.get(k, 0) for k in HOST_LAUNCHES),
                graph_launches=host.get("cudaGraphLaunch", 0),
                top=[f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                     for e in top])


def same_solve(a, b) -> bool:
    """Two registration results with the same bits: parameters, per-level
    histories, stop iterations and best metrics."""
    def bits(t):
        return t.detach().cpu().contiguous().view(torch.int32)
    if not torch.equal(bits(a.params_device), bits(b.params_device)):
        return False
    if any(not torch.equal(bits(x), bits(y)) for x, y in zip(a._solve["hist"], b._solve["hist"])):
        return False
    if (a.iters_run is None) != (b.iters_run is None):
        return False
    return a.iters_run is None or (np.array_equal(a.iters_run, b.iters_run) and torch.equal(
        bits(a._solve["final_f"]), bits(b._solve["final_f"])))


def phase11_registration(n: int = 192, device: str = "cuda"):
    """register_rigid(ncc) at the default settings on bench.py's 192^3 blob
    scene and its moved copy (rx 0.05, ry -0.04, rz 0.04 rad, t (4, -3, 3)
    mm): gated at 0.01 rad and 0.5 mm (bench.py:722-729), its levels run
    as CUDA graphs (one capture per level, one replay per iteration) and
    gated bitwise against the same solve through the eager loops on the
    card. Then the fusion's call (register_rigid_multi, 2 movings),
    register_affine(cr) on a cross-contrast pair (both bitwise to eager),
    a profile of one rigid solve graphed and eager (device busy time, the
    host's kernel and graph launches), and the card against the CPU at 48^3 (stop_tol=None, the CPU tests' REG_FAST levels and
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

    def rigid():
        return registration.register_rigid(fixed, moving, metric="ncc", device=device)

    c0, r0, _ = graph_counts()
    rigid_ms, res = timed_solves(rigid)
    per_solve = tuple(d / 4 for d in counts_since((c0, r0, 0))[:2])   # the warm solve + 3
    rot, tr = pose_error(T1, res.matrix, center)
    gate(rot < 0.01 and tr < 0.5, f"{n}^3 rigid recovery {rot:.4f} rad / {tr:.3f} mm "
                                  "(gates 0.01 rad, 0.5 mm)")
    # the same solve through the eager loops on the card: the graphs' bits
    with eager_loops("levels"):
        eager_ms, eager_res = timed_solves(rigid)
    gate(same_solve(res, eager_res), f"{n}^3 rigid: the graphed levels differ from the eager loops")
    if device != "cpu":
        gate(per_solve[0] == len(res.iters_run) and per_solve[1] >= sum(res.iters_run) - 3,
             f"{n}^3 rigid: {per_solve} graph captures / replays a solve for iters_run "
             f"{res.iters_run.tolist()}")
    multi_ms, regs = timed_solves(
        lambda: registration.register_rigid_multi(fixed, [moving, moving2], metric="ncc",
                                                  device=device))
    multi_err = [pose_error(T, r.matrix, center) for T, r in zip((T1, T2), regs)]
    for r_, t_ in multi_err:
        gate(r_ < 0.01 and t_ < 0.5, f"{n}^3 multi-pair recovery {r_:.4f} rad / {t_:.3f} mm")
    with eager_loops("levels"):
        eager_multi = registration.register_rigid_multi(fixed, [moving, moving2], metric="ncc",
                                                        device=device)
    gate(all(same_solve(a, b) for a, b in zip(regs, eager_multi)),
         f"{n}^3 multi-pair: the graphed levels differ from the eager loops")
    affine_ms, aff = timed_solves(
        lambda: registration.register_affine(fixed, moving_cc, metric="cr", device=device), reps=1)
    aff_err = pose_error(T1, aff.matrix, center)
    with eager_loops("levels"):
        eager_aff = registration.register_affine(fixed, moving_cc, metric="cr", device=device)
    gate(same_solve(aff, eager_aff), f"{n}^3 affine cr: the graphed levels differ from the eager loops")

    # one rigid solve under the profiler, graphed and eager: the card's busy
    # time, the host's launches
    prof = profile_solve(rigid)
    with eager_loops("levels"):
        prof_eager = profile_solve(rigid)

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
          f"{rigid_ms:.1f} ms graphed, {eager_ms:.1f} ms through the eager loops (bitwise equal), "
          f"graph captures / replays a solve {per_solve}, iters_run {res.iters_run.tolist()}, "
          f"host syncs per solve {res.host_syncs}, recovery {rot:.5f} rad / {tr:.4f} mm; "
          f"register_rigid_multi (2 movings) median {multi_ms:.1f} ms, iters_run "
          f"{regs[0].iters_run.tolist()}, host syncs {regs[0].host_syncs}, recovery "
          f"{[(round(r_, 5), round(t_, 4)) for r_, t_ in multi_err]}, bitwise to eager; "
          f"register_affine cr (cross contrast) {affine_ms:.1f} ms, iters_run "
          f"{aff.iters_run.tolist()}, recovery {aff_err[0]:.5f} rad / {aff_err[1]:.4f} mm, bitwise "
          f"to eager; profile of one rigid solve, graphed: {prof}; eager: {prof_eager}; "
          f"48^3 card vs CPU (REG_FAST, stop_tol=None, "
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


def invivo_acquisitions(n: int, seed: int = 12):
    """3 TEs x ax/cor/sag acquisitions, n x n at 1 mm in plane with 4 mm
    slabs of n / 4 slices (bench.py:1198-1260's geometry at n = 240), cor
    and sag rigidly offset (SESSION_MOTION), noise sigma 4: a list of
    (orientation, TE ms, noisy Volume), and the truth's ``fields``."""
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
    acqs = []
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
            acqs.append((otype, te, v.with_data(noisy)))
    return acqs, fields


def _write_invivo_session(root: str, n: int, seed: int = 12, acqs=None):
    """invivo_acquisitions' nine volumes as NIfTI inputs of a BIDS tree,
    with its metadata CSV; or ``acqs`` as they are (returning no fields)."""
    fields = None
    if acqs is None:
        acqs, fields = invivo_acquisitions(n, seed)
    bids = os.path.join(root, "projects/")
    logs = os.path.join(root, "dicom/logs/")
    os.makedirs(logs)
    rows, writes = [], []
    for otype, te, v in acqs:
        acq = {"prj": "prj-smoke", "sub": "sub-01", "ses": "ses-01",
               "run": f"run-{otype}-{te}", "EchoTime": te / 1000.0,
               "ImageOrientationPatientSTR": otype, "CoilString": "Body"}
        writes.append((get_img_path(bids, acq, C.IN_DIRNAME), v))
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


STAGE_NAMES = ("recon.resample", "recon.fuse", "fuse.fuse", "fuse.reg_echo", "fuse.denoise",
               "fuse.write", "recon.synthseg", "recon.masks_bet", "recon.feta", "recon.atlas",
               "t2map.load", "t2map.fit", "t2map.save")


def session_stages():
    """Seconds per stage-2 and stage-3 step since the last profiler.reset()."""
    return {k: round(v["seconds"], 3) for k, v in profiler.as_dict().items()
            if k in STAGE_NAMES}


def invivo_gates(bids, rows, fields, n, t2_path):
    """Stage 2's and stage 3's outputs of an in-vivo session against the
    simulation's truth: per TE the fused recon (median relative error on
    the core < 0.06), BET = recon x mask exactly, the dtypes; the T2 map's
    median relative error in the mask and the brain <= 5e-2. Returns the
    recon errors, the T2 error, the mask's share and the T2 map (those two
    None without a ``t2_path``). Reads the files: the volume cache is
    emptied first."""
    volcache.clear()
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
    if t2_path is None:                       # stage 2's outputs alone
        return errs, None, float(union.mean()), None
    t2_fit = nifti.read(t2_path).data
    inside = union & (support <= 1.0)
    t2_err = float(np.median(np.abs(t2_fit[inside] - t2_true[inside]) / t2_true[inside]))
    gate(t2_err <= 5e-2, f"stage-3 median rel T2 err {t2_err:.4f} > 5e-2 inside the mask")
    return errs, t2_err, float(union.mean()), t2_fit


def phase12_session(n: int = SESSION_N, device: str = "cuda"):
    """One in-vivo session at clinical size through process_qmri on the
    card (SynthSeg 'fake'), then stage 3 (process_t2maps, gaussian) on the
    same tree; then one in-vitro session on a 240^3 phantom recon, on the
    card and on the CPU."""
    from fetal_t2mapping_tpu_torch.pipeline import process_qmri

    records = _Records()
    logging.getLogger("fetal_t2mapping_tpu_torch.recon").addHandler(records)
    with tempfile.TemporaryDirectory(prefix="ft2_smoke_s2_") as root:
        os.environ["FSLDIR"] = os.path.join(root, "no_fsl")       # no atlases: the step skips
        t0 = time.perf_counter()
        bids, logs, fields = _write_invivo_session(root, n)
        setup_s = time.perf_counter() - t0
        rows = set_metadata(logs, ["smoke.csv"], low_field=True)
        profiler.reset()
        launches0 = profiler.counter("gauss_fit.launches")
        before = graph_counts()
        t0 = time.perf_counter()
        process_qmri(bids, rows, in_vivo=True, low_field=True,
                     synthseg=SynthSegRunner(mode="fake"), device=device)
        stage2_s = time.perf_counter() - t0
        stage2_graphs = counts_since(before)
        if torch.device(device).type == "cuda":
            gate(min(stage2_graphs) > 0, f"stage 2 ran no graph {stage2_graphs}")
        t0 = time.perf_counter()
        summaries = process_t2maps(rows, bids, list(SESSION_TES), C.fit_config("gaussian", True),
                                   low_field=True, sim="smoke", make_plots=False, device=device)
        stage3_s = time.perf_counter() - t0
        launches = profiler.counter("gauss_fit.launches") - launches0
        gate(launches > 0, "the chained stage-3 run launched no gauss_fit kernel")
        gate(any("skipping atlas labels" in m for m in records.messages),
             "the atlas step did not warn and skip")
        stages = session_stages()

        errs, t2_err, mask_frac, _ = invivo_gates(bids, rows, fields, n,
                                                  summaries[0]["maps"]["t2"])
        acq = next(r for r in rows if r["EchoTime"] == SESSION_TES[0] / 1000.0)
        loops = stage2_loops(nifti.read(get_img_path(bids, acq, C.RECON_DIRNAME)).data, device)

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
          f"mm -> {n}^3, SynthSeg fake; data set-up {setup_s:.1f} s): stage 2 {stage2_s:.2f} s "
          f"(graphs captured / replayed / host reads {stage2_graphs}; fuse.denoise "
          f"{stages.get('fuse.denoise')} s, recon.masks_bet {stages.get('recon.masks_bet')} s), "
          f"stage 3 (process_t2maps gaussian) {stage3_s:.2f} s, gauss_fit launches {launches}; "
          f"fused recon median rel err vs truth on the core {errs}; mask share {mask_frac:.3f}; "
          f"stage-3 median rel T2 err vs truth in mask and brain {t2_err:.4f}; stage seconds "
          f"{stages}; in vitro ({n}^3 phantom, masks + labels) card {vitro_s[device]} s, CPU "
          f"{vitro_s['cpu']} s, equal; on the {SESSION_TES[0]} ms recon: {loops}", flush=True)
    return launches


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    def bits(t):
        t = t.contiguous()
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


class make_room_log:
    """Within the block, each call of ``graphs._make_room`` (before every
    capture) is logged: (cached MiB, free MiB, whether it emptied the
    allocator's cache)."""

    def __enter__(self):
        self.calls, self._orig = [], graphs._make_room

        def logged(device):
            cached = (torch.cuda.memory_reserved(device)
                      - torch.cuda.memory_allocated(device)) / 2 ** 20
            free = torch.cuda.mem_get_info(device)[0] / 2 ** 20
            before = torch.cuda.memory_reserved(device)
            self._orig(device)
            self.calls.append((round(cached), round(free),
                               torch.cuda.memory_reserved(device) < before))

        graphs._make_room = logged
        return self

    def __exit__(self, *exc):
        graphs._make_room = self._orig
        return False


def stage2_loops(recon: np.ndarray, device: str, reps: int = 3) -> str:
    """tv_denoise_slices, fill_holes (the recon above its mean) and
    build_slice_mask on one of the session's recons, each as its replayed
    graph and then as its eager loop on the same device, gated bitwise: ms
    of each call (TV once each way, the two fills ``reps`` times each way,
    one after another in this process), the graphed calls' graphs captured
    / replayed / host reads, and for each capture whether
    ``graphs._make_room`` emptied the allocator's cache before it (cached
    and free MiB)."""
    from fetal_t2mapping_tpu_torch.ops import morphology, tv

    rec = torch.from_numpy(np.ascontiguousarray(recon, np.float32)).to(device)
    above = rec > rec.mean()
    calls = {"tv_denoise_slices": ("tv", lambda: tv.tv_denoise_slices(rec), 1),
             "fill_holes": ("fill", lambda: morphology.fill_holes(above), reps),
             "build_slice_mask": ("fill", lambda: morphology.build_slice_mask(rec), reps)}
    parts = []
    for name, (loop, fn, n_calls) in calls.items():
        res = {}
        for route in ("graph", "eager"):
            with eager_loops(*((loop,) if route == "eager" else ())), make_room_log() as room:
                runs = []
                for _ in range(n_calls):
                    _sync()
                    before = graph_counts()
                    t0 = time.perf_counter()
                    out = fn()
                    _sync()
                    runs.append((out, (time.perf_counter() - t0) * 1e3, counts_since(before)))
            res[route] = (runs, room.calls)
        gate(all(same_bits(r[0], res["graph"][0][0][0]) for rt in res.values() for r in rt[0]),
             f"{name}: the graphed loop differs from the eager loop on {device}")
        ms = {rt: " / ".join(f"{r[1]:.1f}" for r in res[rt][0]) for rt in res}
        parts.append(f"{name} {ms['graph']} ms graphed (graphs captured / replayed / host reads "
                     f"{[r[2] for r in res['graph'][0]]}; before each capture cached / free MiB, "
                     f"cache emptied: {res['graph'][1]}), {ms['eager']} ms eager, bitwise equal")
    card = card_name_and_power_limit() if torch.device(device).type == "cuda" else device
    return "; ".join(parts) + f" ({card})"


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
                     varpro3=None, kernels=("gauss_fit.launches",)),
    "gaussian_rician": dict(model="gaussian_rician", lo=LO3, hi=HI3, guess=GUESS3, varpro3=True,
                            kernels=("gr_varpro_fit.launches",), **TOL3),
    "gaussian_rician multistart": dict(model="gaussian_rician", lo=LO3, hi=HI3, guess=GUESS3,
                                       varpro3=False, kernels=("fit3.launches",
                                                               "fit3_cont.launches"), **TOL3),
    "rician": dict(model="rician", lo=LO3, hi=HI3, guess=GUESS3, varpro3=None,
                   kernels=("fit3.launches", "fit3_cont.launches"), **TOL3),
}
# fit_volume's one layout at its two capacities (a buffer over every block,
# compact=False; mask_frac of the grid) and voxel-exact
LAYOUTS = {"full": dict(compact=False), "block": dict(compact=True),
           "voxel": dict(compact=True, block=1)}
VF_MAPS = ("t2", "k", "sigma", "fun", "converged", "n_iter")


def touched_blocks(mask: torch.Tensor, block: int = 32) -> int:
    """The ``block``-voxel blocks of the flat grid holding a masked voxel."""
    flat = torch.nn.functional.pad(mask.reshape(-1) > 0, (0, -mask.numel() % block))
    return int(flat.reshape(-1, block).any(dim=1).sum())


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


LAYOUT_COUNTERS = ("volume_layout.compact.launches", "volume_layout.scatter.launches")


def layout_bound(n: int, block: int, rows: int, kept_rows: int, T: int, P: int):
    """The block layout's least time on the card for one request (bytes,
    each read or written once): compaction reads the mask (n bytes), writes
    the block -> slot map and fills the buffer (``rows`` x T floats, the
    kept rows' echoes and mask bytes read); the scatter reads the map, the
    kept rows' mask bytes and fit rows (P + 1 floats, a flag, an int) and
    writes six maps (four float32, a bool, an int32)."""
    nb = -(-n // block)
    compact = n + 4 * nb + kept_rows * (4 * T + 1) + 4 * rows * T
    scatter = 4 * nb + kept_rows * (4 * (P + 1) + 1 + 4 + 1) + n * (4 * 4 + 1 + 4)
    return bound(compact, 0, FP32_OPS)[0], bound(scatter, 0, FP32_OPS)[0]


def fit3_list_gate(buf, fit: dict, list_k, list_p, what: str):
    """fit3's multistart prefix and continuation over a gathered buffer's
    row list: the kernels over the gather's list (the continuation in place
    over the prefix's outputs) bitwise the plain versions over the plain
    list, the rows not listed included (all 0)."""
    args = (buf, fit["model"], TES3, fit["lo"], fit["hi"], fit["guess"])
    kw = dict(ftol=fit["ftol"], gtol=fit["gtol"], stall_tol=max(fit["ftol"], 1e-6))
    cont = dict(max_iters=60 - PREFIX3, **kw)
    pre_k = fused_fit._fit3_cuda(*args, max_iters=PREFIX3, row_list=list_k, **kw)
    pre_p = fused_fit._fit3_plain(*args, max_iters=PREFIX3, row_list=list_p, **kw)
    cont_p = fused_fit._fit3_cont_plain(*args, *pre_p, row_list=list_p, **cont)

    def same(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))

    gate(same(pre_k, pre_p), f"{what}: fit3's prefix over the row list differs from the plain "
         "version")
    cont_k = fused_fit._fit3_cont_cuda(*args, *pre_k, row_list=list_k, in_place=True, **cont)
    gate(same(cont_k, cont_p), f"{what}: fit3's continuation over the row list (in place) "
         "differs from the plain version")


def layout_gate(sig, mask, fit: dict, mask_frac: float, block: int, what: str, timed=False):
    """The block layout's kernels (csrc/volume_layout.cu) against their
    plain versions on one request: the buffer, the block -> slot map and
    the counts, then, from one fit of the buffer, the six maps, n_masked and
    n_overflow, all bitwise. For a fit that takes a row list (the 3-start
    multistart) both compactions list the rows: the gather's list, sorted,
    is the plain list and nothing past counts[2] is written, and fit3's
    prefix and continuation (in place, as fit_fused runs it) over the
    gather's list are bitwise their plain versions over the plain list
    (fit3_list_gate). With ``timed``, the ms a call of each half
    takes back to back (10 calls an event pair, so the host's launch of
    one overlaps the device's work of the last), kernel and plain, and
    their bounds at this request's shape."""
    from fetal_t2mapping_tpu_torch.models import volume_fit

    te_t, lo_t, hi_t, guess_t = fused_fit.validate_fused_args(
        fit["model"], TES3, fit["lo"], fit["hi"], fit["guess"], False)
    filler = volume_fit._filler_values(te_t, lo_t, hi_t, guess_t)
    n = mask.numel()
    blk_cap = volume_fit._block_capacity(n, mask_frac, block)
    flat, fmask = sig.reshape(n, 3), mask.reshape(n)
    bufs = [torch.empty((blk_cap * block, 3), device=sig.device) for _ in range(2)]
    listed = fused_fit.takes_row_list(fit["model"], fit["varpro3"])
    lists = [torch.full((blk_cap * block,), -1, dtype=torch.int32, device=sig.device)
             if listed else None for _ in range(2)]
    slot_k, counts_k = volume_fit._compact_cuda(flat, fmask, filler, blk_cap, block, bufs[0],
                                                lists[0])
    slot_p, counts_p = volume_fit._compact_plain(flat, fmask, filler, blk_cap, block, bufs[1],
                                                 lists[1])
    gate(torch.equal(bufs[0].view(torch.int32), bufs[1].view(torch.int32))
         and torch.equal(slot_k, slot_p) and torch.equal(counts_k[:3], counts_p),
         f"{what}: the compaction kernel's buffer, slot map or counts differ from the plain version")
    if listed:
        kept = int(counts_k[2])
        gate(torch.equal(torch.sort(lists[0][:kept]).values, lists[1][:kept])
             and not bool((lists[0][kept:] != -1).any()),
             f"{what}: the gather's row list ({kept} kept masked voxels) is not the plain list "
             "or runs past counts[2]")
        fit3_list_gate(bufs[0], fit, (lists[0], counts_k[2]), (lists[1], counts_p[2]), what)
    res = fused_fit.fit_fused(bufs[0], TES3, fit["lo"], fit["hi"], model=fit["model"],
                              guess=fit["guess"], ftol=fit["ftol"], gtol=fit["gtol"],
                              varpro3=fit["varpro3"], sync=False, device=sig.device)
    got = volume_fit._scatter_cuda(fmask, block, slot_k, res, counts_k, mask.shape)
    want = volume_fit._scatter_plain(fmask, block, slot_p, res, counts_p, mask.shape)
    for f in volume_fit.VolumeFitResult._fields:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        gate(a.dtype == b.dtype and torch.equal(a, b),
             f"{what}: the scatter kernel's {f} differs from the plain version")
    if not timed:
        return None

    def per_call(fn, reps):
        return cuda_ms(lambda: [fn() for _ in range(10)], reps) / 10

    ms = dict(
        compact=per_call(lambda: volume_fit._compact_cuda(flat, fmask, filler, blk_cap, block,
                                                          bufs[0]), 10),
        compact_plain=per_call(lambda: volume_fit._compact_plain(flat, fmask, filler, blk_cap,
                                                                 block, bufs[1]), 2),
        scatter=per_call(lambda: volume_fit._scatter_cuda(fmask, block, slot_k, res, counts_k,
                                                          mask.shape), 10),
        scatter_plain=per_call(lambda: volume_fit._scatter_plain(fmask, block, slot_p, res,
                                                                 counts_p, mask.shape), 2))
    kept_rows = int(counts_k[2])
    ms["compact_bound"], ms["scatter_bound"] = layout_bound(n, block, blk_cap * block, kept_rows,
                                                            3, res.x.shape[1])
    return ms


def phase13_serving(n: int = SERVING_N, device: str = "cuda"):
    """fit_volume, the serving path, on 240^3 x 3-TE requests per model:
    the block layout with a buffer over every block (compact=False), at
    mask_frac (32) and voxel-exact, each for 3 rounds of 4 requests; all
    three bitwise equal per voxel and equal to fit_fused on the gathered
    voxels; the 22% request gated; launches per request counted from 0
    around one compact='auto' request, and one compaction and one scatter
    of csrc/volume_layout.cu per request; on the card the layout's kernels
    bitwise their plain versions on every request and capacity, and timed
    at the ~5% request (gaussian)."""
    from fetal_t2mapping_tpu_torch.models import volume_fit

    launches, times = {}, {}
    layout_ms = None
    for fit_name, fit in SERVING_FITS.items():
        model, lo, hi = fit["model"], fit["lo"], fit["hi"]
        kw = dict(model=model, guess=fit["guess"], ftol=fit["ftol"], gtol=fit["gtol"],
                  varpro3=fit["varpro3"], check_capacity=False, device=device)
        text = []
        for name, scale in SERVING_MASKS.items():
            sig, mask, t2 = serving_request(n, scale, seed=21, device=device)
            # 6% over the touched blocks
            mask_frac = math.ceil(106 * touched_blocks(mask) * 32 / mask.numel()) / 100
            res = {}
            for lay, lk in LAYOUTS.items():
                before = {c: profiler.counter(c) for c in LAYOUT_COUNTERS}
                res[lay] = volume_fit.fit_volume(sig, mask, TES3, lo, hi, mask_frac=mask_frac,
                                                 **lk, **kw)
                want = int(device == "cuda")
                for c in LAYOUT_COUNTERS:
                    gate(profiler.counter(c) - before[c] == want,
                         f"serving {fit_name} {name} {lay}: {c} "
                         f"{profiler.counter(c) - before[c]} per request, expected {want}")
                if device == "cuda":
                    timed = fit_name == "gaussian" and lay == "block" and name == "5%"
                    out = layout_gate(sig, mask, fit, 1.0 if lay == "full" else mask_frac,
                                      lk.get("block", 32), f"serving {fit_name} {name} {lay}",
                                      timed=timed)
                    layout_ms = out if timed else layout_ms
            _sync()
            d = res["full"]
            n_masked = int(d.n_masked)
            gate(n_masked == int(mask.sum()), f"serving {fit_name} {name}: n_masked {n_masked}")
            for lay, r in res.items():
                gate(int(r.n_overflow) == 0, f"serving {fit_name} {name} {lay}: n_overflow "
                     f"{int(r.n_overflow)}")
                for m in VF_MAPS:
                    gate(torch.equal(getattr(r, m), getattr(d, m)),
                         f"serving {fit_name} {name}: layout {lay} map {m} differs from full")
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
                counts0 = launches_since()
                volume_fit.fit_volume(sig, mask, TES3, lo, hi, mask_frac=mask_frac, **kw)
                _sync()
                counts = launches_since(counts0)
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
            text.append(f"{name} mask ({n_masked} voxels, mask_frac {mask_frac}): "
                        + ", ".join(f"{lay} {t:.3f} ms ({n_masked / t * 1e3:.4g} voxels/s)"
                                    for lay, t in ms.items())
                        + f", median rel T2 err {med_rel:.3e}, converged {conv:.5f}")
            del sig, mask, t2
        print(f"phase 13 serving {fit_name} (fit_volume, {n}^3 x 3 TEs, 3 rounds of 4 "
              f"requests, bitwise across capacities and with fit_fused): " + "; ".join(text)
              + f"; launches per request {launches[fit_name]}", flush=True)
    if layout_ms is not None:
        print("phase 13 block layout (csrc/volume_layout.cu) at the ~5% request, ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in layout_ms.items()), flush=True)
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
    def same_n4(x, y):
        return (np.array_equal(x.corrected.data, y.corrected.data)
                and np.array_equal(x.field.data, y.field.data)
                and np.array_equal(x.field_cv, y.field_cv))

    before = graph_counts()
    s1, a = timed_s(lambda: n4_bias_correction(vol, mvol, device=device))
    n4_graphs = counts_since(before)
    s1b, b = timed_s(lambda: n4_bias_correction(vol, mvol, device=device))
    gate(same_n4(a, b), "n4: two card runs differ")
    with eager_loops("n4"):
        s1e, e = timed_s(lambda: n4_bias_correction(vol, mvol, device=device))
    gate(same_n4(a, e), "n4: the graphed level differs from the eager loop (corrected, field "
                        "or field_cv)")
    if torch.device(device).type == "cuda":
        gate(n4_graphs[:2] == (1, 39) and n4_graphs[2] == 0,
             f"n4: graphs captured / replayed / host reads {n4_graphs} for one 40-iteration level")
    # the host's launches per level at 96^3 with the 240^3 scene's 1 mm
    # voxels: the smoothing's taps, and so the launches, are the same
    img96, mask96, *_ = n4_scene(96, seed=2)
    v96 = Volume(img96, spacing=mm)
    m96 = Volume(mask96.astype(np.uint8), spacing=mm)
    launches = {}
    for route in ("graph", "eager"):
        with eager_loops(*(("n4",) if route == "eager" else ())):
            prof = profile_solve(lambda: n4_bias_correction(v96, m96, device=device),
                                 done=lambda r: None)
        launches[route] = (prof if isinstance(prof, str) else
                           {k: prof[k] for k in ("wall_ms", "host_kernel_launches",
                                                 "graph_launches", "device_kernels")})
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
    card = card_name_and_power_limit() if torch.device(device).type == "cuda" else device
    print(f"phase 14 n4 ({n}^3, {mm[0]:g} mm, known field; {single}): defaults (one level of 40 "
          f"iterations) {s1:.3f} s and {s1b:.3f} s graphed (graphs captured / replayed / host "
          f"reads {n4_graphs}), {s1e:.3f} s eager, bitwise equal (field_cv included); a level's "
          f"host launches at 96^3: {launches}; {card}; "
          f"(200, 100, 50) mm {s3:.3f} s ({multi}); shared_log_bias x 3 echoes "
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


# ------------------------------------------ stage 1: DICOM ingest (host code)
TS_EXPLICIT, TS_IMPLICIT, TS_RLE = "1.2.840.10008.1.2.1", "1.2.840.10008.1.2", "1.2.840.10008.1.2.5"
TS_JPEGLL, TS_JPEG8, TS_JPEG12 = ("1.2.840.10008.1.2.4.70", "1.2.840.10008.1.2.4.50",
                                  "1.2.840.10008.1.2.4.51")
TS_J2K = "1.2.840.10008.1.2.4.90"
ENHANCED_MR = b"1.2.840.10008.5.1.4.1.1.4.1"
INGEST_DATE, INGEST_PARENT = "2026081710", "30540000"


def _dcm_element(group, elem, vr: bytes, value: bytes, explicit=True) -> bytes:
    """One little-endian data element, padded to even length."""
    if len(value) % 2:
        value += b"\x00" if vr in (b"UI", b"OB", b"OW") else b" "
    if not explicit:
        return struct.pack("<HHI", group, elem, len(value)) + value
    if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
        return struct.pack("<HH2sHI", group, elem, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", group, elem, vr, len(value)) + value


def _ds(values) -> bytes:
    """DS values at 10 significant digits: each fits DS's 16 characters."""
    return "\\".join(f"{float(v):.10g}" for v in values).encode()


def write_dicom(path, pix: np.ndarray, vol: Volume, te: float, *, ts=TS_EXPLICIT,
                frames=None, acq_time="", series_uid="1.2.3", description="t2_haste",
                bits_stored=None, explicit=True) -> None:
    """A Part-10 MR file of ``pix`` ((frames,) rows, cols; uint16 or uint8)
    with ``vol``'s geometry in LPS: IPP = the origin, IOP = the direction's
    first two columns, frames along their cross product at the z spacing.
    ``frames`` holds one encoded stream per frame (one fragment each) for
    an encapsulated syntax; otherwise the pixels are stored native."""
    pix = pix.reshape((-1,) + pix.shape[-2:])
    n, rows, cols = pix.shape
    D = np.asarray(vol.direction, np.float64).reshape(3, 3)
    bits = pix.dtype.itemsize * 8

    def el(g, e, vr, v):
        return _dcm_element(g, e, vr, v, explicit)

    meta_body = (_dcm_element(0x0002, 0x0002, b"UI", ENHANCED_MR)
                 + _dcm_element(0x0002, 0x0010, b"UI", ts.encode()))
    meta = _dcm_element(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))) + meta_body
    body = b"".join([
        el(0x0008, 0x002A, b"DT", acq_time.encode()),
        el(0x0008, 0x0060, b"CS", b"MR"),
        el(0x0008, 0x103E, b"LO", description.encode()),
        el(0x0018, 0x0050, b"DS", _ds([vol.spacing[2]])),
        el(0x0018, 0x0081, b"DS", _ds([te])),
        el(0x0018, 0x0087, b"DS", b"0.55"),
        el(0x0018, 0x0088, b"DS", _ds([vol.spacing[2]])),
        el(0x0020, 0x000E, b"UI", series_uid.encode()),
        el(0x0020, 0x0013, b"IS", b"1"),
        el(0x0020, 0x0032, b"DS", _ds(vol.origin)),
        el(0x0020, 0x0037, b"DS", _ds(list(D[:, 0]) + list(D[:, 1]))),
        el(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
        el(0x0028, 0x0008, b"IS", str(n).encode()),
        el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        el(0x0028, 0x0030, b"DS", _ds([vol.spacing[1], vol.spacing[0]])),   # (dy, dx)
        el(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
        el(0x0028, 0x0101, b"US", struct.pack("<H", bits_stored or bits)),
        el(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
    ])
    if frames is None:
        body += el(0x7FE0, 0x0010, b"OW", np.ascontiguousarray(pix).tobytes())
    else:
        body += struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF)
        body += struct.pack("<HHI", 0xFFFE, 0xE000, 0)                 # empty offset table
        for f in frames:
            f = f + b"\x00" if len(f) % 2 else f
            body += struct.pack("<HHI", 0xFFFE, 0xE000, len(f)) + f
        body += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def encode_lossless(frame: np.ndarray) -> bytes:
    """One frame as a JPEG-lossless SV1 stream (the port's encoder)."""
    from fetal_t2mapping_tpu_torch.utils import jpegll

    return jpegll.encode(frame, predictor=1, precision=16)


def encode_frames(pix: np.ndarray, workers: int) -> list:
    """encode_lossless over the frames, in ``workers`` spawned processes
    (the encoder is pure Python: ~2 s a 240 x 240 frame)."""
    if workers <= 1:
        return [encode_lossless(f) for f in pix]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(encode_lossless, list(pix)))


def _rle_frame(pix: np.ndarray) -> bytes:
    """One uint16 frame as RLE Lossless (PS3.5 G): two byte planes, MSB
    first, each PackBits-coded as literal runs of up to 128 bytes."""
    segs = []
    for plane in ((pix >> 8).astype(np.uint8).tobytes(), (pix & 0xFF).astype(np.uint8).tobytes()):
        seg = bytearray()
        for i in range(0, len(plane), 128):
            chunk = plane[i:i + 128]
            seg += bytes([len(chunk) - 1]) + chunk
        segs.append(bytes(seg) + (b"\x00" if len(seg) % 2 else b""))
    return struct.pack("<16I", 2, 64, 64 + len(segs[0]), *([0] * 13)) + b"".join(segs)


def write_dicom_session(root: str, acqs, workers: int = 1):
    """invivo_acquisitions' nine volumes as nine enhanced multi-frame
    Part-10 files (one per acquisition) under
    root/dicom/<YYYYMMDDHH>/<MMSS0000>/, with the master log_dcms.csv.
    Pixels are rounded and clipped to uint16; AcquisitionDateTime orders
    the runs as ``acqs`` lists them; the first TE's axial stack is
    JPEG-lossless (one fragment per frame), the rest uncompressed.
    Returns the session directory and {run: (orientation, TE, pixels, Volume)}."""
    session = os.path.join(root, "dicom", INGEST_DATE, INGEST_PARENT)
    logs = os.path.join(root, "dicom", "logs")
    os.makedirs(session)
    os.makedirs(logs)
    with open(os.path.join(logs, "log_dcms.csv"), "w", newline="") as f:
        csv.writer(f).writerows([["date", "dcm_parent", "prj", "sub", "ses"],
                                 [INGEST_DATE, INGEST_PARENT, "prj-smoke", "sub-01", "ses-01"]])
    written = {}
    for i, (otype, te, v) in enumerate(acqs):
        pix = np.clip(np.rint(v.data), 0, 65535).astype(np.uint16)
        lossless = otype == "ax" and te == SESSION_TES[0]
        write_dicom(os.path.join(session, f"IM{i:04d}"), pix, v, te,
                    ts=TS_JPEGLL if lossless else TS_EXPLICIT,
                    frames=encode_frames(pix, workers) if lossless else None,
                    acq_time=f"{INGEST_DATE}{31 + i:02d}00.000000",
                    series_uid=f"1.2.826.0.1.3680043.8.498.{i + 1}",
                    description=f"t2_haste_{otype}_te{te}")
        written[f"run-{i + 1:02d}"] = (otype, te, pix, v)
    return session, written


def phase15a_decoders(slice16: np.ndarray, vol: Volume, root: str):
    """One rows x cols 16-bit slice through read_dcm in each transfer
    syntax: ms per slice, lossless ones exact, 12-bit DCT within 4 at
    quant 1 (tests/test_jpegdct.py:29-36), 8-bit baseline and JPEG 2000
    where PIL imports."""
    import io

    from fetal_t2mapping_tpu_torch.utils import dicom, jpegdct

    t0 = time.perf_counter()
    build.load_host_lib()
    host_build_s = time.perf_counter() - t0
    s12 = np.minimum(slice16, 4095)
    cases = {   # name -> (ts, pixels, encoded frames or None, explicit, bits stored, exact)
        "explicit": (TS_EXPLICIT, slice16, None, True, 16, True),
        "implicit": (TS_IMPLICIT, slice16, None, False, 16, True),
        "rle": (TS_RLE, slice16, [_rle_frame(slice16)], True, 16, True),
        "jpegll": (TS_JPEGLL, slice16, [encode_lossless(slice16)], True, 16, True),
        "jpeg12": (TS_JPEG12, s12, [jpegdct.encode(s12, precision=12, quant=1)], True, 12,
                   False),
    }
    try:
        from PIL import Image, features

        s8 = np.clip(slice16, 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(s8).save(buf, format="JPEG", quality=95)
        cases["jpeg8 (PIL)"] = (TS_JPEG8, s8, [buf.getvalue()], True, 8, False)
        if features.check("jpg_2000"):
            buf = io.BytesIO()
            Image.fromarray(slice16).save(buf, format="JPEG2000", irreversible=False, no_jp2=True)
            cases["j2k (PIL)"] = (TS_J2K, slice16, [buf.getvalue()], True, 16, True)
    except ImportError:
        pass
    ms, errs = {}, {}
    for name, (ts, pix, frames, explicit, stored, exact) in cases.items():
        path = os.path.join(root, f"{name.split()[0]}.dcm")
        write_dicom(path, pix, vol, SESSION_TES[0], ts=ts, frames=frames, explicit=explicit,
                    bits_stored=stored)
        routes = [(name, None)]
        if name == "jpegll":   # and again through utils/jpegll: the library's -11 route
            routes = [("jpegll (host library)", None), ("jpegll (utils/jpegll)", lambda d: None)]
        for label, patch in routes:
            orig = build.jpegll_decode
            if patch is not None:
                build.jpegll_decode = patch
            try:
                times = []
                for _ in range(1 if patch or name == "jpeg12" else 3):
                    t0 = time.perf_counter()
                    ds = dicom.read_dcm(path, with_pixels=True)
                    times.append(time.perf_counter() - t0)
            finally:
                build.jpegll_decode = orig
            got = np.frombuffer(ds.get("PixelData"), pix.dtype).reshape(pix.shape)
            err = int(np.abs(got.astype(np.int64) - pix.astype(np.int64)).max())
            ms[label], errs[label] = round(1e3 * float(np.median(times)), 3), err
            if exact:
                gate(err == 0, f"{label}: decoded slice differs from the source by {err}")
            elif name == "jpeg12":
                gate(err <= 4, f"{label}: max |err| {err} > 4 at quant 1")
            else:
                mean = float(np.abs(got.astype(np.float64) - pix).mean())
                gate(mean <= 1.0, f"{label}: mean |err| {mean:.3f} > 1 at quality 95")
    print(f"phase 15a decoders ({slice16.shape[0]}x{slice16.shape[1]} 16-bit slice through "
          f"utils.dicom.read_dcm; host library built in {host_build_s:.2f} s): ms per slice "
          f"{ms}, max |err| vs the source {errs}", flush=True)
    return ms


def phase15_ingest_chain(n: int = SESSION_N, device: str = "cuda", workers: int = 8):
    """DICOM -> BIDS -> stage 2 -> stage 3 through the port's three CLIs:
    phase 12's in-vivo session written as nine multi-frame DICOMs, ingested
    by dcm2csv (the in-repo converter: dcm2niix is kept off PATH), then
    qmri_reconstruction (SynthSeg fake) and t2mapping (gaussian) on the
    CSV it wrote; gated on the pixels and geometry written and on the
    simulation's truth. The chain runs in this process with the volume
    cache on, so stage 3 reads stage 2's recons and masks from memory
    (the gates read the files); phase 16's stage-2 runs, each in a fresh
    process, are what hold the file round trip."""
    import contextlib
    import glob
    import io

    from fetal_t2mapping_tpu_torch.cli import dcm2csv, qmri_reconstruction, t2mapping
    from fetal_t2mapping_tpu_torch.utils import ingest, metadata

    t_chain = time.perf_counter()
    acqs, fields = invivo_acquisitions(n)
    with tempfile.TemporaryDirectory(prefix="ft2_smoke_ingest_") as tmp:
        ax = next(v for o, te, v in acqs if o == "ax" and te == SESSION_TES[0])
        slice16 = np.clip(np.rint(ax.data[ax.shape[0] // 2]), 0, 65535).astype(np.uint16)
        os.makedirs(os.path.join(tmp, "decoders"))
        dec_ms = phase15a_decoders(slice16, ax, os.path.join(tmp, "decoders"))

        root = os.path.join(tmp, "qMRI")
        t0 = time.perf_counter()
        session, written = write_dicom_session(root, acqs, workers)
        write_s = time.perf_counter() - t0

        path_env = os.environ.get("PATH", "")
        os.environ["PATH"] = os.pathsep.join(
            d for d in path_env.split(os.pathsep)
            if not os.path.exists(os.path.join(d, "dcm2niix")))
        orig, decode_s = build.jpegll_decode, [0.0, 0]

        def timed_decode(data):
            t = time.perf_counter()
            try:
                return orig(data)
            finally:
                decode_s[0] += time.perf_counter() - t
                decode_s[1] += 1

        build.jpegll_decode = timed_decode
        out = io.StringIO()
        try:
            route = "dcm2niix" if ingest.dcm2niix_available() else "in-repo converter"
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = dcm2csv.main(["--path", session, "--process"])
            ingest_s = time.perf_counter() - t0
        finally:
            build.jpegll_decode = orig
            os.environ["PATH"] = path_env
        gate(rc == 0, f"dcm2csv --process returned {rc}")
        gate(route == "in-repo converter", f"dcm2csv ran {route} with dcm2niix off PATH")
        gate(decode_s[1] == n // 4, f"{decode_s[1]} JPEG-lossless frames decoded, not {n // 4}")

        csv_name = f"{INGEST_DATE}_{INGEST_PARENT}.csv"
        rows = metadata.read_csv(os.path.join(root, "dicom", "logs", csv_name))
        gate([r["run"] for r in rows] == sorted(written), f"runs {[r['run'] for r in rows]}")
        bids = os.path.join(root, "projects/")
        geo_err = [0.0, 0.0]
        for r in rows:
            otype, te, pix, v = written[r["run"]]
            gate((r["EchoTime"], r["ImageOrientationPatientSTR"]) == (te / 1000.0, otype),
                 f"{r['run']}: EchoTime {r['EchoTime']}, orientation "
                 f"{r['ImageOrientationPatientSTR']}")
            got = nifti.read(get_img_path(bids, r, C.IN_DIRNAME))
            gate(got.data.dtype == np.int16 and np.array_equal(got.data, pix),
                 f"{r['run']}: the ingested NIfTI is not the pixel array written")
            gate(np.allclose(got.spacing, v.spacing, atol=1e-6), f"{r['run']}: spacing")
            geo_err[0] = max(geo_err[0], float(np.abs(np.subtract(got.origin, v.origin)).max()))
            geo_err[1] = max(geo_err[1], float(np.abs(got.direction_matrix
                                                      - v.direction_matrix).max()))
        gate(geo_err[0] <= 1e-3 and geo_err[1] <= 1e-6,
             f"ingested affines: origin off by {geo_err[0]:.2e} mm, direction {geo_err[1]:.2e}")

        os.environ["FSLDIR"] = os.path.join(tmp, "no_fsl")      # no atlases: the step skips
        profiler.reset()
        t0 = time.perf_counter()
        rc = qmri_reconstruction.main(["--path", root, "--csv", csv_name, "--in_vivo", "--lf",
                                       "--synthseg", "fake", "--device", device])
        stage2_s = time.perf_counter() - t0
        gate(rc == 0, f"qmri_reconstruction returned {rc}")
        launches0 = profiler.counter("gauss_fit.launches")
        t0 = time.perf_counter()
        rc = t2mapping.main(["--path", root, "--csv", csv_name, "--in_vivo", "--gaussian",
                             "--lf", "--sim", "chain", "--device", device])
        stage3_s = time.perf_counter() - t0
        launches = profiler.counter("gauss_fit.launches") - launches0
        stages = session_stages()
        gate(rc == 0, f"t2mapping returned {rc}")
        gate((launches > 0) == (torch.device(device).type == "cuda"),
             f"the chain's stage 3 launched gauss_fit {launches} times on {device}")
        t2_dir = os.path.dirname(get_img_path(bids, rows[0], C.T2MAP_DIRNAME))
        t2_path, = glob.glob(os.path.join(t2_dir, "*sim-chain_t2map*.nii.gz"))
        errs, t2_err, mask_frac, t2_fit = invivo_gates(bids, rows, fields, n, t2_path)
        gate(bool(np.isfinite(t2_fit).all()), "non-finite values in the chain's T2 map")
    chain_s = time.perf_counter() - t_chain
    card = card_name_and_power_limit() if torch.device(device).type == "cuda" else device
    print(f"phase 15 ingest chain (phase 12's session as 9 multi-frame DICOMs, ax TE "
          f"{SESSION_TES[0]} JPEG-lossless, {n}x{n}x{n // 4} -> {n}^3; dcm2csv route: {route}; "
          f"stage 2 and 3 on {device}): tree write {write_s:.2f} s ({workers} encoder processes), "
          f"ingest {ingest_s:.2f} s (JPEG-lossless decode {decode_s[0]:.3f} s for {decode_s[1]} "
          f"frames), stage 2 {stage2_s:.2f} s, stage 3 {stage3_s:.2f} s, whole chain "
          f"{chain_s:.2f} s (decoders included); ingested NIfTIs equal to the pixels written, "
          f"affines within {geo_err[0]:.2e} mm / {geo_err[1]:.2e}; fused recon median rel err "
          f"{errs}; mask share {mask_frac:.3f}; stage-3 median rel T2 err {t2_err:.4f}; gauss_fit "
          f"launches {launches}; stage seconds {stages}; {card}", flush=True)
    return {"decoders_ms": dec_ms, "write_s": write_s, "ingest_s": ingest_s,
            "stage2_s": stage2_s, "stage3_s": stage3_s, "chain_s": chain_s,
            "launches": launches}


# ------------------------------------------------ the host I/O layer (phase 16)
# the stage-2 entry points on a small synthetic session (ax/cor/sag of an
# n^3 mm field of view, 3 mm slices; two Adam steps per registration level):
# what a warm-up before stage 2 could run
_STAGE2_STEPS = r"""
import numpy as np
import torch
from fetal_t2mapping_tpu_torch.core import Volume
from fetal_t2mapping_tpu_torch.labels.feta import synthseg_to_feta
from fetal_t2mapping_tpu_torch.recon.denoise import denoise_volume
from fetal_t2mapping_tpu_torch.recon.fuse import fuse_orientations
from fetal_t2mapping_tpu_torch.recon.registration import register_rigid_multi
from fetal_t2mapping_tpu_torch.recon.resample import resample_to_reference, resample_volume
def stage2_steps(dev, n):
    rng = np.random.default_rng(0)
    acqs = {}
    for otype, axis in (("ax", 2), ("cor", 1), ("sag", 0)):
        spacing, shape = [1.0, 1.0, 1.0], [n, n, n]
        spacing[axis], shape[2 - axis] = 3.0, n // 3
        acqs[otype] = Volume(rng.integers(0, 1000, shape).astype(np.int16),
                             spacing=tuple(spacing))
    reg = dict(iters=(2, 2, 2))
    st = {}
    def resample():
        st["his"] = {o: resample_volume(v, [1.0] * 3, on_device=True, device=dev)
                     for o, v in acqs.items()}
    def fuse():
        st["fused"] = fuse_orientations(st["his"], "ax", registration_kwargs=reg, device=dev)
    def denoise():
        denoise_volume(st["fused"], device=dev)
    def reg_echo():
        f = st["fused"]
        r = register_rigid_multi(f, [f, f], device=dev, **reg)
        resample_to_reference(f, f, transform=r[0].matrix_device, on_device=True, device=dev)
    def feta():
        lab = (rng.random(st["fused"].shape) > 0.5).astype(np.int16) * 2
        synthseg_to_feta(st["fused"].with_data(torch.from_numpy(lab).to(dev)), device=dev)
    return [("resample", resample), ("fuse", fuse), ("denoise", denoise),
            ("reg_echo", reg_echo), ("feta", feta)]
"""

# qmri_reconstruction.main in a fresh process; FT2_SMOKE_WARMUP (for
# prewarm_study only) first starts a warm-up on a thread of its own:
# "context" (the CUDA context), "cublas" (the context and a cuBLAS matmul)
# or "steps32" (_STAGE2_STEPS at 32^3 on a stream of its own)
_STAGE2_RUN = r"""
import json, os, sys, threading, time
t0 = time.perf_counter()
""" + _STAGE2_STEPS + r"""
from fetal_t2mapping_tpu_torch import graphs
from fetal_t2mapping_tpu_torch.cli import qmri_reconstruction
from fetal_t2mapping_tpu_torch.core import volcache
from fetal_t2mapping_tpu_torch.pipeline import recon_pipeline
from fetal_t2mapping_tpu_torch.utils.profiling import profiler
handles = []
start = recon_pipeline._start_prewarm
def capture(*args, **kwargs):
    handles.append(start(*args, **kwargs))
    return handles[-1]
recon_pipeline._start_prewarm = capture
import_s = time.perf_counter() - t0
def warm(kind, dev):
    if kind in ("context", "cublas"):
        a = torch.ones((32, 32), device=dev)
        if kind == "cublas":
            (a @ a).sum().item()
        return
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        for _, fn in stage2_steps(dev, 32):
            fn()
    torch.cuda.synchronize(dev)
warmup = os.environ.get("FT2_SMOKE_WARMUP")
t0 = time.perf_counter()
if warmup:
    dev = torch.device(sys.argv[sys.argv.index("--device") + 1])
    threading.Thread(target=warm, args=(warmup, dev), daemon=True).start()
rc = qmri_reconstruction.main(sys.argv[1:])
main_s = time.perf_counter() - t0
pending = volcache.n_pending()
h = handles[0] if handles else None
print(json.dumps({"rc": rc, "import_s": import_s, "main_s": main_s, "pending": pending,
                  "stages": profiler.as_dict(), "report": profiler.report(),
                  "graphs": [profiler.counter("graphs.captures"),
                             profiler.counter("graphs.replays"), profiler.counter("host_reads")],
                  "prewarm": None if h is None else {
                      "steps": h.steps, "seconds": h.seconds, "done": h.done,
                      "error": None if h.error is None else repr(h.error)}}))
"""

# what a fresh process pays the first time it touches each piece, against
# the second time: the context, a large allocation, the host library, the
# cuBLAS matmul and batched matmul, then each of _STAGE2_STEPS at argv[2]
# voxels a side
_FIRST_LAUNCH_RUN = r"""
import json, sys, time
t0 = time.perf_counter()
""" + _STAGE2_STEPS + r"""
from fetal_t2mapping_tpu_torch import native
import_s = time.perf_counter() - t0
dev, n = torch.device(sys.argv[1]), int(sys.argv[2])
def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
out = {"import_s": import_s}
def twice(name, fn):
    out[name] = []
    for _ in range(2):
        t = time.perf_counter()
        fn()
        sync()
        out[name].append(time.perf_counter() - t)
twice("context", lambda: torch.zeros(1, device=dev))
twice("alloc_1GiB", lambda: torch.empty(1 << 28, device=dev))
twice("gzio_lib", native.available)
a = torch.ones((32, 32), device=dev)
twice("cublas", lambda: (a @ a, torch.bmm(a[None], a[None])))
for name, fn in stage2_steps(dev, n):
    twice(name, fn)
print(json.dumps(out))
"""

_ATEXIT_RUN = r"""
import sys
import numpy as np, torch
from fetal_t2mapping_tpu_torch.core import Volume, nifti
n = int(sys.argv[2])
x = (torch.arange(n ** 3, device=sys.argv[3], dtype=torch.float32) % 977.0).reshape(n, n, n) * 0.5
nifti.write_async(sys.argv[1] + "/f32.nii.gz", Volume(x))
nifti.write_async(sys.argv[1] + "/i16.nii.gz", Volume(x - 200.0), dtype=np.int16)
print("queued, exiting without a flush", flush=True)
"""

IO_RUNS = {   # run: (environment, extra CLI flags)
    "a": ({"FT2_VOLCACHE": "0", "FT2_ASYNC_WRITES": "0", "FT2_DISABLE_NATIVE": "1"}, []),
    "b": ({}, []),
    "c": ({}, ["--prewarm"]),
}
IO_KNOBS = ("FT2_VOLCACHE", "FT2_VOLCACHE_MB", "FT2_ASYNC_WRITES", "FT2_WRITE_THREADS",
            "FT2_DISABLE_NATIVE", "FT2_SMOKE_WARMUP")


def _stage2_process(root: str, env_extra: dict, flags, device: str) -> dict:
    """qmri_reconstruction.main in a fresh process on ``root``; its JSON
    line (stage seconds, prewarm, writes pending at return) and the
    process's wall time."""
    env = {k: v for k, v in os.environ.items() if k not in IO_KNOBS}
    env.update(env_extra, FSLDIR=os.path.join(root, "no_fsl"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _STAGE2_RUN, "--path", root, "--csv", "smoke.csv",
                          "--in_vivo", "--lf", "--synthseg", "fake", "--device", device, *flags],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    gate(out.returncode == 0, f"stage-2 process {env_extra} {flags} failed ({out.returncode}): "
                              f"{out.stderr[-4000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["wall_s"] = wall
    return res


def first_launch_costs(device: str, n: int = 32) -> dict:
    """_FIRST_LAUNCH_RUN in a fresh process: each piece's first and second
    time, the stage-2 entry points at n^3."""
    out = subprocess.run([sys.executable, "-c", _FIRST_LAUNCH_RUN, device, str(n)],
                         cwd=REPO, capture_output=True, text=True, timeout=600,
                         env={k: v for k, v in os.environ.items() if k not in IO_KNOBS})
    gate(out.returncode == 0, f"first-launch process failed: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def prewarm_study(n: int = SESSION_N, device: str = "cuda",
                  order=("b", "context", "context", "b", "b", "context", "context", "b")):
    """Stage 2 of phase 16's session in fresh processes, in turns: the
    defaults (b) against a warm-up started on a thread of its own just
    before the stage (FT2_SMOKE_WARMUP in _STAGE2_RUN: "context", "cublas"
    or "steps32"), and the first-launch costs of a fresh process: the
    measurement behind utils/prewarm, which runs no step. Not part of
    main(): run it as ``python3 -c "import chip_smoke; chip_smoke.prewarm_study()"``."""
    acqs, _ = invivo_acquisitions(n)
    acqs = [(o, te, v.with_data(np.clip(np.rint(v.data), 0, 65535).astype(np.int16)))
            for o, te, v in acqs]
    times = {k: [] for k in order}
    costs = first_launch_costs(device)
    print(f"prewarm study first-launch costs (s): {json.dumps(costs)}", flush=True)
    with tempfile.TemporaryDirectory(prefix="ft2_smoke_pw_") as tmp:
        src = os.path.join(tmp, "src")
        _write_invivo_session(src, n, acqs=acqs)
        set_metadata(os.path.join(src, "dicom/logs/"), ["smoke.csv"], low_field=True)
        for i, key in enumerate(order):
            root = os.path.join(tmp, f"{key}{i}")
            shutil.copytree(src, root)
            r = _stage2_process(root, {} if key == "b" else {"FT2_SMOKE_WARMUP": key}, [],
                                device)
            times[key].append(round(r["main_s"], 3))
            print(f"prewarm study run {i} {key}: main {r['main_s']:.3f} s, stages "
                  f"{json.dumps({k: round(v['seconds'], 3) for k, v in sorted(r['stages'].items()) if k.startswith(('recon.', 'fuse.'))})}",
                  flush=True)
            shutil.rmtree(root)
    card = card_name_and_power_limit() if torch.device(device).type == "cuda" else device
    print(f"prewarm study ({n}^3, stage 2 main seconds): {times}; {card}", flush=True)
    return times, costs


def _payload_digests(root: str) -> dict:
    """{path under root: sha256 of the decompressed file} of every NIfTI
    under root/projects: header and voxels, not the gzip framing."""
    import hashlib

    from fetal_t2mapping_tpu_torch import native

    paths = sorted(os.path.join(d, f) for d, _, fs in os.walk(os.path.join(root, "projects"))
                   for f in fs if f.endswith(".nii.gz"))
    with ThreadPoolExecutor(max_workers=8) as ex:
        digests = ex.map(lambda p: hashlib.sha256(native.read_file(p)).hexdigest(), paths)
        return {os.path.relpath(p, root): d for p, d in zip(paths, digests)}


def _differing(a: dict, b: dict) -> list:
    return sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))


def phase16_io_layer(n: int = SESSION_N, device: str = "cuda"):
    """Stage 2 through the host I/O layer, each run a fresh process on its
    own copy of one int16 BIDS tree at n^3: (a) FT2_VOLCACHE=0
    FT2_ASYNC_WRITES=0 FT2_DISABLE_NATIVE=1 (synchronous stdlib gzip, the
    previous behaviour), (b) the defaults (volume cache, writer pool,
    native gzip), (c) the defaults with --prewarm. First, in another fresh
    process, what the context, the cuBLAS handle and each stage-2 entry
    point cost the first time against the second (first_launch_costs).
    Gates: equal trees (decompressed payloads; where (a) is not
    reproducible against itself, the differing files are held to phase
    12's gates instead), no write pending at return, (c)'s prewarm
    finished with no step and no error (utils/prewarm runs none), stage 3
    on (b)'s tree against the truth, and the exit of a process with
    queued CUDA writes. (b) and (c) run the same device code, so their
    times are printed, not compared (prewarm_study measures warm-ups)."""
    from fetal_t2mapping_tpu_torch.cli import t2mapping

    acqs, fields = invivo_acquisitions(n)
    acqs = [(o, te, v.with_data(np.clip(np.rint(v.data), 0, 65535).astype(np.int16)))
            for o, te, v in acqs]                   # the inputs phase 15's ingest writes
    runs, digests = {}, {}
    with tempfile.TemporaryDirectory(prefix="ft2_smoke_io_") as tmp:
        src = os.path.join(tmp, "src")
        _write_invivo_session(src, n, acqs=acqs)
        rows = set_metadata(os.path.join(src, "dicom/logs/"), ["smoke.csv"], low_field=True)
        costs = first_launch_costs(device)
        for key, (env_extra, flags) in IO_RUNS.items():
            root = os.path.join(tmp, key)
            shutil.copytree(src, root)
            runs[key] = _stage2_process(root, env_extra, flags, device)
            gate(runs[key]["rc"] == 0 and runs[key]["pending"] == 0,
                 f"run {key}: rc {runs[key]['rc']}, {runs[key]['pending']} writes pending")
            digests[key] = _payload_digests(root)
        pw = runs["c"]["prewarm"]
        gate(pw is not None and pw["done"] and pw["error"] is None and pw["steps"] == [],
             f"run c's prewarm: {pw}")
        gate(runs["a"]["prewarm"] is None and runs["b"]["prewarm"] is None,
             "a prewarm ran without --prewarm")
        gate(len(digests["a"]) == 33, f"{len(digests['a'])} NIfTIs in run a's tree, not 33")
        differ = {k: _differing(digests["a"], digests[k]) for k in IO_RUNS if k != "a"}
        repeat = None
        if any(differ.values()):
            # registration sums in floating point on the card: first show
            # whether (a) differs from itself
            root = os.path.join(tmp, "a2")
            shutil.copytree(src, root)
            _stage2_process(root, *IO_RUNS["a"], device)
            repeat = _differing(digests["a"], _payload_digests(root))
            gate(bool(repeat), f"run a repeats bitwise, yet the defaults differ on {differ}")
            for key in ("a2",) + tuple(differ):
                invivo_gates(os.path.join(tmp, key, "projects/"), rows, fields, n, None)

        profiler.reset()
        launches0 = profiler.counter("gauss_fit.launches")
        t0 = time.perf_counter()
        rc = t2mapping.main(["--path", os.path.join(tmp, "b"), "--csv", "smoke.csv", "--in_vivo",
                             "--gaussian", "--lf", "--sim", "io", "--device", device])
        stage3_s = time.perf_counter() - t0
        launches = profiler.counter("gauss_fit.launches") - launches0
        gate(rc == 0 and volcache.n_pending() == 0,
             f"t2mapping returned {rc}, {volcache.n_pending()} writes pending")
        gate((launches > 0) == (torch.device(device).type == "cuda"),
             f"stage 3 launched gauss_fit {launches} times on {device}")
        bids_b = os.path.join(tmp, "b", "projects/")
        t2_dir = os.path.dirname(get_img_path(bids_b, rows[0], C.T2MAP_DIRNAME))
        t2_path = os.path.join(t2_dir, next(f for f in os.listdir(t2_dir) if "sim-io_t2map" in f))
        errs, t2_err, mask_frac, _ = invivo_gates(bids_b, rows, fields, n, t2_path)
        stage3_stages = {k: round(v["seconds"], 3) for k, v in profiler.as_dict().items()
                         if k.startswith(("t2map.", "io."))}

        out_dir = os.path.join(tmp, "atexit")
        os.makedirs(out_dir)
        m = n
        out = subprocess.run([sys.executable, "-c", _ATEXIT_RUN, out_dir, str(m), device], cwd=REPO,
                             capture_output=True, text=True, timeout=300,
                             env={k: v for k, v in os.environ.items() if k not in IO_KNOBS})
        gate(out.returncode == 0, f"the exiting writer failed: {out.stderr[-3000:]}")
        x = ((np.arange(m ** 3, dtype=np.float32) % 977.0) * 0.5).reshape(m, m, m)
        for name, want in (("f32", x), ("i16", nifti._cast_for_disk(x - 200.0, np.int16))):
            got = nifti.read(os.path.join(out_dir, f"{name}.nii.gz")).data
            gate(got.dtype == want.dtype and np.array_equal(got, want),
                 f"atexit: {name}.nii.gz is not the volume queued before the exit")

    card = card_name_and_power_limit() if torch.device(device).type == "cuda" else device
    keep = ("recon.", "io.", "fuse.")
    for key in IO_RUNS:
        r = runs[key]
        stages = {k: round(v["seconds"], 3) for k, v in sorted(r["stages"].items())
                  if k.startswith(keep)}
        print(f"phase 16 run {key} {IO_RUNS[key]}: process wall {r['wall_s']:.2f} s (imports "
              f"{r['import_s']:.2f} s, qmri_reconstruction.main {r['main_s']:.2f} s), writes "
              f"pending at return {r['pending']}, prewarm {r['prewarm']}; graphs captured / "
              f"replayed / host reads {tuple(r['graphs'])}; stage seconds {stages}", flush=True)
    print("phase 16 run b profiler.report():\n" + runs["b"]["report"], flush=True)
    print(f"phase 16 first-launch costs (s, first and second time in a fresh process; the "
          f"stage-2 entry points at 32^3): {json.dumps(costs)}", flush=True)
    print(f"phase 16 io layer ({n}^3 in-vivo session, int16 inputs, 3 TEs x ax/cor/sag, stage 2 "
          f"in fresh processes on {device}): stage 2 (main) a {runs['a']['main_s']:.2f} s, b "
          f"{runs['b']['main_s']:.2f} s, c {runs['c']['main_s']:.2f} s (b/a "
          f"{runs['b']['main_s'] / runs['a']['main_s']:.3f}, c/b "
          f"{runs['c']['main_s'] / runs['b']['main_s']:.3f}); trees: {len(digests['a'])} NIfTIs, payloads differing from a: "
          f"{ {k: len(v) for k, v in differ.items()} }"
          f"{'' if repeat is None else f', a against a repeat of a {len(repeat)} ({repeat})'}; "
          f"prewarm steps {pw['steps']} in {pw['seconds']:.2f} s; stage 3 (t2mapping --gaussian "
          f"on b's tree) {stage3_s:.2f} s, gauss_fit launches {launches}, stage seconds "
          f"{stage3_stages}; fused recon median rel err {errs}; mask share {mask_frac:.3f}; "
          f"median rel T2 err {t2_err:.4f}; atexit: two queued {m}^3 {device} writes complete "
          f"after the exit; {card}", flush=True)
    return {k: r["main_s"] for k, r in runs.items()}


# ------------------------------------------------ the voxel mesh and 'twophase' (phase 17)
def smoke_mesh(dev: torch.device):
    """Two cards when two are visible, else ``dev`` twice (two shards on two
    streams of one card, or two CPU shards): (mesh, description)."""
    from fetal_t2mapping_tpu_torch.parallel import voxel_mesh

    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        return voxel_mesh(2), "two cards"
    return voxel_mesh(devices=[dev, dev]), f"{dev} twice (two streams)"


def host_overflow(conv1: np.ndarray, bc: int, frac: float, rounds: int):
    """The rows a 'twophase' fit of one batch leaves unrefit, from its
    phase-1 flags ``conv1``: unconverged rows of the blocks of ``bc`` rows
    past the first rounds * cap_b blocks that hold one, in block order."""
    n = conv1.size
    nbk = -(-n // bc)
    c = np.ones(nbk * bc, bool)
    c[:n] = conv1
    quantum = 128 // math.gcd(bc, 128)
    cap_b = max(quantum, -(-int(nbk * frac) // quantum) * quantum)
    left = np.zeros(nbk, bool)
    left[np.flatnonzero(~c.reshape(nbk, bc).all(1))[rounds * cap_b:]] = True
    return np.repeat(left, bc)[:n] & ~conv1


def phase17_mesh(device: str = "cuda", n_fit: int = N_HEADLINE3, n_session: int = 240,
                 n_reg: int = 192, n_seg: int = 160, n_batch: int = 2 ** 18):
    """The port's mesh and 'twophase' paths. The mesh is two cards when two
    are visible, else cuda:0 twice (two shards on two streams of one card).
    (a) fit_fused_sharded at n_fit x 3 TEs per model against fit_fused:
    bitwise; (b) fit_fused(strategy='twophase') (and its sharded form) per
    model: bitwise equal to 'single' on every voxel but the overflow, at the
    default tail_frac and at a starved one, n_overflow equal to the count
    recomputed on the host from the phase-1 flags, > 0 when starved;
    (c) process_t2maps(mesh=) on phase 4's session: maps equal to the
    single-device run's; (d) register_rigid(mesh=) on phase 11's scene:
    within 5e-3 rad / 0.3 mm of single at a fixed budget, the recovery
    gate at the defaults, ms and launches; (e) segment_volume(mesh=) at
    n_seg^3 with phase 9's weights (fp32, TF32 off): labels equal to the
    unsharded forward's; (f) mesh_from_flag(device_count() + 1) raises;
    (g) the batch solvers over the mesh (mesh_batch_solvers).
    Returns (per-model ms and launches of (a)/(b), registration ms)."""
    from fetal_t2mapping_tpu_torch.parallel import fit_fused_sharded, mesh_from_flag
    from fetal_t2mapping_tpu_torch.recon import registration

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    mesh, mesh_kind = smoke_mesh(dev)

    def same(a, b, keep=None):
        fields = [(a.x, b.x), (a.fun, b.fun), (a.converged, b.converged), (a.n_iter, b.n_iter)]
        if keep is None:
            return all(torch.equal(u, v) for u, v in fields)
        return all(torch.equal(u[keep], v[keep]) for u, v in fields)

    fits = {"gaussian": (TES3, LO, HI, None, {}),
            "gaussian_rician": (TES3, LO3, HI3, GUESS3, TOL3),
            "rician": (TES3, LO3, HI3, GUESS3, TOL3)}
    starved_frac = 1e-4
    rows, fit_line = {}, []
    for model, (tes, lo, hi, guess, tol) in fits.items():
        if model == "gaussian":
            sig = make_data(n_fit, tes, seed=0)[0]
        else:
            sig = make_data3(n_fit, tes, seed=0)[0]
        s = torch.from_numpy(sig).to(dev)
        kw = dict(model=model, guess=guess, max_iters=60, **tol)
        counts0 = launches_since()
        single = fused_fit.fit_fused(s, tes, lo, hi, device=dev, **kw)
        launches_single = {c: n for c, n in launches_since(counts0).items() if n}
        counts0 = launches_since()
        sharded = fit_fused_sharded(s, tes, lo, hi, mesh, **kw)
        launches_sharded = {c: n for c, n in launches_since(counts0).items() if n}
        gate(bool(launches_single) and bool(launches_sharded) or not cuda,
             f"{model}: no fit kernel launched ({launches_single}, {launches_sharded})")
        gate(same(single, sharded), f"(a) {model}: fit_fused_sharded differs from fit_fused")
        gate(sharded.n_overflow == 0, f"(a) {model}: sharded 'single' n_overflow {sharded.n_overflow}")
        tail_block = fused_fit.resolve_tail_block(None, model)
        conv1 = fused_fit.fit_fused(s, tes, lo, hi, device=dev, **dict(kw, max_iters=10)) \
            .converged.cpu().numpy()
        tp_rows = {}
        for label, frac in (("default", None), ("starved", starved_frac)):
            counts0 = launches_since()
            tp = fused_fit.fit_fused(s, tes, lo, hi, device=dev, strategy="twophase",
                                     tail_frac=frac, **kw)
            launches_tp = {c: n for c, n in launches_since(counts0).items() if n}
            gate(bool(launches_tp) or not cuda, f"(b) {model} {label}: no fit kernel launched")
            over = host_overflow(conv1, tail_block,
                                 fused_fit.resolve_tail_frac(frac, tail_block), 2)
            keep = torch.from_numpy(~over).to(dev)
            gate(int(tp.n_overflow) == int(over.sum()),
                 f"(b) {model} {label}: n_overflow {int(tp.n_overflow)}, host {int(over.sum())}")
            gate(same(single, tp, keep), f"(b) {model} {label}: twophase differs from 'single' "
                                         "on a handled voxel")
            tps = fit_fused_sharded(s, tes, lo, hi, mesh, strategy="twophase", tail_frac=frac, **kw)
            m = n_fit // mesh.size
            over_s = np.concatenate([host_overflow(conv1[i * m:(i + 1) * m], tail_block,
                                                   fused_fit.resolve_tail_frac(frac, tail_block), 2)
                                     for i in range(mesh.size)])
            gate(int(tps.n_overflow) == int(over_s.sum()),
                 f"(b) {model} {label} sharded: n_overflow {int(tps.n_overflow)}, host "
                 f"{int(over_s.sum())}")
            gate(same(single, tps, torch.from_numpy(~over_s).to(dev)),
                 f"(b) {model} {label}: sharded twophase differs from 'single' on a handled voxel")
            tp_rows[label] = (int(tp.n_overflow), launches_tp)
        gate(tp_rows["starved"][0] > 0, f"(b) {model}: a starved tail_frac left n_overflow 0")
        if cuda:
            t_single = cuda_ms(lambda: fused_fit.fit_fused(s, tes, lo, hi, device=dev, sync=False,
                                                           **kw), 3)
            t_sharded = cuda_ms(lambda: fit_fused_sharded(s, tes, lo, hi, mesh, sync=False,
                                                          **kw), 3)
            t_tp = cuda_ms(lambda: fused_fit.fit_fused(s, tes, lo, hi, device=dev, sync=False,
                                                       strategy="twophase", **kw), 3)
        else:
            t_single = t_sharded = t_tp = float("nan")
        rows[model] = dict(single_ms=t_single, sharded_ms=t_sharded, twophase_ms=t_tp,
                           launches_single=launches_single, launches_sharded=launches_sharded,
                           launches_twophase=tp_rows["default"][1],
                           n_overflow=tp_rows["default"][0], n_overflow_starved=tp_rows["starved"][0])
        fit_line.append(f"{model}: single {t_single:.3f} ms {launches_single}, sharded "
                        f"{t_sharded:.3f} ms {launches_sharded}, twophase {t_tp:.3f} ms "
                        f"{tp_rows['default'][1]} n_overflow {tp_rows['default'][0]} (tail_frac "
                        f"{starved_frac:g}: {tp_rows['starved'][0]})")
        del s, single, sharded

    # (c) process_t2maps over phase 4's session, single and on the mesh
    with tempfile.TemporaryDirectory(prefix="ft2_smoke_mesh_") as root:
        bids, logs, mask, _, _, _ = _write_session(root, n_session, seed=11)
        rows_md = set_metadata(logs, ["smoke.csv"], low_field=True)
        cfg = C.fit_config("gaussian", low_field=True)
        maps = {}
        for sim, m_ in (("single", None), ("mesh", mesh)):
            launches0 = profiler.counter("gauss_fit.launches")
            t0 = time.perf_counter()
            summ = process_t2maps(rows_md, bids, list(TES_SESSION), cfg, sim=sim,
                                  make_plots=False, mesh=m_, device=dev)
            maps[sim] = ({k: np.asarray(nifti.read(p).data) for k, p in summ[0]["maps"].items()},
                         time.perf_counter() - t0,
                         profiler.counter("gauss_fit.launches") - launches0)
        for k, v in maps["single"][0].items():
            gate(np.array_equal(v, maps["mesh"][0][k], equal_nan=True),
                 f"(c) process_t2maps(mesh=) map {k} differs from the single-device map")
        gate(maps["mesh"][2] == mesh.size or not cuda,
             f"(c) the mesh session launched gauss_fit {maps['mesh'][2]} times")

    # (d) the rigid registration of phase 11's scene
    center = np.full(3, (n_reg - 1) / 2.0)
    T1 = rigid_matrix(0.05, -0.04, 0.04, [4.0, -3.0, 3.0], center)
    fixed = Volume(blob_scene(n_reg, np.eye(4), dev))
    moving = Volume(blob_scene(n_reg, T1, dev))
    fixed_budget = dict(metric="ncc", stop_tol=None)
    r1 = registration.register_rigid(fixed, moving, device=dev, **fixed_budget)
    r2 = registration.register_rigid(fixed, moving, mesh=mesh, **fixed_budget)
    d_rot = float(np.abs(r2.matrix[:3, :3] - r1.matrix[:3, :3]).max())
    d_tr = float(np.abs(r2.matrix[:3, 3] - r1.matrix[:3, 3]).max())
    gate(d_rot <= 5e-3 and d_tr <= 0.3, f"(d) sharded vs single rigid: {d_rot:.2e} / {d_tr:.3f} mm "
                                        "(5e-3, 0.3 mm)")
    reg_ms, res = timed_solves(lambda: registration.register_rigid(fixed, moving, metric="ncc",
                                                                   mesh=mesh))
    single_ms, _ = timed_solves(lambda: registration.register_rigid(fixed, moving, metric="ncc",
                                                                    device=dev))
    rot, tr = pose_error(T1, res.matrix, center)
    gate(rot < 0.01 and tr < 0.5, f"(d) mesh rigid recovery {rot:.4f} rad / {tr:.3f} mm")
    launches = "not measured"
    if cuda:
        try:
            from torch.profiler import ProfilerActivity, profile

            _sync()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                registration.register_rigid(fixed, moving, metric="ncc",
                                            mesh=mesh).params_device.sum().item()
            launches = sum(e.count for e in prof.key_averages()
                           if str(getattr(e, "device_type", "")).endswith("CUDA"))
        except Exception as exc:   # the profiler is untried on this machine: report, do not fail
            launches = f"profiler unavailable ({type(exc).__name__})"
    del fixed, moving

    # (e) the U-Net at n_seg^3, fp32 (TF32 off), phase 9's weights and head
    full_fp32()
    params = unet3d.random_params(unet3d.UNetConfig(batch_norm=True), seed=0)
    vol = brain_volume(n_seg, seed=21)
    seg = {}
    for name, m_ in (("single", None), ("mesh", mesh)):
        launches0 = profiler.counter("conv_s2d.launches")
        for _ in range(2):          # the second call is timed: weights on the card
            _sync()
            t0 = time.perf_counter()
            seg[name] = unet3d.segment_volume(params, vol, use_s2d=False,
                                              compute_dtype=torch.float32, mesh=m_, device=dev)
            seg[name + "_s"] = time.perf_counter() - t0
    gate(np.array_equal(seg["single"], seg["mesh"]),
         f"(e) segment_volume(mesh=) labels differ from unsharded on "
         f"{int((seg['single'] != seg['mesh']).sum())} voxels")
    gate(profiler.counter("conv_s2d.launches") == launches0,
         "(e) the mesh forward launched conv_s2d")

    # (f) more devices than are visible
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    try:
        mesh_from_flag(max(2, visible + 1))
        raised = ""
    except ValueError as exc:
        raised = str(exc)
    gate(f"only {visible} CUDA device(s)" in raised, f"(f) mesh_from_flag: {raised!r}")

    batch_line = mesh_batch_solvers(mesh, dev, n_batch)

    card = card_name_and_power_limit() if cuda else device
    print(f"phase 17 mesh ({mesh_kind}: {mesh}; 'twophase' phase1_iters 10, tail_rounds 2): (a)+(b) "
          f"at {n_fit} voxels x 3 TEs, bitwise to 'single' but the overflow, n_overflow = host "
          f"count: {'; '.join(fit_line)}; (c) process_t2maps {n_session}^3 single "
          f"{maps['single'][1]:.3f} s, mesh {maps['mesh'][1]:.3f} s (gauss_fit launches "
          f"{maps['mesh'][2]}), maps equal; (d) register_rigid {n_reg}^3 ncc mesh median "
          f"{reg_ms:.1f} ms (single {single_ms:.1f} ms), launches per mesh solve {launches}, "
          f"recovery {rot:.5f} rad / {tr:.4f} mm, fixed budget mesh vs single {d_rot:.2e} / "
          f"{d_tr:.4f} mm; (e) segment_volume {n_seg}^3 fp32 single {seg['single_s']:.3f} s, "
          f"mesh {seg['mesh_s']:.3f} s, labels equal; (f) {raised!r}; (g) {batch_line}; {card}",
          flush=True)
    return rows, reg_ms


def mesh_batch_solvers(mesh, dev: torch.device, n: int) -> str:
    """(g) the batch solvers over the mesh, each shard's fit_batch as its
    replayed graph: fit_batch_sharded (gaussian, log-linear start) and
    fit_batch_multistart_sharded (rician, log-linear, grid and guess
    starts) at n voxels, bitwise against the one-device call; graphs
    captured / replayed / host reads of the sharded call."""
    from fetal_t2mapping_tpu_torch.models import init, solver
    from fetal_t2mapping_tpu_torch.parallel import (fit_batch_multistart_sharded,
                                                     fit_batch_sharded)

    parts = []
    for model, tes, lo, hi in (("gaussian", TES3, LO, HI), ("rician", TES3, LO3, HI3)):
        make = make_data if model == "gaussian" else make_data3
        sig = torch.from_numpy(make(n, tes, seed=5)[0]).to(dev)
        x0 = init.loglinear_init(sig, tes, lo, hi)
        kw = dict(model=model, max_iters=60, ftol=1e-9, gtol=0.0)
        if model == "gaussian":
            single = solver.fit_batch(sig, tes, x0, lo, hi, **kw)
            before = graph_counts()
            sharded = fit_batch_sharded(sig, tes, x0, lo, hi, mesh, **kw)
        else:
            x0s = torch.stack([x0, init.grid_init(sig, tes, lo, hi),
                               torch.as_tensor(GUESS3, dtype=torch.float32, device=dev)
                               .clamp(torch.as_tensor(lo, device=dev),
                                      torch.as_tensor(hi, device=dev)).expand_as(x0)])
            single = solver.fit_batch_multistart(sig, tes, x0s, lo, hi, **kw)
            before = graph_counts()
            sharded = fit_batch_multistart_sharded(sig, tes, x0s, lo, hi, mesh, **kw)
        counts = counts_since(before)
        gate(all(same_bits(getattr(single, f), getattr(sharded, f))
                 for f in ("x", "fun", "converged", "n_iter")),
             f"(g) {model}: the sharded batch solver differs from one device")
        gate(counts[0] == mesh.size or dev.type != "cuda",
             f"(g) {model}: {counts} graphs captured / replayed / host reads over {mesh.size} shards")
        parts.append(f"{'fit_batch_sharded gaussian' if model == 'gaussian' else 'fit_batch_multistart_sharded rician'} "
                     f"{n} voxels, bitwise to one device, graphs captured / replayed / host reads "
                     f"{counts}")
    return "; ".join(parts)


# ------------------------------------------------ fit_volume over a mesh, the entry module
# and the examples (phase 18)
def volume_fit_rows(mask: np.ndarray, compact: bool, mask_frac: float, block: int) -> np.ndarray:
    """The voxel (flat index) each row of fit_volume's fit batch holds, -1
    for a filler row, recomputed on the host from the layout's rules: the
    first ``_block_capacity`` blocks of ``block`` voxels that hold a masked
    voxel, in block order, at ``mask_frac``'s capacity, or without
    ``compact`` at a capacity of every block."""
    from fetal_t2mapping_tpu_torch.models.volume_fit import _block_capacity

    flat = np.asarray(mask, bool).reshape(-1)
    n = flat.size
    if not compact:
        mask_frac = 1.0
    n_pad = -(-n // block) * block
    sel = np.zeros(n_pad, bool)
    sel[:n] = flat
    kept = np.flatnonzero(sel.reshape(-1, block).any(1))[:_block_capacity(n, mask_frac, block)]
    rows = np.full((_block_capacity(n, mask_frac, block), block), -1)
    idx = kept[:, None] * block + np.arange(block)
    rows[:kept.size] = np.where(sel[idx], idx, -1)
    return rows.reshape(-1)


def volume_twophase_left(rows: np.ndarray, conv1: np.ndarray, shards: int, n_fit: int,
                         bc: int, frac: float, rounds: int = 2) -> np.ndarray:
    """The masked voxels a 'twophase' fit_volume leaves unrefit: ``rows``
    (volume_fit_rows) padded with filler to ``n_fit`` rows, split into
    ``shards`` contiguous shards that each run their own rounds, from the
    phase-1 flags ``conv1`` (flat, per voxel; a filler row converges in
    phase 1). Returns a flat bool map."""
    r = np.full(n_fit, -1)
    r[:rows.size] = rows
    conv = np.ones(n_fit, bool)
    conv[r >= 0] = conv1[r[r >= 0]]
    m = n_fit // shards
    over = np.concatenate([host_overflow(conv[i * m:(i + 1) * m], bc, frac, rounds)
                           for i in range(shards)])
    left = np.zeros(conv1.size, bool)
    left[r[over & (r >= 0)]] = True
    return left


def _peak_mib(fn, dev):
    """(result, peak bytes allocated on ``dev`` during fn, in MiB; nan on the CPU)."""
    if dev.type != "cuda":
        return fn(), float("nan")
    _sync()
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    _sync()
    return out, torch.cuda.max_memory_allocated(dev) / 2 ** 20


def phase18a_serving_mesh(n: int = SERVING_N, device: str = "cuda"):
    """The 240^3 serving request (bench.py:431-440, phase 13's 22% mask)
    per model through fit_volume(mesh=) on phase 17's mesh: each layout's
    every map and count bitwise equal to the single-device call; a starved
    mask_frac gives the same n_overflow > 0; 'twophase' per layout: every
    voxel its rounds handle bitwise equal to 'single', n_overflow equal to
    the host count from the phase-1 flags; ms per request single and mesh,
    kernel launches per mesh request (one per shard) and peak memory."""
    from fetal_t2mapping_tpu_torch.models import volume_fit
    from fetal_t2mapping_tpu_torch.parallel import pad_to_devices

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    mesh, mesh_kind = smoke_mesh(dev)
    fields = volume_fit.VolumeFitResult._fields
    starved = 0.05
    lines, rows_out = [], {}
    for fit_name in ("gaussian", "gaussian_rician", "rician"):
        fit = SERVING_FITS[fit_name]
        lo, hi = fit["lo"], fit["hi"]
        kw = dict(model=fit["model"], guess=fit["guess"], ftol=fit["ftol"], gtol=fit["gtol"],
                  varpro3=fit["varpro3"], check_capacity=False)
        sig, mask, t2 = serving_request(n, 1.0, seed=21, device=device)
        mask_np = mask.cpu().numpy()
        n_mask = int(mask_np.sum())
        # phase 13's rule, 6% over the touched blocks: 0.30 at 240^3
        mask_frac = math.ceil(106 * touched_blocks(mask) * 32 / mask.numel()) / 100
        conv1 = volume_fit.fit_volume(sig, mask, TES3, lo, hi, mask_frac=mask_frac,
                                      max_iters=10, device=dev, **kw).converged
        conv1 = conv1.cpu().numpy().reshape(-1)
        bc = fused_fit.resolve_tail_block(None, fit["model"])
        per_layout = {}
        for lay, lk in LAYOUTS.items():
            call_kw = dict(kw, mask_frac=mask_frac, **lk)
            single, peak_s = _peak_mib(lambda: volume_fit.fit_volume(
                sig, mask, TES3, lo, hi, device=dev, **call_kw), dev)
            counts0 = launches_since()
            meshed, peak_m = _peak_mib(lambda: volume_fit.fit_volume(
                sig, mask, TES3, lo, hi, mesh=mesh, **call_kw), dev)
            counts = {c: n for c, n in launches_since(counts0).items() if n}
            want = {c: mesh.size for c in fit["kernels"]} if cuda else {}
            gate(counts == want, f"(a) {fit_name} {lay}: launches per mesh request {counts}, "
                 f"expected {want}")
            for f in fields:
                gate(torch.equal(getattr(single, f), getattr(meshed, f)),
                     f"(a) {fit_name} {lay}: fit_volume(mesh=) {f} differs from one device")
            gate(int(meshed.n_masked) == n_mask and int(meshed.n_overflow) == 0,
                 f"(a) {fit_name} {lay}: n_masked {int(meshed.n_masked)} ({n_mask}), n_overflow "
                 f"{int(meshed.n_overflow)}")
            over = {}
            if lk.get("compact"):
                s_kw = dict(kw, mask_frac=starved, **lk)
                a = volume_fit.fit_volume(sig, mask, TES3, lo, hi, device=dev, **s_kw)
                b = volume_fit.fit_volume(sig, mask, TES3, lo, hi, mesh=mesh, **s_kw)
                over = dict(single=int(a.n_overflow), mesh=int(b.n_overflow))
                gate(over["single"] == over["mesh"] > 0,
                     f"(a) {fit_name} {lay}: starved n_overflow {over}")
                gate(all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields),
                     f"(a) {fit_name} {lay}: starved fit_volume(mesh=) differs from one device")
            rows = volume_fit_rows(mask_np, bool(lk.get("compact")), mask_frac,
                                   lk.get("block", 32))
            tp_over = {}
            for label, tail_frac in (("default", None), ("starved", 1e-4)):
                tp = volume_fit.fit_volume(sig, mask, TES3, lo, hi, mesh=mesh, strategy="twophase",
                                           tail_frac=tail_frac, **call_kw)
                left = volume_twophase_left(rows, conv1, mesh.size,
                                            pad_to_devices(rows.size, mesh), bc,
                                            fused_fit.resolve_tail_frac(tail_frac, bc))
                gate(int(tp.n_overflow) == int(left.sum()),
                     f"(a) {fit_name} {lay} twophase {label}: n_overflow {int(tp.n_overflow)}, "
                     f"host {int(left.sum())}")
                keep = torch.from_numpy(mask_np & ~left.reshape(mask_np.shape)).to(dev)
                for f in VF_MAPS:
                    gate(torch.equal(getattr(tp, f)[keep], getattr(single, f)[keep]),
                         f"(a) {fit_name} {lay} twophase {label}: {f} differs from 'single' on "
                         "a handled voxel")
                tp_over[label] = int(tp.n_overflow)
            if cuda:
                ms_s = serving_ms(lambda: volume_fit.fit_volume(sig, mask, TES3, lo, hi,
                                                                device=dev, **call_kw))
                ms_m = serving_ms(lambda: volume_fit.fit_volume(sig, mask, TES3, lo, hi,
                                                                mesh=mesh, **call_kw))
            else:
                ms_s = ms_m = float("nan")
            per_layout[lay] = dict(single_ms=ms_s, mesh_ms=ms_m, launches=counts,
                                   peak_mib_single=peak_s, peak_mib_mesh=peak_m,
                                   starved_n_overflow=over, twophase_n_overflow=tp_over)
            del single, meshed, tp
        rows_out[fit_name] = per_layout
        lines.append(f"{fit_name}: " + ", ".join(
            f"{lay} single {r['single_ms']:.3f} ms / mesh {r['mesh_ms']:.3f} ms, launches "
            f"{r['launches']}, peak {r['peak_mib_single']:.0f} / {r['peak_mib_mesh']:.0f} MiB, "
            f"starved mask_frac n_overflow {r['starved_n_overflow'] or '-'}, twophase "
            f"n_overflow {r['twophase_n_overflow']}" for lay, r in per_layout.items()))
        del sig, mask, t2
    card = card_name_and_power_limit() if cuda else device
    print(f"phase 18a fit_volume(mesh=) ({mesh_kind}: {mesh}; {n}^3 x 3 TEs, {n_mask} masked "
          f"voxels, mask_frac {mask_frac}, starved {starved}; twophase at the default tail_frac "
          f"and 1e-4; 3 rounds of 4 requests; every map and count bitwise equal to one device, "
          f"twophase bitwise on handled voxels, n_overflow = host count): " + "; ".join(lines) + f"; {card}", flush=True)
    return rows_out


def phase18b_entry(device: str = "cuda"):
    """entry() on ``device``: converged >= 0.9, and x within the gaussian
    band (1e-3 of max(1, |x|)) of the same call on the CPU on the voxels
    converged on both and identifiable (noiseless last echo >= 3 sigma;
    example_batch's k and T2 redrawn from its seed)."""
    from fetal_t2mapping_tpu_torch.entry import entry

    fn, args = entry(device=device)
    t0 = time.perf_counter()
    x, conv, res = fn(*args)
    _sync()
    card_s = time.perf_counter() - t0
    fn_c, args_c = entry(device="cpu")
    x_c, conv_c, res_c = fn_c(*args_c)
    rng = np.random.default_rng(0)
    k = rng.uniform(600.0, 5000.0, 4096)
    t2 = rng.uniform(20.0, 500.0, 4096)
    ident = k * np.exp(-TES3[-1] / t2) >= 30.0
    x, conv = x.cpu().numpy(), conv.cpu().numpy()
    both = conv & conv_c.numpy() & ident
    rel = np.abs(x - x_c.numpy()) / np.maximum(np.abs(x_c.numpy()), 1.0)
    gate(tuple(x.shape) == (4096, 2) and bool(np.isfinite(res.cpu().numpy()).all()),
         f"(b) entry: x {x.shape}, residual finite {bool(np.isfinite(res.cpu().numpy()).all())}")
    gate(conv.mean() >= 0.9, f"(b) entry: converged {conv.mean():.4f} < 0.9")
    worst = float(rel[both].max())
    gate(worst <= 1e-3, f"(b) entry: card vs CPU max rel {worst:.3e} > 1e-3 on {both.sum()} voxels")
    print(f"phase 18b entry() ({device}, 4096 voxels): converged {conv.mean():.4f} (CPU "
          f"{conv_c.float().mean().item():.4f}), forward {card_s * 1e3:.1f} ms, card vs CPU max "
          f"rel {worst:.3e} on {int(both.sum())} identifiable voxels converged on both", flush=True)
    return worst


def phase18c_dryrun(device: str = "cuda"):
    """dryrun_multichip(2) on phase 17's mesh: the seven paths, each's wall time."""
    from fetal_t2mapping_tpu_torch.entry import dryrun_multichip

    mesh, mesh_kind = smoke_mesh(torch.device(device))
    out = dryrun_multichip(mesh.size, devices=list(mesh.devices))
    print(f"phase 18c dryrun_multichip({mesh.size}) on {mesh_kind}: path seconds "
          f"{json.dumps({k: round(v, 3) for k, v in out['seconds'].items()})}; path 7 "
          f"{out['scale']['n_voxels']} voxels, maps bitwise {out['scale']['equal_maps']}",
          flush=True)
    return out["seconds"]


def phase18d_examples(device: str = "cuda", unet_n: int = 160):
    """The five example scripts on ``device`` with figures=False (the
    card's machine has no matplotlib), each against its truth gates
    (tests/test_examples.py's), and the wall time of each."""
    from fetal_t2mapping_tpu_torch.examples import (invitro_phantom, invivo_analysis,
                                                   multichip, profile_unet, serving)

    dev = torch.device(device)
    mesh, _ = smoke_mesh(dev)
    secs = {}

    def run(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = round(time.perf_counter() - t0, 3)
        return out

    stats = run("serving", lambda: serving.main(2, device=device))
    for s in stats:
        gate(180_000 < s["n_masked"] < 260_000 and s["median_rel_err"] < 0.02 and s["converged"] > 0.98 and s["n_overflow"] == 0,
             f"(d) serving: {s}")
    mc = run("multichip", lambda: multichip.main(devices=list(mesh.devices)))
    f, r = mc["fit"], mc["registration"]
    gate(f["bitwise"] and f["max_shard_vs_single_rel"] == 0 and f["max_rel_t2_err_vs_truth"] < 1e-3
         and f["overflow"] == 0, f"(d) multichip fit: {f}")
    gate(r["rot_err_rad"] < 0.01 and r["trans_err_mm"] < 0.5, f"(d) multichip registration: {r}")
    gate(mc["unet"]["label_agreement"] == 1.0, f"(d) multichip unet: {mc['unet']}")
    with tempfile.TemporaryDirectory(prefix="ft2_smoke_ex_") as out:
        roi = run("invitro_phantom", lambda: invitro_phantom.main(
            os.path.join(out, "invitro"), device=device, figures=False))
        rel = (roi["meanT2"] - roi["trueT2"]).abs() / roi["trueT2"]
        ident = roi["trueT2"] >= 50
        gate(len(roi) == 9 and bool(roi["meanT2"].notna().all()) and int(ident.sum()) == 8
             and bool((rel[ident] < 0.10).all()) and bool((rel[~ident] < 0.25).all())
             and bool((roi.loc[ident, "stdT2"] / roi.loc[ident, "meanT2"] < 0.25).all()),
             f"(d) invitro_phantom ROI table:\n{roi}")
        df = run("invivo_analysis", lambda: invivo_analysis.main(
            os.path.join(out, "invivo"), device=device, figures=False))
    wm, gm = df[df["roi"] == "wm"]["mean"], df[df["roi"] == "gm"]["mean"]
    csf = df[df["roi"] == "csf"]["mean"]
    gm_rois = df[(df["tissue"] == "gm") & df["roi"].str.startswith("ROI-")]
    gate(len(wm) == len(gm) == len(csf) == 6 and 105 < wm.mean() < 125
         and bool(wm.between(100, 130).all()) and 135 < gm.mean() < 155
         and bool(gm.between(130, 160).all()) and 850 < csf.mean() < 950
         and len(gm_rois) == 36 and bool(gm_rois["mean"].between(120, 170).all()),
         "(d) invivo_analysis table off its truth")
    launches0 = profiler.counter("conv_s2d.launches")
    prof = run("profile_unet", lambda: profile_unet.main(unet_n, reps=3, device=device))
    names = [row["name"] for row in prof["rows"]]
    if dev.type == "cuda":
        launches = profiler.counter("conv_s2d.launches") - launches0
        gate(launches > 0 and any("conv_s2d" in nm for nm in names),
             f"(d) profile_unet: conv_s2d launches {launches}, not in the "
             f"table's {len(names)} ops")
    gate(len(names) > 0, "(d) profile_unet: empty table")
    top = ", ".join(f"{row['name'][:40]} {row['ms']:.2f} ms" for row in prof["rows"][:3])
    print(f"phase 18d examples ({device}, figures=False: the card's machine has no matplotlib): wall s "
          f"{json.dumps(secs)}; serving 96^3 warm {stats[-1]['ms']:.1f} ms/request; "
          f"multichip fit bitwise, registration {r['rot_err_rad']:.4f} rad / "
          f"{r['trans_err_mm']:.3f} mm; phantom max rel T2 err (identifiable) "
          f"{rel[ident].max():.4f}; profile_unet {unet_n}^3 wall {prof['wall_ms']:.1f} ms, op "
          f"self time {prof['op_ms']:.1f} ms per forward, top ops {top}", flush=True)
    return secs


def phase18(device: str = "cuda", n: int = SERVING_N, unet_n: int = 160):
    """Phase 18: fit_volume over a mesh (a), entry() (b), the mesh dry run
    (c) and the five examples (d); returns each part's wall seconds."""
    wall = {}
    for name, fn in (("a", lambda: phase18a_serving_mesh(n, device)),
                     ("b", lambda: phase18b_entry(device)),
                     ("c", lambda: phase18c_dryrun(device)),
                     ("d", lambda: phase18d_examples(device, unet_n))):
        t0 = time.perf_counter()
        fn()
        wall[name] = round(time.perf_counter() - t0, 1)
    print(f"phase 18 wall seconds per part: {wall}", flush=True)
    return wall


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
    timed("phase 15", phase15_ingest_chain)
    timed("phase 16", phase16_io_layer)
    mesh_rows, _ = timed("phase 17", phase17_mesh)
    timed("phase 18", phase18)
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
            ("gr_varpro", "gr_varpro_fit.cu", 537, "gaussian_rician", "gr_varpro_fit.launches"),
            ("fit3", "fit3.cu", 848, "rician", "fit3.launches"),
            ("fit3_cont", "fit3.cu", 887, "rician", "fit3_cont.launches")):
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
