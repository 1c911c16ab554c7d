"""The flagship fit step as a function, and a dry run of every mesh surface.

The counterpart of the JAX package's entry module (``__graft_entry__``):

- :func:`entry` returns the flagship "model" of this framework, the batched
  box-constrained Newton T2 solver (signal batch in, fitted (k, T2),
  convergence flags and mean residual out), with an example batch on the
  requested device.
- :func:`dryrun_multichip` runs the seven voxel-mesh paths at the sizes a
  user would run: the sharded fused fit and batch solver, ``fit_volume``
  over a mesh on a ragged mask, the sample-sharded registration, the
  z-sharded U-Net, one small end-to-end session through the pipelines and
  stage 3 at >= 10^6 fitted voxels against the same tree fitted on one
  device.

Run the dry run over the first two visible GPUs, or two streams of one:

    python -c "from fetal_t2mapping_tpu_torch.entry import dryrun_multichip; \\
        dryrun_multichip(2)"
    python -c "from fetal_t2mapping_tpu_torch.entry import dryrun_multichip; \\
        dryrun_multichip(2, devices=['cuda:0', 'cuda:0'])"
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .device import resolve_device

TES = (114.0, 202.0, 299.0)
LO, HI = (0.0, 10.0), (1e6, 2000.0)


def example_batch(n: int = 4096, t: int = 3, seed: int = 0):
    """(signal (n, t), te (t,)) float32 numpy: k ~ U(600, 5000), T2 ~ U(20,
    500), gaussian noise of sigma 10, clipped at 1e-2."""
    rng = np.random.default_rng(seed)
    te = np.array(TES[:t], np.float32)
    k = rng.uniform(600.0, 5000.0, n).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, n).astype(np.float32)
    sig = (k[:, None] * np.exp(-te[None, :] / t2[:, None])).astype(np.float32)
    sig = np.maximum(sig + rng.normal(0, 10.0, sig.shape).astype(np.float32), 1e-2)
    return sig, te


def entry(device="cuda"):
    """``(forward, (signal, te))``: the flagship fit step and its example
    batch (4096 voxels, seed 0) on ``device``.

    ``forward(signal, te)`` runs the log-linear start, the gaussian batch
    solver (40 iterations at most), the model's prediction and the mean
    residual per voxel, and returns ``(x (N, 2), converged (N,), residual
    (N,))`` on the batch's device."""
    from .models.init import loglinear_init
    from .models.signal import predict_signal
    from .models.solver import fit_batch

    dev = resolve_device(device)

    def forward(signal, te):
        x0 = loglinear_init(signal, te, LO, HI)
        res = fit_batch(signal, te, x0, LO, HI, model="gaussian", max_iters=40)
        pred = predict_signal("gaussian", (res.x[:, 0:1], res.x[:, 1:2]), te[None, :])
        residual = torch.mean(signal - pred, dim=1)
        return res.x, res.converged, residual

    sig, te = example_batch()
    return forward, (torch.from_numpy(sig).to(dev), torch.from_numpy(te).to(dev))


def dryrun_mesh(n_devices: int, devices: Optional[Sequence] = None):
    """The dry run's mesh: ``devices`` (exactly ``n_devices`` of them), or
    the first ``n_devices`` visible CUDA devices, raising when fewer are
    visible. Nothing falls back to fewer cards or to the CPU."""
    from .parallel.mesh import voxel_mesh

    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n_devices:
            raise RuntimeError(f"a mesh of {n_devices} CUDA devices: only {visible} visible; "
                               "pass devices=[...] (two streams of one card: "
                               "['cuda:0', 'cuda:0']; a CPU mesh: ['cpu'] * n)")
        return voxel_mesh(n_devices)
    if len(devices) != n_devices:
        raise ValueError(f"a mesh of {n_devices} devices: {len(devices)} given")
    return voxel_mesh(devices=devices)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def ragged_stack(n_devices: int, seed: int = 2):
    """Path 3's request: a 56 x 48 x 48 x 3-TE stack (k ~ U(600, 4000),
    T2 ~ U(30, 450), noise sigma 6) and a tilted-ellipsoid mask with 5%
    holes, whose per-shard masked counts are uneven; and the generator, as
    path 5 draws on from it. Returns (vol, mask, per-shard counts, rng)."""
    z, y, x = 56, 48, 48                      # 129,024 voxels
    te = np.asarray(TES, np.float32)
    rng = np.random.default_rng(seed)
    t2v = rng.uniform(30, 450, (z, y, x)).astype(np.float32)
    kv = rng.uniform(600, 4000, (z, y, x)).astype(np.float32)
    vol = (kv[..., None] * np.exp(-te / t2v[..., None])).astype(np.float32)
    vol = np.maximum(vol + rng.normal(0, 6.0, vol.shape), 1e-2).astype(np.float32)
    gz, gy, gx = np.meshgrid(np.linspace(-1, 1, z), np.linspace(-1, 1, y),
                             np.linspace(-1, 1, x), indexing="ij")
    mask = ((gz + 0.15 * gy) / 0.8) ** 2 + (gy / 0.7) ** 2 \
        + ((gx - 0.1 * gz) / 0.6) ** 2 <= 1.0
    mask &= rng.uniform(size=mask.shape) > 0.05   # 5% holes
    per_shard = np.array_split(mask.reshape(-1), n_devices)
    return vol, mask, [int(p.sum()) for p in per_shard], rng


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run every voxel-mesh path once over an ``n_devices`` mesh.

    ``devices`` defaults to the first ``n_devices`` visible CUDA devices
    and raises when fewer are visible; two streams of one card
    (``['cuda:0', 'cuda:0']``) or a CPU mesh (``['cpu'] * n``) are asked
    for explicitly. The seven paths:

    1. ``fit_fused_sharded`` on ``pad_to_devices(110_000)`` voxels;
    2. ``fit_batch_sharded`` on the same batch, the converged share and the
       mean T2 reduced on the first device;
    3. ``fit_volume(mesh=)`` on the ragged 56 x 48 x 48 stack
       (``compact=True``, ``mask_frac=0.6``): ``n_masked`` is the mask's
       count, ``n_overflow`` 0, and the maps are the single-device call's;
    4. ``register_rigid(mesh=, metric='mi')`` at 64^3;
    5. ``segment_volume(mesh=)``;
    6. one small in-vivo session through ``process_qmri(mesh=)`` and
       ``process_t2maps(mesh=)``;
    7. ``process_t2maps(mesh=)`` at 144^3 with >= 10^6 fitted voxels,
       maps equal to the same tree fitted without a mesh.

    Prints one summary line and returns the numbers in it, with each
    path's wall time in seconds under ``"seconds"``."""
    from .core.volume import Volume
    from .labels.unet3d import UNetConfig, random_params, segment_volume
    from .models.init import loglinear_init
    from .models.volume_fit import fit_volume
    from .parallel.mesh import fit_batch_sharded, fit_fused_sharded, pad_to_devices
    from .recon.registration import register_rigid

    mesh = dryrun_mesh(n_devices, devices)
    dev0 = mesh.devices[0]
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev0.type == "cuda":
            torch.cuda.synchronize(dev0)
        seconds[name] = time.perf_counter() - t0
        return out

    sig, te = example_batch(n=pad_to_devices(110_000, mesh), t=3, seed=1)

    # Path 1: the fused fit, one shard per mesh entry
    rf = timed("fused", lambda: fit_fused_sharded(sig, te.tolist(), LO, HI, mesh,
                                                  phase1_iters=8, max_iters=20))
    _check(tuple(rf.x.shape) == (sig.shape[0], 2), f"path 1 x {tuple(rf.x.shape)}")
    _check(int(rf.n_overflow) == 0, f"path 1 n_overflow {int(rf.n_overflow)}")

    # Path 2: the batch solver, reductions on the first device
    def batch_solve():
        s = torch.from_numpy(sig).to(dev0)
        x0 = loglinear_init(s, torch.from_numpy(te).to(dev0), LO, HI)
        res = fit_batch_sharded(s, te, x0, LO, HI, mesh, model="gaussian", max_iters=25)
        return res.x, res.converged.float().mean(), res.x[:, 1].mean()

    x, conv_rate, t2_mean = timed("batch", batch_solve)
    _check(tuple(x.shape) == (sig.shape[0], 2), f"path 2 x {tuple(x.shape)}")
    _check(bool(torch.isfinite(conv_rate)) and bool(torch.isfinite(t2_mean)),
           "path 2 reductions are not finite")

    # Path 3: the serving wrapper over the mesh on a ragged mask
    vol, mask, per_shard, rng = ragged_stack(n_devices)
    vkw = dict(mask_frac=0.6, compact=True, max_iters=12)
    rv = timed("fit_volume", lambda: fit_volume(vol, mask, TES, LO, HI, mesh=mesh, **vkw))
    _check(tuple(rv.t2.shape) == mask.shape, f"path 3 t2 {tuple(rv.t2.shape)}")
    _check(int(rv.n_masked) == int(mask.sum()),
           f"path 3 n_masked {int(rv.n_masked)} != {int(mask.sum())}")
    _check(int(rv.n_overflow) == 0, f"path 3 n_overflow {int(rv.n_overflow)}")
    r1 = fit_volume(vol, mask, TES, LO, HI, device=dev0, **vkw)
    _check(all(torch.equal(getattr(rv, f), getattr(r1, f)) for f in rv._fields),
           "path 3 fit_volume(mesh=) differs from the single-device call")

    # Path 4: the registration with its fixed samples sharded
    nvol = 64
    gax = np.linspace(-1, 1, nvol, dtype=np.float32)
    gz, gy, gx = np.meshgrid(gax, gax, gax, indexing="ij")
    img = (np.exp(-4 * (gz ** 2 + gy ** 2 + gx ** 2))
           * (1 + 0.3 * np.sin(6 * gx) * np.cos(5 * gy))).astype(np.float32)
    reg = timed("registration", lambda: register_rigid(
        Volume(img), Volume(np.roll(img, 1, axis=2)), mesh=mesh, metric="mi",
        levels=(2, 1), sigmas=(1.0, 0.0), iters=(8, 8), stop_tol=None))
    _check(bool(np.isfinite(reg.params).all()), "path 4 params are not finite")
    _check(bool(np.isfinite(reg.metric_history).all()), "path 4 metric is not finite")

    # Path 5: the U-Net with the volume's z axis split over the mesh
    ucfg = UNetConfig(n_levels=3, base_features=4, n_labels=7)
    uvol = np.abs(rng.normal(400.0, 80.0, (4 * n_devices, 24, 24))).astype(np.float32)
    labels = timed("segmentation", lambda: segment_volume(random_params(ucfg, seed=3), uvol,
                                                          ucfg, mesh=mesh))
    _check(labels.shape == uvol.shape, f"path 5 labels {labels.shape}")

    # Path 6: one small session through both pipelines
    e2e = timed("session", lambda: _dryrun_pipeline_session(mesh))

    # Path 7: stage 3 at >= 10^6 fitted voxels, mesh against one device
    scale = timed("scale", lambda: _dryrun_pipeline_scale(mesh))

    summary = dict(
        n_devices=n_devices, devices=[str(d) for d in mesh.devices], n_fused=int(sig.shape[0]),
        conv_rate=float(conv_rate), t2_mean=float(t2_mean),
        fit_volume_n_masked=int(rv.n_masked), per_shard=per_shard,
        reg_metric=float(reg.final_metric), n_unet_labels=int(len(np.unique(labels))),
        session=e2e, scale=scale, seconds=seconds)
    print(f"dryrun_multichip({n_devices}) over {summary['devices']}: "
          f"fused x{tuple(rf.x.shape)} @ {sig.shape[0]} voxels; "
          f"batch solver x{tuple(x.shape)} on {x.device}, conv_rate={float(conv_rate):.3f}, "
          f"mean T2={float(t2_mean):.1f} ms; "
          f"fit_volume {tuple(rv.t2.shape)} n_masked={int(rv.n_masked)} "
          f"(ragged per-shard counts {sorted(set(per_shard))[:3]}..), equal to one device; "
          f"sharded-MI registration 64^3 (mesh=) metric {reg.final_metric:.4f}; "
          f"z-sharded U-Net {labels.shape} ({len(np.unique(labels))} labels); "
          f"PIPELINE session via process_qmri/process_t2maps(mesh=): "
          f"{e2e['n_voxels']} voxels fitted, converged {e2e['converged_frac']:.3f}, "
          f"maps {sorted(e2e['maps'])}; "
          f"PIPELINE mesh path AT SCALE (process_t2maps(mesh=), {scale['grid']} grid): "
          f"{scale['n_voxels']} fitted voxels, converged sharded {scale['conv_sharded']:.3f} / "
          f"single {scale['conv_single']:.3f}, sharded-vs-single maps bitwise equal "
          f"({', '.join(scale['equal_maps'])}); path seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()), flush=True)
    return summary


def _dryrun_pipeline_scale(mesh) -> dict:
    """Path 7: a 144^3 grid at 1 mm with a ~35% brain-like ellipsoid mask
    (3% holes), 3 TEs, written as stage-2 derivatives; the same tree fitted
    twice through ``process_t2maps``, sharded over ``mesh`` and on its first
    device (distinct ``sim`` tags keep the map files apart). Both go
    through the fused fit, so every map is bitwise equal."""
    from . import config as C
    from .core import Volume, nifti
    from .pipeline.t2map_pipeline import process_t2maps
    from .utils.bids import get_img_path

    n = 144
    # 3 TEs: with only 2 the fit is exactly determined and both runs
    # return the clipped log-linear interpolant
    tes = [114, 202, 299]
    rng = np.random.default_rng(7)
    g = np.linspace(-1, 1, n, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    t2_true = 140.0 + 30.0 * np.sin(3 * x) * np.cos(2 * y) + 20.0 * z
    k_true = 900.0 + 150.0 * np.sin(4 * y) * np.cos(3 * z)
    mask = (z / 0.92) ** 2 + (y / 0.88) ** 2 + (x / 0.85) ** 2 <= 1.0
    mask &= rng.uniform(size=mask.shape) > 0.03      # ragged holes
    _check(int(mask.sum()) >= 1_000_000, f"path 7 mask has {int(mask.sum())} voxels")

    root = tempfile.mkdtemp(prefix="ft2_dryrun_scale_")
    try:
        bids = os.path.join(root, "projects/")
        rows = []
        for te in tes:
            img = (k_true * np.exp(-te / t2_true)).astype(np.float32)
            img = np.maximum(img + rng.normal(0, 4.0, img.shape), 1e-2)
            acq = {"prj": "prj-004", "sub": "sub-002", "ses": "ses-01",
                   "run": f"run-{te}", "EchoTime": te / 1000.0,
                   "ImageOrientationPatientSTR": "ax"}
            nifti.write(get_img_path(bids, acq, C.RECON_DIRNAME),
                        Volume(img.astype(np.float32), spacing=(1, 1, 1)), dtype=np.float32)
            nifti.write(get_img_path(bids, acq, C.MASK_DIRNAME),
                        Volume(mask.astype(np.uint8), spacing=(1, 1, 1)), dtype=np.uint8)
            rows.append(acq)
        cfg = C.fit_config("gaussian", low_field=True, max_iters=20)
        sum_m = process_t2maps(rows, bids, tes, cfg, low_field=True, sim="d",
                               make_plots=False, mesh=mesh)
        sum_s = process_t2maps(rows, bids, tes, cfg, low_field=True, sim="0",
                               make_plots=False, device=mesh.devices[0])
        _check(len(sum_m) == 1 and len(sum_s) == 1, "path 7 expected one session each")
        _check(sum_m[0]["n_voxels"] == sum_s[0]["n_voxels"] == int(mask.sum()),
               f"path 7 fitted {sum_m[0]['n_voxels']} / {sum_s[0]['n_voxels']} voxels")
        equal = []
        for name in sorted(sum_s[0]["maps"]):
            a = np.asarray(nifti.read(sum_s[0]["maps"][name]).data)
            b = np.asarray(nifti.read(sum_m[0]["maps"][name]).data)
            _check(np.array_equal(a, b, equal_nan=True),
                   f"path 7 map {name} differs between the mesh and one device")
            equal.append(name)
        _check(sum_m[0]["converged_frac"] > 0.99 and sum_s[0]["converged_frac"] > 0.99,
               f"path 7 converged {sum_m[0]['converged_frac']} / {sum_s[0]['converged_frac']}")
        return {"grid": f"{n}^3", "n_voxels": sum_m[0]["n_voxels"],
                "conv_sharded": sum_m[0]["converged_frac"],
                "conv_single": sum_s[0]["converged_frac"], "equal_maps": equal}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _dryrun_pipeline_session(mesh) -> dict:
    """Path 6: a 3-orientation x 2-TE in-vivo session of a 32^3 object on
    disk through stage 2 (``process_qmri(mesh=)``: the registration's
    samples sharded, SynthSeg ``fake``) and stage 3 (``process_t2maps(mesh=)``)
    with coarse registration budgets; returns the fit's summary."""
    from . import config as C
    from .core import Volume, nifti
    from .labels.synthseg import SynthSegRunner
    from .pipeline.recon_pipeline import process_qmri
    from .pipeline.t2map_pipeline import process_t2maps
    from .recon.resample import resample_volume
    from .utils.bids import get_img_path

    n = 32
    tes = [114, 202]
    rng = np.random.default_rng(4)
    g = np.linspace(-1, 1, n, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    r2 = z * z + y * y + x * x
    t2_true = 140.0 + 25.0 * np.sin(2 * x) * np.cos(2 * y)
    k_true = 900.0 * np.exp(-2.5 * r2) * (1 + 0.2 * np.sin(5 * x))
    dev0 = mesh.devices[0]

    root = tempfile.mkdtemp(prefix="ft2_dryrun_")
    try:
        bids = os.path.join(root, "projects/")
        rows = []
        for te in tes:
            img = (k_true * np.exp(-te / t2_true)).astype(np.float32)
            truth = Volume(img, spacing=(1, 1, 1), origin=(0, 0, 0))
            for otype, axis in (("ax", 2), ("cor", 1), ("sag", 0)):
                spacing = [1.0, 1.0, 1.0]
                spacing[axis] = 2.0
                low = resample_volume(truth, spacing, device="cpu")
                data = np.asarray(low.data) + rng.normal(0, 3.0, low.shape).astype(np.float32)
                acq = {"prj": "prj-004", "sub": "sub-001", "ses": "ses-01",
                       "run": f"run-{otype}-{te}", "EchoTime": te / 1000.0,
                       "ImageOrientationPatientSTR": otype}
                nifti.write(get_img_path(bids, acq, C.IN_DIRNAME),
                            low.with_data(np.maximum(data, 0.0).astype(np.float32)),
                            dtype=np.float32)
                rows.append(acq)
        process_qmri(bids, rows, in_vivo=True, low_field=True,
                     synthseg=SynthSegRunner(mode="fake"),
                     registration_kwargs=dict(levels=(2, 1), sigmas=(1.0, 0.0), iters=(20, 10)),
                     mesh=mesh, device=dev0)
        cfg = C.fit_config("gaussian", low_field=True, max_iters=25)
        summaries = process_t2maps(rows, bids, tes, cfg, low_field=True, sim="d",
                                   make_plots=False, mesh=mesh)
        _check(len(summaries) == 1 and summaries[0]["n_voxels"] > 0,
               "path 6 fitted no voxel")
        _check(summaries[0]["converged_frac"] > 0.9,
               f"path 6 converged {summaries[0]['converged_frac']}")
        return summaries[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
