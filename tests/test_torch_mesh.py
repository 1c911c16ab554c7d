"""The port's voxel mesh (``fetal_t2mapping_tpu_torch.parallel``) and the
``mesh=`` surfaces, on a mesh of CPU entries (``voxel_mesh(devices=["cpu"]
* 4)``: the port's counterpart of the JAX package's 8 fake CPU devices).

Port against port, tolerance none (bitwise): the sharded fits
(``fit_fused_sharded`` for the three models and no-prior gaussian,
``fit_batch_sharded``, ``fit_batch_multistart_sharded``) equal the
single-device fits, and ``fit_stack(mesh=)`` maps equal the unsharded
maps, because every fit freezes a voxel once it converges. The U-Net's
labels equal the unsharded forward's for a z the mesh divides (the small
configuration of ``tests/test_parallel.py``); for one it does not, the
reference's shape and label-set checks. Registration: the sharded solve
within the reference's 5e-3 (rotation) / 0.3 mm (translation) of the
single-device one at a fixed budget (``tests/test_parallel.py:301-304``)
and its recovery tolerances.

Port against reference: ``fit_fused_sharded`` against the JAX package's
``fit_fused_sharded`` (interpret mode, 8 fake CPU devices), in the bands
``bench.py:638-652`` sets between two codegens of one kernel (gaussian
params 1e-3, objective 1e-2; 3-parameter k and T2 1e-2, objective 3e-2;
convergence rates within 0.01) on identifiable voxels.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu.parallel import mesh as ref_mesh
from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.core import EchoStack, Volume
from fetal_t2mapping_tpu_torch.models import fused_fit, solver
from fetal_t2mapping_tpu_torch.models.init import loglinear_init
from fetal_t2mapping_tpu_torch.models.t2map import fit_stack
from fetal_t2mapping_tpu_torch.parallel import (VOXEL_AXIS, fit_batch_multistart_sharded,
                                                fit_batch_sharded, fit_fused_sharded,
                                                mesh_from_flag, pad_to_devices, shard_voxels,
                                                voxel_mesh)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_recon import FAST_REG, _blob_volume, _rigid_world_matrix  # noqa: E402

torch.set_num_threads(1)

TES = (114.0, 202.0, 299.0)
FITS = {  # model: (lo, hi, guess, tolerances)
    "gaussian": ((0.0, 10.0), (1e6, 2000.0), None, {}),
    "gaussian_rician": ((1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0), {}),
    "rician": ((1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0), {}),
}
MESH4 = ["cpu"] * 4


def _make_data(n, seed):
    """bench.py:120-127's generator; the identifiable voxels."""
    rng = np.random.default_rng(seed)
    te = np.asarray(TES, np.float32)
    k = rng.uniform(600.0, 5000.0, n).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, n).astype(np.float32)
    sig = (k[:, None] * np.exp(-te[None, :] / t2[:, None])).astype(np.float32)
    sig = np.maximum(sig + rng.normal(0, 8.0, sig.shape).astype(np.float32), 1e-2)
    return sig, k * np.exp(-TES[-1] / t2) >= 24.0


def _same(a, b):
    return all(torch.equal(u, v) for u, v in ((a.x, b.x), (a.fun, b.fun),
                                              (a.converged, b.converged),
                                              (a.n_iter, b.n_iter)))


# ------------------------------------------------------------------ the mesh
def test_mesh_basics():
    mesh = voxel_mesh(devices=MESH4)
    assert mesh.size == 4 and mesh.axis_names == (VOXEL_AXIS,) == ("vox",)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    ref = ref_mesh.voxel_mesh(4)
    for n, lane in ((1, 8), (65, 8), (100, 128), (4096, 128)):
        assert pad_to_devices(n, mesh, lane) == ref_mesh.pad_to_devices(n, ref, lane)
    x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    shards = shard_voxels(x, mesh)
    assert [s.shape for s in shards] == [(16, 3)] * 4
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)
    with pytest.raises(ValueError, match="not divisible by mesh size 4"):
        shard_voxels(x[:63], mesh)


def test_mesh_from_flag_and_visible_devices():
    for flag in (None, 0, 1):
        assert mesh_from_flag(flag) is None
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"only {visible} CUDA device"):
        mesh_from_flag(visible + 2)
    if visible == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            voxel_mesh()


@pytest.mark.parametrize("cli", ["t2mapping", "qmri_reconstruction"])
def test_cli_mesh_flag_reports_the_visible_count(cli, tmp_path, capsys):
    """--mesh N with fewer visible CUDA devices fails with the count."""
    import importlib

    main = importlib.import_module(f"fetal_t2mapping_tpu_torch.cli.{cli}").main
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    args = ["--path", str(tmp_path), "--csv", "x.csv", "--in_vivo", "--lf",
            "--mesh", str(visible + 2)]
    if cli == "t2mapping":
        args += ["--gaussian", "--sim", "1"]
    assert main(args) == 1
    assert f"only {visible} CUDA device(s) visible" in capsys.readouterr().err


# ------------------------------------------------------- port against port
@pytest.mark.parametrize("model", sorted(FITS) + ["gaussian-no_prior"])
def test_fit_fused_sharded_is_the_single_fit(model):
    no_prior = model.endswith("no_prior")
    model = model.split("-")[0]
    lo, hi, guess, _ = FITS[model]
    if no_prior:
        lo, hi = (0.0, 10.0), (1e4, 2000.0)
    sig, _ = _make_data(1024, seed=3)
    kw = dict(model=model, guess=guess, no_prior=no_prior)
    single = fused_fit.fit_fused(sig, TES, lo, hi, device="cpu", **kw)
    sharded = fit_fused_sharded(sig, TES, lo, hi, voxel_mesh(devices=MESH4), **kw)
    assert _same(single, sharded) and sharded.n_overflow == 0
    with pytest.raises(ValueError, match="not divisible"):
        fit_fused_sharded(sig[:1023], TES, lo, hi, voxel_mesh(devices=MESH4), **kw)


def test_fit_fused_sharded_rejects_bad_tail_block():
    sig = np.ones((128, 3), np.float32)
    with pytest.raises(ValueError, match="tail_block must divide 128"):
        fit_fused_sharded(sig, TES, (0.0, 10.0), (1e6, 2000.0), voxel_mesh(devices=MESH4),
                          strategy="twophase", tail_block=12)


def test_launch_counters_lose_no_count_across_shard_threads(monkeypatch):
    """run_sharded launches each shard's kernels from a thread of its own:
    the module's launch counters count every launch (8 threads x 20,000)."""
    import threading

    monkeypatch.setattr(fused_fit, "KERNEL_LAUNCHES", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)              # switch threads as often as possible
    try:
        threads = [threading.Thread(target=lambda: [fused_fit._count("KERNEL_LAUNCHES")
                                                    for _ in range(20_000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert fused_fit.KERNEL_LAUNCHES == 8 * 20_000


def test_fit_batch_sharded_is_fit_batch():
    sig, _ = _make_data(512, seed=4)
    lo, hi = (0.0, 10.0), (1e6, 2000.0)
    x0 = loglinear_init(torch.from_numpy(sig), torch.tensor(TES), torch.tensor(lo),
                        torch.tensor(hi))
    single = solver.fit_batch(sig, TES, x0, lo, hi, model="gaussian")
    sharded = fit_batch_sharded(sig, TES, x0, lo, hi, voxel_mesh(devices=MESH4),
                                model="gaussian")
    assert _same(single, sharded)


def test_fit_batch_multistart_sharded_is_the_multistart():
    sig, _ = _make_data(256, seed=5)
    lo, hi = (1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0)
    rng = np.random.default_rng(0)
    x0s = np.stack([np.column_stack([rng.uniform(600, 4000, 256), rng.uniform(30, 400, 256),
                                     rng.uniform(5, 50, 256)]).astype(np.float32)
                    for _ in range(2)])
    single = solver.fit_batch_multistart(sig, TES, x0s, lo, hi, model="rician", max_iters=20)
    sharded = fit_batch_multistart_sharded(sig, TES, x0s, lo, hi, voxel_mesh(devices=MESH4),
                                           model="rician", max_iters=20)
    assert _same(single, sharded)


def _stack(seed=1, shape=(10, 12, 11)):
    rng = np.random.default_rng(seed)
    k = rng.uniform(600, 3000, shape)
    t2 = rng.uniform(30, 300, shape)
    sig = k[..., None] * np.exp(-np.asarray(TES) / t2[..., None])
    sig = np.abs(sig + rng.normal(0, 8, shape + (3,))).astype(np.float32)
    return EchoStack(sig, rng.random(shape) > 0.3, list(TES), Volume(sig[..., 0]))


@pytest.mark.parametrize("model", sorted(FITS))
@pytest.mark.parametrize("prior", [True, False])
def test_fit_stack_mesh_maps_equal_unsharded(model, prior):
    """The fused configurations (prior, and no-prior gaussian) and the
    no-prior 3-parameter multistart: the mesh's maps are the unsharded
    maps, bit for bit."""
    st = _stack()
    cfg = C.fit_config(model, True, prior=prior)
    a = fit_stack(st, cfg, device="cpu", granule=128)
    b = fit_stack(st, cfg, mesh=voxel_mesh(devices=["cpu"] * 3), granule=128)
    for f in ("t2", "k", "sigma", "res", "converged", "n_iter", "fun"):
        np.testing.assert_array_equal(getattr(a, f).data, getattr(b, f).data, err_msg=f)
    np.testing.assert_array_equal(a.trace_t2, b.trace_t2)
    assert a.n_overflow == b.n_overflow == 0


def test_fit_stack_mesh_guess_start_runs_the_sharded_multistart():
    """loglinear_init=False on a mesh runs the multistart from the guess
    start, as the reference's _fit_batch_mesh does: finite maps."""
    st = _stack(seed=2)
    cfg = dataclasses.replace(C.fit_config("gaussian", True), loglinear_init=False)
    out = fit_stack(st, cfg, mesh=voxel_mesh(devices=["cpu"] * 2), granule=128)
    assert np.isfinite(out.t2.data[st.mask]).all() and out.n_overflow == 0


def test_process_qmri_puts_the_mesh_into_registration_and_synthseg(monkeypatch):
    from fetal_t2mapping_tpu_torch.labels.synthseg import SynthSegRunner
    from fetal_t2mapping_tpu_torch.pipeline import recon_pipeline

    seen = {}
    monkeypatch.setattr(recon_pipeline, "_process_qmri_stages",
                        lambda *a, **kw: seen.update(kw))
    mesh = voxel_mesh(devices=["cpu"] * 2)
    recon_pipeline.process_qmri("unused/", [], in_vivo=True, low_field=True,
                                synthseg=SynthSegRunner(mode="torch", device="cpu"),
                                registration_kwargs=dict(fixed_mask="auto"), mesh=mesh,
                                device="cpu")
    assert seen["registration_kwargs"] == dict(fixed_mask="auto", mesh=mesh)
    assert seen["synthseg"].mesh is mesh and seen["synthseg"].mode == "torch"


# ----------------------------------------------------- port against reference
@pytest.mark.parametrize("model", sorted(FITS))
def test_fit_fused_sharded_matches_reference_sharded(model):
    lo, hi, guess, _ = FITS[model]
    ref_m = ref_mesh.voxel_mesh()
    n = ref_mesh.pad_to_devices(1000, ref_m, lane=128)
    sig, ident = _make_data(n, seed=6)
    p = fit_fused_sharded(sig, TES, lo, hi, voxel_mesh(devices=MESH4), model=model,
                          guess=guess)
    r = ref_mesh.fit_fused_sharded(sig, TES, lo, hi, ref_m, model=model, guess=guess,
                                   interpret=True, strategy="single")
    x_p, x_r = p.x.numpy(), np.asarray(r.x)
    rel = np.abs(x_p - x_r) / np.maximum(np.abs(x_r), 1.0)
    f_r = np.asarray(r.fun)
    f_rel = np.abs(p.fun.numpy() - f_r) / np.maximum(np.abs(f_r), 1.0)
    if model == "gaussian":
        assert rel[ident].max() <= 1e-3 and f_rel[ident].max() <= 1e-2
    else:
        assert rel[ident][:, :2].max() <= 1e-2 and f_rel[ident].max() <= 3e-2
    assert abs(p.converged.numpy().mean() - np.asarray(r.converged).mean()) <= 0.01
    assert int(p.n_overflow) == int(r.n_overflow) == 0


# ---------------------------------------------------------------- registration
def _pair(seed=3, shape=(24, 24, 24)):
    from fetal_t2mapping_tpu_torch.recon.resample import resample_to_reference

    f = _blob_volume(shape=shape, seed=seed)
    fixed = Volume(np.asarray(f.data), spacing=f.spacing, origin=f.origin,
                   direction=f.direction)
    center = np.asarray(fixed.center_world())
    T = _rigid_world_matrix(0.04, -0.03, 0.05, [3.0, -2.0, 2.0], center)
    return fixed, resample_to_reference(fixed, fixed, transform=T, device="cpu"), T, center


def _assert_recovers(reg, T_true, center, atol_rot=0.02, atol_mm=1.0):
    comp = T_true @ reg.matrix
    np.testing.assert_allclose(comp[:3, :3], np.eye(3), atol=atol_rot)
    assert np.abs(comp[:3, 3] - center + comp[:3, :3] @ center).max() < atol_mm


@pytest.mark.parametrize("metric", ["ncc", "mi"])
def test_mesh_rigid_matches_single_device(metric):
    from fetal_t2mapping_tpu_torch.recon.registration import register_rigid

    fixed, moving, T, center = _pair()
    kw = dict(FAST_REG, stop_tol=None, metric=metric)
    reg1 = register_rigid(fixed, moving, device="cpu", **kw)
    reg4 = register_rigid(fixed, moving, mesh=voxel_mesh(devices=MESH4), **kw)
    _assert_recovers(reg1, T, center)
    _assert_recovers(reg4, T, center)
    np.testing.assert_allclose(reg4.matrix[:3, :3], reg1.matrix[:3, :3], atol=5e-3)
    np.testing.assert_allclose(reg4.matrix[:3, 3], reg1.matrix[:3, 3], atol=0.3)


def test_mesh_of_one_is_the_single_device_solve():
    from fetal_t2mapping_tpu_torch.recon.registration import register_rigid

    fixed, moving, _, _ = _pair()
    kw = dict(FAST_REG, stop_tol=None, metric="cr")
    a = register_rigid(fixed, moving, device="cpu", **kw).params
    b = register_rigid(fixed, moving, mesh=voxel_mesh(devices=["cpu"]), **kw).params
    np.testing.assert_array_equal(a, b)


def test_mesh_mi_on_a_level_the_mesh_does_not_divide():
    """21^3 = 9261 samples on 4 devices: the even resample to a multiple."""
    from fetal_t2mapping_tpu_torch.recon.registration import register_rigid

    fixed, moving, T, center = _pair(seed=5, shape=(21, 21, 21))
    reg = register_rigid(fixed, moving, mesh=voxel_mesh(devices=MESH4), metric="mi",
                         levels=(2, 1), sigmas=(1.0, 0.0), iters=(100, 60), lr=0.8,
                         stop_tol=None)
    _assert_recovers(reg, T, center, atol_rot=0.03, atol_mm=1.5)


def test_mesh_multi_pair_and_affine():
    from fetal_t2mapping_tpu_torch.recon.registration import (register_affine,
                                                              register_rigid_multi)
    from fetal_t2mapping_tpu_torch.recon.resample import resample_to_reference

    fixed, _, _, center = _pair(seed=7)
    poses = [_rigid_world_matrix(0.03, 0.02, -0.04, [2.0, -1.5, 2.5], center),
             _rigid_world_matrix(-0.04, 0.03, 0.02, [-2.5, 2.0, -1.5], center)]
    movings = [resample_to_reference(fixed, fixed, transform=T, device="cpu") for T in poses]
    regs = register_rigid_multi(fixed, movings, mesh=voxel_mesh(devices=MESH4),
                                **dict(FAST_REG, stop_tol=None))
    for reg, T in zip(regs, poses):
        _assert_recovers(reg, T, center)
    kw = dict(levels=(2, 1), sigmas=(1.0, 0.0), iters=(40, 20), metric="cr", stop_tol=None)
    a = register_affine(fixed, movings[0], device="cpu", **kw).matrix
    b = register_affine(fixed, movings[0], mesh=voxel_mesh(devices=MESH4), **kw).matrix
    np.testing.assert_allclose(b[:3, :3], a[:3, :3], atol=5e-3)
    np.testing.assert_allclose(b[:3, 3], a[:3, 3], atol=0.3)


# ----------------------------------------------------------------------- U-Net
def _unet(seed):
    from fetal_t2mapping_tpu_torch.labels.unet3d import UNetConfig, random_params

    cfg = UNetConfig(n_levels=3, base_features=4, n_labels=7)
    return cfg, random_params(cfg, seed=seed)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_segment_volume_mesh_matches_single(n_dev):
    from fetal_t2mapping_tpu_torch.labels.unet3d import segment_volume

    cfg, params = _unet(6)
    data = np.abs(np.random.default_rng(6).normal(500, 120, (30, 17, 13))).astype(np.float32)
    single = segment_volume(params, data, cfg, compute_dtype=torch.float32, device="cpu")
    sharded = segment_volume(params, data, cfg, compute_dtype=torch.float32,
                             mesh=voxel_mesh(devices=["cpu"] * n_dev))
    np.testing.assert_array_equal(sharded, single)


def test_segment_volume_mesh_non_divisible_z():
    from fetal_t2mapping_tpu_torch.labels.unet3d import segment_volume

    cfg, params = _unet(8)
    data = np.abs(np.random.default_rng(8).normal(500, 120, (20, 13, 9))).astype(np.float32)
    sharded = segment_volume(params, data, cfg, compute_dtype=torch.float32,
                             mesh=voxel_mesh(devices=["cpu"] * 8))
    assert sharded.shape == data.shape
    assert set(np.unique(sharded)) <= set(range(cfg.n_labels))


def test_segment_volume_mesh_rejects_s2d():
    from fetal_t2mapping_tpu_torch.labels.unet3d import segment_volume

    cfg, params = _unet(9)
    with pytest.raises(ValueError, match="mutually exclusive"):
        segment_volume(params, np.ones((16, 16, 16), np.float32), cfg, use_s2d=True,
                       mesh=voxel_mesh(devices=["cpu"] * 2))


def test_synthseg_runner_torch_mode_on_a_mesh(tmp_path):
    """SynthSegRunner(mode='torch', mesh=) writes the unsharded labels."""
    from fetal_t2mapping_tpu_torch.core import nifti
    from fetal_t2mapping_tpu_torch.labels.synthseg import SynthSegRunner
    from fetal_t2mapping_tpu_torch.labels.unet3d import segment_volume

    cfg, params = _unet(10)
    wpath = str(tmp_path / "w.npz")
    np.savez(wpath, **params)
    data = np.abs(np.random.default_rng(10).normal(500, 120, (16, 12, 12))).astype(np.float32)
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    nifti.write(str(src / "a_recon.nii.gz"), Volume(data))
    SynthSegRunner(mode="torch", weights=wpath, device="cpu",
                   mesh=voxel_mesh(devices=["cpu"] * 2)).run(str(src), str(out))
    got = nifti.read(str(out / "a_recon_synthseg.nii.gz")).data
    want = segment_volume(params, data, device="cpu")
    np.testing.assert_array_equal(np.asarray(got), want)


def test_reference_mesh_has_eight_devices():
    """The reference's side of the comparisons above runs on the 8 fake CPU
    devices the root conftest sets up."""
    assert jax.device_count() == 8
