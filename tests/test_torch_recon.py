"""The port's resampling, fusion and denoising against the JAX package's,
on the same seeded volumes.

Tolerances: resampling is one gather pass, held to 1e-5 of the output's
scale (linear) and exactly (nearest, integer dtypes kept). The fusion
solves two registrations first (the plateau exit on; the solved poses
agree to ~1e-6), so the fused volume is held to 1e-4 of its scale.
Denoising is held as in test_torch_ops.py:
each slice to the port's iterate at its own stop or one iteration either
side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu.core.volume import Volume as RefVolume
from fetal_t2mapping_tpu.recon import denoise as ref_denoise
from fetal_t2mapping_tpu.recon import fuse as ref_fuse
from fetal_t2mapping_tpu.recon import resample as ref_resample
from fetal_t2mapping_tpu_torch.core.volume import Volume
from fetal_t2mapping_tpu_torch.ops import tv
from fetal_t2mapping_tpu_torch.recon import denoise, fuse, resample

from test_torch_ops import _tv_stop_iter

torch.set_num_threads(1)

ROT30 = (np.cos(np.pi / 6), -np.sin(np.pi / 6), 0.0,
         np.sin(np.pi / 6), np.cos(np.pi / 6), 0.0, 0.0, 0.0, 1.0)
GEOMS = {
    "axis": dict(spacing=(1.0, 1.0, 3.0), origin=(-12.0, 4.0, 30.0)),
    "permuted": dict(spacing=(0.8, 1.1, 1.3), origin=(-10.5, 4.25, 30.0),
                     direction=(0.0, 1.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0, 1.0)),
    "oblique": dict(spacing=(1.2, 0.9, 2.0), origin=(3.0, -7.0, 11.0), direction=ROT30),
}


def _scale_close(got, ref, rtol):
    ref = np.asarray(ref)
    err = float(np.nanmax(np.abs(np.asarray(got) - ref))) / float(np.nanmax(np.abs(ref)))
    assert err <= rtol, f"relative error {err:.3e} > {rtol:g}"


def _vol(shape=(14, 16, 18), seed=0, dtype=np.float32):
    data = np.random.default_rng(seed).uniform(0, 400, shape)
    return data.astype(dtype)


def _both(data, **geom):
    return RefVolume(data, **geom), Volume(data, **geom)


@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (0.7, 1.3, 0.5)])
def test_resample_volume_linear(geom, spacing):
    r, p = _both(_vol(), **GEOMS[geom])
    ref = ref_resample.resample_volume(r, spacing)
    got = resample.resample_volume(p, spacing, device="cpu")
    assert got.shape == ref.shape and got.data.dtype == np.float32
    assert (got.spacing, got.origin, got.direction) == (ref.spacing, ref.origin, ref.direction)
    _scale_close(got.data, ref.data, 1e-5)


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.uint16])
def test_resample_nearest_keeps_integer_type(dtype):
    labels = np.random.default_rng(1).integers(0, 60, (14, 16, 18)).astype(dtype)
    r, p = _both(labels, **GEOMS["permuted"])
    # a factor-of-2 grid lands samples on exact half-integers
    for spacing in ((0.4, 0.55, 0.65), (0.8, 1.1, 1.3)):
        ref = np.asarray(ref_resample.resample_volume(r, spacing, method="nearest").data)
        got = resample.resample_volume(p, spacing, method="nearest", device="cpu").data
        assert got.dtype == ref.dtype == dtype
        np.testing.assert_array_equal(got, ref)


def test_resample_integer_input_linear_is_float():
    data = _vol(dtype=np.int16)
    r, p = _both(data, **GEOMS["axis"])
    ref = np.asarray(ref_resample.resample_volume(r, (1.0, 1.0, 1.0)).data)
    got = resample.resample_volume(p, (1.0, 1.0, 1.0), device="cpu").data
    assert got.dtype == np.float32
    _scale_close(got, ref, 1e-5)


@pytest.mark.parametrize("on_device", [False, True])
def test_resample_to_reference_with_transform(on_device):
    """A host (float64) transform and a device (float32) one, as the fusion
    passes RegistrationResult.matrix_device; NaN marks out-of-FOV."""
    T = np.eye(4)
    c, s = np.cos(0.07), np.sin(0.07)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = [1.5, -2.0, 0.75]
    r_src, p_src = _both(_vol(seed=2), **GEOMS["oblique"])
    r_ref, p_ref = _both(_vol((12, 13, 15), seed=3), **GEOMS["permuted"])
    for transform in (T, T.astype(np.float32)):
        if on_device:
            ref = ref_resample.resample_to_reference(
                r_src, r_ref, transform=jnp.asarray(transform),
                cval=np.nan, device=True)
            got = resample.resample_to_reference(p_src, p_ref, transform=torch.from_numpy(transform),
                                                 cval=np.nan, on_device=True, device="cpu")
            assert torch.is_tensor(got.data)
            got_data = got.data.numpy()
        else:
            ref = ref_resample.resample_to_reference(r_src, r_ref, transform=transform, cval=np.nan)
            got_data = resample.resample_to_reference(p_src, p_ref, transform=transform,
                                                      cval=np.nan, device="cpu").data
        ref_data = np.asarray(ref.data)
        np.testing.assert_array_equal(np.isnan(got_data), np.isnan(ref_data))
        assert np.isnan(ref_data).any() and (~np.isnan(ref_data)).any()
        _scale_close(got_data, ref_data, 1e-5)


def test_sample_volume_at_world():
    r, p = _both(_vol(seed=4), **GEOMS["oblique"])
    pts = r.index_to_world(np.random.default_rng(5).uniform(-1, 17, (500, 3)))
    for method in ("linear", "nearest"):
        ref = np.asarray(ref_resample.sample_volume_at_world(r, pts, method=method))
        got = resample.sample_volume_at_world(p, pts, method=method, device="cpu").numpy()
        _scale_close(got, ref, 1e-5)


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, p = _both(_vol(), **GEOMS["axis"])
    with pytest.raises(RuntimeError, match="cuda"):
        resample.resample_volume(p)
    with pytest.raises(RuntimeError, match="cuda"):
        denoise.denoise_volume(p)


# ----------------------------------------------------------------- fusion
def _acquisitions(n=30, seed=0):
    """Three thick-slice orientations of one smooth object, the second and
    third rigidly offset (tests/test_invivo_recon.py's set-up, smaller)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n)] * 3, indexing="ij")
    r = np.sqrt(z ** 2 + y ** 2 + x ** 2)
    truth = (800.0 * np.exp(-3.0 * r ** 2) * (1 + 0.25 * np.sin(4 * x) * np.cos(3 * y))
             ).astype(np.float32)
    truth_vol = RefVolume(truth, spacing=(1, 1, 1), origin=(0, 0, 0))
    imgs = {}
    for otype, axis, shift in (("ax", 2, 0.0), ("cor", 1, 1.5), ("sag", 0, -2.0)):
        spacing = [1.0, 1.0, 1.0]
        spacing[axis] = 3.0
        low = ref_resample.resample_volume(truth_vol, spacing)
        data = np.asarray(low.data) + rng.normal(0, 4.0, low.shape).astype(np.float32)
        origin = np.asarray(low.origin, float)
        origin[axis] += shift
        imgs[otype] = ref_resample.resample_volume(
            RefVolume(data, spacing=low.spacing, origin=tuple(origin)), (1.0, 1.0, 1.0))
    return imgs


FUSE_REG = dict(levels=(2, 1), sigmas=(1.0, 0.0), iters=(30, 15))


@pytest.mark.parametrize("weight_by_coverage", [True, False])
def test_fuse_orientations_matches_reference(weight_by_coverage):
    imgs = _acquisitions()
    ref = ref_fuse.fuse_orientations(imgs, "ax", weight_by_coverage=weight_by_coverage,
                                     registration_kwargs=FUSE_REG)
    p_imgs = {k: Volume(np.asarray(v.data), v.spacing, v.origin, v.direction)
              for k, v in imgs.items()}
    got = fuse.fuse_orientations(p_imgs, "ax", weight_by_coverage=weight_by_coverage,
                                 registration_kwargs=FUSE_REG, device="cpu")
    assert torch.is_tensor(got.data) and got.data.dtype == torch.float32
    assert (got.spacing, got.origin) == (ref.spacing, ref.origin)
    _scale_close(got.data.numpy(), ref.data, 1e-4)


def test_fuse_combine_weights():
    fixed = torch.full((2, 2, 2), 10.0)
    w1 = torch.full((2, 2, 2), 20.0)
    w1[0] = float("nan")
    w2 = torch.full((2, 2, 2), 40.0)
    out = fuse._fuse_combine(fixed, [w1, w2], weight_by_coverage=True)
    assert torch.allclose(out[0], torch.full((2, 2), 25.0))
    assert torch.allclose(out[1], torch.full((2, 2), 70.0 / 3))
    plain = fuse._fuse_combine(fixed, [w1, w2], weight_by_coverage=False)
    assert torch.allclose(plain[0], torch.full((2, 2), 50.0 / 3))


def test_fuse_missing_orientation_raises():
    imgs = {"ax": Volume(_vol()), "cor": Volume(_vol())}
    with pytest.raises(ValueError, match="missing orientations"):
        fuse.fuse_orientations(imgs, device="cpu")


def test_denoise_volume_matches_reference():
    rng = np.random.default_rng(6)
    data = (1.0 + 0.3 * (rng.random((10, 18, 20)) > 0.5)
            + rng.normal(0, 1.0, (10, 18, 20)) * np.geomspace(0.02, 0.5, 10)[:, None, None]
            ).astype(np.float32)
    r, p = _both(data, **GEOMS["oblique"])
    ref = np.asarray(ref_denoise.denoise_volume(r).data)
    got = denoise.denoise_volume(p, device="cpu")
    assert torch.is_tensor(got.data) and got.direction == r.direction
    got = got.data.numpy()
    scale = float(np.abs(ref).max())
    for s, sl in enumerate(data):
        stop = _tv_stop_iter(sl)
        its = [tv._tv2d(torch.from_numpy(sl)[None], 0.1, 0.0, n)[0].numpy()
               for n in (stop - 1, stop, stop + 1) if n >= 1]
        assert min(np.abs(u - ref[s]).max() for u in its) <= 1e-5 * scale, s
    assert np.abs(got - data).max() > 1e-2
