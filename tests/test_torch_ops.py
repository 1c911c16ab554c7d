"""The port's stage-2 device ops against the JAX package's, on the same
seeded numpy inputs: trilinear/nearest sampling (values and coordinate
gradients), Gaussian filtering, binary morphology and TV denoising.

Tolerances: sampling and filtering are one-pass float ops, held to 1e-5 of
the output's scale; morphology and nearest sampling are exact. TV stops
each slice on a test of whole-slice energy sums, whose float order differs
between XLA and torch, so a slice near its threshold may stop one
iteration apart: each JAX slice is held, to 1e-5 of the scale, to the
port's iterate at the port's stop or one iteration either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu.ops import filtering as ref_filtering
from fetal_t2mapping_tpu.ops import interp as ref_interp
from fetal_t2mapping_tpu.ops import morphology as ref_morph
from fetal_t2mapping_tpu.ops import tv as ref_tv
from fetal_t2mapping_tpu_torch.ops import filtering, interp, morphology, tv

torch.set_num_threads(1)

ONE_PASS_RTOL = 1e-5


def _close(got, ref, rtol=ONE_PASS_RTOL):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - ref).max()) / scale
    assert err <= rtol, f"relative error {err:.3e} > {rtol:g}"


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def volume():
    return np.random.default_rng(0).uniform(0, 100, (9, 10, 11)).astype(np.float32)


@pytest.fixture(scope="module")
def coords():
    # a band past both borders on every axis, so in- and out-of-bounds mix
    return np.random.default_rng(1).uniform(-1.5, 11.5, (4000, 3)).astype(np.float32)


@pytest.mark.parametrize("cval", [0.0, -3.0, np.nan])
def test_sample_trilinear_values(volume, coords, cval):
    ref = np.asarray(ref_interp.sample_trilinear(volume, coords, cval=cval))
    got = interp.sample_trilinear(_t(volume), _t(coords), cval=cval).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    _close(got[fin], ref[fin])


def test_sample_trilinear_integer_volume(coords):
    vol = np.random.default_rng(2).integers(0, 500, (9, 10, 11)).astype(np.int16)
    ref = np.asarray(ref_interp.sample_trilinear(vol, coords))
    got = interp.sample_trilinear(_t(vol), _t(coords))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)


def test_sample_trilinear_coordinate_gradient(volume, coords):
    w = np.random.default_rng(3).normal(size=coords.shape[0]).astype(np.float32)
    ref = np.asarray(jax.grad(lambda c: jnp.sum(ref_interp.sample_trilinear(volume, c) * w))(coords))
    c = _t(coords).requires_grad_(True)
    (interp.sample_trilinear(_t(volume), c) * _t(w)).sum().backward()
    _close(c.grad.numpy(), ref)


def test_sample_trilinear_flat_per_block(volume, coords):
    blocks = np.stack([volume, volume[::-1] * 2.0]).astype(np.float32)
    flat = blocks.reshape(-1)
    n = volume.size
    for b in range(2):
        ref = np.asarray(ref_interp.sample_trilinear_flat(flat, volume.shape, coords, base=b * n))
        got = interp.sample_trilinear_flat(_t(flat), volume.shape, _t(coords), base=b * n)
        _close(got.numpy(), ref)
    # one base per row: the multi-pair registration's pair axis
    base = torch.tensor([[0], [n]])
    got = interp.sample_trilinear_flat(_t(flat), volume.shape,
                                       _t(np.stack([coords, coords])), base=base)
    _close(got[1].numpy(), interp.sample_trilinear(_t(blocks[1]), _t(coords)).numpy())


def test_sample_nearest_exact(coords):
    vol = np.random.default_rng(4).integers(0, 40, (9, 10, 11)).astype(np.int16)
    # exact half-integers: floor(c + 0.5), not round-half-to-even
    half = np.stack(np.meshgrid(*[np.arange(-1, 12, 0.5, dtype=np.float32)] * 3,
                                indexing="ij"), -1).reshape(-1, 3)
    for c in (coords, half):
        ref = np.asarray(ref_interp.sample_nearest(vol, c, cval=7))
        got = interp.sample_nearest(_t(vol), _t(c), cval=7)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("sigma", [0.0, 0.4, 1.0, 2.0, 3.3])
def test_gaussian_kernel1d_equal(sigma):
    np.testing.assert_array_equal(filtering.gaussian_kernel1d(sigma),
                                  ref_filtering.gaussian_kernel1d(sigma))


@pytest.mark.parametrize("sigma", [1.0, (2.0, 0.0, 0.7)])
def test_gaussian_smooth3d(volume, sigma):
    ref = ref_filtering.gaussian_smooth3d(volume, sigma)
    _close(filtering.gaussian_smooth3d(_t(volume), sigma).numpy(), ref)


@pytest.mark.parametrize("sigma,factor", [(2.0, 4), (1.0, 2), (0.0, 1)])
def test_smooth_subsample(sigma, factor):
    vol = np.random.default_rng(5).uniform(0, 100, (37, 40, 42)).astype(np.float32)
    ref = np.asarray(ref_filtering.smooth_subsample(vol, sigma, factor))
    got = filtering.smooth_subsample(_t(vol), sigma, factor).numpy()
    assert got.shape == ref.shape
    _close(got, ref)


# ------------------------------------------------------------- morphology
@pytest.fixture(scope="module")
def masks():
    rng = np.random.default_rng(6)
    sparse = rng.random((20, 22, 24)) > 0.97
    blobby = np.asarray(ref_morph.binary_dilate(rng.random((20, 22, 24)) > 0.985, 2))
    return {"sparse": sparse, "blobby": blobby}


@pytest.mark.parametrize("name", ["sparse", "blobby"])
@pytest.mark.parametrize("radius", [1, 2, 4])
@pytest.mark.parametrize("box", [False, True])
def test_dilate_erode_close_open_exact(masks, name, radius, box):
    m = masks[name]
    for fn in ("binary_dilate", "binary_erode", "binary_closing", "binary_opening"):
        ref = np.asarray(getattr(ref_morph, fn)(m, radius, box=box))
        got = getattr(morphology, fn)(_t(m), radius, box=box)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=fn)


def test_dilate_iterations_exact(masks):
    m = masks["sparse"]
    ref = np.asarray(ref_morph.binary_dilate(m, 1, iterations=3))
    np.testing.assert_array_equal(morphology.binary_dilate(_t(m), 1, iterations=3).numpy(), ref)


def _cavities(shape, seed):
    """Shells with closed cavities, an open channel and a slab with holes."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, bool)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    for _ in range(5):
        c = rng.uniform(0.25, 0.75, 3) * np.asarray(shape)
        r = rng.uniform(2.5, 5.0)
        d = np.sqrt((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
        m |= (d <= r) & (d >= r - 1.2)
    m[0:3, 0:3, :] = False                    # border-open region stays open
    m |= rng.random(shape) > 0.9
    return m


@pytest.mark.parametrize("shape", [(24, 26, 28), (30, 28, 1), (1, 20, 22)])
def test_fill_holes_exact(shape):
    m = _cavities(shape, seed=7)
    ref = np.asarray(ref_morph.fill_holes(m))
    got = morphology.fill_holes(_t(m))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.sum() >= m.sum()


def test_fill_holes_long_flood_exact():
    """A spiral corridor needs many more flood steps than one check batch."""
    m = np.ones((3, 40, 40), bool)
    m[1, 1:-1, 1:-1] = False
    for k in range(2, 38, 4):                  # baffles force a serpentine path
        m[1, k, (1 if k % 8 == 2 else 3):(37 if k % 8 == 2 else 39)] = True
    m[1, 0, 1] = False                          # one opening to the border
    ref = np.asarray(ref_morph.fill_holes(m))
    np.testing.assert_array_equal(morphology.fill_holes(_t(m)).numpy(), ref)


@pytest.mark.parametrize("threshold", [1.0, 30.0])
def test_build_slice_mask_exact(threshold):
    rng = np.random.default_rng(8)
    img = np.where(_cavities((26, 28, 30), seed=9), 80.0, 0.5).astype(np.float32)
    img += rng.normal(0, 0.5, img.shape).astype(np.float32)
    ref = np.asarray(ref_morph.build_slice_mask(img, threshold))
    got = morphology.build_slice_mask(_t(img), threshold)
    np.testing.assert_array_equal(got.numpy(), ref)


# -------------------------------------------------------------------- TV
def _tv_stop_iter(sl, max_iter=200):
    """A slice's stop iteration in the port: the least budget whose result
    equals the unlimited one (bisection; the result is fixed from the
    stop on)."""
    x = _t(sl)[None]
    full = tv._tv2d(x, 0.1, 2e-4, max_iter)
    lo, hi = 1, max_iter
    while lo < hi:
        mid = (lo + hi) // 2
        if torch.equal(tv._tv2d(x, 0.1, 2e-4, mid), full):
            hi = mid
        else:
            lo = mid + 1
    return lo


def _tv_volume():
    """Slices of a normalized noisy sphere at different noise levels, so
    the slices stop between 3 and ~45 iterations, plus a constant slice
    (zero energy: every step leaves it as it is)."""
    rng = np.random.default_rng(10)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, 20)] * 3, indexing="ij")
    clean = 0.3 * (np.sqrt(z ** 2 + y ** 2 + x ** 2) < 0.7) + 1.0
    sigma = np.geomspace(0.01, 1.0, 20)[:, None, None]
    vol = (clean + rng.normal(0, 1.0, clean.shape) * sigma).astype(np.float32)
    vol[3] = 1.0
    return vol


def test_tv_denoise_slices_matches_reference():
    """Each slice of the JAX result equals the port's iterate at the port's
    own stop, or one iteration either side (an energy sum near its
    threshold), to 1e-5 of the scale; the iterates come from the port run
    with eps=0, which never stops early."""
    vol = _tv_volume()
    ref = np.asarray(ref_tv.tv_denoise_slices(vol))
    got = tv.tv_denoise_slices(_t(vol)).numpy()
    scale = float(np.abs(ref).max())
    off_by_one = 0
    for s, sl in enumerate(vol):
        stop = _tv_stop_iter(sl)
        it = {n: tv._tv2d(_t(sl)[None], 0.1, 0.0, n)[0].numpy()
              for n in (stop - 1, stop, stop + 1) if n >= 1}
        np.testing.assert_array_equal(got[s], it[stop])
        errs = {n: float(np.abs(u - ref[s]).max()) / scale for n, u in it.items()}
        assert min(errs.values()) <= ONE_PASS_RTOL, (s, stop, errs)
        off_by_one += errs[stop] > ONE_PASS_RTOL
    assert off_by_one <= 2, off_by_one
    assert np.abs(got - vol).max() > 1e-2          # it did denoise


def test_tv_slices_stop_on_their_own():
    """Each slice's result equals that slice denoised alone: the lock-step
    loop neither stops every slice at the first stop nor runs all to
    max_iter, and the slices here stop at different iterations."""
    vol = _tv_volume()[::3]
    together = tv.tv_denoise_slices(_t(vol))
    for i, sl in enumerate(vol):
        assert torch.equal(together[i], tv.tv_denoise_slices(_t(sl)[None])[0]), i
    stops = [_tv_stop_iter(sl) for sl in vol]
    assert len(set(stops)) >= 4 and max(stops) < 200, stops
