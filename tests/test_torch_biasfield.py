"""The port's N4-style bias correction (recon/biasfield.py) and the stage-2
step that runs it (``run_biasfield_correction``) against the JAX
package's, on the same volumes: the four cases of tests/test_biasfield.py
on the port, then port against reference.

Tolerance: corrected image and field within 1e-4 relative on the mask.
The two differ only in float32 summation order — the port sums the soft
histogram exactly (integer fixed point) where the reference scatter-adds
float32, its FFTs and separable smoothing sum in other orders — and the
histogram's linear interpolation is continuous across bin edges, so no
voxel jumps when a rounding moves it across one. Measured at 32^3: one
sharpening pass agrees to 6e-6 absolute in log space, and after 40
iterations (or 3 x 20) the corrected image to 1.4e-5 relative; 1e-4
leaves 7x. ``field_cv`` (std / |mean| of each update) is compared as
its inverse, |mean| / std, within 5e-3: the update's mean is a cancelling
sum (its std is 6x its mean at the first iteration and ~200x later), so
an error of a few float32 roundings of the field moves the ratio by
percents where the mean is near 0. The reference's own float32 value
differs from a float64 evaluation of its own field by 0.3% at the first
200 mm iteration (4.686 against 4.672). Measured |mean| / std differences
between the packages: at most 9.3e-4 over three scenes and three
settings.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from fetal_t2mapping_tpu.core import nifti as ref_nifti
from fetal_t2mapping_tpu.core.volume import Volume as RefVolume
from fetal_t2mapping_tpu.pipeline import recon_pipeline as ref_pipe
from fetal_t2mapping_tpu.recon import biasfield as ref_bf
from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.core import nifti
from fetal_t2mapping_tpu_torch.core.volume import Volume
from fetal_t2mapping_tpu_torch.pipeline import recon_pipeline as pipe
from fetal_t2mapping_tpu_torch.recon.biasfield import n4_bias_correction, shared_log_bias
from fetal_t2mapping_tpu_torch.utils.bids import get_img_path

torch.set_num_threads(1)

RTOL = 1e-4
INV_CV_ATOL = 5e-3


def _biased_volume(seed=0, nz=32, bias_strength=0.6, cls=Volume):
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, nz)] * 3, indexing="ij")
    # piecewise "tissue" image: two intensity classes + mild noise
    tissue = np.where(np.sqrt(z**2 + y**2 + x**2) < 0.6, 1000.0, 600.0)
    tissue = tissue * (1 + 0.02 * rng.standard_normal(tissue.shape))
    field = np.exp(bias_strength * (0.7 * z + 0.5 * y * y - 0.3 * x))
    mask = (np.sqrt(z**2 + y**2 + x**2) < 0.95)
    img = np.where(mask, tissue * field, 0.0).astype(np.float32)
    return (cls(data=img, spacing=(4.0, 4.0, 4.0), origin=(0, 0, 0)),
            cls(data=mask.astype(np.uint8), spacing=(4.0, 4.0, 4.0), origin=(0, 0, 0)),
            field, mask, tissue)


def _cv(img, mask):
    vals = img[mask]
    return np.std(vals) / np.mean(vals)


def _held(a, b, mask, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    rel = np.abs(a[mask] - b[mask]) / np.abs(b[mask])
    assert rel.max() <= rtol, rel.max()


def test_n4_reduces_residual_field_error():
    vol, mask_vol, field, mask, tissue = _biased_volume()
    res = n4_bias_correction(vol, mask_vol, device="cpu")
    err_before = np.std(np.log(vol.data[mask] / tissue[mask]))
    err_after = np.std(np.log(np.maximum(res.corrected.data[mask], 1e-6) / tissue[mask]))
    assert err_after < err_before * 0.5, (err_before, err_after)
    corr = np.corrcoef(np.log(res.field.data[mask]), np.log(field[mask]))[0, 1]
    assert corr > 0.9, corr
    assert res.field_cv.shape == (40,)


def test_n4_multiresolution_refines():
    vol, mask_vol, field, mask, tissue = _biased_volume(seed=3)
    single = n4_bias_correction(vol, mask_vol, n_iters=20, ctrl_spacing_mm=100.0, device="cpu")
    multi = n4_bias_correction(vol, mask_vol, n_iters=20, ctrl_spacing_mm=(200.0, 100.0, 60.0),
                               device="cpu")

    def err(res):
        return np.std(np.log(np.maximum(res.corrected.data[mask], 1e-6) / tissue[mask]))

    assert err(multi) <= err(single) * 1.05
    assert multi.field_cv.shape == (60,)


def test_n4_nearly_identity_on_unbiased_image():
    vol, mask_vol, _, mask, _tis = _biased_volume(bias_strength=0.0)
    res = n4_bias_correction(vol, mask_vol, n_iters=10, ctrl_spacing_mm=60.0, device="cpu")
    assert np.abs(np.log(res.field.data[mask])).max() < 0.1


def test_shared_log_bias_pools_echoes():
    vol1, mask_vol, field, mask, _tis = _biased_volume(seed=1)
    vol2 = vol1.with_data((vol1.data * 0.5).astype(np.float32))
    corrected, shared = shared_log_bias([vol1, vol2], [mask_vol, mask_vol],
                                        n_iters=10, ctrl_spacing_mm=60.0, device="cpu")
    assert len(corrected) == 2
    assert _cv(corrected[0].data, mask) < _cv(vol1.data, mask)
    corr = np.corrcoef(np.log(shared.data[mask]), np.log(field[mask]))[0, 1]
    assert corr > 0.7, corr


@pytest.mark.parametrize("kw", [dict(), dict(n_iters=20, ctrl_spacing_mm=(200.0, 100.0, 60.0)),
                                dict(n_iters=10, ctrl_spacing_mm=60.0, mask=False)],
                         ids=["single-level", "three-levels", "no-mask"])
def test_n4_matches_reference(kw):
    kw = dict(kw)
    use_mask = kw.pop("mask", True)
    vol, mask_vol, _, mask, _ = _biased_volume(seed=5)
    rvol, rmask_vol, *_ = _biased_volume(seed=5, cls=RefVolume)
    res = n4_bias_correction(vol, mask_vol if use_mask else None, device="cpu", **kw)
    ref = ref_bf.n4_bias_correction(rvol, rmask_vol if use_mask else None, **kw)
    fg = mask if use_mask else vol.data > 0
    _held(res.corrected.data, ref.corrected.data, fg)
    _held(res.field.data, ref.field.data, fg)
    np.testing.assert_array_equal(res.corrected.data[~fg], np.asarray(ref.corrected.data)[~fg])
    assert res.field_cv.shape == np.asarray(ref.field_cv).shape
    np.testing.assert_allclose(1 / res.field_cv, 1 / np.asarray(ref.field_cv), rtol=0,
                               atol=INV_CV_ATOL)
    assert res.corrected.spacing == vol.spacing


def test_n4_repeats_bitwise():
    vol, mask_vol, *_ = _biased_volume(seed=2, nz=24)
    a = n4_bias_correction(vol, mask_vol, n_iters=5, device="cpu")
    b = n4_bias_correction(vol, mask_vol, n_iters=5, device="cpu")
    np.testing.assert_array_equal(a.field.data, b.field.data)
    np.testing.assert_array_equal(a.corrected.data, b.corrected.data)
    np.testing.assert_array_equal(a.field_cv, b.field_cv)


def test_shared_log_bias_matches_reference():
    vol1, mask_vol, *_ = _biased_volume(seed=1)
    rvol1, rmask_vol, *_ = _biased_volume(seed=1, cls=RefVolume)
    vol2 = vol1.with_data((vol1.data * 0.5).astype(np.float32))
    rvol2 = rvol1.with_data((np.asarray(rvol1.data) * 0.5).astype(np.float32))
    kw = dict(n_iters=10, ctrl_spacing_mm=60.0)
    corrected, shared = shared_log_bias([vol1, vol2], [mask_vol, mask_vol], device="cpu", **kw)
    r_corrected, r_shared = ref_bf.shared_log_bias([rvol1, rvol2], [rmask_vol, rmask_vol], **kw)
    mask = mask_vol.data > 0
    _held(shared.data, r_shared.data, mask)
    for a, b in zip(corrected, r_corrected):
        _held(a.data, b.data, mask)


N_TREE = 20
TREE_KW = dict(n_iters=8, ctrl_spacing_mm=50.0)


def _tree(root):
    """Resampled volumes of one session: two orientations x two TEs, each
    with the same smooth field per orientation."""
    bids = os.path.join(root, "projects/")
    rows = []
    for o, otype in enumerate(("ax", "cor")):
        for te in (114, 202):
            img = _biased_volume(seed=o, nz=N_TREE, cls=RefVolume)[0]
            data = (np.asarray(img.data) * np.exp(-te / 150.0)).astype(np.float32)
            acq = {"prj": "prj-004", "sub": "sub-001", "ses": "ses-01",
                   "run": f"run-{otype}-{te}", "EchoTime": te / 1000.0,
                   "ImageOrientationPatientSTR": otype, "CoilString": "Body"}
            ref_nifti.write(get_img_path(bids, acq, C.RESAMP_DIRNAME), img.with_data(data),
                            dtype=np.float32)
            rows.append(acq)
    return bids, rows


@pytest.mark.parametrize("shared", [False, True])
def test_run_biasfield_correction_matches_reference(tmp_path, shared):
    bids_p, rows = _tree(str(tmp_path / "port"))
    bids_r, _ = _tree(str(tmp_path / "ref"))
    pipe.run_biasfield_correction(rows, bids_p, shared=shared, device="cpu", **TREE_KW)
    ref_pipe.run_biasfield_correction(pd.DataFrame(rows), bids_r, shared=shared, **TREE_KW)
    for acq in rows:
        a = nifti.read(get_img_path(bids_p, acq, C.N4_DIRNAME))
        b = ref_nifti.read(get_img_path(bids_r, acq, C.N4_DIRNAME))
        assert a.spacing == tuple(b.spacing) and a.origin == tuple(b.origin)
        fg = np.asarray(b.data) > 0
        _held(a.data, np.asarray(b.data), fg)
    # outputs that exist are kept unless overwrite is asked for
    path = get_img_path(bids_p, rows[0], C.N4_DIRNAME)
    stamp = os.path.getmtime(path)
    pipe.run_biasfield_correction(rows, bids_p, shared=shared, device="cpu", **TREE_KW)
    assert os.path.getmtime(path) == stamp
