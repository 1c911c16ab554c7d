"""The port's label and mask steps against the JAX package's, on the same
seeded inputs: masks from labels, brain extraction, the phantom mask, the
SynthSeg -> FeTA remap and the phantom sphere labels. Every output is an
integer or a product with a 0/1 mask, so each is held exactly."""

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu import config as ref_C
from fetal_t2mapping_tpu.core.volume import Volume as RefVolume
from fetal_t2mapping_tpu.labels import feta as ref_feta
from fetal_t2mapping_tpu.labels import masks as ref_masks
from fetal_t2mapping_tpu.labels import phantom as ref_phantom
from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.core.volume import Volume
from fetal_t2mapping_tpu_torch.labels import feta, masks, phantom

torch.set_num_threads(1)

GEOM = dict(spacing=(0.8, 1.1, 1.3), origin=(-10.5, 4.25, 30.0),
            direction=(0.0, 1.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0, 1.0))


def _labels(shape=(20, 22, 24), seed=0):
    ids = np.array([0, 2, 3, 4, 5, 7, 8, 10, 14, 16, 17, 24, 26, 28, 41, 42, 43, 60, 77, 255])
    return np.random.default_rng(seed).choice(ids, shape).astype(np.int16)


def test_lut_and_class_names_equal():
    np.testing.assert_array_equal(feta._LUT, ref_feta._LUT)
    assert feta._SYNTHSEG_TO_FETA == ref_feta._SYNTHSEG_TO_FETA
    assert feta.FETA_CLASS_NAMES == ref_feta.FETA_CLASS_NAMES


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.uint8])
def test_synthseg_to_feta_exact(dtype):
    lab = _labels().astype(dtype)
    lab.flat[:3] = [300, -4, 1000] if dtype != np.uint8 else [250, 1, 9]   # outside the table
    ref = np.asarray(ref_feta.synthseg_to_feta(RefVolume(lab, **GEOM)).data)
    got = feta.synthseg_to_feta(Volume(lab, **GEOM), device="cpu")
    assert torch.is_tensor(got.data) and got.direction == GEOM["direction"]
    np.testing.assert_array_equal(got.data.numpy(), ref)


def test_mask_from_labels_and_extract_brain_exact():
    lab = _labels(seed=1)
    ref_mask = ref_masks.mask_from_labels(RefVolume(lab, **GEOM))
    got_mask = masks.mask_from_labels(Volume(lab, **GEOM))
    assert got_mask.data.dtype == np.uint8
    np.testing.assert_array_equal(got_mask.data, np.asarray(ref_mask.data))
    recon = np.random.default_rng(2).uniform(0, 900, lab.shape).astype(np.float32)
    ref = ref_masks.extract_brain(RefVolume(recon, **GEOM), ref_mask)
    got = masks.extract_brain(Volume(recon, **GEOM), got_mask)
    assert got.data.dtype == np.float32
    np.testing.assert_array_equal(got.data, np.asarray(ref.data))
    with pytest.raises(ValueError, match="shape mismatch"):
        masks.extract_brain(Volume(recon), Volume(lab[:-1]))


def _phantom_recon(shape=(40, 48, 52), seed=3):
    """A cylinder body with a hollow shell, tubes of other intensities and
    dark holes, in noise: fill, closing and dilation all change it."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    r = np.hypot(yy - shape[1] / 2, xx - shape[2] / 2)
    vol = np.where((r < 18) & (zz > 4) & (zz < shape[0] - 5), 300.0, 5.0)
    vol[(r > 10) & (r < 12)] = 50.0                       # a dark ring inside the body
    vol[(np.hypot(yy - 20, xx - 30) < 3)] = 600.0          # a bright tube
    vol[(np.hypot(yy - 28, xx - 20) < 2) & (zz > 10) & (zz < 20)] = 20.0   # a closed hole
    return (vol + rng.normal(0, 10.0, shape)).astype(np.float32)


@pytest.mark.parametrize("radii", [(15, 10), (3, 2)])
def test_phantom_mask_exact(radii):
    recon = _phantom_recon()
    ref = ref_masks.phantom_mask(RefVolume(recon, **GEOM), closing_radius=radii[0],
                                 dilate_radius=radii[1])
    got = masks.phantom_mask(Volume(recon, **GEOM), closing_radius=radii[0],
                             dilate_radius=radii[1], device="cpu")
    assert got.data.dtype == np.uint8 and isinstance(got.data, np.ndarray)
    np.testing.assert_array_equal(got.data, np.asarray(ref.data))
    assert 0 < got.data.sum() < got.data.size


@pytest.mark.parametrize("radius", [2, 6])
def test_phantom_labels_exact(radius):
    geom = np.zeros((30, 36, 40), np.float32)
    seeds = [[10, 12, 8], [30, 25, 20], [33, 25, 20], [5, 30, 2], [39, 0, 29]]
    ref = ref_phantom.phantom_labels_from_seeds(RefVolume(geom, **GEOM), seeds, radius=radius)
    got = phantom.phantom_labels_from_seeds(Volume(geom, **GEOM), seeds, radius=radius,
                                            device="cpu")
    assert got.data.dtype == np.uint8
    np.testing.assert_array_equal(got.data, np.asarray(ref.data))
    assert set(np.unique(got.data).tolist()) == set(range(len(seeds) + 1))


def test_phantom_labels_at_the_seed_set():
    """The default phantom seed set on a 240^3 grid, radius 6 (the CLI's)."""
    assert C.PHANTOM_SEEDS == ref_C.PHANTOM_SEEDS
    seeds = C.PHANTOM_SEEDS[C.DEFAULT_PHANTOM_SEEDS_KEY]
    geom = np.zeros((120, 240, 240), np.uint8)
    ref = ref_phantom.phantom_labels_from_seeds(RefVolume(geom), seeds)
    got = phantom.phantom_labels_from_seeds(Volume(geom), seeds, device="cpu")
    np.testing.assert_array_equal(got.data, np.asarray(ref.data))


def test_phantom_labels_bad_seeds_raise():
    with pytest.raises(ValueError, match="seeds"):
        phantom.phantom_labels_from_seeds(Volume(np.zeros((4, 4, 4))), [[1, 2]], device="cpu")
