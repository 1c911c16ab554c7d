"""The port's Keras-weight converter (``labels/convert_synthseg``) against
the JAX package's, on the CPU, on fixture .h5 files written in Keras's
layout (tests/test_synthseg_weights.py, tests/test_synthseg_real_layout.py).

The .npz manifests must be equal key by key and bitwise; the distractor,
cascade, missing-bias and batch-norm cases must behave the same (the same
manifest, or the same error class and message); and the port's
``segment_volume`` on the converted weights must give the JAX package's
labels at a small crop, exactly as tests/test_torch_unet3d.py holds fp32
segmentations. The weights then run through ``SynthSegRunner(mode="torch")``.
"""

import os

import numpy as np
import pytest

from fetal_t2mapping_tpu.labels import convert_synthseg as ref_conv
from fetal_t2mapping_tpu.labels import unet3d as ref_unet3d
from fetal_t2mapping_tpu_torch.core import Volume, nifti
from fetal_t2mapping_tpu_torch.labels import SynthSegRunner, convert_synthseg, unet3d
from tests.test_synthseg_real_layout import REAL_CFG, _write_real_layout_h5
from tests.test_synthseg_weights import CFG, _write_fixture_h5

h5py = pytest.importorskip("h5py")


def _both(tmp_path, h5_path):
    """Convert with each package; return (port dict, ref dict, port npz, ref npz)."""
    out = []
    for name, mod in (("port", convert_synthseg), ("ref", ref_conv)):
        npz = str(tmp_path / f"{name}.npz")
        out.append((mod.convert(h5_path, npz, verbose=False), npz))
    (got, npz_p), (want, npz_r) = out
    return got, want, npz_p, npz_r


def _equal_manifests(got, want, npz_p, npz_r):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    with np.load(npz_p) as a, np.load(npz_r) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(want)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


@pytest.fixture(scope="module")
def fixture_h5(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("synthseg") / "fixture.h5")
    _write_fixture_h5(h5py, path, CFG)
    return path


def test_manifest_equals_reference(fixture_h5, tmp_path, capsys):
    got = convert_synthseg.convert(fixture_h5, str(tmp_path / "port.npz"))
    printed = capsys.readouterr().out
    want = ref_conv.convert(fixture_h5, str(tmp_path / "ref.npz"))
    assert printed == capsys.readouterr().out       # the same mapping, layer by layer
    _equal_manifests(got, want, str(tmp_path / "port.npz"), str(tmp_path / "ref.npz"))
    cfg = unet3d.config_from_params(unet3d.load_params(str(tmp_path / "port.npz")))
    assert (cfg.n_levels, cfg.base_features, cfg.n_labels) == (CFG.n_levels, CFG.base_features,
                                                                CFG.n_labels)


def test_real_layout_with_batch_norm_equals_reference(tmp_path):
    path = str(tmp_path / "synthseg_1.0.h5")
    _write_real_layout_h5(h5py, path, REAL_CFG)
    got, want, npz_p, npz_r = _both(tmp_path, path)
    _equal_manifests(got, want, npz_p, npz_r)
    assert {k for k in got if k.startswith("bn_up")} == {
        f"bn_up{lv}_{sfx}" for lv in range(REAL_CFG.n_levels - 1) for sfx in ("s", "b")}


def test_distractors_are_skipped_as_the_reference_skips_them(fixture_h5, tmp_path):
    """tests/test_synthseg_weights.py:188-226: optimizer slots, a stray
    batch-norm layer and a 2-D 'kernel' give the clean file's manifest."""
    dirty = str(tmp_path / "dirty.h5")
    _write_fixture_h5(h5py, dirty, CFG)
    rng = np.random.default_rng(0)
    with h5py.File(dirty, "a") as f:
        lay = f.create_group("optimizer_weights/Adam").create_group("unet_conv_downarm_0_0")
        lay.create_dataset("kernel:0", data=rng.normal(
            0, 1, (CFG.kernel,) * 3 + (1, CFG.base_features)).astype(np.float32))
        lay.create_dataset("bias:0", data=rng.normal(0, 1, CFG.base_features).astype(np.float32))
        f["optimizer_weights"].create_dataset("iter:0", data=np.asarray(123, np.int64))
        bn = f["model_weights"].create_group("unet_bn_0").create_group("unet_bn_0")
        for nm in ("gamma:0", "beta:0", "moving_mean:0", "moving_variance:0"):
            bn.create_dataset(nm, data=np.ones(CFG.base_features, np.float32))
        f["model_weights"].create_group("unet_dense").create_group("unet_dense").create_dataset(
            "kernel:0", data=np.ones((4, 4), np.float32))
    got, want, npz_p, npz_r = _both(tmp_path, dirty)
    _equal_manifests(got, want, npz_p, npz_r)
    clean = convert_synthseg.convert(fixture_h5, str(tmp_path / "clean.npz"), verbose=False)
    _equal_manifests(got, clean, npz_p, str(tmp_path / "clean.npz"))


def _cascade(path):
    _write_fixture_h5(h5py, path, CFG, prefix="unet")
    _write_fixture_h5(h5py, path, CFG, prefix="l2l", seed=7)


def _no_bias(path):
    _write_fixture_h5(h5py, path, CFG)
    with h5py.File(path, "a") as f:
        del f["model_weights/unet_conv_downarm_0_0/unet_conv_downarm_0_0/bias:0"]


def _bn_missing_leaf(path):
    _write_real_layout_h5(h5py, path, REAL_CFG)
    with h5py.File(path, "a") as f:
        del f["unet_bn_down_1/unet_bn_down_1/moving_mean:0"]


def _bn_count(path):
    _write_real_layout_h5(h5py, path, REAL_CFG)
    with h5py.File(path, "a") as f:
        del f["unet_bn_up_0"]


def _no_head(path):
    _write_fixture_h5(h5py, path, CFG)
    with h5py.File(path, "a") as f:
        del f["model_weights/unet_likelihood"]


@pytest.mark.parametrize("make", [_cascade, _no_bias, _bn_missing_leaf, _bn_count, _no_head],
                         ids=lambda f: f.__name__.strip("_"))
def test_bad_files_raise_as_the_reference(tmp_path, make):
    path = str(tmp_path / "bad.h5")
    make(path)
    with pytest.raises(ValueError) as want:
        ref_conv.convert(path, str(tmp_path / "ref.npz"), verbose=False)
    with pytest.raises(ValueError) as got:
        convert_synthseg.convert(path, str(tmp_path / "port.npz"), verbose=False)
    assert str(got.value) == str(want.value)
    assert not os.path.exists(tmp_path / "port.npz")


def test_converted_weights_segment_as_the_reference(fixture_h5, tmp_path):
    """segment_volume on the CPU (fp32) at a small crop: the JAX package's
    labels, exactly; then the same weights through SynthSegRunner."""
    npz = str(tmp_path / "w.npz")
    convert_synthseg.convert(fixture_h5, npz, verbose=False)
    params = unet3d.load_params(npz)
    vol = np.abs(np.random.default_rng(2).normal(300, 120, (23, 20, 26))).astype(np.float32)
    got = unet3d.segment_volume(params, vol, device="cpu")
    want = ref_unet3d.segment_volume(ref_unet3d.load_params(npz), vol)
    assert got.dtype == np.int16 and got.shape == vol.shape
    np.testing.assert_array_equal(got, want)
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    nifti.write(str(in_dir / "recon.nii.gz"), Volume(vol, spacing=(1.0, 1.0, 1.0)))
    SynthSegRunner(mode="torch", weights=npz, device="cpu").run(str(in_dir), str(out_dir))
    outs = nifti.list_volumes(str(out_dir))
    assert len(outs) == 1
    np.testing.assert_array_equal(nifti.read(outs[0]).data, got)


def test_main_usage_names_the_port(capsys):
    with pytest.raises(SystemExit, match="fetal_t2mapping_tpu_torch.labels.convert_synthseg"):
        convert_synthseg.main(["only-one-argument.h5"])
    assert "Convert released SynthSeg Keras weights" in capsys.readouterr().out
