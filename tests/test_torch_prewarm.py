"""The port's cold-start prewarm (utils/prewarm.py), header-only reads and
process_qmri(prewarm=True): tests/test_prewarm.py's cases on the port.

On the CPU these pin the host-side contracts: read_header's geometry and
dtype fidelity, the prewarm's handle (finished at once, no step: the port's
prewarm runs none), and the process_qmri wiring.
That the session's files are the same with and without the prewarm is
held in test_torch_recon_pipeline.py.
"""

import os
import struct
import threading

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.core import nifti, volcache
from fetal_t2mapping_tpu_torch.core.volume import Volume
from fetal_t2mapping_tpu_torch.labels.synthseg import SynthSegRunner
from fetal_t2mapping_tpu_torch.recon.resample import resample_volume
from fetal_t2mapping_tpu_torch.utils.bids import get_img_path
from fetal_t2mapping_tpu_torch.utils.prewarm import geoms_from_metadata, start_recon_prewarm

torch.set_num_threads(1)

# a short multi-level registration: full budgets make the CPU needlessly slow
REG_FAST = dict(levels=(2, 1), sigmas=(1.0, 0.0), iters=(8, 4), samples=(512, 512))


def _rot_direction():
    c, s = np.cos(np.pi / 6), np.sin(np.pi / 6)
    return tuple(np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]).reshape(-1))


class TestReadHeader:
    def test_matches_full_read(self, tmp_path):
        vol = Volume(np.arange(4 * 5 * 6, dtype=np.int16).reshape(4, 5, 6),
                     spacing=(0.8, 1.25, 3.0), origin=(-12.0, 4.5, 7.25),
                     direction=_rot_direction())
        for name in ("a.nii.gz", "a.nii"):
            path = str(tmp_path / name)
            nifti.write(path, vol, dtype=np.int16)
            volcache.invalidate(path)  # the on-disk header path
            full, hdr = nifti.read(path), nifti.read_header(path)
            assert hdr.shape == full.shape
            assert hdr.data.dtype == full.data.dtype
            np.testing.assert_allclose(hdr.spacing, full.spacing, atol=1e-5)
            np.testing.assert_allclose(hdr.origin, full.origin, atol=1e-4)
            np.testing.assert_allclose(hdr.direction, full.direction, atol=1e-5)
            assert not hdr.data.any()
            # a broadcast view: geometry-only reads commit no voxel memory
            assert set(hdr.data.strides) == {0}

    def test_error_contract(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            nifti.read_header(str(tmp_path / "missing.nii.gz"))
        bad = tmp_path / "bad.nii"
        bad.write_bytes(b"\x00" * 400)
        with pytest.raises(ValueError):
            nifti.read_header(str(bad))
        trunc = tmp_path / "trunc.nii.gz"
        trunc.write_bytes(b"\x1f\x8b\x08\x00junkjunk")
        with pytest.raises(ValueError):
            nifti.read_header(str(trunc))

    def test_scaled_header_promotes_to_float32(self, tmp_path):
        vol = Volume(np.arange(24, dtype=np.int16).reshape(2, 3, 4))
        path = str(tmp_path / "scaled.nii")
        nifti.write(path, vol, dtype=np.int16)
        raw = bytearray(open(path, "rb").read())
        struct.pack_into("<f", raw, 112, 2.0)   # scl_slope
        struct.pack_into("<f", raw, 116, 1.5)   # scl_inter
        open(path, "wb").write(bytes(raw))
        volcache.invalidate(path)
        full, hdr = nifti.read(path), nifti.read_header(path)
        assert full.data.dtype == hdr.data.dtype == np.float32
        np.testing.assert_allclose(full.data.ravel()[:3], [1.5, 3.5, 5.5])

    def test_pending_async_write_is_served(self, tmp_path):
        vol = Volume(np.ones((3, 4, 5), np.float32), spacing=(1, 2, 3))
        path = str(tmp_path / "q.nii.gz")
        nifti.write_async(path, vol)
        hdr = nifti.read_header(path)
        assert hdr.shape == (3, 4, 5)
        np.testing.assert_allclose(hdr.spacing, (1, 2, 3))
        nifti.flush_writes()


def _acq_geoms(n=30, dtype=np.float32):
    """Three anisotropic acquisition geometries of one ~n^3 mm field of view."""
    geoms = {}
    for otype, axis in (("ax", 2), ("cor", 1), ("sag", 0)):
        spacing = [1.0, 1.0, 1.0]
        spacing[axis] = 3.0
        shape = [n, n, n]
        shape[2 - axis] = n // 3          # data is (z, y, x); spacing is (x, y, z)
        geoms[otype] = Volume(np.broadcast_to(np.zeros((), dtype), tuple(shape)),
                              spacing=tuple(spacing))
    return geoms


class TestPrewarm:
    """The prewarm keeps the reference's interface and runs no step (no
    warm-up made stage 2 faster on the H100, utils/prewarm)."""

    @pytest.mark.parametrize("case", ["float32", "uint16", "synthseg_torch", "synthseg_fake",
                                      "unmatched_registration_kwargs"])
    def test_default_runs_no_step(self, case, tmp_path):
        """Whatever the session (integer inputs, a torch-mode U-Net whose
        weights are never read, registration arguments the stage would
        reject), the handle is finished at once: no step, no error, no
        thread started and the global RNG states untouched."""
        kwargs = {"synthseg_torch": dict(synthseg=SynthSegRunner(
                      mode="torch", weights=str(tmp_path / "missing.npz"), device="cpu")),
                  "synthseg_fake": dict(synthseg=SynthSegRunner(mode="fake")),
                  "unmatched_registration_kwargs": dict(
                      registration_kwargs=dict(levels=(2, 1)))}.get(case, {})
        geoms = _acq_geoms(dtype=np.uint16 if case == "uint16" else np.float32)
        state = torch.random.get_rng_state()
        np_state = np.random.get_state()[1].copy()
        threads = threading.active_count()
        h = start_recon_prewarm(geoms, n_echoes=3, device="cpu", **kwargs)
        assert threading.active_count() == threads
        assert h.wait(timeout=0) is h
        assert h.done and h.error is None and h.steps == [] and h.seconds == 0.0
        assert torch.equal(torch.random.get_rng_state(), state)
        assert np.array_equal(np.random.get_state()[1], np_state)

    def test_requires_fixed_orientation(self):
        geoms = _acq_geoms()
        del geoms["ax"]
        with pytest.raises(ValueError, match="fixed_type"):
            start_recon_prewarm(geoms, device="cpu")


class TestProcessQmriPrewarm:
    def _make_tree(self, root, tes=(114, 202)):
        rng = np.random.default_rng(0)
        n = 36
        z, y, x = np.meshgrid(*[np.linspace(-1, 1, n)] * 3, indexing="ij")
        truth = Volume((600.0 * np.exp(-3.0 * (x * x + y * y + z * z))).astype(np.float32))
        bids = os.path.join(root, "projects/")
        rows = []
        for te in tes:
            for otype, axis in (("ax", 2), ("cor", 1), ("sag", 0)):
                spacing = [1.0, 1.0, 1.0]
                spacing[axis] = 3.0
                low = resample_volume(truth, spacing, device="cpu")
                data = (low.data + rng.normal(0, 3.0, low.shape)).astype(np.float32)
                acq = {"prj": "prj-004", "sub": "sub-001", "ses": "ses-01",
                       "run": f"run-{otype}-{te}", "EchoTime": te / 1000.0,
                       "ImageOrientationPatientSTR": otype}
                nifti.write(get_img_path(bids, acq, C.IN_DIRNAME), low.with_data(data))
                rows.append(acq)
        return bids, rows

    def test_geoms_from_metadata(self, tmp_path):
        bids, rows = self._make_tree(str(tmp_path))
        volcache.clear()  # a fresh process reads the headers from disk
        geoms = geoms_from_metadata(rows, bids)
        assert sorted(geoms) == ["ax", "cor", "sag"]
        for g in geoms.values():
            assert set(g.data.strides) == {0}   # headers only
        assert geoms["ax"].spacing[2] == 3.0
        assert geoms_from_metadata([], bids) == {}

    def test_process_qmri_with_prewarm(self, tmp_path):
        from fetal_t2mapping_tpu_torch.pipeline.recon_pipeline import process_qmri

        bids, rows = self._make_tree(str(tmp_path))
        h = process_qmri(bids, rows, in_vivo=True, low_field=True,
                         synthseg=SynthSegRunner(mode="fake"),
                         registration_kwargs=dict(REG_FAST), prewarm=True, device="cpu")
        h.wait(timeout=300)
        assert h.error is None, h.error
        assert h.done and h.steps == []     # no step (utils/prewarm)
        recon = get_img_path(bids, rows[0], C.RECON_DIRNAME)
        assert os.path.exists(recon)
        assert nifti.read(recon).shape[0] >= 30

    def test_prewarm_skips_on_unfusable_orientations(self, tmp_path):
        # without the full ax/cor/sag triple the prewarm is skipped with a
        # warning and the pipeline runs on
        from fetal_t2mapping_tpu_torch.pipeline.recon_pipeline import process_qmri

        bids, rows = self._make_tree(str(tmp_path))
        rows = [r for r in rows if r["ImageOrientationPatientSTR"] != "ax"]
        assert process_qmri(bids, rows, in_vivo=True, low_field=True,
                            synthseg=SynthSegRunner(mode="fake"),
                            registration_kwargs=dict(REG_FAST), prewarm=True,
                            device="cpu") is None
