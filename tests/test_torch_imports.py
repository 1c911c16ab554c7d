"""The port stands alone: importing every module of
``fetal_t2mapping_tpu_torch`` pulls in neither ``jax`` nor the JAX package,
and asking for a GPU where there is none raises instead of moving to the
CPU."""

import json
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import fetal_t2mapping_tpu_torch
from fetal_t2mapping_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import fetal_t2mapping_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names,
                  "leaked": sorted(m for m in sys.modules
                                   if m == "jax" or m.startswith("jax.")
                                   or m.startswith("jaxlib")
                                   or m.startswith("fetal_t2mapping_tpu.")
                                   or m == "fetal_t2mapping_tpu")}))
"""


def test_importing_every_module_leaves_jax_out():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {m.name for m in pkgutil.walk_packages(
        fetal_t2mapping_tpu_torch.__path__, "fetal_t2mapping_tpu_torch.")}
    assert set(res["modules"]) == expected
    for name in ("fused_fit", "fgh", "signal", "init", "solver", "oracle", "t2map"):
        assert f"fetal_t2mapping_tpu_torch.models.{name}" in expected
    for name in ("unet3d", "conv_s2d", "synthseg"):
        assert f"fetal_t2mapping_tpu_torch.labels.{name}" in expected
    for name in ("build", "pipeline.recon_pipeline", "cli.qmri_reconstruction",
                 "ops.interp", "ops.filtering", "ops.tv", "ops.morphology",
                 "recon.resample", "recon.registration", "recon.fuse", "recon.denoise",
                 "labels.masks", "labels.feta", "labels.phantom",
                 "models.volume_fit", "models.lut", "recon.biasfield", "analysis.roi",
                 "analysis.noise", "analysis.stats", "analysis.figures",
                 "utils.dicom", "utils.jpegll", "utils.jpegdct", "utils.dcm2nifti",
                 "utils.ingest", "cli.dcm2csv", "labels.convert_synthseg",
                 "core.volcache", "native", "utils.prewarm", "parallel", "parallel.mesh",
                 "core.nifti", "models.t2map", "pipeline.t2map_pipeline", "cli.t2mapping",
                 "labels.synthseg", "entry", "examples", "examples.serving",
                 "examples.multichip", "examples.invitro_phantom", "examples.invivo_analysis",
                 "examples.profile_unet"):
        assert f"fetal_t2mapping_tpu_torch.{name}" in expected
    assert res["leaked"] == []


_INGEST_PROBE = """
import json, os, sys
import numpy as np
from fetal_t2mapping_tpu_torch import build
from fetal_t2mapping_tpu_torch.utils import dicom, jpegll
img = np.arange(48, dtype=np.uint16).reshape(6, 8) * 37
ok = bool((build.jpegll_decode(jpegll.encode(img)) == img).all())
flags = build.dicom_probe([sys.argv[1]])
print(json.dumps({"ok": ok, "flags": flags, "lib": build.host_lib_path(),
                  "leaked": sorted(m for m in sys.modules
                                   if m == "jax" or m.startswith("jax.")
                                   or m.startswith("jaxlib")
                                   or m.startswith("fetal_t2mapping_tpu.")
                                   or m == "fetal_t2mapping_tpu")}))
"""


def test_host_binding_runs_without_the_jax_package():
    """The ingest's host library (csrc/dicom_host.cpp, built by build.py
    with g++) decodes and probes in a process that never imports jax, the
    JAX package or its native library."""
    from fetal_t2mapping_tpu_torch import build

    if shutil.which(build.gxx()) is None:
        pytest.skip("needs g++ to build csrc/dicom_host.cpp")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _INGEST_PROBE, __file__], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["flags"] == [0] and res["leaked"] == []
    assert res["lib"].startswith(os.path.join(os.path.dirname(build.__file__), "_build"))
    assert os.path.basename(build.HOST_SOURCE) == "dicom_host.cpp"


_IO_PROBE = """
import json, os, sys
import numpy as np
import torch
from fetal_t2mapping_tpu_torch import native
from fetal_t2mapping_tpu_torch.core import Volume, nifti, volcache
from fetal_t2mapping_tpu_torch.utils.prewarm import start_recon_prewarm
path = os.path.join(sys.argv[1], "v.nii.gz")
nifti.write_async(path, Volume(torch.arange(60.0).reshape(3, 4, 5)), dtype=np.int16)
nifti.flush_writes()
volcache.clear()
ok = bool((nifti.read(path).data == np.arange(60).reshape(3, 4, 5)).all())
geoms = {o: Volume(np.broadcast_to(np.zeros((), np.int16), (4, 12, 12)), spacing=(1, 1, 3))
         for o in ("ax", "cor", "sag")}
h = start_recon_prewarm(geoms, n_echoes=1, denoise=False, device="cpu").wait()
print(json.dumps({"ok": ok, "native": native.available(), "steps": h.steps,
                  "error": repr(h.error),
                  "leaked": sorted(m for m in sys.modules
                                   if m == "jax" or m.startswith("jax.")
                                   or m.startswith("jaxlib")
                                   or m.startswith("fetal_t2mapping_tpu.")
                                   or m == "fetal_t2mapping_tpu")}))
"""


def test_io_layer_runs_without_the_jax_package(tmp_path):
    """The volume cache, the async writer through the native gzip library
    (csrc/gzio_host.cpp) and the prewarm run in a process that never
    imports jax, the JAX package or its native library."""
    from fetal_t2mapping_tpu_torch import build

    if shutil.which(build.gxx()) is None:
        pytest.skip("needs g++ to build csrc/gzio_host.cpp")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "FT2_DISABLE_NATIVE")}
    out = subprocess.run([sys.executable, "-c", _IO_PROBE, str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["native"] and res["leaked"] == [], res
    assert res["steps"] == [] and res["error"] == "None", res   # the prewarm runs no step


_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|fetal_t2mapping_tpu)(\.|\s|$)", re.M)


def test_source_has_no_jax_import():
    pkg_dir = os.path.dirname(fetal_t2mapping_tpu_torch.__file__)
    n_files = 0
    for root, _, files in os.walk(pkg_dir):
        for f in files:
            if f.endswith(".py"):
                n_files += 1
                with open(os.path.join(root, f)) as fh:
                    assert not _JAX_IMPORT.search(fh.read()), f
    assert n_files >= 20


def test_resolve_device_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_fit_fused_defaults_to_cuda(monkeypatch):
    from fetal_t2mapping_tpu_torch.models.fused_fit import fit_fused

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fit_fused([[900.0, 400.0, 200.0]], (114.0, 202.0, 299.0),
                  (0.0, 10.0), (1e6, 2000.0))


def test_segment_volume_defaults_to_cuda(monkeypatch):
    from fetal_t2mapping_tpu_torch.labels import unet3d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = unet3d.UNetConfig(n_levels=2, base_features=2, n_labels=3)
    params = unet3d.random_params(cfg, seed=0)
    for use_s2d in (False, "kernel"):
        with pytest.raises(RuntimeError, match="is_available"):
            unet3d.segment_volume(params, np.ones((8, 8, 8), np.float32), cfg,
                                  use_s2d=use_s2d)


def test_weight_converters_default_to_cuda(monkeypatch):
    from fetal_t2mapping_tpu_torch.labels import unet3d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = unet3d.UNetConfig(n_levels=2, base_features=2, n_labels=3)
    params = unet3d.random_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="is_available"):
        unet3d.to_torch_params(params)
    with pytest.raises(RuntimeError, match="is_available"):
        unet3d.to_torch_s2d_params(unet3d.s2d_level0_params(params, cfg))


def _fit_volume():
    from fetal_t2mapping_tpu_torch.models import fit_volume

    fit_volume(np.ones((4, 4, 4, 3), np.float32), np.ones((4, 4, 4), bool),
               (114.0, 202.0, 299.0), (0.0, 10.0), (1e6, 2000.0))


def _n4():
    from fetal_t2mapping_tpu_torch.core.volume import Volume
    from fetal_t2mapping_tpu_torch.recon import n4_bias_correction

    n4_bias_correction(Volume(np.ones((4, 4, 4), np.float32)))


def _shared_n4():
    from fetal_t2mapping_tpu_torch.core.volume import Volume
    from fetal_t2mapping_tpu_torch.recon import shared_log_bias

    shared_log_bias([Volume(np.ones((4, 4, 4), np.float32))])


def _lut():
    from fetal_t2mapping_tpu_torch.models.lut import lut_t2

    lut_t2(np.ones((4, 3), np.float32), te=(114.0, 202.0, 299.0))


def _roi_moments():
    from fetal_t2mapping_tpu_torch.analysis.roi import roi_stats_per_label

    roi_stats_per_label(np.ones((4, 4, 4), np.float32), np.ones((4, 4, 4), np.int16))


def _roi_atlas():
    from fetal_t2mapping_tpu_torch.analysis.roi import t2_per_atlas_roi

    ones = np.ones((4, 4, 4), np.int16)
    t2_per_atlas_roi(np.ones((4, 4, 4), np.float32), ones, ones, [{"index": 1, "name": "a"}], 1)


def _roi_tissue():
    from fetal_t2mapping_tpu_torch.analysis.roi import t2_per_tissue_feta

    t2_per_tissue_feta(np.ones((4, 4, 4), np.float32), np.ones((4, 4, 4), np.int16))


@pytest.mark.parametrize("call", [_fit_volume, _n4, _shared_n4, _lut, _roi_moments, _roi_atlas,
                                  _roi_tissue], ids=lambda f: f.__name__.strip("_"))
def test_serving_and_analysis_default_to_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        call()


@pytest.mark.parametrize("model,lo,hi", [
    ("gaussian_rician", (1.0, 10.0, 1.0), (1e6, 2000.0, 1e3)),
    ("rician", (1.0, 10.0, 1.0), (1e6, 2000.0, 1e3))])
def test_three_parameter_fits_default_to_cuda(monkeypatch, model, lo, hi):
    from fetal_t2mapping_tpu_torch.models.fused_fit import fit_fused

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fit_fused([[900.0, 400.0, 200.0]], (114.0, 202.0, 299.0), lo, hi, model=model)


_FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "{fail}" in args[-1]:
    print("ptxas error: made to fail"); sys.exit(2)
open(out, "w").write("built from " + args[-1])
print("flags: " + " ".join(args[:args.index("-o")]))
print("ptxas info    : Used 42 registers")
"""


def _fake_toolkit(tmp_path, monkeypatch, fail=""):
    from fetal_t2mapping_tpu_torch import build

    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True, exist_ok=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, fail=fail or "no such source"))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    return build


def test_build_compiles_every_source_once(tmp_path, monkeypatch):
    """One nvcc per csrc/*.cu into the build directory, each with its
    compiler log and its own flags; an up-to-date library is not rebuilt."""
    b = _fake_toolkit(tmp_path, monkeypatch)
    csrc = os.path.join(os.path.dirname(fetal_t2mapping_tpu_torch.__file__), "csrc")
    assert {os.path.basename(v) for v in b.KERNEL_SOURCES.values()} == {
        f for f in os.listdir(csrc) if f.endswith(".cu")}
    libs = b.build_kernels()
    assert set(libs) == {"gauss_fit", "gr_varpro_fit", "fit3", "conv_s2d", "volume_layout"}
    for name, path in libs.items():
        with open(path) as f:
            assert f.read() == "built from " + b.KERNEL_SOURCES[name]
        log = b.build_log(name)
        assert "Used 42 registers" in log
        assert "flags: " + " ".join(b.nvcc_flags(name)) in log
        assert "arch=compute_90a,code=sm_90a" in log
        # the fits round op by op like their plain versions: no FMA
        # contraction; the conv is held by a tolerance and keeps it, the
        # volume layout only copies
        assert ("-fmad=false" in log) == (name not in ("conv_s2d", "volume_layout"))
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [f"lib{n}.so" for n in libs] + [f"{n}.log" for n in libs])
    stamp = {n: os.path.getmtime(p) for n, p in libs.items()}
    b.build_kernels()
    assert {n: os.path.getmtime(p) for n, p in libs.items()} == stamp


def test_failed_build_raises_and_leaves_no_library(tmp_path, monkeypatch):
    b = _fake_toolkit(tmp_path, monkeypatch, fail="conv_s2d.cu")
    with pytest.raises(RuntimeError, match="made to fail"):
        b.build_kernels()
    built = os.listdir(tmp_path / "build")
    assert "libconv_s2d.so" not in built and not any(f.endswith(".tmp") for f in built)
    assert {"libgr_varpro_fit.so", "libfit3.so", "libgauss_fit.so"} <= set(built)
