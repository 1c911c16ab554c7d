"""``fit_volume(mesh=)``: one serving request over a voxel mesh of CPU
entries (``voxel_mesh(devices=["cpu"] * 4)`` and a mesh of 3), plain PyTorch
fit versions.

Port against port, tolerance none (bitwise): on the ragged 56 x 48 x 48
stack of the reference's dry run (tilted ellipsoid, 5% holes, uneven
per-shard counts), every map, ``n_masked`` and ``n_overflow`` of the block
layout over every block (``compact=False``, the cases named "dense"), at
``mask_frac`` and voxel-exact under 'single' equal the single-device call's
for the three models; under 'twophase' each shard runs its own refit
rounds, so every voxel its rounds handle equals 'single' and
``n_overflow`` equals the count recomputed on the host from the phase-1
flags (``chip_smoke.volume_twophase_left``).

Port against reference: at a starved ``mask_frac`` the capacity overflow
(exact integers) equals the JAX package's ``fit_volume`` on arrays sharded
over its 8 fake CPU devices; at the reference's 8 x 16 x 16 shape
(tests/test_parallel.py:155-163) the maps agree within the bands of
ROADMAP.md (gaussian parameters 1e-3 relative, 3-parameter k and T2 1e-2,
converged shares within 0.01) on the masked voxels.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import chip_smoke as cs
from fetal_t2mapping_tpu.models.volume_fit import fit_volume as ref_fit_volume
from fetal_t2mapping_tpu.parallel import mesh as ref_mesh
from fetal_t2mapping_tpu_torch.entry import ragged_stack
from fetal_t2mapping_tpu_torch.models import fused_fit
from fetal_t2mapping_tpu_torch.models.volume_fit import fit_volume
from fetal_t2mapping_tpu_torch.parallel import pad_to_devices, voxel_mesh

torch.set_num_threads(1)

TES = (114.0, 202.0, 299.0)
FITS = {  # model: (lo, hi, guess)
    "gaussian": ((0.0, 10.0), (1e6, 2000.0), None),
    "gaussian_rician": ((1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0)),
    "rician": ((1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0)),
}
LAYOUTS = {"dense": dict(compact=False), "block": dict(compact=True),
           "voxel": dict(compact=True, block=1)}
MASK_FRAC = 0.6


@functools.lru_cache(maxsize=None)
def _ragged():
    vol, mask, per_shard, _ = ragged_stack(4)
    assert len(set(per_shard)) == 4 and int(mask.sum()) > 20_000   # uneven shards
    return vol, mask


def _kw(model, layout, **extra):
    lo, hi, guess = FITS[model]
    return dict(te=TES, lo=lo, hi=hi, model=model, guess=guess, mask_frac=MASK_FRAC,
                **LAYOUTS[layout], **extra)


def _call(vol, mask, kw, **where):
    kw = dict(kw)
    return fit_volume(vol, mask, kw.pop("te"), kw.pop("lo"), kw.pop("hi"), **kw, **where)


@functools.lru_cache(maxsize=None)
def _single(model, layout):
    vol, mask = _ragged()
    return _call(vol, mask, _kw(model, layout), device="cpu")


def _assert_same(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("size", [3, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("model", sorted(FITS))
def test_mesh_is_the_single_device_call(model, layout, size):
    vol, mask = _ragged()
    single = _single(model, layout)
    meshed = _call(vol, mask, _kw(model, layout), mesh=voxel_mesh(devices=["cpu"] * size))
    _assert_same(single, meshed)
    assert int(meshed.n_masked) == int(mask.sum()) and int(meshed.n_overflow) == 0
    assert meshed.t2.device == torch.device("cpu")


@pytest.mark.parametrize("model,layout", [("gaussian", "dense"), ("gaussian", "block"),
                                          ("gaussian", "voxel"), ("gaussian_rician", "block"),
                                          ("rician", "block")])
def test_twophase_handles_voxels_as_single(model, layout):
    """Each shard's rounds refit the blocks of its own rows: the voxels
    they handle equal 'single', the rest are counted in n_overflow."""
    vol, mask = _ragged()
    mesh = voxel_mesh(devices=["cpu"] * 3)
    single = _single(model, layout)
    conv1 = _call(vol, mask, _kw(model, layout, max_iters=10), device="cpu").converged
    conv1 = conv1.numpy().reshape(-1)
    rows = cs.volume_fit_rows(mask, layout != "dense", MASK_FRAC, LAYOUTS[layout].get("block", 32))
    bc = fused_fit.resolve_tail_block(None, model)
    counts = {}
    for tail_frac in (None, 1e-4):
        tp = _call(vol, mask, _kw(model, layout, strategy="twophase", tail_frac=tail_frac),
                   mesh=mesh)
        left = cs.volume_twophase_left(rows, conv1, mesh.size, pad_to_devices(rows.size, mesh),
                                       bc, fused_fit.resolve_tail_frac(tail_frac, bc))
        assert int(tp.n_overflow) == int(left.sum())
        keep = torch.from_numpy(mask & ~left.reshape(mask.shape))
        for f in ("t2", "k", "sigma", "fun", "converged", "n_iter"):
            assert torch.equal(getattr(tp, f)[keep], getattr(single, f)[keep]), f
        counts[tail_frac] = int(tp.n_overflow)
    if model == "gaussian":     # the pipeline's ftol 1e-9 leaves stragglers after phase 1
        assert counts[1e-4] > 0


def _small(noise=0.0):
    """tests/test_parallel.py:155-163's 8 x 16 x 16 stack and mask."""
    rng = np.random.default_rng(5)
    z, y, x = 8, 16, 16
    te = np.asarray(TES, np.float32)
    t2 = rng.uniform(50, 400, (z, y, x)).astype(np.float32)
    k = rng.uniform(600, 4000, (z, y, x)).astype(np.float32)
    sig = (k[..., None] * np.exp(-te / t2[..., None])).astype(np.float32)
    mask = np.zeros((z, y, x), bool)
    mask[2:6, 4:12, 4:12] = True
    return sig, mask


def _ref_sharded(sig, mask, **kw):
    mesh = ref_mesh.voxel_mesh()
    assert mesh.devices.size == 8
    sig_sh = jax.device_put(sig, NamedSharding(mesh, P("vox", None, None, None)))
    mask_sh = jax.device_put(mask, NamedSharding(mesh, P("vox", None, None)))
    return ref_fit_volume(sig_sh, mask_sh, TES, **kw)


@pytest.mark.parametrize("block", [32, 1])
def test_starved_capacity_overflow_matches_the_reference(block):
    sig, mask = _small()
    lo, hi, _ = FITS["gaussian"]
    kw = dict(mask_frac=0.02, compact=True, block=block, check_capacity=False)
    single = fit_volume(sig, mask, TES, lo, hi, device="cpu", **kw)
    meshes = [fit_volume(sig, mask, TES, lo, hi, mesh=voxel_mesh(devices=["cpu"] * s), **kw)
              for s in (3, 4)]
    ref = _ref_sharded(sig, mask, lo=lo, hi=hi, strategy="single", **kw)
    want = int(ref.n_overflow)
    assert want > 0 and int(ref.n_masked) == int(mask.sum())
    assert int(single.n_overflow) == want
    for m in meshes:
        _assert_same(single, m)


@pytest.mark.parametrize("model", sorted(FITS))
def test_mesh_matches_the_reference_sharded_call(model):
    sig, mask = _small()
    lo, hi, guess = FITS[model]
    kw = dict(model=model, guess=guess, mask_frac=0.5, compact=True)
    p = fit_volume(sig, mask, TES, lo, hi, mesh=voxel_mesh(devices=["cpu"] * 4), **kw)
    r = _ref_sharded(sig, mask, lo=lo, hi=hi, strategy="single", **kw)
    assert int(p.n_masked) == int(r.n_masked) and int(p.n_overflow) == int(r.n_overflow) == 0
    band = 1e-3 if model == "gaussian" else 1e-2
    for f in ("t2", "k"):
        a, b = getattr(p, f).numpy()[mask], np.asarray(getattr(r, f))[mask]
        assert (np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max() <= band, f
    conv_p, conv_r = p.converged.numpy()[mask].mean(), np.asarray(r.converged)[mask].mean()
    assert abs(conv_p - conv_r) <= 0.01


def test_device_other_than_the_first_mesh_device_raises(monkeypatch):
    sig, mask = _small()
    lo, hi, _ = FITS["gaussian"]
    mesh = voxel_mesh(devices=["cpu"] * 2)
    ok = fit_volume(sig, mask, TES, lo, hi, mesh=mesh, device="cpu", compact=False)
    assert ok.t2.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="not the mesh's first device"):
        fit_volume(sig, mask, TES, lo, hi, mesh=mesh, device="cuda:0")
