"""The port's serving wrapper ``fit_volume`` (plain PyTorch fit versions,
CPU) against the JAX package's ``fit_volume(strategy='single')`` (its
Pallas kernels in interpret mode), on the same seeded volumes.

One counterpart per case of tests/test_volume_fit.py, and the port against
the reference with the bands bench.py:638-652 sets between two codegens of
one kernel (ROADMAP.md): gaussian parameters 1e-3 and objective 1e-2
relative; 3-parameter k and T2 1e-2 and objective 3e-2; convergence rates
within 0.01; on identifiable masked voxels (noiseless last echo >= 3
sigma, bench.py:612). Counts and the zero maps outside the mask are held
exactly. Inside the port, the block layout's capacities and block sizes
(a buffer over every block, ``compact=False``; ``mask_frac`` of the
volume; voxel-exact ``block=1``) are held bitwise to each other and to
``fit_fused`` on the gathered voxels: every fit freezes a voxel once it
has converged, so how voxels are grouped never changes an iterate.
"""

import warnings

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu.models import fit_volume as ref_fit_volume
from fetal_t2mapping_tpu_torch.models import fit_volume
from fetal_t2mapping_tpu_torch.models.fused_fit import fit_fused, validate_fused_args
from fetal_t2mapping_tpu_torch.models.volume_fit import _filler
from fetal_t2mapping_tpu_torch.utils.profiling import profiler

torch.set_num_threads(1)

TES = (114.0, 202.0, 299.0)
LO = (0.0, 10.0)
HI = (1e6, 2000.0)
LO3, HI3, GUESS3 = (1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0)
NOISE = 8.0
MAPS = ("t2", "k", "sigma", "fun", "converged", "n_iter")


def _volume(nz=16, seed=0):
    rng = np.random.default_rng(seed)
    t2 = rng.uniform(60.0, 400.0, (nz, nz, nz)).astype(np.float32)
    k = rng.uniform(600.0, 3000.0, (nz, nz, nz)).astype(np.float32)
    te = np.asarray(TES, np.float32)
    sig = k[..., None] * np.exp(-te / t2[..., None])
    mask = np.zeros((nz, nz, nz), bool)
    mask[2:14, 2:14, 2:14] = True
    return sig.astype(np.float32), mask, t2, k


def _bench_volume(nz=16, seed=0):
    """bench.py:431-440's request at a small size: k ~ U(600, 5000),
    T2 ~ U(20, 500), noise sigma 8, the 0.75/0.85/0.65 ellipsoid mask
    (22% of the grid); identifiable voxels as bench.py:612."""
    rng = np.random.default_rng(seed)
    shape = (nz, nz, nz)
    k = rng.uniform(600.0, 5000.0, shape).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, shape).astype(np.float32)
    te = np.asarray(TES, np.float32)
    sig = k[..., None] * np.exp(-te / t2[..., None])
    sig = np.maximum(sig + rng.normal(0, NOISE, sig.shape), 1e-2).astype(np.float32)
    ax = (np.arange(nz, dtype=np.float32) - (nz - 1) / 2) / (nz / 2)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    mask = (zz / 0.75) ** 2 + (yy / 0.85) ** 2 + (xx / 0.65) ** 2 <= 1.0
    ident = k * np.exp(-TES[-1] / t2) >= 3 * NOISE
    return sig, mask, t2, ident


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


def _np(res):
    return {name: np.asarray(getattr(res, name)) for name in MAPS}


def test_fit_volume_masked_recovery():
    sig, mask, t2, k = _volume()
    # the 12^3 cube touches 72 32-voxel blocks (2304 voxels of capacity)
    # of the 16^3 grid: mask_frac 0.6 covers it
    res = fit_volume(sig, mask, TES, LO, HI, max_iters=30, mask_frac=0.6, device="cpu")
    t2map = res.t2.numpy()
    assert t2map.shape == mask.shape and res.t2.device.type == "cpu"
    np.testing.assert_allclose(t2map[mask], t2[mask], rtol=5e-3)
    np.testing.assert_allclose(res.k.numpy()[mask], k[mask], rtol=5e-3)
    assert np.all(t2map[~mask] == 0.0)
    assert np.all(~res.converged.numpy()[~mask])
    assert res.converged.numpy()[mask].mean() > 0.99
    assert int(res.n_masked) == int(mask.sum())
    assert int(res.n_overflow) == 0
    assert res.n_masked.dtype == torch.int32 and res.n_overflow.dtype == torch.int32


def test_fit_volume_overflow_reported():
    sig, mask, _, _ = _volume()
    mask[:] = True  # 100% masked against a 10% capacity
    with pytest.warns(UserWarning, match="left unfitted"):
        res = fit_volume(sig, mask, TES, LO, HI, max_iters=12, mask_frac=0.1, device="cpu")
    assert int(res.n_overflow) > 0
    assert int(res.n_masked) == mask.size
    fitted = res.converged.numpy() | (res.n_iter.numpy() > 0)
    assert fitted.sum() + int(res.n_overflow) >= mask.size * 0.95
    assert fitted.sum() <= 0.11 * mask.size + 128 * 3
    # the same capacity arithmetic as the reference: the same count
    with pytest.warns(UserWarning, match="left unfitted"):
        ref = ref_fit_volume(sig, mask, TES, LO, HI, max_iters=12, mask_frac=0.1,
                             strategy="single")
    assert int(res.n_overflow) == int(ref.n_overflow)


def test_fit_volume_block_matches_voxel_exact():
    """block=32 and block=1 give the same bits on every voxel, with a grid
    that is not a multiple of the block."""
    sig, mask, t2, _ = _volume(nz=15, seed=3)   # 3375 voxels: not 32-aligned
    res_b = fit_volume(sig, mask, TES, LO, HI, max_iters=30, mask_frac=1.0,
                       block=32, compact=True, device="cpu")
    res_v = fit_volume(sig, mask, TES, LO, HI, max_iters=30, mask_frac=1.0,
                       block=1, compact=True, device="cpu")
    assert int(res_b.n_overflow) == 0 and int(res_v.n_overflow) == 0
    for name in MAPS:
        assert torch.equal(getattr(res_b, name), getattr(res_v, name)), name
    np.testing.assert_array_equal(res_b.t2.numpy()[~mask], 0.0)
    np.testing.assert_allclose(res_b.t2.numpy()[mask], t2[mask], rtol=5e-3)


@pytest.mark.parametrize("model,lo,hi", [("gaussian_rician", (0.0, 10.0, 1.0), (900.0, 600.0, 100.0)),
                                         ("rician", (0.0, 10.0, 1.0), (900.0, 600.0, 100.0))])
def test_block_filler_converges_quickly_for_3param(model, lo, hi):
    """The filler that fit_volume feeds unmasked voxels of kept blocks (and
    a mesh's padding rows) is an exact decay at the clamped guess: it must
    converge, and within a few iterations, so its fit costs next to
    nothing."""
    te_t, lo_t, hi_t, guess = validate_fused_args(model, TES, lo, hi, None, False)
    sig = _filler(te_t, lo_t, hi_t, guess, torch.device("cpu")).repeat(256, 1)
    res = fit_fused(sig, TES, lo_t, hi_t, model=model, max_iters=60, device="cpu")
    assert res.converged.all()
    assert int(res.n_iter.max()) <= 10


def test_fit_volume_3param_partial_blocks():
    """gaussian_rician through the block path: partially masked blocks mix
    real voxels with fillers, and every masked voxel still converges."""
    rng = np.random.default_rng(7)
    nz = 12
    t2 = rng.uniform(60.0, 350.0, (nz, nz, nz)).astype(np.float32)
    k = rng.uniform(200.0, 800.0, (nz, nz, nz)).astype(np.float32)
    te = np.asarray(TES, np.float32)
    sig = k[..., None] * np.exp(-te / t2[..., None])
    sig = np.maximum(sig + rng.normal(0, 2.0, sig.shape), 1e-2).astype(np.float32)
    mask = rng.random((nz, nz, nz)) < 0.5          # scattered: no full block
    res = fit_volume(sig, mask, TES, (0.0, 10.0, 0.1), (2000.0, 600.0, 50.0),
                     model="gaussian_rician", max_iters=40, mask_frac=1.0,
                     compact=True, device="cpu")
    assert int(res.n_overflow) == 0
    assert res.converged.numpy()[mask].mean() > 0.98
    rel = np.abs(res.t2.numpy()[mask] - t2[mask]) / t2[mask]
    assert np.median(rel) < 5e-2
    assert np.all(res.sigma.numpy()[~mask] == 0.0)


def test_fit_volume_matches_fit_stack_path():
    """The serving path and the file pipeline's fit_stack agree voxel by
    voxel on the same data."""
    from fetal_t2mapping_tpu_torch.config import FitConfig
    from fetal_t2mapping_tpu_torch.core.stack import EchoStack
    from fetal_t2mapping_tpu_torch.core.volume import Volume
    from fetal_t2mapping_tpu_torch.models.t2map import fit_stack

    sig, mask, t2, _ = _volume(nz=12, seed=9)
    res_v = fit_volume(sig, mask, TES, LO, HI, max_iters=40, mask_frac=1.0, device="cpu")
    st = EchoStack(sig, mask, np.asarray(TES, np.float32), Volume(sig[..., 0]))
    cfg = FitConfig(model="gaussian", initial_guess=(1000.0, 100.0),
                    lower=LO, upper=HI, max_iters=40)
    out = fit_stack(st, cfg, device="cpu")
    np.testing.assert_allclose(res_v.t2.numpy()[mask], np.asarray(out.t2.data)[mask], rtol=1e-3)


def test_fit_volume_validates_shapes():
    sig, mask, _, _ = _volume()
    with pytest.raises(ValueError, match=r"\(Z, Y, X, T\)"):
        fit_volume(sig[..., 0], mask, TES, LO, HI, device="cpu")
    with pytest.raises(ValueError, match="mask"):
        fit_volume(sig, mask[2:], TES, LO, HI, device="cpu")
    with pytest.raises(ValueError, match="block"):
        fit_volume(sig, mask, TES, LO, HI, block=0, device="cpu")
    with pytest.raises(ValueError, match="unknown strategy"):
        fit_volume(sig, mask, TES, LO, HI, strategy="fastest", device="cpu")
    with pytest.raises(ValueError, match="compact"):
        fit_volume(sig, mask, TES, LO, HI, compact="always", device="cpu")


def test_fit_volume_dense_matches_compact():
    """compact=False (a buffer over every block of the grid) gives the
    bits of the block layout at mask_frac 1.0."""
    sig, mask, t2, _ = _volume(nz=15, seed=9)
    res_c = fit_volume(sig, mask, TES, LO, HI, max_iters=30, mask_frac=1.0,
                       compact=True, device="cpu")
    res_d = fit_volume(sig, mask, TES, LO, HI, max_iters=30, compact=False, device="cpu")
    assert int(res_c.n_overflow) == 0 and int(res_d.n_overflow) == 0
    assert int(res_c.n_masked) == int(res_d.n_masked)
    for name in MAPS:
        assert torch.equal(getattr(res_c, name), getattr(res_d, name)), name
    np.testing.assert_array_equal(res_d.t2.numpy()[~mask], 0.0)
    assert not res_d.converged.numpy()[~mask].any()


def test_compact_false_holds_any_mask_without_a_read():
    """compact=False ignores a mask_frac that could not hold the mask: no
    capacity check (no host read, no warning), one fit pass bounded at the
    touched blocks, n_overflow 0, and the maps of a buffer over every block."""
    sig, mask, _, _ = _volume(nz=15, seed=4)
    assert mask.mean() > 0.4
    counters = ("host_reads", "fit_fused.row_bound.launches")
    before = [profiler.counter(c) for c in counters]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = fit_volume(sig, mask, TES, LO, HI, max_iters=30, mask_frac=0.05, compact=False,
                         device="cpu")
    assert [profiler.counter(c) - b for c, b in zip(counters, before)] == [0, 1]
    assert int(got.n_overflow) == 0 and int(got.n_masked) == int(mask.sum())
    want = fit_volume(sig, mask, TES, LO, HI, max_iters=30, mask_frac=1.0, compact=True,
                      device="cpu")
    for name in MAPS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_auto_honours_mask_frac_at_any_mask():
    """compact='auto' takes mask_frac's capacity whatever the model and
    mask_frac: a mask beyond it warns before the fit and counts its
    unfitted voxels in n_overflow, as compact=True does."""
    sig, mask, _, _ = _volume(nz=15, seed=4)
    for model, lo, hi, guess in (("gaussian", LO, HI, None),
                                 ("gaussian_rician", LO3, HI3, GUESS3)):
        kw = dict(model=model, guess=guess, max_iters=8, mask_frac=0.3, device="cpu")
        with pytest.warns(UserWarning, match="left unfitted"):
            auto = fit_volume(sig, mask, TES, lo, hi, compact="auto", varpro3=True, **kw)
        with pytest.warns(UserWarning, match="left unfitted"):
            block = fit_volume(sig, mask, TES, lo, hi, compact=True, varpro3=True, **kw)
        assert int(auto.n_overflow) > 0
        for name in MAPS + ("n_masked", "n_overflow"):
            assert torch.equal(getattr(auto, name), getattr(block, name)), (model, name)


CASES = {
    "gaussian": ("gaussian", LO, HI, None, (1e-3, 1e-3, 1e-2)),
    "gaussian_rician": ("gaussian_rician", LO3, HI3, GUESS3, (1e-2, 1e-2, 3e-2)),
    "rician": ("rician", LO3, HI3, GUESS3, (1e-2, 1e-2, 3e-2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_volume_matches_reference(case):
    """The port's fit_volume against the JAX package's, strategy 'single'
    (the same solver on both sides), at the pipeline's tolerances."""
    model, lo, hi, guess, (tol_k, tol_t2, tol_f) = CASES[case]
    sig, mask, _, ident = _bench_volume(seed=len(case))
    kw = dict(model=model, guess=guess, ftol=1e-9, gtol=0.0, mask_frac=0.6, compact=True)
    r = ref_fit_volume(sig, mask, TES, lo, hi, strategy="single", **kw)
    p = fit_volume(sig, mask, TES, lo, hi, device="cpu", **kw)
    r, pn = _np(r), _np(p)
    assert int(p.n_masked) == int(mask.sum()) and int(p.n_overflow) == 0
    for name in MAPS:
        assert np.all(pn[name][~mask] == 0) and np.all(r[name][~mask] == 0), name
    sel = mask & ident
    assert _rel(pn["k"], r["k"])[sel].max() <= tol_k
    assert _rel(pn["t2"], r["t2"])[sel].max() <= tol_t2
    assert _rel(pn["fun"], r["fun"])[sel].max() <= tol_f
    assert abs(pn["converged"][mask].mean() - r["converged"][mask].mean()) <= 0.01


@pytest.mark.parametrize("case", sorted(CASES))
def test_layouts_bitwise_equal_fit_fused(case):
    """A buffer over every block (compact=False), block at mask_frac and
    voxel-exact give the same bits, equal to fit_fused on the gathered
    voxels."""
    model, lo, hi, guess, _ = CASES[case]
    sig, mask, _, _ = _bench_volume(nz=15, seed=11)
    kw = dict(model=model, guess=guess, ftol=1e-9, gtol=0.0, device="cpu")
    layouts = [fit_volume(sig, mask, TES, lo, hi, compact=False, **kw),
               fit_volume(sig, mask, TES, lo, hi, compact=True, mask_frac=0.6, **kw),
               fit_volume(sig, mask, TES, lo, hi, compact=True, mask_frac=0.6, block=1, **kw)]
    for res in layouts[1:]:
        assert int(res.n_overflow) == 0
        for name in MAPS:
            assert torch.equal(getattr(res, name), getattr(layouts[0], name)), name
    ref = fit_fused(sig[mask], TES, lo, hi, **kw)
    m = torch.from_numpy(mask)
    res = layouts[0]
    assert torch.equal(res.t2[m], ref.x[:, 1]) and torch.equal(res.k[m], ref.x[:, 0])
    sigma = ref.x[:, 2] if ref.x.shape[1] == 3 else torch.zeros_like(ref.fun)
    assert torch.equal(res.sigma[m], sigma)
    assert torch.equal(res.fun[m], ref.fun)
    assert torch.equal(res.converged[m], ref.converged)
    assert torch.equal(res.n_iter[m], ref.n_iter)
