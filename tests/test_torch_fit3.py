"""The port's 3-parameter fused fits (plain PyTorch versions, CPU) against
the JAX package's fused Pallas kernels (interpret mode on CPU), on the
same seeded inputs, with the bands bench.py:638-652 sets between two
codegens of one 3-parameter kernel: k and T2 within 1e-2 relative, the
objective within 3e-2, the convergence rate within 0.01 — on identifiable
voxels (noiseless last echo >= 3 sigma, bench.py:612). Sigma is not
compared: at 3 echoes it is a zero-dof ridge direction.

The fits run at the pipeline's own tolerances (FitConfig: ftol 1e-9,
gtol 0), where the two agree to ~6e-4. At the bench's ftol 1e-2 the stop
rule fires on the first slow step of a flat valley, so where it stops
depends on the last bit of an exp: there the kernel is held to its plain
version (bitwise, on the card) and to the truth and the L-BFGS-B oracle
(chip_smoke.py), not to another implementation.
"""

import math

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu.models import pallas_fit as ref
from fetal_t2mapping_tpu_torch.models import fused_fit as port

torch.set_num_threads(1)

TES3 = (114.0, 202.0, 299.0)
TES6 = (114.0, 150.0, 202.0, 250.0, 299.0, 350.0)
LO, HI = (1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0)     # bench.py:242
GUESS = (650.0, 110.0, 40.0)
NOISE = 8.0
N = 4096


def _make_data(n, tes, seed=0):
    """bench.py:120-127's generator; the identifiable voxels."""
    rng = np.random.default_rng(seed)
    te = np.asarray(tes, np.float32)
    k = rng.uniform(600.0, 5000.0, n).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, n).astype(np.float32)
    sig = (k[:, None] * np.exp(-te[None, :] / t2[:, None])).astype(np.float32)
    sig = np.maximum(sig + rng.normal(0, NOISE, sig.shape).astype(np.float32), 1e-2)
    return sig, k * np.exp(-tes[-1] / t2) >= 3 * NOISE


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


CASES = {
    "gaussian_rician-varpro-3te": ("gaussian_rician", TES3, dict(varpro3=True)),
    "gaussian_rician-varpro-6te": ("gaussian_rician", TES6, dict(varpro3=True)),
    "gaussian_rician-multistart-3te": ("gaussian_rician", TES3, dict(varpro3=False)),
    "rician-pruned-3te": ("rician", TES3, dict(prefix3=4)),
    "rician-unpruned-3te": ("rician", TES3, dict(prefix3=0)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def fitted(request):
    model, tes, kw = CASES[request.param]
    sig, ident = _make_data(N, tes, seed=len(request.param))
    r = ref.fit_fused(sig, tes, LO, HI, model=model, guess=GUESS, ftol=1e-9,
                      gtol=0.0, interpret=True, strategy="single", **kw)
    p = port.fit_fused(sig, tes, LO, HI, model=model, guess=GUESS, ftol=1e-9,
                       gtol=0.0, device="cpu", **kw)
    return model, sig, ident, r, p


def test_fit_fused_3param_matches_reference_kernel(fitted):
    model, sig, ident, r, p = fitted
    x_r, f_r = np.asarray(r.x), np.asarray(r.fun)
    x_p, f_p = p.x.numpy(), p.fun.numpy()
    assert x_p.shape == (N, 3) and p.x.device.type == "cpu"
    assert p.converged.dtype == torch.bool and p.n_iter.dtype == torch.int32
    assert p.n_overflow == 0
    assert _rel(x_p[:, :2], x_r[:, :2])[ident].max() <= 1e-2
    assert _rel(f_p, f_r)[ident].max() <= 3e-2
    conv_r = float(np.mean(np.asarray(r.converged)))
    assert abs(p.converged.float().mean().item() - conv_r) <= 0.01


def test_fit_fused_3param_stays_in_the_box(fitted):
    model, sig, ident, r, p = fitted
    lo = LO[:2] + (max(LO[2], 1e-2),) if model == "rician" else LO
    x = p.x.numpy()
    assert np.isfinite(x).all() and np.isfinite(p.fun.numpy()).all()
    for j in range(3):
        assert x[:, j].min() >= np.float32(lo[j]) and x[:, j].max() <= np.float32(HI[j])
    assert p.converged.float().mean().item() >= 0.98


def test_continuation_extends_the_shorter_run():
    """pallas_fit.py:352-361: the same (x0, convf0, nit0) at a larger budget
    extends the smaller-budget trajectory — voxels the short run converged
    stay bit-identical, and no voxel's objective or step count goes back."""
    sig, _ = _make_data(2048, TES3, seed=11)
    s = torch.from_numpy(sig)
    tab = dict(ftol=1e-9, gtol=0.0, stall_tol=1e-6)
    lo = LO[:2] + (1e-2,)
    x0, st0 = port._fit3(s, "rician", TES3, lo, HI, GUESS, max_iters=2, **tab)
    x_a, st_a = port._fit3_cont(s, "rician", TES3, lo, HI, GUESS, x0, st0, max_iters=3, **tab)
    x_b, st_b = port._fit3_cont(s, "rician", TES3, lo, HI, GUESS, x0, st0, max_iters=30, **tab)
    done = st_a[1] > 0.5
    assert 0 < done.float().mean().item() < 1
    assert torch.equal(x_a[:, done], x_b[:, done]) and torch.equal(st_a[:, done], st_b[:, done])
    assert (st_b[2] >= st_a[2]).all() and (st_a[2] >= st0[2]).all()
    assert (st_b[0] <= st_a[0]).all()
    # voxels converged in the prefix are frozen: x0 kept, f re-evaluated
    pre = st0[1] > 0.5
    assert pre.any()
    assert torch.equal(x_b[:, pre], x0[:, pre]) and torch.equal(st_b[0, pre], st0[0, pre])
    assert torch.equal(st_b[2, pre], st0[2, pre])
    # the pruned fit is exactly prefix + continuation
    x_p, st_p = port._fit3_pruned(s, "rician", TES3, lo, HI, GUESS, prefix_iters=2,
                                  max_iters=32, **tab)
    assert torch.equal(x_p, x_b) and torch.equal(st_p, st_b)


@pytest.mark.parametrize("model,kw", [("gaussian_rician", dict(varpro3=True)),
                                      ("gaussian_rician", dict(varpro3=False)),
                                      ("rician", dict(prefix3=4))])
def test_results_do_not_depend_on_batch_grouping(model, kw):
    sig, _ = _make_data(1024, TES3, seed=9)
    fit = lambda a: port.fit_fused(a, TES3, LO, HI, model=model, guess=GUESS,   # noqa: E731
                                   ftol=1e-2, gtol=1e-2, device="cpu", **kw)
    whole = fit(sig)
    parts = [fit(sig[i:i + 100]) for i in range(0, 1024, 100)]
    for field in ("x", "fun", "converged", "n_iter"):
        assert torch.equal(getattr(whole, field),
                           torch.cat([getattr(q, field) for q in parts])), field


def test_varpro_full_budget_changes_no_output():
    sig, _ = _make_data(1024, TES3, seed=7)
    kw = dict(model="gaussian_rician", guess=GUESS, ftol=1e-2, gtol=1e-2, device="cpu")
    a = port.fit_fused(sig, TES3, LO, HI, **kw)
    b = port.fit_fused(sig, TES3, LO, HI, full_budget=True, **kw)
    for fa, fb in zip(a[:4], b[:4]):
        assert torch.equal(fa, fb)


def test_multistart_keeps_the_lowest_objective_start():
    # the third start (the interpolant for gaussian_rician at 3 echoes) is
    # exact on noiseless data: the winner's objective is ~0 and no start
    # beats the returned one
    te = np.asarray(TES3, np.float32)
    k = np.asarray([1000.0, 3000.0], np.float32)
    t2 = np.asarray([80.0, 250.0], np.float32)
    sig = np.sqrt((k[:, None] * np.exp(-te / t2[:, None])) ** 2 + 20.0 ** 2).astype(np.float32)
    x, st = port._fit3_plain(torch.from_numpy(sig), "gaussian_rician", TES3, LO, HI, GUESS,
                             max_iters=60, ftol=1e-9, gtol=0.0, stall_tol=1e-6)
    np.testing.assert_allclose(x[1].numpy(), t2, rtol=1e-3)
    np.testing.assert_allclose(x[2].numpy(), 20.0, rtol=1e-2)
    assert (st[0] <= 1e-2).all()


def _grid64(te, lo_t2, hi_t2, two):
    t2_glo = max(lo_t2, 1.0)
    t2_ghi = max(hi_t2, t2_glo + 1.0)
    frac = 0.02 + 0.96 * np.arange(12) / 11.0
    t2_g = np.exp(np.log(t2_glo) + frac * (np.log(t2_ghi) - np.log(t2_glo)))
    return t2_g, np.exp(-(2.0 if two else 1.0) * np.asarray(te)[None, :] / t2_g[:, None])


def _interp64(te, lo_t2, hi_t2):
    t2_a = max(lo_t2, 1.0)
    t2_b = max(hi_t2, t2_a * (1.0 + 1e-6))
    ts = np.exp(np.log(t2_a) + np.arange(16) / 15.0 * (np.log(t2_b) - np.log(t2_a)))
    e = np.exp(-2.0 * np.asarray(te)[None, :] / ts[:, None])
    return ts, e[:, 1] - e[:, 2], e[:, 0] - e[:, 1]


def _fields(flat, fields):
    out, i = {}, 0
    for name, size in fields:
        out[name] = flat[i:i + size]
        i += size
    assert i == flat.size
    return out


def test_gr_kernel_params_layout():
    """GrParams (csrc/gr_varpro_fit.cu): each field against the reference's
    float64 expressions (pallas_fit.py:568-681), rounded to float32 once."""
    lo, hi, guess = (550.0, 10.0, 2.0), (10000.0, 600.0, 1000.0), (650.0, 110.0, 40.0)
    flat = port._gr_kernel_params(TES3, lo, hi, guess, 1e-2, 1e-3, 1e-2)
    assert flat.dtype == np.float32 and flat.size == 231
    f = _fields(flat, port._GR_FIELDS)
    f32 = np.float32
    np.testing.assert_array_equal(f["ab"], f32([550.0 ** 2, 1e4 ** 2, 4.0, 1e6]))
    tol_a, tol_b, tol_t = 1e-8 * (1e8 - 550.0 ** 2), 1e-8 * (1e6 - 4.0), 1e-8 * 590.0
    np.testing.assert_array_equal(f["thr"], f32([550.0 ** 2 + tol_a, 1e8 - tol_a, 4.0 + tol_b,
                                                 1e6 - tol_b, 10.0 + tol_t, 600.0 - tol_t]))
    np.testing.assert_array_equal(f["b_init"], f32([1600.0]))
    np.testing.assert_array_equal(f["fb"], f32(guess))
    np.testing.assert_array_equal(f["tols"], f32([1e-2, 1e-3, 1e-2]))
    np.testing.assert_array_equal(f["te"][:3], f32(TES3))
    np.testing.assert_array_equal(f["m2te"][:3], f32([-228.0, -404.0, -598.0]))
    t2_g, e_g = _grid64(TES3, 10.0, 600.0, two=True)
    np.testing.assert_array_equal(f["grid_t2"], t2_g.astype(f32))
    np.testing.assert_array_equal(f["grid_e"].reshape(12, 8)[:, :3], e_g.astype(f32))
    se, se2 = e_g.sum(1), (e_g * e_g).sum(1)
    np.testing.assert_allclose(f["grid_se"], se, rtol=1e-7)
    np.testing.assert_allclose(f["grid_se2"], se2, rtol=1e-7)
    np.testing.assert_allclose(f["grid_idet"], 1.0 / (3 * se2 - se * se), rtol=1e-6)
    ts, d12, d01 = _interp64(TES3, 10.0, 600.0)
    np.testing.assert_array_equal(f["it_ts"], ts.astype(f32))
    np.testing.assert_allclose(f["it_d12"], d12, rtol=1e-7)
    np.testing.assert_allclose(f["it_d01"], d01, rtol=1e-7)
    # the interpolant exists at 3 echoes only
    f6 = _fields(port._gr_kernel_params(TES6, lo, hi, guess, 1e-2, 1e-3, 1e-2), port._GR_FIELDS)
    assert not f6["it_ts"].any() and f6["te"][5] == 350.0


def test_fit3_kernel_params_layout():
    """Fit3Params (csrc/fit3.cu) against the reference's expressions
    (pallas_fit.py:341-533); the grid is _grid_start3's exp(-te/t2)."""
    lo, hi, guess = (550.0, 10.0, 2.0), (900.0, 600.0, 1000.0), (650.0, 110.0, 4000.0)
    flat = port._fit3_kernel_params(TES6, lo, hi, guess, 1e-9, 0.0, 1e-6)
    assert flat.dtype == np.float32 and flat.size == 202
    f = _fields(flat, port._FIT3_FIELDS)
    f32 = np.float32
    tol = [1e-8 * max(h - l, 1.0) for l, h in zip(lo, hi)]
    np.testing.assert_array_equal(f["lo_thr"], f32([l + t for l, t in zip(lo, tol)]))
    np.testing.assert_array_equal(f["hi_thr"], f32([h - t for h, t in zip(hi, tol)]))
    np.testing.assert_array_equal(f["fb"], f32([650.0, 110.0, 1000.0]))   # clipped
    t2_g, e_g = _grid64(TES6, 10.0, 600.0, two=False)
    np.testing.assert_array_equal(f["grid_t2"], t2_g.astype(f32))
    np.testing.assert_array_equal(f["grid_e"].reshape(12, 8)[:, :6], e_g.astype(f32))
    np.testing.assert_allclose(f["grid_ee"], (e_g * e_g).sum(1), rtol=1e-7)
    assert not f["it_ts"].any()


def test_resolve_knobs_match_reference(monkeypatch):
    for v in (None, True, False):
        for model in ("gaussian", "gaussian_rician", "rician"):
            assert port.resolve_varpro3(v, model) == ref.resolve_varpro3(v, model)
    for p in (None, 0, -1, 4, 59, 60, 100):
        assert port.resolve_prefix3(p, 60) == ref.resolve_prefix3(p, 60)
    monkeypatch.setenv("FT2_FIT3_VARPRO", "0")
    monkeypatch.setenv("FT2_FIT3_PREFIX", "7")
    assert port.resolve_varpro3(None, "gaussian_rician") is False
    assert port.resolve_prefix3(None, 60) == ref.resolve_prefix3(None, 60) == 7
    # one pass in which each voxel stops on its own, also where the
    # reference's 'auto' picks straggler compaction
    assert ref.resolve_strategy("auto", 10, 60, "gaussian_rician", 0, False) == "twophase"
    assert port.resolve_strategy("auto") == port.resolve_strategy("single") == "single"
    with pytest.raises(NotImplementedError, match="twophase"):
        port.resolve_strategy("twophase")
    with pytest.raises(ValueError, match="unknown strategy"):
        port.resolve_strategy("fastest")


def test_env_knobs_select_the_fit(monkeypatch):
    sig, _ = _make_data(256, TES3, seed=4)
    kw = dict(model="gaussian_rician", guess=GUESS, ftol=1e-2, gtol=1e-2, device="cpu")
    monkeypatch.setenv("FT2_FIT3_VARPRO", "0")
    a = port.fit_fused(sig, TES3, LO, HI, **kw)
    b = port.fit_fused(sig, TES3, LO, HI, varpro3=False, **kw)
    c = port.fit_fused(sig, TES3, LO, HI, varpro3=True, **kw)
    assert torch.equal(a.x, b.x) and not torch.equal(a.x, c.x)
    assert math.isclose(float(a.converged.float().mean()), 1.0, abs_tol=0.02)
