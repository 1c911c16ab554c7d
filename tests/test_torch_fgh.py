"""The port's hand-fused (f, g, H) of the 3-parameter objectives
(``fetal_t2mapping_tpu_torch.models.fgh``) against autodiff of the port's
own objectives (``torch.func``, float64) and against the JAX package's
``models.fgh`` on the same seeded inputs.

Bands: against autodiff the bands of the JAX package's tests/test_fgh.py
(the rician Bessel factors are A&S polynomials, |eps| < 2e-7, where the
autodiff objective uses the exact i0e); against the reference, float32
rounding of two implementations of one algebra (1e-4 relative, with
near-zero entries floored at 1% of the component's range).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import i0e as sp_i0e, i1e as sp_i1e
from torch.func import grad, hessian, vmap

from fetal_t2mapping_tpu.models import fgh as ref_fgh
from fetal_t2mapping_tpu_torch.models import fgh
from fetal_t2mapping_tpu_torch.models.signal import make_objective

torch.set_num_threads(1)

TES = (114.0, 202.0, 299.0)
MODELS = ("gaussian_rician", "rician")


def _rand_points(model, n=64, seed=0):
    """tests/test_fgh.py's draw: interior points, with the rician Bessel
    argument x = m s / sigma^2 kept <= ~100 (above it R' sits below the
    polynomials' truncation error in any precision)."""
    rng = np.random.default_rng(seed)
    if model == "rician":
        k = rng.uniform(50.0, 300.0, n).astype(np.float32)
        sg = rng.uniform(10.0, 40.0, n).astype(np.float32)
        noise = 5.0
    else:
        k = rng.uniform(500.0, 6000.0, n).astype(np.float32)
        sg = rng.uniform(5.0, 80.0, n).astype(np.float32)
        noise = 10.0
    t2 = rng.uniform(30.0, 800.0, n).astype(np.float32)
    true_t2 = rng.uniform(50.0, 400.0, n).astype(np.float32)
    te = np.asarray(TES, np.float32)
    s = np.maximum(k[:, None] * np.exp(-te[None, :] / true_t2[:, None])
                   + rng.normal(0, noise, (n, 3)).astype(np.float32), 0.5)
    if model == "rician":
        m = k[:, None] * np.exp(-te[None, :] / t2[:, None])
        sg = np.maximum(sg, np.sqrt((m * s).max(axis=1) / 100.0)).astype(np.float32)
    return (k, t2, sg), s.astype(np.float32)


@pytest.mark.parametrize("x", [0.0, 1e-5, 3.7499, 3.75, 50.0, 1e4])
def test_bessel_matches_reference_and_scipy(x):
    xt = torch.tensor([x, -x], dtype=torch.float32)
    xj = jnp.asarray([x, -x], jnp.float32)
    for ours, ref, exact in ((fgh.i0e, ref_fgh.i0e, sp_i0e), (fgh.i1e, ref_fgh.i1e, sp_i1e)):
        o = ours(xt).numpy()
        np.testing.assert_allclose(o, np.asarray(ref(xj)), rtol=2e-6, atol=1e-12)
        # both halves use |x| (the caller folds the odd part of I1)
        np.testing.assert_allclose(o, exact(abs(x)), rtol=5e-6, atol=1e-7)
    r = fgh.bessel_ratio(xt).numpy()
    np.testing.assert_allclose(r, np.asarray(ref_fgh.bessel_ratio(xj)), rtol=2e-6, atol=1e-12)


@pytest.mark.parametrize("model", MODELS)
def test_fgh_matches_autodiff(model):
    params, s = _rand_points(model, seed=zlib.crc32(model.encode()) % 2**31)
    p64 = tuple(torch.from_numpy(p.astype(np.float64)) for p in params)
    s64 = torch.from_numpy(s.astype(np.float64))
    te64 = torch.tensor(TES, dtype=torch.float64)
    obj = make_objective(model)
    x = torch.stack(p64, dim=-1)
    f_ref = obj(x, te64, s64).numpy()
    g_ref = vmap(grad(obj), in_dims=(0, None, 0))(x, te64, s64).numpy()
    h_ref = vmap(hessian(obj), in_dims=(0, None, 0))(x, te64, s64).numpy()

    f, g, h = fgh.FGH[model](p64, list(s64.t()), TES)
    v, _ = fgh.VALUE_E[model](p64, list(s64.t()), TES)
    scale_f = np.maximum(np.abs(f_ref), 1.0)
    np.testing.assert_allclose(f.numpy() / scale_f, f_ref / scale_f, atol=2e-4)
    np.testing.assert_allclose(v.numpy(), f.numpy(), rtol=1e-5, atol=1e-5)
    for i in range(3):
        den = np.maximum(np.abs(g_ref[:, i]), 1e-3)
        np.testing.assert_allclose(g[i].numpy() / den, g_ref[:, i] / den, atol=5e-3,
                                   err_msg=f"grad[{i}]")
        for j in range(3):
            ref_ij = h_ref[:, i, j]
            den = np.maximum(np.abs(ref_ij), np.maximum(1e-2 * np.abs(ref_ij).max(), 1e-3))
            np.testing.assert_allclose(h[i][j].numpy() / den, ref_ij / den, atol=1e-1,
                                       err_msg=f"hess[{i}][{j}]")


def _rel(a, b, floor):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) / np.maximum(np.abs(b), floor)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("carried_exps", [False, True])
def test_fgh_and_value_e_match_reference(model, carried_exps):
    params, s = _rand_points(model, n=256, seed=3)
    pt = tuple(torch.from_numpy(p) for p in params)
    pj = tuple(jnp.asarray(p) for p in params)
    s_t = list(torch.from_numpy(s).t())
    s_j = [jnp.asarray(s[:, i]) for i in range(3)]
    v_p, e_p = fgh.VALUE_E[model](pt, s_t, TES)
    v_r, e_r = ref_fgh.VALUE_E[model](pj, s_j, TES)
    assert _rel(v_p.numpy(), v_r, 1.0).max() <= 1e-5
    for ep, er in zip(e_p, e_r):
        assert _rel(ep.numpy(), er, 1e-30).max() <= 1e-6
    f_p, g_p, h_p = fgh.FGH[model](pt, s_t, TES, e_p if carried_exps else None)
    f_r, g_r, h_r = ref_fgh.FGH[model](pj, s_j, TES, e_r if carried_exps else None)
    assert _rel(f_p.numpy(), f_r, 1.0).max() <= 1e-5
    for i in range(3):
        gr = np.asarray(g_r[i])
        assert _rel(g_p[i].numpy(), gr, max(1e-2 * np.abs(gr).max(), 1e-6)).max() <= 1e-4
        for j in range(3):
            hr = np.asarray(h_r[i][j])
            assert (_rel(h_p[i][j].numpy(), hr, max(1e-2 * np.abs(hr).max(), 1e-6)).max()
                    <= 1e-4), (i, j)


@pytest.mark.parametrize("model", ("gaussian",) + MODELS)
def test_value_dicts_and_gaussian_entries_match_reference(model):
    """The per-model tables (FGH / VALUE / VALUE_E / N_PARAMS) have the
    reference's keys; VALUE is VALUE_E's objective; every model's f, g and
    H (the gaussian entries too) within the bands of the test above."""
    for table in ("FGH", "VALUE", "VALUE_E", "N_PARAMS"):
        assert set(getattr(fgh, table)) == set(getattr(ref_fgh, table)), table
    assert fgh.N_PARAMS == ref_fgh.N_PARAMS
    params, s = _rand_points("gaussian_rician" if model == "gaussian" else model, n=256, seed=5)
    params = params[:fgh.N_PARAMS[model]]
    pt = tuple(torch.from_numpy(p) for p in params)
    pj = tuple(jnp.asarray(p) for p in params)
    s_t = list(torch.from_numpy(s).t())
    s_j = [jnp.asarray(s[:, i]) for i in range(3)]
    v_p, v_r = fgh.VALUE[model](pt, s_t, TES), ref_fgh.VALUE[model](pj, s_j, TES)
    assert _rel(v_p.numpy(), v_r, 1.0).max() <= 1e-5
    np.testing.assert_array_equal(v_p.numpy(), fgh.VALUE_E[model](pt, s_t, TES)[0].numpy())
    f_p, g_p, h_p = fgh.FGH[model](pt, s_t, TES)
    f_r, g_r, h_r = ref_fgh.FGH[model](pj, s_j, TES)
    assert _rel(f_p.numpy(), f_r, 1.0).max() <= 1e-5
    np.testing.assert_array_equal(f_p.numpy().shape, (256,))
    p = fgh.N_PARAMS[model]
    for i in range(p):
        gr = np.asarray(g_r[i])
        assert _rel(g_p[i].numpy(), gr, max(1e-2 * np.abs(gr).max(), 1e-6)).max() <= 1e-4
        for j in range(p):
            hr = np.asarray(h_r[i][j])
            assert (_rel(h_p[i][j].numpy(), hr, max(1e-2 * np.abs(hr).max(), 1e-6)).max()
                    <= 1e-4), (i, j)


def test_rician_value_stable_at_pinned_sigma_corner():
    """At x = m s / sigma^2 ~ 1e7 (sigma pinned at its lower bound) the
    float32 NLL tracks the float64 reference-order evaluation: the
    squared-difference form has no catastrophic cancellation."""
    k, t2, sg = 3000.0, 120.0, 1.0
    s_vals = [k * np.exp(-t / t2) + 5.0 for t in TES]
    f64 = 0.0
    for st, t in zip(s_vals, TES):
        m = k * np.exp(-t / t2)
        x = m * st / sg ** 2
        f64 -= (np.log(st) - np.log(sg ** 2) - (st ** 2 + m ** 2) / (2 * sg ** 2)
                + abs(x) + np.log(sp_i0e(x)))
    f32 = fgh.rician_value_e(tuple(torch.tensor([v], dtype=torch.float32) for v in (k, t2, sg)),
                             [torch.tensor([v], dtype=torch.float32) for v in s_vals],
                             TES)[0].item()
    assert abs(f32 - f64) / abs(f64) < 1e-4, (f32, f64)


def test_divisions_by_constants_are_true_divisions():
    # a tensor divided by a Python float runs as a multiply by its
    # reciprocal on CUDA; the helpers divide by a device scalar instead
    x = torch.tensor([1.0, 7.0, 3.7499, 1e-3], dtype=torch.float32)
    np.testing.assert_array_equal(fgh.cdiv(x, 3.75).numpy(),
                                  x.numpy() / np.float32(3.75))
    np.testing.assert_array_equal(fgh.rdiv(3.75, x).numpy(),
                                  np.float32(3.75) / x.numpy())
    assert fgh.scalar(2.0, x) is fgh.scalar(2.0, x)      # cached per device
