"""The port's signal models, initializers, batched Newton solver and scipy
oracle (PyTorch, CPU) against the JAX package's, on the same seeded inputs.

Comparisons that run a solver are made on identifiable voxels only
(noiseless last echo >= 3 sigma, bench.py:612): on the noise floor the
objective is a flat ridge where float32 rounding differences between two
implementations move (k, T2) by O(1) at equal objective. The init is
held to identifiable voxels as well, because its slope b ~ 0 on the noise
floor flips the T2 = 2000 branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu import config as ref_C
from fetal_t2mapping_tpu.models import init as ref_init
from fetal_t2mapping_tpu.models import oracle as ref_oracle
from fetal_t2mapping_tpu.models import signal as ref_signal
from fetal_t2mapping_tpu.models import solver as ref_solver
from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.models import init as port_init
from fetal_t2mapping_tpu_torch.models import oracle as port_oracle
from fetal_t2mapping_tpu_torch.models import signal as port_signal
from fetal_t2mapping_tpu_torch.models import solver as port_solver

torch.set_num_threads(1)

TES = (114.0, 202.0, 299.0)
LO = np.asarray([600.0, 10.0], np.float32)      # _FIT_TABLE gaussian, low field
HI = np.asarray([10000.0, 600.0], np.float32)
NOISE = 8.0


def _make_data(n, seed=3):
    rng = np.random.default_rng(seed)
    te = np.asarray(TES, np.float32)
    k = rng.uniform(700.0, 5000.0, n).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, n).astype(np.float32)
    sig = (k[:, None] * np.exp(-te[None, :] / t2[:, None])).astype(np.float32)
    sig = np.maximum(sig + rng.normal(0, NOISE, sig.shape).astype(np.float32), 1e-2)
    ident = k * np.exp(-TES[-1] / t2) >= 3 * NOISE
    return sig, ident


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


def test_loglinear_init_matches_reference():
    sig, ident = _make_data(2048)
    x_r = np.asarray(ref_init.loglinear_init(sig, jnp.asarray(TES), LO, HI))
    x_p = port_init.loglinear_init(torch.from_numpy(sig), TES, LO, HI).numpy()
    assert x_p.shape == (2048, 2)
    assert (np.abs(x_p - x_r) / np.abs(x_r))[ident].max() <= 1e-4


def test_loglinear_init_per_voxel_bounds():
    sig, ident = _make_data(256, seed=4)
    lo = np.tile(LO, (256, 1))
    lo[:, 0] = sig[:, 0]                       # the no-prior k bound
    hi = np.tile(HI, (256, 1))
    x_r = np.asarray(ref_init.loglinear_init(sig, jnp.asarray(TES), lo, hi))
    x_p = port_init.loglinear_init(torch.from_numpy(sig), TES,
                                   torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    assert (np.abs(x_p - x_r) / np.abs(x_r))[ident].max() <= 1e-4


@pytest.mark.parametrize("sigma0", [None, 25.0, "per-voxel"])
def test_loglinear_init_sigma0_matches_reference(sigma0):
    """sigma0 (a scalar or one value per voxel) replaces the RMS-residual
    start of the 3-parameter sigma; k and T2 are unchanged. The band of
    the default start's test below (1e-4 of max(|x|, 1) on identifiable
    voxels)."""
    sig, ident = _make_data3(512, "gaussian_rician", seed=14)
    lo, hi = LO3["gaussian_rician"], HI3["gaussian_rician"]
    if sigma0 == "per-voxel":
        sigma0 = np.random.default_rng(2).uniform(0.5, 2000.0, 512).astype(np.float32)
    x_r = np.asarray(ref_init.loglinear_init(sig, jnp.asarray(TES), lo, hi, sigma0))
    x_p = port_init.loglinear_init(torch.from_numpy(sig), TES, lo, hi,
                                   sigma0=None if sigma0 is None else torch.as_tensor(sigma0)).numpy()
    assert x_p.shape == (512, 3)
    assert _rel(x_p, x_r)[ident].max() <= 1e-4
    if sigma0 is not None:
        np.testing.assert_array_equal(x_p[:, 2], np.clip(np.broadcast_to(sigma0, (512,)),
                                                         lo[2], hi[2]).astype(np.float32))
    # a 2-parameter box ignores sigma0, as the reference does
    two = port_init.loglinear_init(torch.from_numpy(sig), TES, LO, HI, sigma0=7.0)
    np.testing.assert_array_equal(two.numpy(),
                                  port_init.loglinear_init(torch.from_numpy(sig), TES, LO, HI).numpy())


def test_gauss_fgh_and_predict_signal_match_reference():
    sig, _ = _make_data(512, seed=6)
    rng = np.random.default_rng(0)
    x = np.stack([rng.uniform(600, 6000, 512), rng.uniform(15, 550, 512)],
                 axis=1).astype(np.float32)
    te = jnp.asarray(TES, jnp.float32)
    f_r, g_r, h_r = jax.vmap(ref_signal._gauss_fgh, in_axes=(0, None, 0))(
        jnp.asarray(x), te, jnp.asarray(sig))
    f_p, g_p, h_p = port_signal._gauss_fgh(torch.from_numpy(x),
                                           torch.tensor(TES), torch.from_numpy(sig))
    f_r, g_r, h_r = map(np.asarray, (f_r, g_r, h_r))
    assert (np.abs(f_p.numpy() - f_r) / np.maximum(np.abs(f_r), 1.0)).max() <= 1e-4
    assert (np.abs(g_p.numpy() - g_r) / np.maximum(np.abs(g_r), 1.0)).max() <= 1e-4
    assert (np.abs(h_p.numpy() - h_r) / np.maximum(np.abs(h_r), 1.0)).max() <= 1e-4

    pred_r = np.asarray(ref_signal.predict_signal(
        "gaussian", (x[:, 0:1], x[:, 1:2]), te[None, :]))
    pred_p = port_signal.predict_signal(
        "gaussian", (torch.from_numpy(x[:, 0:1]), torch.from_numpy(x[:, 1:2])),
        torch.tensor(TES)[None, :]).numpy()
    assert (np.abs(pred_p - pred_r) / np.maximum(np.abs(pred_r), 1.0)).max() <= 1e-4


def _starts(sig):
    return np.array(ref_init.loglinear_init(sig, jnp.asarray(TES), LO, HI))


def test_fit_batch_traced_matches_reference():
    sig, ident = _make_data(50, seed=8)
    x0 = _starts(sig)
    r_res, r_tr = ref_solver.fit_batch_traced(
        sig, jnp.asarray(TES), x0, LO, HI, model="gaussian", max_iters=60)
    p_res, p_tr = port_solver.fit_batch_traced(
        torch.from_numpy(sig), TES, x0, LO, HI, model="gaussian", max_iters=60)
    assert p_tr["f_val"].shape == (60, 50) and p_tr["active"].dtype == torch.bool
    assert _rel(p_res.x.numpy(), np.asarray(r_res.x))[ident].max() <= 1e-3
    f_r = np.asarray(r_tr["f_val"])
    rel_f = np.abs(p_tr["f_val"].numpy() - f_r) / np.maximum(np.abs(f_r), 1.0)
    assert rel_f[:, ident].max() <= 1e-2
    np.testing.assert_array_equal(p_tr["active"].numpy()[0], np.ones(50, bool))


def test_fit_batch_matches_reference():
    sig, ident = _make_data(1024, seed=10)
    x0 = _starts(sig)
    r = ref_solver.fit_batch(sig, jnp.asarray(TES), x0, LO, HI,
                             model="gaussian", max_iters=60)
    p = port_solver.fit_batch(torch.from_numpy(sig), TES, x0, LO, HI,
                              model="gaussian", max_iters=60)
    both = ident & np.asarray(r.converged) & p.converged.numpy()
    assert both.sum() >= 0.99 * ident.sum()
    assert abs(p.converged.float().mean().item()
               - float(np.mean(np.asarray(r.converged)))) <= 0.01
    assert _rel(p.x.numpy(), np.asarray(r.x))[both].max() <= 1e-3
    assert _rel(p.fun.numpy(), np.asarray(r.fun))[both].max() <= 1e-2
    assert p.n_iter.dtype == torch.int32


# the reference fit table's low-field 3-parameter rows (config._FIT_TABLE)
LO3 = {"gaussian_rician": np.asarray([550.0, 10.0, 2.0], np.float32),
       "rician": np.asarray([550.0, 10.0, 2.0], np.float32)}
HI3 = {"gaussian_rician": np.asarray([10000.0, 600.0, 1000.0], np.float32),
       "rician": np.asarray([900.0, 600.0, 1000.0], np.float32)}


def _make_data3(n, model, seed):
    """Rician-noise data (magnitude of signal + complex Gaussian noise) in
    each model's low-field box; identifiable = last echo >= 3 sigma."""
    rng = np.random.default_rng(seed)
    te = np.asarray(TES, np.float32)
    k = rng.uniform(600.0, 5000.0 if model == "gaussian_rician" else 880.0, n).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, n).astype(np.float32)
    a = k[:, None] * np.exp(-te[None, :] / t2[:, None])
    sig = np.hypot(a + rng.normal(0, NOISE, a.shape), rng.normal(0, NOISE, a.shape))
    return sig.astype(np.float32), k * np.exp(-TES[-1] / t2) >= 3 * NOISE


@pytest.fixture
def x64():
    """float64 in JAX for the duration of a test (restored after)."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("model", ["gaussian_rician", "rician"])
def test_three_parameter_models_are_not_ported(model, x64):
    """Kept name: the 3-parameter models used to raise here. They now run:
    predict_signal (gaussian_rician's first-moment curve for rician too, as
    in the reference), the objectives, and make_value_grad_hess (autodiff)
    against the reference's jax.grad / jax.hessian."""
    sig, _ = _make_data3(256, model, seed=2)
    rng = np.random.default_rng(1)
    x = np.stack([rng.uniform(600, 900, 256), rng.uniform(20, 500, 256),
                  rng.uniform(5, 50, 256)], axis=1).astype(np.float32)
    te = jnp.asarray(TES, jnp.float32)
    cols = (x[:, 0:1], x[:, 1:2], x[:, 2:3])
    pred_r = np.asarray(ref_signal.predict_signal(model, cols, te[None, :]))
    pred_p = port_signal.predict_signal(model, tuple(map(torch.from_numpy, cols)),
                                        torch.tensor(TES)[None, :]).numpy()
    assert _rel(pred_p, pred_r).max() <= 1e-5
    # float64 on both sides: the rician sigma entries cancel in float32
    x64_, sig64 = x.astype(np.float64), sig.astype(np.float64)
    f_r, g_r, h_r = jax.vmap(ref_signal.make_value_grad_hess(model), in_axes=(0, None, 0))(
        jnp.asarray(x64_), jnp.asarray(TES, jnp.float64), jnp.asarray(sig64))
    f_p, g_p, h_p = port_signal.make_value_grad_hess(model)(
        torch.from_numpy(x64_), torch.tensor(TES, dtype=torch.float64), torch.from_numpy(sig64))
    assert f_p.shape == (256,) and g_p.shape == (256, 3) and h_p.shape == (256, 3, 3)
    for a, b in ((f_p[:, None], f_r[:, None]), (g_p, g_r), (h_p.reshape(256, 9), h_r.reshape(256, 9))):
        a, b = a.numpy(), np.asarray(b)
        floor = np.maximum(1e-2 * np.abs(b).max(axis=0), 1e-12)
        assert (np.abs(a - b) / np.maximum(np.abs(b), floor)).max() <= 1e-8
    with pytest.raises(ValueError, match="unknown model"):
        port_signal.predict_signal("lorentzian", cols, TES)


@pytest.mark.parametrize("model", ["gaussian_rician", "rician"])
def test_loglinear_and_grid_init_3param_match_reference(model):
    sig, ident = _make_data3(2048, model, seed=5)
    lo, hi = LO3[model], HI3[model]
    for ref_fn, port_fn in ((ref_init.loglinear_init, port_init.loglinear_init),
                            (ref_init.grid_init, port_init.grid_init)):
        x_r = np.asarray(ref_fn(sig, jnp.asarray(TES), lo, hi))
        x_p = port_fn(torch.from_numpy(sig), TES, lo, hi).numpy()
        assert x_p.shape == (2048, 3)
        assert _rel(x_p, x_r)[ident].max() <= 1e-4, ref_fn.__name__
        assert (x_p >= lo).all() and (x_p <= hi).all()


def _starts3(sig, model):
    lo, hi = LO3[model], HI3[model]
    x0 = np.asarray(ref_init.loglinear_init(sig, jnp.asarray(TES), lo, hi))
    xg = np.asarray(ref_init.grid_init(sig, jnp.asarray(TES), lo, hi))
    xc = np.clip(np.tile(np.float32([650.0, 110.0, 40.0]), (sig.shape[0], 1)), lo, hi)
    return np.stack([x0, xg, xc])


def _assert_fits_agree(a, b, ident):
    """Bands of the 3-parameter kernels (bench.py:638-652) on identifiable
    voxels both converged: k and T2 1e-2, objective 3e-2; convergence rate
    within 0.01."""
    both = ident & np.asarray(b.converged) & a.converged.numpy()
    assert both.sum() >= 0.97 * ident.sum()
    assert abs(a.converged.float().mean().item() - float(np.mean(b.converged))) <= 0.01
    assert _rel(a.x.numpy()[:, :2], np.asarray(b.x)[:, :2])[both].max() <= 1e-2
    assert _rel(a.fun.numpy(), np.asarray(b.fun))[both].max() <= 3e-2


@pytest.mark.parametrize("model", ["gaussian_rician", "rician"])
def test_fit_batch_and_multistart_3param_match_reference(model):
    """P = 3 through the autodiff solver. The multistart (what fit_stack
    runs) is held to the bands for both models. A single gaussian_rician
    start is not: from the log-linear start its sigma ridge lets float32
    differences between two autodiff Hessians steer a few voxels into
    different local minima (sigma pinned at its bound, or the exact
    interpolant) — the reason both packages fit it from three starts."""
    sig, ident = _make_data3(512, model, seed=10)
    x0s = _starts3(sig, model)
    lo, hi = LO3[model], HI3[model]
    r = ref_solver.fit_batch(sig, jnp.asarray(TES), x0s[0], lo, hi, model=model,
                             max_iters=60)
    p = port_solver.fit_batch(torch.from_numpy(sig), TES, x0s[0], lo, hi, model=model,
                              max_iters=60)
    rm = ref_solver.fit_batch_multistart(sig, jnp.asarray(TES), x0s, lo, hi, model=model,
                                         max_iters=60)
    pm = port_solver.fit_batch_multistart(torch.from_numpy(sig), TES, x0s, lo, hi,
                                          model=model, max_iters=60)
    for a in (p, pm):
        assert a.x.shape == (512, 3) and a.n_iter.dtype == torch.int32
        assert (a.x.numpy() >= lo).all() and (a.x.numpy() <= hi).all()
    _assert_fits_agree(pm, rm, ident)
    if model == "rician":
        _assert_fits_agree(p, r, ident)
    else:
        assert abs(p.converged.float().mean().item() - float(np.mean(r.converged))) <= 0.01
    # the multistart keeps each voxel's best start
    assert (pm.fun <= p.fun + 1e-3 * p.fun.abs().clamp(min=1.0)).all()


@pytest.mark.parametrize("model", ["gaussian_rician", "rician"])
def test_fit_batch_traced_3param_matches_reference(model):
    """60 traced iterations: rician from the log-linear start (what
    fit_stack traces), gaussian_rician from a start near each voxel's
    multistart optimum (for the reason above)."""
    sig, ident = _make_data3(50, model, seed=12)
    lo, hi = LO3[model], HI3[model]
    x0s = _starts3(sig, model)
    x0 = x0s[0]
    if model == "gaussian_rician":
        rm = ref_solver.fit_batch_multistart(sig, jnp.asarray(TES), x0s, lo, hi,
                                             model=model, max_iters=60)
        x0 = np.clip(np.asarray(rm.x) * np.float32([1.05, 0.95, 1.1]), lo, hi)
    r_res, r_tr = ref_solver.fit_batch_traced(sig, jnp.asarray(TES), x0, lo, hi,
                                              model=model, max_iters=60)
    p_res, p_tr = port_solver.fit_batch_traced(torch.from_numpy(sig), TES, x0, lo, hi,
                                               model=model, max_iters=60)
    assert p_tr["f_val"].shape == (60, 50) and p_tr["active"].dtype == torch.bool
    _assert_fits_agree(p_res, r_res, ident)
    both = ident & np.asarray(r_res.converged) & p_res.converged.numpy()
    f_r = np.asarray(r_tr["f_val"])
    assert (np.abs(p_tr["f_val"].numpy() - f_r) / np.maximum(np.abs(f_r), 1.0))[:, both].max() <= 3e-2
    np.testing.assert_array_equal(p_tr["active"].numpy()[0], np.ones(50, bool))


@pytest.mark.parametrize("model", ["gaussian", "gaussian_rician", "rician"])
def test_scipy_oracle_matches_reference(model):
    """The same-model L-BFGS-B oracle is the reference's numpy/scipy code:
    identical objectives and fits on the same float64 inputs."""
    sig, _ = _make_data3(6, "gaussian_rician" if model == "gaussian" else model, seed=3)
    te64 = np.asarray(TES, np.float64)
    cfg_p, cfg_r = C.fit_config(model, True), ref_C.fit_config(model, True)
    f_p, f_r = port_oracle._objective(model), ref_oracle._objective(model)
    for s in sig.astype(np.float64):
        x = np.asarray(cfg_p.initial_guess, np.float64)
        assert f_p(x, te64, s) == f_r(x, te64, s)
    for tight in (True, False):
        np.testing.assert_array_equal(
            port_oracle.fit_batch_scipy(sig.astype(np.float64), te64, cfg_p, tight=tight),
            ref_oracle.fit_batch_scipy(sig.astype(np.float64), te64, cfg_r, tight=tight))
    no_prior = C.fit_config(model, True, prior=False)
    x, ok, nit, fun = port_oracle.fit_voxel_scipy(sig[0].astype(np.float64), te64, no_prior)
    assert x[0] >= sig[0, 0] - 1e-6 and 10.0 <= x[1] <= 2000.0
