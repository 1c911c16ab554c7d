"""The port's signal model, log-linear init and batched Newton solver
(PyTorch, CPU) against the JAX package's, on the same seeded inputs.

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

from fetal_t2mapping_tpu.models import init as ref_init
from fetal_t2mapping_tpu.models import signal as ref_signal
from fetal_t2mapping_tpu.models import solver as ref_solver
from fetal_t2mapping_tpu_torch.models import init as port_init
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


@pytest.mark.parametrize("model", ["gaussian_rician", "rician"])
def test_three_parameter_models_are_not_ported(model):
    sig, _ = _make_data(8)
    x0 = np.ones((8, 3), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        port_solver.fit_batch_traced(torch.from_numpy(sig), TES, x0, 0.0, 1e4,
                                     model=model)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        port_signal.predict_signal(model, (x0[:, 0], x0[:, 1], x0[:, 2]), TES)
