"""The port's two-phase solver (``solver.fit_batch_twophase``,
``_tail_partition``) and the ``loglinear_init=False`` route of ``fit_stack``
(PyTorch, CPU) against the JAX package's, on the same seeded inputs.

The two-phase fit runs 12 lock-step iterations from the protocol guess
clipped into each voxel's box, then refits up to 6.25% of the voxels that
have not converged for the rest of the budget; the others keep phase 1's
result and are counted in ``n_overflow``. Parameters are compared in the
bench.py:638-652 bands on identifiable voxels (noiseless last echo >= 3
sigma) that both sides converged: gaussian 1e-3 and objective 1e-2,
3-parameter k and T2 1e-2 and objective 3e-2; convergence rates within
0.01.

Two float32 implementations at ftol 1e-9 part on some voxels, and the
bands are held per voxel against a witness (``_assert_bands``). A voxel
outside them passes only if (a) the float64 objectives at the two answers
lie within each other's objective band, two equally good minima (a flat
ridge: gaussian_rician's T2 pinned at its bound, k and sigma trading off),
or (b) it is rounding-sensitive: one side's own answer leaves the bands
when the signal moves by one float32 ulp, up or down. From a single start
the 3-parameter objectives have a second basin at the sigma bound, and
which one a voxel enters turns on such ulps, in both directions. The same
holds for ``n_overflow``, the count of voxels still unconverged after 12
phase-1 iterations: it must be equal, or, where one side's own count moves
under a one-ulp change of the signal, within the convergence band (0.01 N).
After 2 phase-1 iterations, where every voxel's flag agrees, it is equal.
The gaussian fit is held to the bands on every voxel and needs no witness.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu import config as ref_C
from fetal_t2mapping_tpu.core import stack as ref_stack
from fetal_t2mapping_tpu.core.volume import Volume as RefVolume
from fetal_t2mapping_tpu.models import solver as ref_solver
from fetal_t2mapping_tpu.models import t2map as ref_t2map
from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.core import stack
from fetal_t2mapping_tpu_torch.core.volume import Volume
from fetal_t2mapping_tpu_torch.models import solver as port_solver
from fetal_t2mapping_tpu_torch.models import t2map as port_t2map
from fetal_t2mapping_tpu_torch.models.oracle import _objective

torch.set_num_threads(1)

TES = (114.0, 202.0, 299.0)
NOISE = 8.0
N_VOX = 2048
MODELS = ("gaussian", "gaussian_rician", "rician")
BANDS = {"gaussian": (1e-3, 1e-2), "gaussian_rician": (1e-2, 3e-2), "rician": (1e-2, 3e-2)}


def _make_data(n, model, seed):
    """Signals in each model's low-field box (rician's caps k at 900):
    additive Gaussian noise for gaussian, the magnitude of complex Gaussian
    noise for the 3-parameter models; identifiable = last echo >= 3 sigma."""
    rng = np.random.default_rng(seed)
    te = np.asarray(TES, np.float32)
    k = rng.uniform(600.0, 880.0 if model == "rician" else 5000.0, n).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, n).astype(np.float32)
    a = k[:, None] * np.exp(-te[None, :] / t2[:, None])
    if model == "gaussian":
        sig = np.maximum(a + rng.normal(0, NOISE, a.shape), 1e-2)
    else:
        sig = np.hypot(a + rng.normal(0, NOISE, a.shape), rng.normal(0, NOISE, a.shape))
    return sig.astype(np.float32), k * np.exp(-TES[-1] / t2) >= 3 * NOISE


def _start(model, prior, sig):
    """fit_stack's inputs for loglinear_init=False: per-voxel boxes and the
    protocol guess clipped into them."""
    cfg = C.fit_config(model, True, prior=prior, loglinear_init=False)
    lo, hi = port_t2map._bounds_for(cfg, sig)
    return np.clip(np.tile(np.float32(cfg.initial_guess), (sig.shape[0], 1)), lo, hi), lo, hi


def _outside(model, a, b, ident):
    """The ``ident`` voxels where fits a and b, each (x, fun, converged),
    leave the bands."""
    bx, bf = BANDS[model]
    rel_x = (np.abs(a[0] - b[0]) / np.maximum(np.abs(b[0]), 1.0))[:, :2].max(axis=1)
    rel_f = np.abs(a[1] - b[1]) / np.maximum(np.abs(b[1]), 1.0)
    return ident & ~((rel_x <= bx) & (rel_f <= bf))


def _assert_bands(model, sig, port, ref, ident, rerun_port, rerun_ref):
    """The module docstring's bands on the ``ident`` voxels that both
    converged, the convergence rates and n_overflow. ``port`` and ``ref``
    are (x, fun, converged, n_overflow); ``rerun_port(sig)`` and
    ``rerun_ref(sig)`` fit another signal the same way, for the witness of
    rounding (run only where a voxel or n_overflow needs it)."""
    assert abs(float(np.mean(port[2])) - float(np.mean(ref[2]))) <= 0.01
    both = ident & port[2] & ref[2]
    assert both.sum() >= 16
    out = np.flatnonzero(_outside(model, port, ref, both))
    te = np.asarray(TES, np.float64)
    objective, bf = _objective(model), BANDS[model][1]
    f64 = np.array([[objective(x[i].astype(np.float64), te, sig[i].astype(np.float64))
                     for x in (port[0], ref[0])] for i in out]).reshape(-1, 2)
    equal = np.abs(f64[:, 0] - f64[:, 1]) <= bf * np.maximum(np.abs(f64).min(axis=1), 1.0)
    rest = out[~equal]
    text = (f"{model}: {out.size} of {both.sum()} outside the bands, {int(equal.sum())} of them "
            f"equally good minima; n_overflow port {port[3]} ref {ref[3]}")
    if model == "gaussian":
        assert out.size == 0, text
    if rest.size or port[3] != ref[3]:
        sensitive, counts = np.zeros(sig.shape[0], bool), []
        for own, rerun in ((port, rerun_port), (ref, rerun_ref)):
            for towards in (np.inf, 0.0):
                other = rerun(np.nextafter(sig, np.float32(towards)))
                sensitive |= _outside(model, other, own, ident)
                counts.append(other[3])
        moved = counts[:2] != [port[3]] * 2 or counts[2:] != [ref[3]] * 2
        text += (f"; {int(sensitive[rest].sum())} of the other {rest.size} rounding-sensitive; "
                 f"n_overflow with the signal one ulp up, down: port {counts[:2]} ref "
                 f"{counts[2:]}")
        assert sensitive[rest].all(), f"{text}; not: {rest[~sensitive[rest]]}"
        if port[3] != ref[3]:
            assert moved and abs(port[3] - ref[3]) <= 0.01 * sig.shape[0], text
    print(text)


def _result(r):
    """(x, fun, converged, n_overflow) of a FitResult of either package."""
    return (np.asarray(r.x), np.asarray(r.fun), np.asarray(r.converged).astype(bool),
            int(r.n_overflow))


@pytest.mark.parametrize("capacity", [128, 1000, N_VOX, N_VOX + 96])
def test_tail_partition_matches_reference(capacity):
    conv = np.random.default_rng(capacity).uniform(size=N_VOX) < 0.7
    idx_r, n_r = ref_solver._tail_partition(jnp.asarray(conv), capacity)
    idx_p, n_p = port_solver._tail_partition(torch.from_numpy(conv), capacity)
    assert idx_p.shape == (capacity,) and n_p.dtype == torch.int32
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_r))
    assert int(n_p) == int(n_r) == int((~conv).sum())


@pytest.mark.parametrize("prior", [True, False], ids=["prior", "no_prior"])
@pytest.mark.parametrize("model", MODELS)
def test_fit_batch_twophase_matches_reference(model, prior):
    """fit_stack's two-phase solve at the pipeline's tolerances: from the
    guess most voxels are still running after 12 iterations, so the
    128-voxel tail overflows."""
    sig, ident = _make_data(N_VOX, model, seed=1)
    x0, lo, hi = _start(model, prior, sig)

    def ref(s):
        return _result(ref_solver.fit_batch_twophase(s, jnp.asarray(TES), x0, lo, hi, model=model))

    def port(s):
        return _result(port_solver.fit_batch_twophase(torch.from_numpy(s), TES, x0, lo, hi,
                                                      model=model))

    p = port_solver.fit_batch_twophase(torch.from_numpy(sig), TES, x0, lo, hi, model=model)
    assert p.x.shape == (N_VOX, len(lo[0])) and p.n_iter.dtype == torch.int32
    assert p.converged.dtype == torch.bool and p.n_overflow.dtype == torch.int32
    x_p = p.x.numpy()
    assert np.isfinite(x_p).all() and (x_p >= lo).all() and (x_p <= hi).all()
    r = ref(sig)
    assert r[3] > 0
    _assert_bands(model, sig, _result(p), r, ident, port, ref)


@pytest.mark.parametrize("model", MODELS)
def test_twophase_tail_overflow_matches_reference(model):
    """Two phase-1 iterations leave both sides the same unconverged voxels,
    far more than the 128 refit slots: the same n_overflow, the refit
    voxels in the bands, and every voxel without a slot keeps phase 1's
    result, bits and all."""
    sig, ident = _make_data(N_VOX, model, seed=2)
    x0, lo, hi = _start(model, True, sig)
    r = ref_solver.fit_batch_twophase(sig, jnp.asarray(TES), x0, lo, hi, model=model,
                                      phase1_iters=2)
    p = port_solver.fit_batch_twophase(torch.from_numpy(sig), TES, x0, lo, hi, model=model,
                                       phase1_iters=2)
    r1 = port_solver.fit_batch(torch.from_numpy(sig), TES, x0, lo, hi, model=model, max_iters=2)
    n_tail = int((~r1.converged).sum())
    assert n_tail > 128
    assert int(p.n_overflow) == int(r.n_overflow) == n_tail - 128
    refit = np.zeros(N_VOX, bool)
    refit[np.flatnonzero(~r1.converged.numpy())[:128]] = True
    for a, b in ((p.x, r1.x), (p.fun, r1.fun), (p.converged, r1.converged),
                 (p.n_iter, r1.n_iter)):
        np.testing.assert_array_equal(a.numpy()[~refit], b.numpy()[~refit])
    assert (p.n_iter.numpy()[refit] >= r1.n_iter.numpy()[refit]).all()
    _assert_bands(model, sig, _result(p), _result(r), ident & refit,
                  lambda s: _result(port_solver.fit_batch_twophase(
                      torch.from_numpy(s), TES, x0, lo, hi, model=model, phase1_iters=2)),
                  lambda s: _result(ref_solver.fit_batch_twophase(
                      s, jnp.asarray(TES), x0, lo, hi, model=model, phase1_iters=2)))


GEOM = dict(spacing=(1.0, 1.0, 1.0))
SHAPE = (16, 16, 8)   # N_VOX voxels, all masked in


def _recons(sig):
    return [np.ascontiguousarray(sig[:, t].reshape(SHAPE)) for t in range(len(TES))]


def _cols(model, out):
    """(x, fun, converged) of a fit_stack output, voxels in the volume's
    flat order, as the signal was made."""
    x = [out.k.data.reshape(-1), out.t2.data.reshape(-1)]
    if model != "gaussian":
        x.append(out.sigma.data.reshape(-1))
    return np.stack(x, axis=1), out.fun.data.reshape(-1), out.converged.data.reshape(-1) > 0.5


def _port_fit_stack(model, sig):
    """The port's fit_stack (loglinear_init=False) on the CPU over a fully
    masked stack of ``sig``: its output and (x, fun, converged, n_overflow)."""
    mask = Volume(np.ones(SHAPE, np.uint8), **GEOM)
    st = stack.EchoStack.from_volumes([Volume(r, **GEOM) for r in _recons(sig)],
                                      [mask] * len(TES), TES)
    out = port_t2map.fit_stack(st, C.fit_config(model, True, loglinear_init=False),
                               trace_samples=20, device="cpu")
    return out, (*_cols(model, out), out.n_overflow)


def _ref_fit_stack(model, sig):
    """The reference's fit_stack on the same stack, and its n_overflow from
    its two-phase solver on the batch that fit_stack gathers."""
    mask = RefVolume(np.ones(SHAPE, np.uint8), **GEOM)
    st = ref_stack.EchoStack.from_volumes([RefVolume(r, **GEOM) for r in _recons(sig)],
                                          [mask] * len(TES), TES)
    cfg = ref_C.fit_config(model, True, loglinear_init=False)
    out = ref_t2map.fit_stack(st, cfg, trace_samples=20)
    batch, _, n = st.gather()
    assert n == batch.shape[0] == N_VOX
    lo, hi = ref_t2map._bounds_for(cfg, batch)
    r = ref_solver.fit_batch_twophase(batch, jnp.asarray(TES), ref_t2map._init_for(
        cfg, batch, TES, lo, hi), lo, hi, model=model)
    return out, (*_cols(model, out), int(r.n_overflow))


@pytest.mark.parametrize("model", MODELS)
def test_fit_stack_guess_start_matches_reference(model):
    """fit_stack with loglinear_init=False (no longer refused): the
    two-phase solve on the gathered batch, the maps in the bands, the
    overflow count of the reference's solver on the same batch, and traces
    that start from the guess as the reference's do."""
    sig, ident = _make_data(N_VOX, model, seed=3)
    out_p, port = _port_fit_stack(model, sig)
    out_r, ref = _ref_fit_stack(model, sig)
    assert out_p.n_voxels == N_VOX
    _assert_bands(model, sig, port, ref, ident, lambda s: _port_fit_stack(model, s)[1],
                  lambda s: _ref_fit_stack(model, s)[1])
    assert out_p.traces["f_val"].shape == out_r.traces["f_val"].shape == (60, 20)
    np.testing.assert_array_equal(out_p.trace_t2, out_p.t2.data.reshape(-1)[
        np.random.default_rng(0).choice(N_VOX, size=20, replace=False)])
    f0_p, f0_r = out_p.traces["f_val"][0], out_r.traces["f_val"][0]
    assert (np.abs(f0_p - f0_r) / np.maximum(np.abs(f0_r), 1.0)).max() <= 1e-4
