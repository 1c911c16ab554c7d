"""The port's fused fit (plain PyTorch version, CPU) against the JAX
package's fused Pallas kernel (interpret mode on CPU), on the same seeded
inputs, with the bands bench.py:638-652 sets between two codegens of one
kernel: parameters 1e-3 and objective 1e-2 relative, convergence rate
within 0.01.

Parameters and objectives are compared on identifiable voxels only
(noiseless last echo >= 3 sigma, bench.py:612): below that the SSE has a
flat ridge along which float32 rounding alone moves (k, T2) by O(1) at
equal objective, in the reference as much as in the port.
"""

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu.models import pallas_fit as ref
from fetal_t2mapping_tpu_torch.models import fused_fit as port

torch.set_num_threads(1)

TES3 = (114.0, 202.0, 299.0)
TES6 = (114.0, 150.0, 202.0, 250.0, 299.0, 350.0)
LO, HI = (0.0, 10.0), (1e6, 2000.0)
NOISE = 8.0


def _make_data(n, tes, seed=5):
    """bench.py:120-127's generator."""
    rng = np.random.default_rng(seed)
    te = np.asarray(tes, np.float32)
    k = rng.uniform(600.0, 5000.0, n).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, n).astype(np.float32)
    sig = (k[:, None] * np.exp(-te[None, :] / t2[:, None])).astype(np.float32)
    sig = np.maximum(sig + rng.normal(0, NOISE, sig.shape).astype(np.float32), 1e-2)
    ident = k * np.exp(-tes[-1] / t2) >= 3 * NOISE
    return sig, ident


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


@pytest.mark.parametrize("tes,no_prior,gtol", [
    (TES3, False, 0.0), (TES3, True, 0.0), (TES6, False, 0.0),
    (TES6, True, 0.0), (TES3, False, 1e-3)])
def test_fit_fused_matches_reference_kernel(tes, no_prior, gtol):
    sig, ident = _make_data(4096, tes)
    r = ref.fit_fused(sig, tes, LO, HI, no_prior=no_prior, gtol=gtol,
                      interpret=True)
    p = port.fit_fused(sig, tes, LO, HI, no_prior=no_prior, gtol=gtol,
                       device="cpu")
    x_r, f_r = np.asarray(r.x), np.asarray(r.fun)
    x_p, f_p = p.x.numpy(), p.fun.numpy()
    assert x_p.shape == (4096, 2) and p.x.device.type == "cpu"
    assert p.converged.dtype == torch.bool and p.n_iter.dtype == torch.int32
    assert p.n_overflow == 0
    assert _rel(x_p, x_r)[ident].max() <= 1e-3
    assert _rel(f_p, f_r)[ident].max() <= 1e-2
    conv_r = float(np.mean(np.asarray(r.converged)))
    assert abs(p.converged.float().mean().item() - conv_r) <= 0.01


def test_full_budget_changes_no_output():
    # converged voxels are frozen, so running every voxel to max_iters
    # (the measurement instrument) must give bit-identical results
    sig, _ = _make_data(2048, TES3, seed=7)
    a = port.fit_fused(sig, TES3, LO, HI, device="cpu")
    b = port.fit_fused(sig, TES3, LO, HI, full_budget=True, device="cpu")
    for fa, fb in zip(a[:4], b[:4]):
        assert torch.equal(fa, fb)


def test_results_do_not_depend_on_batch_grouping():
    sig, _ = _make_data(1024, TES3, seed=9)
    whole = port.fit_fused(sig, TES3, LO, HI, device="cpu")
    parts = [port.fit_fused(sig[i:i + 100], TES3, LO, HI, device="cpu")
             for i in range(0, 1024, 100)]
    assert torch.equal(whole.x, torch.cat([q.x for q in parts]))
    assert torch.equal(whole.n_iter, torch.cat([q.n_iter for q in parts]))


_BAD_ARGS = [
    ("lorentzian", TES3, LO, HI, None, False),                  # unknown model
    ("gaussian", TES3, (0.0,), HI, None, False),                # too few bounds
    ("gaussian", TES3, LO, (1e6, 2000.0, 5.0), None, False),    # too many
    ("rician", TES3, LO, HI, None, False),                      # 3-param needs 3
    ("gaussian_rician", TES3, (1.0, 10.0, 1.0), (1e6, 2000.0, 1e3), None, True),
]


@pytest.mark.parametrize("args", _BAD_ARGS)
def test_validate_fused_args_rejects_like_reference(args):
    with pytest.raises(ValueError) as e_ref:
        ref.validate_fused_args(*args)
    with pytest.raises(ValueError) as e_port:
        port.validate_fused_args(*args)
    assert str(e_port.value) == str(e_ref.value)


@pytest.mark.parametrize("args", [
    ("gaussian", TES3, LO, HI, None, True),
    ("rician", np.asarray(TES3, np.float32), (1.0, 10.0, 0.0),
     (1e6, 2000.0, 1e3), (650.0, 110.0, 40.0), False),
    ("gaussian_rician", TES6, (1.0, 10.0, 1.0), (1e6, 2000.0, 1e3), None, False),
])
def test_validate_fused_args_normalizes_like_reference(args):
    assert port.validate_fused_args(*args) == ref.validate_fused_args(*args)


def test_unported_strategies_and_models_raise():
    """An unknown strategy raises ('twophase', which raised here before it
    was ported, runs: tests/test_torch_fused_twophase.py); the
    3-parameter models, which raised here before they were ported, run."""
    sig, _ = _make_data(64, TES3)
    with pytest.raises(ValueError, match="unknown strategy"):
        port.fit_fused(sig, TES3, LO, HI, strategy="fastest", device="cpu")
    r = port.fit_fused(sig, TES3, (1.0, 10.0, 1.0), (1e6, 2000.0, 1e3),
                       model="gaussian_rician", device="cpu")
    assert r.x.shape == (64, 3) and bool(torch.isfinite(r.x).all())
    with pytest.raises(ValueError, match="echoes"):
        port.fit_fused(np.ones((8, 9), np.float32), tuple(range(1, 10)), LO, HI,
                       device="cpu")


def test_kernel_params_layout():
    # the host-side struct the CUDA kernel reads: float32, the grid scan's
    # constants computed in float64 as the reference's Python floats and
    # rounded once
    params = port._kernel_params(TES3, LO, HI, 1e-9, 0.0, 1e-3)
    assert params.dtype == np.float32 and params.size == 10 + 8 + 2 * 12 + 12 * 8
    np.testing.assert_array_equal(params[10:13], np.float32(TES3))
    frac = 0.02 + 0.96 * np.arange(12) / 11.0
    t2_g = np.exp(np.log(10.0) + frac * (np.log(2000.0) - np.log(10.0)))
    e_g = np.exp(-np.asarray(TES3)[None, :] / t2_g[:, None])
    np.testing.assert_array_equal(params[18:30], t2_g.astype(np.float32))
    np.testing.assert_allclose(params[30:42], (e_g ** 2).sum(1), rtol=1e-7)
    np.testing.assert_array_equal(params[42:].reshape(12, 8)[:, :3],
                                  e_g.astype(np.float32))


@pytest.mark.parametrize("layout", ["rows of one buffer", "separate", "rows out of order"])
def test_columns_view_the_kernels_rows_else_stack(layout):
    """The gaussian x (N, 2) is a view of k and t2 where they are
    consecutive rows of one buffer (as the CUDA entry writes them), else a
    stack; the values are the stack's either way."""
    out = torch.arange(15, dtype=torch.float32).reshape(3, 5)
    k, t2 = {"rows of one buffer": (out[0], out[1]),
             "separate": (out[0].clone(), out[1].clone()),
             "rows out of order": (out[1], out[0])}[layout]
    x = port._columns(k, t2)
    assert torch.equal(x, torch.stack([k, t2], dim=1))
    assert (x.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()) \
        == (layout == "rows of one buffer")
