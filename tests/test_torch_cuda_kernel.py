"""The CUDA fit kernel against its plain PyTorch version, on the card.

Runs only where ``torch.cuda.is_available()`` (marker ``cuda``): on the
H100, ``python3 -m pytest --noconftest tests/test_torch_cuda_kernel.py``
(the root conftest imports jax, which a GPU host need not have). The kernel is
built with -fmad=false and follows the plain version op for op, and both
use the card's IEEE division and accurate expf/logf, so they are expected
to agree to the last bit; the bench.py:638-652 bands are the gate.
"""

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu_torch.models import fused_fit

TES3 = (114.0, 202.0, 299.0)
TES6 = (114.0, 150.0, 202.0, 250.0, 299.0, 350.0)
LO, HI = (0.0, 10.0), (1e6, 2000.0)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _make_data(n, tes, seed=5):
    rng = np.random.default_rng(seed)
    te = np.asarray(tes, np.float32)
    k = rng.uniform(600.0, 5000.0, n).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, n).astype(np.float32)
    sig = (k[:, None] * np.exp(-te[None, :] / t2[:, None])).astype(np.float32)
    sig = np.maximum(sig + rng.normal(0, 8.0, sig.shape).astype(np.float32), 1e-2)
    return sig, k * np.exp(-tes[-1] / t2) >= 24.0


@pytest.mark.parametrize("tes,no_prior,gtol", [
    (TES3, False, 0.0), (TES3, True, 0.0), (TES6, False, 0.0), (TES6, True, 1e-3)])
def test_kernel_matches_plain_version(card, tes, no_prior, gtol):
    sig, ident = _make_data(1 << 16, tes)
    s = torch.from_numpy(sig).to(card)
    kw = dict(max_iters=60, ftol=1e-9, gtol=gtol, no_prior=no_prior,
              full_budget=False, stall_iters=3, stall_tol=1e-3)
    before = fused_fit.KERNEL_LAUNCHES
    out_k = fused_fit._gauss_fit_cuda(s, tes, LO, HI, **kw)
    torch.cuda.synchronize()
    assert fused_fit.KERNEL_LAUNCHES == before + 1
    out_p = fused_fit._gauss_fit_plain(s, tes, LO, HI, **kw)
    assert fused_fit.KERNEL_LAUNCHES == before + 1
    x_k = torch.stack(out_k[:2]).cpu().numpy()
    x_p = torch.stack(out_p[:2]).cpu().numpy()
    assert (np.abs(x_k - x_p) / np.maximum(np.abs(x_p), 1.0))[:, ident].max() <= 1e-3
    f_k, f_p = out_k[2].cpu().numpy(), out_p[2].cpu().numpy()
    assert (np.abs(f_k - f_p) / np.maximum(np.abs(f_p), 1.0))[ident].max() <= 1e-2
    assert abs(out_k[3].float().mean().item() - out_p[3].float().mean().item()) <= 0.01


def test_fit_fused_on_cuda_uses_the_kernel(card):
    sig, _ = _make_data(5000, TES3, seed=1)
    before = fused_fit.KERNEL_LAUNCHES
    r = fused_fit.fit_fused(sig, TES3, LO, HI)
    assert fused_fit.KERNEL_LAUNCHES == before + 1
    assert r.x.device.type == "cuda" and r.x.shape == (5000, 2)
    assert r.converged.dtype == torch.bool and r.n_iter.dtype == torch.int32
    assert torch.isfinite(r.x).all()
