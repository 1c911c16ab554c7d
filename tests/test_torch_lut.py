"""The port's lookup-table T2 estimate (models/lut.py) against the JAX
package's, on the seeded signals of tests/test_profiling_lut.py.

Both build a 2048-entry log-spaced T2 table per echo pair and invert the
decay ratios by a table search and a linear interpolation. The port builds
its table in float64 and rounds it once; the JAX package's float32 grid
(``jnp.linspace`` and ``exp``) is within 13 ulps of it in T2 (1.1e-6
relative) and 70 ulps in the ratio (6.6e-6 relative; exp(-dte/T2) near 1
amplifies T2's rounding). On these signals the two estimates then agree
to 1e-6 relative, so they are held to 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu.models.lut import build_ratio_table as ref_build_ratio_table
from fetal_t2mapping_tpu.models.lut import lut_t2_host as ref_lut_t2_host
from fetal_t2mapping_tpu_torch.models.lut import build_ratio_table, lut_t2, lut_t2_host

TE = [114.0, 202.0, 299.0]


def _noiseless():
    rng = np.random.default_rng(0)
    k = rng.uniform(500.0, 4000.0, 512).astype(np.float32)
    t2 = rng.uniform(30.0, 800.0, 512).astype(np.float32)
    sig = k[:, None] * np.exp(-np.asarray(TE)[None, :] / t2[:, None])
    return sig, k, t2


def _noisy():
    rng = np.random.default_rng(1)
    t2 = np.full(2000, 120.0, np.float32)
    sig = 1000.0 * np.exp(-np.asarray(TE)[None, :] / t2[:, None])
    sig = np.maximum(sig + rng.normal(0, 10, sig.shape), 1.0).astype(np.float32)
    return sig


def test_lut_recovers_t2_noiseless():
    sig, k, t2 = _noiseless()
    out = lut_t2_host(sig, TE, device="cpu")
    rel_t2 = np.abs(out[:, 1] - t2) / t2
    rel_k = np.abs(out[:, 0] - k) / k
    assert rel_t2.max() < 2e-3, rel_t2.max()
    assert rel_k.max() < 2e-2
    np.testing.assert_allclose(out, ref_lut_t2_host(sig, TE), rtol=1e-5)


def test_lut_is_noise_tolerant_enough_for_init():
    sig = _noisy()
    out = lut_t2_host(sig, TE, device="cpu")
    assert abs(np.median(out[:, 1]) - 120.0) / 120.0 < 0.05
    np.testing.assert_allclose(out, ref_lut_t2_host(sig, TE), rtol=1e-5)


@pytest.mark.parametrize("dte", [36.0, 88.0, 185.0])
def test_ratio_table_within_stated_ulps(dte):
    t2, ratio = (t.numpy() for t in build_ratio_table(dte))
    r_t2, r_ratio = (np.asarray(a) for a in ref_build_ratio_table(dte))
    assert t2.dtype == np.float32 and t2.shape == (2048,)
    assert np.all(np.diff(ratio) >= 0)

    def ulps(a, b):
        return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max()

    assert ulps(t2, r_t2) <= 13
    assert ulps(ratio, r_ratio) <= 70


def test_lut_t2_returns_a_tensor_on_the_device():
    sig, _, _ = _noiseless()
    out = lut_t2(torch.from_numpy(sig.astype(np.float32)), te=TE, device="cpu")
    assert out.shape == (512, 2) and out.dtype == torch.float32 and out.device.type == "cpu"
