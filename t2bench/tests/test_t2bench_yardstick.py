"""The frozen copies hold to what they were copied from, the generator
repeats for a seed, and the trace reduces as documented."""

import numpy as np
import pytest
import torch

from t2bench import generate, reference
from t2bench.counts import fit3, gauss_fit, peaks
from t2bench.reference import fits, objectives

CONFIGS = {
    "gaussian": {"model": "gaussian", "te": [114, 202, 299], "lower": [600.0, 10.0],
                 "upper": [10000.0, 600.0], "initial_guess": [650.0, 165.0], "ftol": 1e-9,
                 "gtol": 0.0, "max_iters": 60, "prefix3": 0, "counts": "gauss_fit"},
    "rician": {"model": "rician", "te": [115, 202, 299], "lower": [850.0, 30.0, 7.0],
               "upper": [30000.0, 600.0, 200.0], "initial_guess": [17.0, 40.0, 0.15],
               "ftol": 1e-9, "gtol": 0.0, "max_iters": 60, "prefix3": 4, "counts": "fit3"},
}


@pytest.mark.parametrize("T,gtol", [(3, 0.0), (3, 1e-2), (6, 0.0)])
def test_counts_equal_chip_smoke(T, gtol):
    import chip_smoke as cs

    assert gauss_fit.gauss_ops(T, gtol) == cs.gauss_ops(T, gtol)
    for model in ("rician", "gaussian_rician"):
        assert fit3.fit3_ops(model, T) == cs.fit3_ops(model, T)
    assert (peaks.HBM_BPS, peaks.FP32_OPS) == (cs.HBM_BPS, cs.FP32_OPS)
    n, steps = 123_457, 987_654
    config = dict(CONFIGS["gaussian"], te=list(range(100, 100 + 10 * T, 10)), gtol=gtol)
    ms, _, ops = cs.gauss_bound(n, T, steps, gtol)
    assert gauss_fit.work(config, n, {"steps.gauss_fit": steps}) == (n * (T * 4 + 17), ops)
    assert gauss_fit.bound_s(config, n, {"steps.gauss_fit": steps}) == pytest.approx(ms * 1e-3)
    config = dict(CONFIGS["rician"], te=config["te"])
    m_ms, _, m_ops = cs.fit3_bound("rician", n, T, steps)
    c_ms, _, c_ops = cs.fit3_bound("rician", n, T, steps // 3, cont=True)
    work = {"steps.fit3_multistart": steps, "steps.fit3_cont": steps // 3}
    assert fit3.work(config, n, work)[1] == m_ops + c_ops
    assert fit3.bound_s(config, n, work) == pytest.approx((m_ms + c_ms) * 1e-3)


@pytest.mark.parametrize("model", ["gaussian", "rician"])
def test_reference_is_the_programs_plain_fit(model):
    """The frozen fits give the bits of the program's plain versions, which
    its kernels are held to bitwise on the card."""
    import chip_smoke as cs
    from fetal_t2mapping_tpu_torch.models import fused_fit

    config = CONFIGS[model]
    sig, *_ = cs.make_data(4096, tuple(float(t) for t in config["te"]), seed=3)
    s = torch.from_numpy(sig)
    got = reference.fit(config, s)
    te, lo, hi, guess = reference.fit_args(config)
    want = fused_fit.fit_fused(s, te, lo, hi, model=model, guess=guess, max_iters=60,
                               ftol=1e-9, gtol=0.0, device="cpu")
    x = torch.stack([got["k"], got["t2"]] + ([got["sigma"]] if model == "rician" else []), 1)
    assert torch.equal(x, want.x)
    assert torch.equal(got["fun"], want.fun) and torch.equal(got["converged"], want.converged)
    assert torch.equal(got["n_iter"], want.n_iter)
    assert all(v > 0 for k, v in got.items() if k.startswith("steps."))


def test_objectives_copy_matches():
    from fetal_t2mapping_tpu_torch.models import fgh

    g = torch.Generator().manual_seed(1)
    p = tuple(torch.rand(500, generator=g) * 100 + 1 for _ in range(3))
    s = list(torch.rand(3, 500, generator=g) * 500)
    te = [115.0, 202.0, 299.0]
    a, b = objectives.rician_fgh(p, s, te), fgh.rician_fgh(p, s, te)
    assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert fits._LAM0 == 1e-3 and fits._STALL_ITERS == 3


def test_generator_repeats_for_a_seed():
    config = {"grid": [20, 22, 24], "te": [114, 202, 299],
              "data": {"k": [600.0, 5000.0], "t2": [20.0, 500.0], "noise": "gaussian",
                       "sigma": 8.0, "floor": 0.01}}
    traffic = {"items": 5, "mask_share": [0.08, 0.22], "head_scale": 1.3, "center_jitter": 2}
    seed = 2**31 + 12345
    a, b = generate.items(config, traffic, seed, "cpu"), generate.items(config, traffic, seed, "cpu")
    c = generate.items(config, traffic, seed + 1, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x.signal, y.signal) and torch.equal(x.mask, y.mask)
    assert not torch.equal(a[0].signal, c[0].signal)
    assert sorted(x.share for x in a) == sorted(x.share for x in c)
    assert a[0].signal.shape == (20, 22, 24, 3) and a[0].signal.dtype == torch.float32
    shifts = generate.shifts(5, 2, seed)
    for x, shift in zip(a, shifts):
        head = generate.ellipsoid_mask(config["grid"], x.share, shift, "cpu", grow=1.3)
        # the echoes are zero outside the head region, and the floor or
        # more inside it, which holds the mask
        assert torch.equal((x.signal == 0).all(dim=-1), ~head)
        assert float(x.signal[head].min()) >= np.float32(0.01)
        assert bool(head[x.mask].all()) and int(head.sum()) > int(x.mask.sum())
    rician = dict(config, data=dict(config["data"], noise="rician"))
    assert torch.equal(generate.items(rician, traffic, -7, "cpu")[1].signal,
                       generate.items(rician, traffic, -7, "cpu")[1].signal)


def test_mask_share_follows_the_traffic():
    grid = (120, 120, 120)
    for share in (0.007, 0.03, 0.08, 0.22):
        m = generate.ellipsoid_mask(grid, share, (3, -4, 5), "cpu")
        assert abs(float(m.float().mean()) - share) < 0.01 * share


def test_trace_reduction():
    """Busy time is the union of device operations; each idle gap inside
    the traced stretch is named by the innermost host event over its
    middle."""
    from t2bench import trace

    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.MARK, "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 10.0, "dur": 20.0},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 20.0, "dur": 20.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 70.0, "dur": 10.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::op", "ts": 0.0, "dur": 15.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 80.0,
           "dur": 20.0}]
    t = trace.reduce(ev, 1e-4)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.op_s == pytest.approx({"a": 20e-6, "b": 20e-6, "copy": 10e-6})
    assert t.gap_s == pytest.approx({"aten::op": 10e-6, "host, no traced op": 30e-6,
                                     "cudaStreamSynchronize": 20e-6})
    assert [name for name, _ in t.top_ops(2)] == ["a", "b"]
