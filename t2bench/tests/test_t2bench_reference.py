"""The reference fit found through the configuration's kernel family gives
the bits of the per-model fit it replaced, and the serve driver runs the
kernels that the configuration states, whatever the environment says.

The expected values come from the per-model fit as it stood before the
families, copied here: a gaussian and a rician branch over the frozen plain
fits.
"""

import pytest
import torch

from t2bench import generate, reference, serve
from t2bench.reference.fits import _fit3_cont_plain, _fit3_plain, _gauss_fit_plain
from t2bench.tests.test_t2bench_run import small

SEED = 2**31 + 21


def _per_model_fit_block(config, s):
    """The reference's per-model fit of one block, as it was."""
    model = config["model"]
    te, lo, hi, guess = reference.fit_args(config)
    ftol, gtol, budget = float(config["ftol"]), float(config["gtol"]), int(config["max_iters"])
    if model == "gaussian":
        k, t2, f, conv, nit = _gauss_fit_plain(
            s, te, lo, hi, max_iters=budget, ftol=ftol, gtol=gtol, no_prior=False,
            full_budget=False, stall_iters=3, stall_tol=max(ftol, 1e-3))
        return {"k": k, "t2": t2, "sigma": torch.zeros_like(k), "fun": f, "converged": conv,
                "n_iter": nit, "steps.gauss_fit": nit.double().sum()}
    assert model == "rician"
    kw = dict(ftol=ftol, gtol=gtol, stall_tol=max(ftol, 1e-6))
    prefix = int(config["prefix3"])
    x1, st1 = _fit3_plain(s, model, te, lo, hi, guess, max_iters=prefix, **kw)
    x, st = _fit3_cont_plain(s, model, te, lo, hi, guess, x1, st1,
                             max_iters=budget - prefix, **kw)
    return {"k": x[0], "t2": x[1], "sigma": x[2], "fun": st[0], "converged": st[1] > 0.5,
            "n_iter": st[2].to(torch.int32), "steps.fit3_multistart": st1[2].double().sum(),
            "steps.fit3_cont": (st[2] - st1[2]).double().sum()}


@pytest.mark.parametrize("name", ["lf055_gauss.serve", "hf15_rician.serve"])
def test_family_fit_is_the_per_model_fit(name):
    """At a 24^3 grid, one seed: every map bitwise, every steps sum equal."""
    cell = small(name)
    s = torch.cat([it.signal[it.mask] for it in generate.items(cell.config, cell.traffic,
                                                               SEED, "cpu")])
    got = reference.fit(cell.config, s)
    want = _per_model_fit_block(cell.config, s)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key.startswith("steps."):
            assert got[key] == float(value) > 0, key
        else:
            value = value.to(torch.float32) if value.dtype.is_floating_point else value
            assert got[key].dtype == value.dtype and torch.equal(got[key], value), key


def _answers(cell, pool):
    call = serve._call(cell.config, cell.traffic, "cpu")
    return [call(it) for it in pool]


def test_serve_runs_the_configurations_kernels(monkeypatch):
    """A small ``hf15_rician`` run: the driver's answers are bitwise the
    same with ``FT2_FIT3_PREFIX=0`` and ``FT2_FIT3_VARPRO=0`` as without
    them, though the prefix variable alone changes an unpinned call."""
    from fetal_t2mapping_tpu_torch.models.volume_fit import fit_volume

    cell = small("hf15_rician.serve")
    pool = generate.items(cell.config, cell.traffic, SEED, "cpu")
    monkeypatch.delenv("FT2_FIT3_PREFIX", raising=False)
    monkeypatch.delenv("FT2_FIT3_VARPRO", raising=False)
    unset = _answers(cell, pool)
    monkeypatch.setenv("FT2_FIT3_PREFIX", "0")
    monkeypatch.setenv("FT2_FIT3_VARPRO", "0")
    pinned = _answers(cell, pool)
    for a, b in zip(unset, pinned):
        for key in serve.MAPS + ("n_masked", "n_overflow"):
            assert torch.equal(getattr(a, key), getattr(b, key)), key
    # the witness: left to the environment, the prefix changes the answer
    te, lo, hi, guess = reference.fit_args(cell.config)
    loose = fit_volume(pool[0].signal, pool[0].mask, te, lo, hi, model="rician", guess=guess,
                       mask_frac=float(cell.traffic["mask_frac"]), device="cpu")
    assert not all(torch.equal(getattr(loose, key), getattr(unset[0], key))
                   for key in serve.MAPS)
