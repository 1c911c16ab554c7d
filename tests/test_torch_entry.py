"""The port's entry module (``fetal_t2mapping_tpu_torch.entry``) against the
JAX package's (``__graft_entry__``), and the port's packaging.

``entry(device="cpu")``'s fit step against the reference's run through
``jax.jit`` on the same batch (the numpy batches are equal bitwise): the
gaussian bands of ROADMAP.md (parameters 1e-3 relative) on the
identifiable voxels converged in both, converged shares within 0.01.
``dryrun_multichip(4, devices=["cpu"] * 4)`` runs at its full sizes (a few
seconds here).
"""

import os
import sys
import tomllib

import jax
import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu_torch import entry as port_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import __graft_entry__ as ref_entry  # noqa: E402

torch.set_num_threads(1)


def test_example_batch_is_the_references():
    for kw in (dict(), dict(n=1000, t=2, seed=3)):
        a, b = port_entry.example_batch(**kw), ref_entry._example_batch(**kw)
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and np.array_equal(u, v)


def test_entry_matches_the_reference_fit_step():
    fn, (sig, te) = port_entry.entry(device="cpu")
    assert sig.device == te.device == torch.device("cpu") and tuple(sig.shape) == (4096, 3)
    x, conv, res = fn(sig, te)
    rfn, rargs = ref_entry.entry()
    np.testing.assert_array_equal(sig.numpy(), rargs[0])
    rx, rconv, rres = (np.asarray(a) for a in jax.jit(rfn)(*rargs))
    x, conv, res = x.numpy(), conv.numpy(), res.numpy()
    assert x.shape == rx.shape == (4096, 2) and np.isfinite(res).all()
    assert conv.mean() > 0.9 and abs(conv.mean() - rconv.mean()) <= 0.01
    rng = np.random.default_rng(0)          # example_batch's truth, redrawn
    k, t2 = rng.uniform(600.0, 5000.0, 4096), rng.uniform(20.0, 500.0, 4096)
    ident = (k * np.exp(-299.0 / t2) >= 30.0) & conv & rconv
    assert ident.sum() > 3000
    rel = np.abs(x - rx) / np.maximum(np.abs(rx), 1.0)
    assert rel[ident].max() <= 1e-3
    np.testing.assert_allclose(res[ident], rres[ident], rtol=0, atol=1e-2 * 10.0)


def test_entry_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_entry.entry()


def test_dryrun_mesh_takes_no_fewer_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="only 0 visible"):
        port_entry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="3 given"):
        port_entry.dryrun_mesh(2, ["cpu"] * 3)
    assert port_entry.dryrun_mesh(3, ["cpu"] * 3).size == 3


def test_dryrun_multichip_on_a_cpu_mesh(capsys):
    out = port_entry.dryrun_multichip(4, devices=["cpu"] * 4)
    assert set(out["seconds"]) == {"fused", "batch", "fit_volume", "registration",
                                   "segmentation", "session", "scale"}
    assert out["n_devices"] == 4 and out["n_fused"] == 110_080
    assert out["fit_volume_n_masked"] == sum(out["per_shard"]) > 20_000
    assert len(set(out["per_shard"])) == 4
    assert out["scale"]["n_voxels"] >= 1_000_000
    assert out["scale"]["equal_maps"] == ["k", "res", "sigma", "t2"]
    assert out["session"]["converged_frac"] > 0.9
    assert capsys.readouterr().out.startswith("dryrun_multichip(4) over ['cpu', 'cpu'")


def test_pyproject_scripts_name_the_port_clis():
    """The port's three CLIs beside the JAX package's, each target a module
    with ``main``."""
    import importlib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items() if k.startswith("t2map-torch-")}
    assert port == {"t2map-torch-dcm2csv": "fetal_t2mapping_tpu_torch.cli.dcm2csv:main",
                    "t2map-torch-recon": "fetal_t2mapping_tpu_torch.cli.qmri_reconstruction:main",
                    "t2map-torch-fit": "fetal_t2mapping_tpu_torch.cli.t2mapping:main"}
    for target in port.values():
        module, attr = target.split(":")
        assert callable(getattr(importlib.import_module(module), attr))
