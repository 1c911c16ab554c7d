"""The port's example scripts (``fetal_t2mapping_tpu_torch.examples``) on
the CPU, held to the synthetic truth gates of tests/test_examples.py, and,
where the data come from the same numpy seed, to the reference example's
own results: per-ROI mean T2 within 1e-2 relative (the phantom's on its
identifiable spheres, true T2 >= 50 ms).

Figures are checked as rendered rasters (tests/test_examples.py's
``_assert_real_figure``); with ``figures=False`` a script imports no
matplotlib (the card's machine has none).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu_torch.examples import (invitro_phantom, invivo_analysis, multichip,
                                               profile_unet, serving)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_examples import _assert_real_figure, _load_example  # noqa: E402

torch.set_num_threads(1)


def test_invivo_analysis_example(tmp_path):
    df = invivo_analysis.main(str(tmp_path / "port"), device="cpu")

    # per-tissue T2 recovered from the synthesized maps: WM 110 (+0/5/10
    # per-subject offsets), GM 140 (+offsets), CSF 900, all +-3% noise
    wm = df[df["roi"] == "wm"]["mean"]
    gm = df[df["roi"] == "gm"]["mean"]
    csf = df[df["roi"] == "csf"]["mean"]
    assert len(wm) == len(gm) == len(csf) == 6          # 3 subs x 2 ses
    assert 105 < wm.mean() < 125 and wm.between(100, 130).all()
    assert 135 < gm.mean() < 155 and gm.between(130, 160).all()
    assert 850 < csf.mean() < 950
    gm_rois = df[(df["tissue"] == "gm") & df["roi"].str.startswith("ROI-")]
    assert len(gm_rois) == 6 * 3 * 2
    assert gm_rois["mean"].between(120, 170).all()
    for fig in ("cov_boxplot.png", "pearson_ses.png", "tissue_violin.png",
                "t2map_montage.png", "resmap_montage.png", "relaxation_curves.png"):
        _assert_real_figure(str(tmp_path / "port" / fig))
    assert os.path.getsize(str(tmp_path / "port" / "roi_t2_table.tsv")) > 500

    ref = _load_example("invivo_analysis").main(str(tmp_path / "ref"))
    assert list(ref[["sub", "ses", "roi", "tissue"]].itertuples(index=False)) == \
        list(df[["sub", "ses", "roi", "tissue"]].itertuples(index=False))
    np.testing.assert_allclose(df["mean"], ref["mean"], rtol=1e-2)


def test_serving_example():
    stats = serving.main(2, device="cpu")
    assert len(stats) == 2
    for s in stats:
        # ellipsoid (semi-axes 0.8/0.85/0.7 of half-side) over a 96^3 FOV
        assert 180_000 < s["n_masked"] < 260_000
        assert s["median_rel_err"] < 0.02
        assert s["converged"] > 0.98
        assert s["n_overflow"] == 0


def test_invitro_phantom_example(tmp_path):
    roi = invitro_phantom.main(str(tmp_path / "port"), device="cpu")

    # all 9 spheres fitted; the fitted means track the NMR ground truth
    # (config.PHANTOM_GT_LF) within the phantom noise level; T2-11 (41 ms)
    # sits at the noise floor for TEs [114, 202, 299]
    assert len(roi) == 9
    assert roi["meanT2"].notna().all()
    rel = (roi["meanT2"] - roi["trueT2"]).abs() / roi["trueT2"]
    identifiable = roi["trueT2"] >= 50
    assert identifiable.sum() == 8
    assert (rel[identifiable] < 0.10).all(), f"sphere T2 off ground truth:\n{roi}"
    assert (rel[~identifiable] < 0.25).all(), f"noise-floor sphere:\n{roi}"
    assert (roi.loc[identifiable, "stdT2"] / roi.loc[identifiable, "meanT2"] < 0.25).all()
    _assert_real_figure(str(tmp_path / "port" / "phantom_decay_fits.png"))
    _assert_real_figure(str(tmp_path / "port" / "phantom_t2map.png"))

    # the reference example on the same seed; compared on the spheres the
    # data determine (ROADMAP.md's bands hold on identifiable voxels): at
    # T2-11's noise floor two solvers stop in different places of a flat
    # valley (40.3 ms here, 35.0 in the reference), both inside its 25%
    ref = _load_example("invitro_phantom").main(str(tmp_path / "ref"))
    assert list(ref["id"]) == list(roi["id"])
    np.testing.assert_allclose(roi["meanT2"][identifiable], ref["meanT2"][identifiable],
                               rtol=1e-2)


def test_multichip_example():
    stats = multichip.main(devices=["cpu"] * 8)
    assert stats["n_devices"] == 8
    f = stats["fit"]
    assert f["bitwise"] and f["max_shard_vs_single_rel"] == 0
    assert f["max_rel_t2_err_vs_truth"] < 1e-3      # noiseless decays
    assert f["overflow"] == 0
    r = stats["registration"]
    assert r["rot_err_rad"] < 0.01 and r["trans_err_mm"] < 0.5
    assert stats["unet"]["label_agreement"] == 1.0


def test_profile_unet_example_table():
    out = profile_unet.main(16, reps=2, device="cpu")
    names = [r["name"] for r in out["rows"]]
    assert names and any("conv" in n for n in names)
    assert out["wall_ms"] > 0 and out["op_ms"] > 0
    assert abs(sum(r["share"] for r in out["rows"]) - 1.0) < 1e-9
    with pytest.raises(ValueError, match="impl must be one of"):
        profile_unet.main(16, reps=1, impl="pallas", device="cpu")


_NO_FIGURES = """
import json, sys
from fetal_t2mapping_tpu_torch.examples import invitro_phantom, invivo_analysis
roi = invitro_phantom.main(sys.argv[1] + "/invitro", device="cpu", figures=False)
df = invivo_analysis.main(sys.argv[1] + "/invivo", device="cpu", figures=False)
print(json.dumps({"matplotlib": sorted(m for m in sys.modules if m.startswith("matplotlib")),
                  "spheres": len(roi), "rows": len(df)}))
"""


def test_examples_without_figures_import_no_matplotlib(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _NO_FIGURES, str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"matplotlib": [], "spheres": 9, "rows": 78}
    assert not list((tmp_path / "invitro").glob("*.png"))


@pytest.mark.parametrize("name", ["serving", "multichip", "invitro_phantom",
                                  "invivo_analysis", "profile_unet"])
def test_example_runs_as_a_module(name):
    """``python -m fetal_t2mapping_tpu_torch.examples.<name> --help``: each
    script parses its arguments under ``__main__`` (importing runs nothing)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", f"fetal_t2mapping_tpu_torch.examples.{name}",
                          "--help"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage:")
