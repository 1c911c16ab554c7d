"""The port's analysis layer (ROI reductions, CoV / Wilcoxon / Pearson
statistics, figure writers, background noise) against the JAX package's,
on the same seeded inputs: the cases of tests/test_analysis.py on the
port, and the ROI tables equal to the reference's.

ROI tables: counts exact; the per-label moments of roi_stats_per_label are
float64 sums in the port and float32 segment sums in the reference, so
means and stds are held to 1e-6 relative; the atlas and tissue tables take
mean / median / std with numpy on the same gathered voxels in both
packages, so they are equal.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from fetal_t2mapping_tpu.analysis import noise as ref_noise
from fetal_t2mapping_tpu.analysis import roi as ref_roi
from fetal_t2mapping_tpu.core.stack import EchoStack as RefEchoStack
from fetal_t2mapping_tpu.core.volume import Volume as RefVolume
from fetal_t2mapping_tpu_torch.analysis.figures import (
    cov_boxplot,
    pearson_scatter,
    t2_boxplot,
    tissue_violin,
)
from fetal_t2mapping_tpu_torch.analysis.noise import estimate_background_noise
from fetal_t2mapping_tpu_torch.analysis.roi import (
    FETA_LABELS,
    parse_xml_labels,
    roi_stats_per_label,
    t2_per_atlas_roi,
    t2_per_tissue_feta,
)
from fetal_t2mapping_tpu_torch.analysis.stats import (
    coefficient_of_variation,
    cov_by_group,
    pairwise_repeatability,
    paired_wilcoxon,
    pearson_regression,
)
from fetal_t2mapping_tpu_torch.core.stack import EchoStack
from fetal_t2mapping_tpu_torch.core.volume import Volume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(shape=(16, 16, 16), n_atlas=12, seed=4):
    """A T2 map, FeTA tissue labels in slabs and an atlas of blocks."""
    rng = np.random.default_rng(seed)
    t2 = rng.uniform(40.0, 400.0, shape).astype(np.float32)
    z = np.arange(shape[0])[:, None, None] * np.ones(shape, int)
    feta = np.clip((z * 8) // shape[0], 0, 7).astype(np.int16)
    feta[rng.random(shape) < 0.1] = 0
    atlas = rng.integers(0, n_atlas + 1, size=(shape[0] // 4, shape[1] // 4, shape[2] // 4))
    atlas = np.kron(atlas, np.ones((4, 4, 4), int)).astype(np.int16)
    labels = [{"index": i, "name": f"roi_{i}"} for i in range(1, n_atlas + 1)]
    return t2, feta, atlas, labels


class TestRoiStats:
    def test_segment_reduction_matches_numpy(self):
        rng = np.random.default_rng(0)
        labels = rng.integers(0, 5, size=(8, 8, 8))
        values = rng.normal(100, 20, size=(8, 8, 8)).astype(np.float32)
        df = roi_stats_per_label(values, labels, n_labels=5, device="cpu")
        for lab in range(1, 5):
            sel = labels == lab
            np.testing.assert_allclose(df.loc[lab, "mean"], values[sel].mean(), rtol=1e-5)
            np.testing.assert_allclose(df.loc[lab, "std"], values[sel].std(), rtol=1e-4)
            assert df.loc[lab, "n"] == sel.sum()
        ref = ref_roi.roi_stats_per_label(values, labels, n_labels=5)
        assert list(df.columns) == list(ref.columns)
        np.testing.assert_array_equal(df["n"], ref["n"])
        np.testing.assert_allclose(df["mean"][1:], ref["mean"][1:], rtol=1e-6)
        np.testing.assert_allclose(df["std"][1:], ref["std"][1:], rtol=1e-5)

    def test_atlas_roi_intersection_and_erosion(self):
        shape = (10, 12, 12)
        t2 = np.full(shape, 80.0, np.float32)
        feta = np.zeros(shape, np.int16)
        feta[2:8, 2:10, 2:10] = 2  # GM
        atlas = np.zeros(shape, np.int16)
        atlas[2:8, 2:10, 2:6] = 1
        atlas[2:8, 2:10, 6:10] = 2
        labels = [{"index": 1, "name": "roi_a"}, {"index": 2, "name": "roi_b"}]
        df = t2_per_atlas_roi(t2, feta, atlas, labels, tissue_class=2, erode=True, device="cpu")
        assert list(df["roi"]) == ["roi_a", "roi_b"]
        raw = ((feta == 2) & (atlas == 1)).sum()
        assert 0 < df.loc[0, "nvoxel"] < raw
        np.testing.assert_allclose(df["mean"].dropna(), 80.0)
        pd.testing.assert_frame_equal(
            df, ref_roi.t2_per_atlas_roi(t2, feta, atlas, labels, tissue_class=2, erode=True))

    def test_feta_label_table(self):
        names = {l["index"]: l["name"] for l in FETA_LABELS}
        assert names[2] == "gm" and names[3] == "wm" and names[7] == "bs"
        assert FETA_LABELS == ref_roi.FETA_LABELS


@pytest.mark.parametrize("mask", [False, True])
def test_roi_stats_per_label_matches_reference(mask):
    t2, feta, atlas, _ = _scene()
    m = (feta > 2) if mask else None
    df = roi_stats_per_label(t2, atlas, mask=m, device="cpu")
    ref = ref_roi.roi_stats_per_label(t2, atlas, mask=m)
    np.testing.assert_array_equal(df["label"], ref["label"])
    np.testing.assert_array_equal(df["n"], ref["n"])
    ok = ref["n"].to_numpy() > 0
    np.testing.assert_allclose(df["mean"][ok], ref["mean"][ok], rtol=1e-6)
    np.testing.assert_allclose(df["std"][ok], ref["std"][ok], rtol=1e-5)
    assert df["mean"][~ok].isna().all() and ref["mean"][~ok].isna().all()


@pytest.mark.parametrize("tissue_class,erode", [(2, True), (3, True), (5, False)])
def test_t2_per_atlas_roi_matches_reference(tissue_class, erode):
    t2, feta, atlas, labels = _scene()
    df = t2_per_atlas_roi(t2, feta, atlas, labels, tissue_class=tissue_class, erode=erode,
                          device="cpu")
    ref = ref_roi.t2_per_atlas_roi(t2, feta, atlas, labels, tissue_class=tissue_class,
                                   erode=erode)
    pd.testing.assert_frame_equal(df, ref)


@pytest.mark.parametrize("erode,gt", [(True, None), (False, {"gm": 120.0, "wm": 90.0})])
def test_t2_per_tissue_feta_matches_reference(erode, gt):
    t2, feta, _, _ = _scene()
    df = t2_per_tissue_feta(t2, feta, erode=erode, gt=gt, device="cpu")
    ref = ref_roi.t2_per_tissue_feta(t2, feta, erode=erode, gt=gt)
    pd.testing.assert_frame_equal(df, ref)


def test_parse_xml_labels_matches_reference(tmp_path):
    xml = tmp_path / "atlas.xml"
    xml.write_text("<atlas><data><label index='0'>Left A</label>"
                   "<label index='1'> Right B </label><label index='7'></label></data></atlas>")
    assert parse_xml_labels(str(xml)) == ref_roi.parse_xml_labels(str(xml))
    assert parse_xml_labels(str(xml))[1] == {"index": 2, "name": "Right B"}


def test_background_noise_matches_reference():
    rng = np.random.default_rng(6)
    sig = np.abs(rng.normal(0, 5.0, (10, 10, 10, 3))).astype(np.float32)
    mask = np.zeros((10, 10, 10), bool)
    mask[3:7, 3:7, 3:7] = True
    tes = np.asarray([114.0, 202.0, 299.0], np.float32)
    out = estimate_background_noise(EchoStack(sig, mask, tes, Volume(sig[..., 0])))
    ref = ref_noise.estimate_background_noise(RefEchoStack(sig, mask, tes, RefVolume(sig[..., 0])))
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(out[key], np.asarray(ref[key]))
    with pytest.raises(ValueError, match="background"):
        estimate_background_noise(EchoStack(sig, np.ones_like(mask), tes, Volume(sig[..., 0])))


class TestStats:
    def test_cov(self):
        assert coefficient_of_variation([100, 100, 100]) == 0.0
        v = coefficient_of_variation([90, 110])
        np.testing.assert_allclose(v, 100 * np.std([90, 110]) / 100.0)

    def test_cov_by_group(self):
        df = pd.DataFrame({
            "sub": ["s1"] * 4 + ["s2"] * 4,
            "ses": ["a", "b"] * 4,
            "roi": ["r1", "r1", "r2", "r2"] * 2,
            "mean": [100, 110, 50, 55, 200, 180, 70, 77],
        })
        out = cov_by_group(df, within=["sub"])
        assert set(out["roi"]) == {"r1", "r2"}
        assert (out["n_repeats"] == 2).all()

    def test_pearson_and_wilcoxon(self):
        rng = np.random.default_rng(1)
        x = rng.uniform(50, 150, 30)
        y = 1.1 * x + rng.normal(0, 2, 30)
        reg = pearson_regression(x, y)
        assert reg["r"] > 0.99 and abs(reg["slope"] - 1.1) < 0.05
        w = paired_wilcoxon(x, y)
        assert w["n"] == 30 and np.isfinite(w["pvalue"])

    def test_pairwise_repeatability(self):
        df = pd.DataFrame({
            "sub": ["s1"] * 6,
            "ses": ["a", "a", "b", "b", "c", "c"],
            "roi": ["r1", "r2"] * 3,
            "mean": [1, 2, 3, 4, 5, 6],
        })
        pairs = pairwise_repeatability(df, unit_cols=("sub",))
        assert len(pairs) == 6
        row = pairs[(pairs.rep_a == "a") & (pairs.rep_b == "b") & (pairs.roi == "r1")].iloc[0]
        assert row.value_a == 1 and row.value_b == 3


class TestFigures:
    def test_figure_writers(self, tmp_path):
        rng = np.random.default_rng(2)
        p1 = cov_boxplot({"inter-run": rng.uniform(1, 5, 10),
                          "inter-ses": rng.uniform(2, 7, 10)},
                         str(tmp_path / "cov.png"))
        p2 = pearson_scatter(rng.uniform(50, 150, 20), rng.uniform(50, 150, 20),
                             str(tmp_path / "pearson.png"))
        df = pd.DataFrame({"tissue": ["wm"] * 5 + ["gm"] * 5,
                           "mean": rng.uniform(60, 120, 10),
                           "roi": list("abcde") * 2})
        p3 = tissue_violin(df, str(tmp_path / "violin.png"))
        p4 = t2_boxplot(df, str(tmp_path / "box.png"))
        for p in (p1, p2, p3, p4):
            assert os.path.exists(p) and os.path.getsize(p) > 0


class TestMapAndCurveFigures:
    def test_map_montage(self, tmp_path):
        from fetal_t2mapping_tpu_torch.analysis.figures import map_montage

        rng = np.random.default_rng(3)
        data = rng.uniform(50, 600, (12, 16, 16)).astype(np.float32)
        mask = np.zeros(data.shape, bool)
        mask[:, 4:12, 4:12] = True
        p = map_montage(data, str(tmp_path / "montage.png"), n_slices=3, mask=mask, title="t2")
        assert os.path.exists(p) and os.path.getsize(p) > 0

    def test_relaxation_curves_r2_exact_fit(self, tmp_path):
        from fetal_t2mapping_tpu_torch.analysis.figures import relaxation_curves

        tes = np.array([114.0, 202.0, 299.0])
        k, t2 = 1200.0, 150.0
        means = k * np.exp(-tes / t2)
        p = relaxation_curves(tes, {"wm": means}, str(tmp_path / "curves.png"),
                              fits={"wm": (k, t2)}, roi_stds={"wm": 0.05 * means},
                              gt={"wm": 150.0})
        assert os.path.exists(p) and os.path.getsize(p) > 0


def test_analysis_imports_without_matplotlib():
    """Importing the analysis package (figures included) pulls in no
    matplotlib: the card's machine has none, and only drawing needs it."""
    probe = ("import sys; import fetal_t2mapping_tpu_torch.analysis, "
             "fetal_t2mapping_tpu_torch.analysis.figures; "
             "print(any(m == 'matplotlib' or m.startswith('matplotlib.') for m in sys.modules))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"
