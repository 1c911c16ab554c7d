"""The port's SynthSeg U-Net (``fetal_t2mapping_tpu_torch.labels.unet3d``)
against the JAX package's on the same numpy inputs, on the CPU.

The host transforms are copies and must agree exactly; so must the S2D
rearranges. Forwards run in fp32 and must agree within the reference's own
S2D-vs-dense band (max |d| / max |ref| < 1e-4, tests/test_unet3d.py:138):
only the order of fp32 sums differs. The reference's Pallas S2D conv runs in
interpret mode, as its own tests run it; the port's ``conv_impl="kernel"``
takes the kernel's plain version on a CPU tensor.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fetal_t2mapping_tpu.labels import unet3d as ref
from fetal_t2mapping_tpu_torch.labels import conv_s2d, unet3d
from fetal_t2mapping_tpu_torch.utils.profiling import profiler

torch.set_num_threads(1)

# the small configs of tests/test_unet3d.py:121-126, then the full topology
CONFIGS = [
    (dict(n_levels=3, base_features=4, n_labels=5), (1, 16, 12, 20, 1)),
    (dict(n_levels=2, base_features=3, n_labels=4), (2, 8, 10, 6, 1)),
    (dict(n_levels=2, base_features=2, n_labels=3, n_conv_per_level=3), (1, 8, 8, 8, 1)),
    (dict(), (1, 16, 16, 16, 1)),
]
CASES = [pytest.param(kw, shape, bn, id=f"{'full' if not kw else kw['n_levels']}-"
                      f"{shape[0]}x{shape[1]}-bn{int(bn)}")
         for kw, shape in CONFIGS for bn in (False, True)]


def _cfgs(kw, bn):
    return ref.UNetConfig(batch_norm=bn, **kw), unet3d.UNetConfig(batch_norm=bn, **kw)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-6))


@pytest.mark.parametrize("kw", [dict(), dict(n_levels=3, base_features=4, n_labels=7),
                                dict(n_levels=2, n_conv_per_level=3, kernel=1)])
@pytest.mark.parametrize("bn", [False, True])
def test_host_params_equal_reference(kw, bn):
    rcfg, cfg = _cfgs(kw, bn)
    assert unet3d._conv_shapes(cfg) == ref._conv_shapes(rcfg)
    assert unet3d._bn_shapes(cfg) == ref._bn_shapes(rcfg)
    assert cfg.divisor == rcfg.divisor
    for seed in (0, 3):
        got, want = unet3d.random_params(cfg, seed), ref.random_params(rcfg, seed)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    params = ref.random_params(rcfg, 1)
    assert (dataclasses.asdict(unet3d.config_from_params(params))
            == dataclasses.asdict(ref.config_from_params(params)))
    unet3d.validate_params(params, cfg)


def test_load_params_roundtrip(tmp_path):
    params = ref.random_params(ref.UNetConfig(n_levels=2, base_features=2, batch_norm=True), 4)
    path = str(tmp_path / "w.npz")
    np.savez(path, **params)
    got, want = unet3d.load_params(path), ref.load_params(path)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("mutate,match", [
    (lambda p: p.pop("enc0_0_b"), "missing"),
    (lambda p: p.update(extra_w=np.zeros(1, np.float32)), "extra"),
    (lambda p: p.update(head_b=np.zeros(2, np.float32)), "head_b: shape"),
    (lambda p: p.pop("bn_up0_s"), "missing"),
])
def test_validate_params_errors_equal_reference(mutate, match):
    kw = dict(n_levels=2, base_features=2, n_labels=3, batch_norm=True)
    params = ref.random_params(ref.UNetConfig(**kw), 0)
    mutate(params)
    with pytest.raises(ValueError) as want:
        ref.validate_params(params, ref.UNetConfig(**kw))
    with pytest.raises(ValueError, match=match) as got:
        unet3d.validate_params(params, unet3d.UNetConfig(**kw))
    assert str(got.value) == str(want.value)


def test_config_from_params_rejects_a_headless_tree():
    with pytest.raises(ValueError, match="lacks"):
        unet3d.config_from_params({"enc0_0_w": np.zeros((3, 3, 3, 1, 2))})


def test_s2d_weight_transforms_equal_reference():
    rng = np.random.default_rng(0)
    for ci, co in ((1, 4), (3, 5), (24, 24)):
        w = rng.normal(0, 1, (3, 3, 3, ci, co)).astype(np.float32)
        np.testing.assert_array_equal(unet3d._s2d_kernel(w), ref._s2d_kernel(w))
        np.testing.assert_array_equal(unet3d._fold_upsample_kernel(w),
                                      ref._fold_upsample_kernel(w))
    np.testing.assert_array_equal(unet3d._UP_FOLD, ref._UP_FOLD)
    with pytest.raises(ValueError, match="3\\^3"):
        unet3d._s2d_kernel(np.zeros((2, 2, 2, 3, 3), np.float32))


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("kw", [dict(n_levels=3, base_features=4, n_labels=5),
                                dict(n_levels=2, base_features=2, n_labels=3,
                                     n_conv_per_level=3)])
def test_s2d_level0_params_equal_reference(kw, bn):
    rcfg, cfg = _cfgs(kw, bn)
    params = ref.random_params(rcfg, 2)
    got, want = unet3d.s2d_level0_params(params, cfg), ref.s2d_level0_params(params, rcfg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # on the device: packed S2D matrices (pack_taps), folded upsample as a
    # conv3d weight, fp32 vectors
    t = unet3d.to_torch_s2d_params(got, device="cpu")
    for k, v in want.items():
        if k == "dec0_0_up_w":
            np.testing.assert_array_equal(t[k].permute(2, 3, 4, 1, 0).numpy(), v)
        elif k.endswith("_w"):
            assert t[k].shape == (8 * v.shape[3], v.shape[4])
            np.testing.assert_array_equal(t[k].numpy(), v.reshape(-1, v.shape[-1]))
        else:
            assert t[k].dtype == torch.float32
            np.testing.assert_array_equal(t[k].numpy(), v)


def test_to_torch_params_layout():
    params = ref.random_params(ref.UNetConfig(n_levels=2, base_features=2, batch_norm=True), 0)
    t = unet3d.to_torch_params(params, device="cpu", dtype=torch.bfloat16)
    for k, v in params.items():
        if k.endswith("_w"):
            assert t[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(t[k].float().permute(2, 3, 4, 1, 0).numpy(),
                                          torch.from_numpy(v).bfloat16().float().numpy())
        else:
            assert t[k].dtype == torch.float32
            np.testing.assert_array_equal(t[k].numpy(), v)


def test_pad_to_divisor_equals_reference():
    d = np.arange(5 * 6 * 7, dtype=np.float32).reshape(5, 6, 7)
    for div in (1, 4, 16):
        got, want = unet3d.pad_to_divisor(d, div), ref.pad_to_divisor(d, div)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize("shape", [(1, 8, 12, 6, 3), (2, 4, 4, 10, 1)])
def test_s2d_rearranges_equal_reference(shape):
    x = np.random.default_rng(7).normal(0, 1, shape).astype(np.float32)
    inform = unet3d._s2d_in(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(inform, np.asarray(ref._s2d_in(jnp.asarray(x))))
    n, d, h, w, c = shape
    y = np.random.default_rng(8).normal(0, 1, (n, d // 2, h // 2, w // 2, 8 * c)).astype(np.float32)
    np.testing.assert_array_equal(unet3d._s2d_regrid(torch.from_numpy(y)).numpy(),
                                  np.asarray(ref._s2d_regrid(jnp.asarray(y))))
    # the out-form maxpool is a max over the 8 slots (unet3d.py:483)
    want = np.asarray(jnp.asarray(y).reshape(n, d // 2, h // 2, w // 2, 8, c).max(axis=4))
    np.testing.assert_array_equal(unet3d._slot_maxpool(torch.from_numpy(y), c).numpy(), want)


def test_dense_blocks_equal_reference():
    x = np.random.default_rng(9).normal(0, 1, (1, 6, 4, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(unet3d._maxpool2(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref._maxpool2(jnp.asarray(x))))
    np.testing.assert_array_equal(unet3d._upsample2(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref._upsample2(jnp.asarray(x))))
    w = np.random.default_rng(10).normal(0, 0.3, (3, 3, 3, 3, 5)).astype(np.float32)
    b = np.random.default_rng(11).normal(0, 0.1, 5).astype(np.float32)
    got = unet3d._conv(torch.from_numpy(x), unet3d._conv_weight(w, "cpu", torch.float32),
                       torch.from_numpy(b)).numpy()
    want = np.asarray(ref._conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    assert _rel(got, want) < 1e-5


def _forward_inputs(kw, shape, bn, seed=1):
    rcfg, cfg = _cfgs(kw, bn)
    params = ref.random_params(rcfg, seed=seed)
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    return rcfg, cfg, params, pj, x


@pytest.mark.parametrize("kw,shape,bn", CASES)
def test_unet_apply_logits_match_reference(kw, shape, bn):
    rcfg, cfg, params, pj, x = _forward_inputs(kw, shape, bn)
    want = np.asarray(ref.unet_apply(pj, jnp.asarray(x), rcfg, jnp.float32))
    got = unet3d.unet_apply(unet3d.to_torch_params(params, device="cpu"), torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("kw,shape,bn", CASES)
def test_unet_apply_s2d_matches_reference_pallas(kw, shape, bn):
    """Both of the port's S2D programs against the reference's
    unet_apply_s2d(conv_impl='pallas') (Pallas interpret), on one volume."""
    shape = (1,) + shape[1:]
    rcfg, cfg, params, pj, x = _forward_inputs(kw, shape, bn)
    s2d_j = {k: jnp.asarray(v) for k, v in ref.s2d_level0_params(params, rcfg).items()}
    want = np.asarray(ref.unet_apply_s2d(pj, s2d_j, jnp.asarray(x), rcfg, jnp.float32,
                                         return_logits=True, conv_impl="pallas"))
    tp = unet3d.to_torch_params(params, device="cpu")
    ts = unet3d.to_torch_s2d_params(unet3d.s2d_level0_params(params, cfg), device="cpu")
    before = profiler.counter("conv_s2d.launches")
    for impl in ("torch", "kernel"):
        got = unet3d.unet_apply_s2d(tp, ts, torch.from_numpy(x), cfg, torch.float32,
                                    return_logits=True, conv_impl=impl).numpy()
        assert _rel(got, want) < 1e-4, impl
        cls = unet3d.unet_apply_s2d(tp, ts, torch.from_numpy(x), cfg, torch.float32,
                                    conv_impl=impl)
        assert cls.shape == shape[:4]
        np.testing.assert_array_equal(cls.numpy(), got.argmax(-1))
    assert profiler.counter("conv_s2d.launches") == before       # plain versions on the CPU


@pytest.mark.parametrize("port_s2d,ref_s2d", [(False, False), (True, True),
                                              ("kernel", "pallas")])
def test_segment_volume_labels_match_reference(port_s2d, ref_s2d):
    kw = dict(n_levels=3, base_features=4, n_labels=7, batch_norm=True)
    params = ref.random_params(ref.UNetConfig(**kw), seed=1)
    vol = np.abs(np.random.default_rng(2).normal(300, 120, (23, 20, 26))).astype(np.float32)
    want = ref.segment_volume(params, vol, ref.UNetConfig(**kw), use_s2d=ref_s2d)
    got = unet3d.segment_volume(params, vol, unet3d.UNetConfig(**kw), use_s2d=port_s2d,
                                device="cpu")
    assert got.dtype == np.int16 and got.shape == vol.shape
    np.testing.assert_array_equal(got, want)


def test_segment_volume_infers_cfg_and_synthseg_labels():
    cfg = unet3d.UNetConfig(n_levels=2, base_features=2, batch_norm=True)
    params = unet3d.random_params(cfg, seed=5)
    vol = np.abs(np.random.default_rng(5).normal(300, 120, (9, 13, 11))).astype(np.float32)
    got = unet3d.segment_volume(params, vol, device="cpu")
    want = ref.segment_volume(params, vol)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= set(unet3d.SYNTHSEG_LABELS)
    assert unet3d.SYNTHSEG_LABELS == ref.SYNTHSEG_LABELS


def test_bf16_path_agrees_with_fp32_labels():
    """tests/test_unet3d.py:215-235 for the port: bf16 operands, fp32 sums."""
    cfg = unet3d.UNetConfig(n_levels=3, n_conv_per_level=2, base_features=4, n_labels=5)
    tp32 = unet3d.to_torch_params(unet3d.random_params(cfg, seed=3), device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 16, 16, 16, 1))
                         .astype(np.float32))
    lg32 = unet3d.unet_apply(tp32, x, cfg, torch.float32).numpy()
    lg16 = unet3d.unet_apply(tp32, x, cfg, torch.bfloat16)
    assert lg16.dtype == torch.float32
    lg16 = lg16.numpy()
    assert np.abs(lg16 - lg32).max() / max(float(np.std(lg32)), 1e-6) < 0.1
    assert (lg16.argmax(-1) == lg32.argmax(-1)).mean() > 0.97


@pytest.mark.parametrize("env,use", [("kernel", "kernel"), ("pallas", "kernel"),
                                     ("1", True), ("xla", True), ("", False), ("0", False)])
def test_env_selects_the_program(monkeypatch, env, use):
    monkeypatch.setenv("FT2_UNET_S2D", env)
    assert unet3d._resolve_use_s2d(None) == use
    cfg = unet3d.UNetConfig(n_levels=2, base_features=2, n_labels=3)
    params = unet3d.random_params(cfg, seed=3)
    vol = np.abs(np.random.default_rng(3).normal(200, 80, (8, 8, 8))).astype(np.float32)
    np.testing.assert_array_equal(
        unet3d.segment_volume(params, vol, cfg, device="cpu"),
        unet3d.segment_volume(params, vol, cfg, use_s2d=use, device="cpu"))


def test_segment_volume_rejects_bad_s2d_requests():
    cfg = unet3d.UNetConfig(n_levels=1, base_features=2, n_labels=3)
    params = unet3d.random_params(cfg, seed=0)
    for use in (True, "kernel"):
        with pytest.raises(ValueError, match="use_s2d"):
            unet3d.segment_volume(params, np.ones((4, 4, 4), np.float32), cfg,
                                  use_s2d=use, device="cpu")
    with pytest.raises(ValueError, match="use_s2d must be"):
        unet3d.segment_volume(params, np.ones((4, 4, 4), np.float32), cfg,
                              use_s2d="xla", device="cpu")


def test_unet_apply_s2d_argument_errors():
    cfg = unet3d.UNetConfig(n_levels=2, base_features=2, n_labels=3)
    params = unet3d.random_params(cfg, seed=0)
    tp = unet3d.to_torch_params(params, device="cpu")
    ts = unet3d.to_torch_s2d_params(unet3d.s2d_level0_params(params, cfg), device="cpu")
    x = torch.zeros((2, 8, 8, 8, 1))
    with pytest.raises(ValueError, match="single volume"):
        unet3d.unet_apply_s2d(tp, ts, x, cfg, conv_impl="kernel")
    with pytest.raises(ValueError, match="conv_impl"):
        unet3d.unet_apply_s2d(tp, ts, x, cfg, conv_impl="pallas")
    with pytest.raises(ValueError, match="n_levels"):
        unet3d.unet_apply_s2d(tp, ts, x, unet3d.UNetConfig(n_levels=1))


def test_weights_converted_once_per_tree():
    cfg = unet3d.UNetConfig(n_levels=2, base_features=2, n_labels=3)
    params = unet3d.random_params(cfg, seed=9)
    dev = torch.device("cpu")
    a = unet3d._params_cached(params, cfg, dev, torch.float32, True)
    assert unet3d._params_cached(params, cfg, dev, torch.float32, True) is a
    assert a[1] is not None
    assert unet3d._params_cached(params, cfg, dev, torch.float32, False)[1] is None
    other = unet3d.random_params(cfg, seed=10)
    assert unet3d._params_cached(other, cfg, dev, torch.float32, True) is not a
