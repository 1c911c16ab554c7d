"""The plain version of the port's fused S2D conv (``labels.conv_s2d``)
against the JAX package's Pallas kernel (``labels.pallas_conv.conv_s2d``,
interpret mode) on the same numpy inputs, on the CPU.

fp32: only the order of fp32 sums differs, so the outputs agree within
1e-5 of scale. bf16: both round the operands to bf16, multiply exactly and
sum in fp32, and round the result to bf16 once, so every element is within
one bf16 ulp of the reference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fetal_t2mapping_tpu.labels import pallas_conv as ref
from fetal_t2mapping_tpu.labels.unet3d import _s2d_kernel
from fetal_t2mapping_tpu_torch.labels import conv_s2d, unet3d

torch.set_num_threads(1)


def _inputs(ci=3, co=5, q=(6, 6, 6), seed=0):
    """tests/test_unet3d.py:251-256: an S2D weight of a random 3^3 kernel."""
    rng = np.random.default_rng(seed)
    w2 = _s2d_kernel(rng.normal(0, 0.2, (3, 3, 3, ci, co)).astype(np.float32))
    b = rng.normal(0, 0.1, 8 * co).astype(np.float32)
    x = rng.normal(0, 1, tuple(v + 1 for v in q) + (8 * ci,)).astype(np.float32)
    res = rng.normal(0, 1, tuple(q) + (8 * co,)).astype(np.float32)
    return x, ref.pack_taps(w2), b, res


def _both(x, wp, b, res, act, jdt, tdt):
    want = ref.conv_s2d(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(b),
                        residual=None if res is None else jnp.asarray(res),
                        activation=act, compute_dtype=jdt, interpret=True)
    got = conv_s2d.conv_s2d(torch.from_numpy(x), torch.from_numpy(wp), torch.from_numpy(b),
                            residual=None if res is None else torch.from_numpy(res),
                            activation=act, compute_dtype=tdt)
    return got, want


CASES = [pytest.param(r, a, q, id=f"res{int(r)}-{a}-{'x'.join(map(str, q))}")
         for r in (False, True) for a in ("elu", None) for q in ((6, 6, 6), (3, 5, 4))]


@pytest.mark.parametrize("with_res,act,q", CASES)
def test_plain_matches_pallas_fp32(with_res, act, q):
    x, wp, b, res = _inputs(q=q)
    before = conv_s2d.CONV_S2D_LAUNCHES
    got, want = _both(x, wp, b, res if with_res else None, act, jnp.float32, torch.float32)
    assert conv_s2d.CONV_S2D_LAUNCHES == before
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert np.abs(got.numpy() - want).max() / scale < 1e-5


def _bf16_order(t: torch.Tensor) -> torch.Tensor:
    """bf16 values -> integers in value order (consecutive bf16 values are
    consecutive integers; +0 and -0 are both 0)."""
    bits = t.contiguous().view(torch.int16).to(torch.int32)
    mag = bits & 0x7FFF
    return torch.where(bits < 0, -mag, mag)


@pytest.mark.parametrize("with_res,act,q", CASES)
def test_plain_within_one_bf16_ulp_of_pallas(with_res, act, q):
    x, wp, b, res = _inputs(q=q, seed=1)
    got, want = _both(x, wp, b, res if with_res else None, act, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    ulps = (_bf16_order(got) - _bf16_order(want)).abs()
    assert int(ulps.max()) <= 1


def test_plain_matches_the_torch_s2d_conv():
    """conv_s2d == ELU(unet3d._conv_s2d(x) + residual): the port's kernel
    path and its F.conv3d path compute the same function."""
    x, wp, b, res = _inputs(ci=2, co=4, q=(4, 6, 5), seed=2)
    got = conv_s2d.conv_s2d(torch.from_numpy(x), torch.from_numpy(wp), torch.from_numpy(b),
                            residual=torch.from_numpy(res), compute_dtype=torch.float32)
    pre = unet3d._conv_s2d(torch.from_numpy(x)[None], torch.from_numpy(wp),
                           torch.from_numpy(b)) + torch.from_numpy(res)[None]
    want = torch.nn.functional.elu(pre)[0]
    assert (got - want).abs().max() / want.abs().max() < 1e-5


def test_pack_taps_equals_reference_and_guards_shape():
    w2 = np.random.default_rng(3).normal(0, 1, (2, 2, 2, 6, 4)).astype(np.float32)
    np.testing.assert_array_equal(conv_s2d.pack_taps(w2), ref.pack_taps(w2))
    for bad in (np.zeros((3, 3, 3, 2, 2), np.float32), np.zeros((2, 2, 3, 2, 2))):
        with pytest.raises(ValueError, match="2\\^3") as want:
            ref.pack_taps(bad)
        with pytest.raises(ValueError, match="2\\^3") as got:
            conv_s2d.pack_taps(bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,match", [
    (dict(w_packed=torch.zeros(40, 8)), "w_packed"),
    (dict(bias=torch.zeros(7)), "bias"),
    (dict(residual=torch.zeros(3, 3, 4, 8)), "residual"),
    (dict(x_inform=torch.zeros(4, 4, 32)), "x_inform"),
    (dict(x_inform=torch.zeros(1, 4, 4, 8), w_packed=torch.zeros(64, 8)), "empty"),
    (dict(activation="relu"), "activation"),
])
def test_wrapper_rejects_bad_arguments(kw, match):
    args = dict(x_inform=torch.zeros(4, 4, 4, 8), w_packed=torch.zeros(64, 8),
                bias=torch.zeros(8), residual=None, activation="elu")
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        conv_s2d.conv_s2d(args.pop("x_inform"), args.pop("w_packed"), args.pop("bias"),
                          **args, compute_dtype=torch.float32)


def test_reference_residual_check_matches():
    """The residual-shape check of pallas_conv.py:149-151."""
    x, wp, b, res = _inputs(q=(4, 4, 4))
    with pytest.raises(ValueError, match="residual") as want:
        ref.conv_s2d(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(b),
                     residual=jnp.asarray(res[:3]), interpret=True)
    with pytest.raises(ValueError, match="residual") as got:
        conv_s2d.conv_s2d(torch.from_numpy(x), torch.from_numpy(wp), torch.from_numpy(b),
                          residual=torch.from_numpy(res[:3]))
    assert str(got.value) == str(want.value)


def test_cuda_request_without_a_gpu_raises(monkeypatch):
    """The kernel path asks for the card; without one it raises instead of
    running the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = unet3d.UNetConfig(n_levels=2, base_features=2, n_labels=3)
    params = unet3d.random_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="is_available"):
        unet3d.segment_volume(params, np.ones((8, 8, 8), np.float32), cfg, use_s2d="kernel")


# ------------------------------------------------ the bf16 kernel's host side
def _tile_origin(plan, t):
    """Tile ``t`` -> (n0, z0, y0, x0), as conv_s2d.cu's tile_origin."""
    n0 = (t % plan.tiles_n) * conv_s2d.TILE_N
    t //= plan.tiles_n
    x0 = (t % plan.tiles_x) * conv_s2d.TILE_X
    t //= plan.tiles_x
    return n0, t // plan.tiles_y, (t % plan.tiles_y) * conv_s2d.TILE_Y, x0


@pytest.mark.parametrize("qz,qy,qx,c_out", [(80, 80, 80, 192), (17, 23, 29, 40), (5, 7, 9, 192),
                                            (1, 1, 1, 8), (3, 17, 33, 200)])
def test_tile_plan_covers_every_output_once(qz, qy, qx, c_out):
    """Every (voxel, channel) of the out-form lies in exactly one tile of
    the plan the wrapper hands the kernel, and no tile is empty."""
    plan = conv_s2d.tile_plan(qz, qy, qx, c_out)
    hits = np.zeros((qz, qy, qx, c_out), np.uint8)
    for t in range(plan.total):
        n0, z0, y0, x0 = _tile_origin(plan, t)
        assert n0 < c_out and z0 < qz and y0 < qy and x0 < qx
        hits[z0, y0:y0 + conv_s2d.TILE_Y, x0:x0 + conv_s2d.TILE_X, n0:n0 + conv_s2d.TILE_N] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("c,cp", [(8, 64), (24, 64), (64, 64), (72, 128), (192, 192)])
def test_padded_channels_are_whole_k_chunks(c, cp):
    assert conv_s2d.padded_channels(c) == cp


@pytest.mark.parametrize("c", [64, 24])
def test_kmajor_weight_is_pack_taps_transposed(c):
    """The kernel's K-major copy: row n is output channel n's pack_taps
    column, each tap's C weights then zeros up to the next 64."""
    w2 = np.random.default_rng(c).normal(0, 1, (2, 2, 2, c, 16)).astype(np.float32)
    wp = torch.from_numpy(conv_s2d.pack_taps(w2))
    wk = conv_s2d.kmajor_weight(wp, c)
    cp = conv_s2d.padded_channels(c)
    assert wk.shape == (16, 8 * cp) and wk.dtype == wp.dtype
    taps = wk.reshape(16, 8, cp)
    np.testing.assert_array_equal(taps[:, :, :c].reshape(16, 8 * c).numpy(), wp.t().numpy())
    assert (taps[:, :, c:] == 0).all()
    if c == cp:
        np.testing.assert_array_equal(wk.numpy(), conv_s2d.pack_taps(w2).T)


def test_kmajor_copy_is_cached_per_weight_and_follows_updates():
    w = torch.randn(8 * 24, 40)
    first = conv_s2d._kmajor_cached(w, 24, torch.bfloat16)
    assert conv_s2d._kmajor_cached(w, 24, torch.bfloat16) is first
    assert first.dtype == torch.bfloat16 and first.is_contiguous()
    w.add_(1.0)
    again = conv_s2d._kmajor_cached(w, 24, torch.bfloat16)
    assert again is not first
    assert torch.equal(again, conv_s2d.kmajor_weight(w.bfloat16(), 24))


@pytest.mark.parametrize("c,c_out,dtype,match", [
    (24, 40, torch.float16, "float32 or bfloat16"),
    (12, 40, torch.bfloat16, "multiples of 8"),
    (24, 20, torch.bfloat16, "multiples of 8"),
    (24, 20, torch.float32, "multiples of 8"),
])
def test_kernel_refuses_what_it_cannot_take(c, c_out, dtype, match):
    with pytest.raises(ValueError, match=match):
        conv_s2d.check_kernel_args(c, c_out, dtype)
    conv_s2d.check_kernel_args(192, 192, torch.bfloat16)


def test_tile_constants_match_the_kernel_source():
    """conv_s2d.py's TILE_* are conv_s2d.cu's kTileX, kTileY, kBN, kBK
    (the library's ft2_conv_s2d_geometry checks the same on the card)."""
    import re
    from fetal_t2mapping_tpu_torch import build

    with open(build.KERNEL_SOURCES["conv_s2d"]) as f:
        src = f.read()
    got = tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                for name in ("kTileX", "kTileY", "kBN", "kBK"))
    assert got == (conv_s2d.TILE_X, conv_s2d.TILE_Y, conv_s2d.TILE_N, conv_s2d.TILE_K)


def test_kmajor_copy_of_an_inference_tensor_is_cached():
    """The U-Net uploads its weights under inference mode: such a weight
    has no version counter, and its copy is still made once."""
    with torch.inference_mode():
        w = torch.randn(8 * 24, 40)
    first = conv_s2d._kmajor_cached(w, 24, torch.bfloat16)
    assert conv_s2d._kmajor_cached(w, 24, torch.bfloat16) is first
    assert torch.equal(first, conv_s2d.kmajor_weight(w.bfloat16(), 24))
