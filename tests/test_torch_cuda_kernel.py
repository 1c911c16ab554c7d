"""The CUDA kernels against their plain PyTorch versions, on the card.

Runs only where ``torch.cuda.is_available()`` (marker ``cuda``): on the
H100, ``python3 -m pytest --noconftest tests/test_torch_cuda_kernel.py``
(the root conftest imports jax, which a GPU host need not have). The fit
kernels are built with -fmad=false and follow the plain version op for op,
and both use the card's IEEE division and accurate expf/logf, so they are
expected to agree to the last bit; the bench.py:638-652 bands are the gate
(3-parameter fits: k and T2 1e-2, objective 3e-2, convergence 0.01), and
the split kernels (gr_varpro's head and tail, the continuation's sweep and
tail, and the gaussian fit's) are held to it bitwise, also on a permuted
input and a second call. The S2D conv kernel sums in another order than its
plain version: fp32 within 1e-5 of scale (TF32 off), bf16 within one ulp
of the element on >= 99.9% of elements and within two ulps of the output's
largest magnitude everywhere.
"""

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu_torch import build
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


LO3, HI3, GUESS = (1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0)


def _assert_bands3(out_k, out_p, ident):
    (xk, sk), (xp, sp) = out_k, out_p
    xk, xp = xk.cpu().numpy(), xp.cpu().numpy()
    assert (np.abs(xk - xp) / np.maximum(np.abs(xp), 1.0))[:2][:, ident].max() <= 1e-2
    fk, fp = sk[0].cpu().numpy(), sp[0].cpu().numpy()
    assert (np.abs(fk - fp) / np.maximum(np.abs(fp), 1.0))[ident].max() <= 3e-2
    assert abs(sk[1].mean().item() - sp[1].mean().item()) <= 0.01


@pytest.mark.parametrize("tes", [TES3, TES6])
def test_gr_varpro_kernel_matches_plain_version(card, tes):
    sig, ident = _make_data(1 << 16, tes)
    s = torch.from_numpy(sig).to(card)
    kw = dict(max_iters=60, ftol=1e-2, gtol=1e-2, full_budget=False, stall_iters=3,
              stall_tol=1e-2)
    before = fused_fit.GR_VARPRO_LAUNCHES
    out_k = fused_fit._gr_varpro_fit_cuda(s, tes, LO3, HI3, GUESS, **kw)
    torch.cuda.synchronize()
    assert fused_fit.GR_VARPRO_LAUNCHES == before + 1
    _assert_bands3(out_k, fused_fit._gr_varpro_fit_plain(s, tes, LO3, HI3, GUESS, **kw), ident)


@pytest.mark.parametrize("model", ["gaussian_rician", "rician"])
@pytest.mark.parametrize("tes", [TES3, TES6])
def test_fit3_kernels_match_plain_versions(card, model, tes):
    sig, ident = _make_data(1 << 16, tes)
    s = torch.from_numpy(sig).to(card)
    lo = LO3[:2] + (max(LO3[2], 1e-2),)
    kw = dict(ftol=1e-2, gtol=1e-2, stall_tol=1e-2)
    before = (fused_fit.FIT3_LAUNCHES, fused_fit.FIT3_CONT_LAUNCHES)
    pre_k = fused_fit._fit3_cuda(s, model, tes, lo, HI3, GUESS, max_iters=4, **kw)
    cont_k = fused_fit._fit3_cont_cuda(s, model, tes, lo, HI3, GUESS, *pre_k, max_iters=56, **kw)
    torch.cuda.synchronize()
    assert (fused_fit.FIT3_LAUNCHES, fused_fit.FIT3_CONT_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _assert_bands3(pre_k, fused_fit._fit3_plain(s, model, tes, lo, HI3, GUESS, max_iters=4, **kw),
                   ident)
    _assert_bands3(cont_k, fused_fit._fit3_cont_plain(s, model, tes, lo, HI3, GUESS, *pre_k,
                                                      max_iters=56, **kw), ident)


def _bitwise(out_k, out_p):
    a, b = torch.cat(out_k), torch.cat(out_p)
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _edge_rows(sig):
    """The NaN, zero and saturated rows of the host tests, at the front."""
    sig = sig.copy()
    sig[0] = np.nan
    sig[1, 1] = np.nan
    sig[2] = 0.0
    sig[3] = 1e6
    sig[4] = 1e20
    return sig


_GAUSS_KW = dict(max_iters=60, ftol=1e-2, gtol=1e-2, no_prior=False, full_budget=False,
                 stall_iters=3, stall_tol=1e-2)
_GR_KW = dict(max_iters=60, ftol=1e-2, gtol=1e-2, full_budget=False, stall_iters=3,
              stall_tol=1e-2)
_CONT_KW = dict(ftol=1e-2, gtol=1e-2, stall_tol=1e-2)


@pytest.mark.parametrize("n", [1, 33, 4099])
@pytest.mark.parametrize("case", ["bench", "no_tail", "largest_tail"])
def test_gauss_head_and_tail_are_bitwise_the_plain_version(card, case, n):
    """The gaussian fit's head kernel, the worklist and the tail against the
    plain version, bitwise: at the bench's tolerances (no_prior at 4099
    voxels); with no voxel in the tail (a budget the head runs in full);
    with the largest tail the stop rules allow (ftol = gtol = stall_tol = 0)."""
    sig, _ = _make_data(n, TES3, seed=6)
    s = torch.from_numpy(_edge_rows(sig) if n > 5 else sig).to(card)
    kw = dict(_GAUSS_KW, no_prior=n > 1000)
    if case == "no_tail":
        kw["max_iters"] = build.load_lib("gauss_fit").ft2_gauss_head_iters()
    elif case == "largest_tail":
        kw.update(ftol=0.0, gtol=0.0, stall_tol=0.0)
    out_k = fused_fit._gauss_fit_cuda(s, TES3, LO, HI, **kw)
    torch.cuda.synchronize()
    out_p = fused_fit._gauss_fit_plain(s, TES3, LO, HI, **kw)
    assert _bitwise(tuple(t.float() for t in out_k), tuple(t.float() for t in out_p))


@pytest.mark.parametrize("n", [1, 33, 4099])
@pytest.mark.parametrize("case", ["bench", "no_tail", "largest_tail"])
def test_gr_varpro_head_and_tail_are_bitwise_the_plain_version(card, case, n):
    """The head kernel, the worklist and the tail against the plain version,
    bitwise: at the bench's tolerances; with no voxel in the tail (a budget
    the head runs in full); with the largest tail the stop rules allow
    (ftol = gtol = stall_tol = 0)."""
    sig, _ = _make_data(n, TES3, seed=7)
    s = torch.from_numpy(_edge_rows(sig) if n > 5 else sig).to(card)
    kw = dict(_GR_KW)
    if case == "no_tail":
        kw["max_iters"] = 1
    elif case == "largest_tail":
        kw.update(ftol=0.0, gtol=0.0, stall_tol=0.0)
    out_k = fused_fit._gr_varpro_fit_cuda(s, TES3, LO3, HI3, GUESS, **kw)
    torch.cuda.synchronize()
    assert _bitwise(out_k, fused_fit._gr_varpro_fit_plain(s, TES3, LO3, HI3, GUESS, **kw))


@pytest.mark.parametrize("n", [1, 33, 4099])
@pytest.mark.parametrize("case", ["bench", "no_tail", "largest_tail"])
@pytest.mark.parametrize("model", ["gaussian_rician", "rician"])
def test_fit3_cont_sweep_and_tail_are_bitwise_the_plain_version(card, model, case, n):
    """The continuation's sweep, worklist and tail against the plain
    version, bitwise, from the kernel's own 4-iteration prefix: as is;
    with every voxel entering converged (no tail); with every voxel
    entering unconverged (the largest tail)."""
    sig, _ = _make_data(n, TES3, seed=8)
    s = torch.from_numpy(_edge_rows(sig) if n > 5 else sig).to(card)
    lo = LO3[:2] + (max(LO3[2], 1e-2),)
    x0, st0 = fused_fit._fit3_cuda(s, model, TES3, lo, HI3, GUESS, max_iters=4, **_CONT_KW)
    if case != "bench":
        st0 = st0.clone()
        st0[1] = 1.0 if case == "no_tail" else 0.0
    out_k = fused_fit._fit3_cont_cuda(s, model, TES3, lo, HI3, GUESS, x0, st0, max_iters=56,
                                      **_CONT_KW)
    torch.cuda.synchronize()
    assert _bitwise(out_k, fused_fit._fit3_cont_plain(s, model, TES3, lo, HI3, GUESS, x0, st0,
                                                      max_iters=56, **_CONT_KW))


@pytest.mark.parametrize("kernel", ["gauss", "gr_varpro", "fit3_cont"])
def test_split_kernels_give_permuted_bits_and_repeat(card, kernel):
    """A permuted input gives the permuted output bitwise (no result depends
    on which lane or slot a voxel takes), and two calls in a row give the
    same bits."""
    sig, _ = _make_data(1 << 16, TES3, seed=9)
    s = torch.from_numpy(_edge_rows(sig)).to(card)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(s.shape[0])).to(card)
    if kernel == "gauss":
        def run(sig_, *_):
            return torch.stack([t.float() for t in fused_fit._gauss_fit_cuda(
                sig_, TES3, LO, HI, **_GAUSS_KW)])
        starts = ()
    elif kernel == "gr_varpro":
        def run(sig_, *_):
            return torch.cat(fused_fit._gr_varpro_fit_cuda(sig_, TES3, LO3, HI3, GUESS, **_GR_KW))
        starts = ()
    else:
        lo = LO3[:2] + (max(LO3[2], 1e-2),)
        starts = fused_fit._fit3_cuda(s, "rician", TES3, lo, HI3, GUESS, max_iters=4, **_CONT_KW)

        def run(sig_, x0, st0):
            return torch.cat(fused_fit._fit3_cont_cuda(sig_, "rician", TES3, lo, HI3, GUESS, x0,
                                                       st0, max_iters=56, **_CONT_KW))
    first = run(s, *starts)
    again = run(s, *starts)
    permuted = run(s[perm].contiguous(), *(t[:, perm].contiguous() for t in starts))
    torch.cuda.synchronize()
    assert _bitwise((first,), (again,))
    assert _bitwise((permuted,), (first[:, perm],))


def test_kernel_rsqrt_is_torch_rsqrt(card):
    lib = build.load_lib("gr_varpro_fit")
    x = torch.logspace(-6, 30, 1 << 20, device=card)
    a, b = torch.empty_like(x), torch.empty_like(x)
    assert lib.ft2_rsqrt_probe(x.data_ptr(), x.numel(), a.data_ptr(), b.data_ptr(),
                               torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(a, torch.rsqrt(x))


@pytest.mark.parametrize("model,counter", [("gaussian_rician", "GR_VARPRO_LAUNCHES"),
                                           ("rician", "FIT3_CONT_LAUNCHES")])
def test_fit_fused_3param_on_cuda_uses_the_kernels(card, model, counter):
    sig, _ = _make_data(5000, TES3, seed=1)
    before = getattr(fused_fit, counter)
    r = fused_fit.fit_fused(sig, TES3, LO3, HI3, model=model, guess=GUESS, ftol=1e-2, gtol=1e-2)
    assert getattr(fused_fit, counter) == before + 1
    assert r.x.device.type == "cuda" and r.x.shape == (5000, 3)
    assert torch.isfinite(r.x).all() and r.n_overflow == 0


# ------------------------------------------------ the S2D conv (conv_s2d.cu)
@pytest.fixture
def no_tf32(card):
    """fp32 comparisons on the card run in full fp32: cuBLAS and cuDNN
    both with TF32 off."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield card
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _conv_inputs(q, c, c_out, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(tuple(v + 1 for v in q) + (c,), generator=g)
    w = torch.randn(8 * c, c_out, generator=g) * (1.0 / (8 * c) ** 0.5)
    b = torch.randn(c_out, generator=g) * 0.1
    res = torch.randn(tuple(q) + (c_out,), generator=g)
    return x.to(dev), w.to(dev), b.to(dev), res.to(dev)


def _bf16_ulps(a, b):
    def order(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (order(a) - order(b)).abs()


@pytest.mark.parametrize("q,c,c_out", [((80, 80, 80), 192, 192), ((17, 23, 29), 24, 40),
                                       ((5, 7, 9), 64, 192), ((4, 9, 20), 72, 64),
                                       ((3, 5, 17), 16, 200)])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_s2d_kernel_matches_plain_version(no_tf32, q, c, c_out, with_res, dtype):
    from fetal_t2mapping_tpu_torch.labels import conv_s2d

    x, w, b, res = _conv_inputs(q, c, c_out, no_tf32)
    res = res if with_res else None
    before = conv_s2d.CONV_S2D_LAUNCHES
    got = conv_s2d.conv_s2d(x, w, b, res, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert conv_s2d.CONV_S2D_LAUNCHES == before + 1
    want = conv_s2d._conv_s2d_plain(x, w, b, res, compute_dtype=dtype)
    assert got.dtype == dtype and got.shape == want.shape == tuple(q) + (c_out,)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() / want.abs().max().item() <= 1e-5
    else:
        # an output near 0 can differ by thousands of its own ulps through
        # the order of the fp32 sums alone: the two-ulp bound is taken at
        # the output's largest magnitude
        assert (_bf16_ulps(got, want) <= 1).float().mean().item() >= 0.999
        scale = want.float().abs().max().item()
        scale_ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert (got.float() - want.float()).abs().max().item() <= 2 * scale_ulp


def test_segment_volume_kernel_path_on_cuda(no_tf32):
    """The full topology at 32^3: three conv_s2d launches per forward, and
    the fp32 kernel program agrees with the fp32 dense program."""
    from fetal_t2mapping_tpu_torch.labels import conv_s2d, unet3d

    cfg = unet3d.UNetConfig(batch_norm=True)
    params = unet3d.random_params(cfg, seed=0)
    vol = np.random.default_rng(0).uniform(0, 1000, (32, 32, 32)).astype(np.float32)
    before = conv_s2d.CONV_S2D_LAUNCHES
    lab = unet3d.segment_volume(params, vol, use_s2d="kernel", compute_dtype=torch.float32)
    assert conv_s2d.CONV_S2D_LAUNCHES == before + 3
    dense = unet3d.segment_volume(params, vol, use_s2d=False, compute_dtype=torch.float32)
    assert (lab == dense).mean() >= 0.999
    lab16 = unet3d.segment_volume(params, vol, use_s2d="kernel")
    assert conv_s2d.CONV_S2D_LAUNCHES == before + 6
    assert (lab16 == dense).mean() >= 0.97
