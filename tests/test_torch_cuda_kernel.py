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
input and a second call, and so are both fit3 entries given a row list (at
2 to 8 echoes; an empty list writes only unfitted rows). The S2D conv
kernel sums in another order than its plain version: fp32 within 1e-5 of
scale (TF32 off), bf16 within one ulp of the element on >= 99.9% of
elements and within two ulps of the output's largest magnitude
everywhere. Stage 2 has no hand kernel: its torch ops on
the card are held against the CPU (interp values and coordinate gradients
1e-5 of scale, nearest equal; TV per slice to the CPU iterate at the card's
stop or one either side; morphology equal; a short registration's params
1e-4 of max(1, |p|) with the same plateau stops). The serving wrapper
``fit_volume`` on the card: each layout launches the model's kernels and
gives the bits of ``fit_fused`` on the masked voxels alone. N4: two card
runs bitwise, the card within the CPU tests' tolerances of the CPU. ROI
tables: the card's equal the CPU's. The I/O layer: a CUDA volume queued by
``nifti.write_async`` from a side stream is read back from the cache and,
after the flush, from the file, equal to what the stream computed. The voxel mesh on one card
(``voxel_mesh(devices=[cuda, cuda])``, two shards on two streams): each
shard allocates its worklist on its own stream, so repeated sharded fits
(the plain fit, 'twophase', and one read on the caller's stream without a
sync) give the bits of the single-device fit; the sharded U-Net and
registration run there too.
"""

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu_torch import build
from fetal_t2mapping_tpu_torch.models import fused_fit
from fetal_t2mapping_tpu_torch.utils.profiling import profiler

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
    before = profiler.counter("gauss_fit.launches")
    out_k = fused_fit._gauss_fit_cuda(s, tes, LO, HI, **kw)
    torch.cuda.synchronize()
    assert profiler.counter("gauss_fit.launches") == before + 1
    out_p = fused_fit._gauss_fit_plain(s, tes, LO, HI, **kw)
    assert profiler.counter("gauss_fit.launches") == before + 1
    x_k = torch.stack(out_k[:2]).cpu().numpy()
    x_p = torch.stack(out_p[:2]).cpu().numpy()
    assert (np.abs(x_k - x_p) / np.maximum(np.abs(x_p), 1.0))[:, ident].max() <= 1e-3
    f_k, f_p = out_k[2].cpu().numpy(), out_p[2].cpu().numpy()
    assert (np.abs(f_k - f_p) / np.maximum(np.abs(f_p), 1.0))[ident].max() <= 1e-2
    assert abs(out_k[3].float().mean().item() - out_p[3].float().mean().item()) <= 0.01


def test_fit_fused_on_cuda_uses_the_kernel(card):
    sig, _ = _make_data(5000, TES3, seed=1)
    before = profiler.counter("gauss_fit.launches")
    r = fused_fit.fit_fused(sig, TES3, LO, HI)
    assert profiler.counter("gauss_fit.launches") == before + 1
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
    before = profiler.counter("gr_varpro_fit.launches")
    out_k = fused_fit._gr_varpro_fit_cuda(s, tes, LO3, HI3, GUESS, **kw)
    torch.cuda.synchronize()
    assert profiler.counter("gr_varpro_fit.launches") == before + 1
    _assert_bands3(out_k, fused_fit._gr_varpro_fit_plain(s, tes, LO3, HI3, GUESS, **kw), ident)


@pytest.mark.parametrize("model", ["gaussian_rician", "rician"])
@pytest.mark.parametrize("tes", [TES3, TES6])
def test_fit3_kernels_match_plain_versions(card, model, tes):
    sig, ident = _make_data(1 << 16, tes)
    s = torch.from_numpy(sig).to(card)
    lo = LO3[:2] + (max(LO3[2], 1e-2),)
    kw = dict(ftol=1e-2, gtol=1e-2, stall_tol=1e-2)
    before = (profiler.counter("fit3.launches"), profiler.counter("fit3_cont.launches"))
    pre_k = fused_fit._fit3_cuda(s, model, tes, lo, HI3, GUESS, max_iters=4, **kw)
    cont_k = fused_fit._fit3_cont_cuda(s, model, tes, lo, HI3, GUESS, *pre_k, max_iters=56, **kw)
    torch.cuda.synchronize()
    assert (profiler.counter("fit3.launches"),
            profiler.counter("fit3_cont.launches")) == (before[0] + 1, before[1] + 1)
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


def _listed(n: int, count: int, dev):
    """A row list of ``count`` of n rows: the edge rows first, then rows
    drawn without repeats; entries past the count are -1 (never read)."""
    rest = np.random.default_rng(count).permutation(np.arange(5, n))[:max(count - 5, 0)]
    rows = np.full(n, -1, np.int32)
    rows[:count] = np.concatenate([np.arange(min(count, 5)), rest])[:count]
    listed = np.zeros(n, bool)
    listed[rows[:count]] = True
    return ((torch.from_numpy(rows).to(dev), torch.tensor(count, dtype=torch.int32, device=dev)),
            torch.from_numpy(listed).to(dev))


@pytest.mark.parametrize("t", range(2, 9))
@pytest.mark.parametrize("model", ["gaussian_rician", "rician"])
def test_fit3_entries_with_a_row_list_are_the_plain_versions(card, model, t):
    """Both fit3 C entries given a row list (1001 of 4099 rows: not a
    multiple of 32), at 2 to 8 echoes: bitwise their plain versions, which
    equal the launch without the list on the listed rows and are 0
    elsewhere; the continuation run in place over the prefix's outputs
    gives the same bits."""
    tes = tuple(float(v) for v in np.linspace(90.0, 330.0, t))
    sig, _ = _make_data(4099, tes, seed=t)
    s = torch.from_numpy(_edge_rows(sig)).to(card)
    lo = LO3[:2] + (max(LO3[2], 1e-2),)
    row_list, listed = _listed(4099, 1001, card)
    pre_k = fused_fit._fit3_cuda(s, model, tes, lo, HI3, GUESS, max_iters=4, row_list=row_list,
                                 **_CONT_KW)
    cont_k = fused_fit._fit3_cont_cuda(s, model, tes, lo, HI3, GUESS, *pre_k, max_iters=56,
                                       row_list=row_list, **_CONT_KW)
    pre_p = fused_fit._fit3_plain(s, model, tes, lo, HI3, GUESS, max_iters=4,
                                  row_list=row_list, **_CONT_KW)
    cont_p = fused_fit._fit3_cont_plain(s, model, tes, lo, HI3, GUESS, *pre_k, max_iters=56,
                                        row_list=row_list, **_CONT_KW)
    full = fused_fit._fit3_cuda(s, model, tes, lo, HI3, GUESS, max_iters=4, **_CONT_KW)
    over = tuple(t.clone() for t in pre_k)
    cont_i = fused_fit._fit3_cont_cuda(s, model, tes, lo, HI3, GUESS, *over, max_iters=56,
                                       row_list=row_list, in_place=True, **_CONT_KW)
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(cont_i, over))
    assert _bitwise(pre_k, pre_p) and _bitwise(cont_k, cont_p) and _bitwise(cont_i, cont_k)
    assert _bitwise(tuple(o[:, listed] for o in pre_k), tuple(o[:, listed] for o in full))
    assert not any(bool(o[:, ~listed].any()) for o in pre_k + cont_k)


@pytest.mark.parametrize("model", ["gaussian_rician", "rician"])
def test_fit3_entries_with_an_empty_row_list_write_unfitted_rows(card, model):
    sig, _ = _make_data(4099, TES3, seed=3)
    s = torch.from_numpy(sig).to(card)
    lo = LO3[:2] + (max(LO3[2], 1e-2),)
    row_list, _ = _listed(4099, 0, card)
    x0 = torch.full((3, 4099), float("nan"), device=card)
    pre = fused_fit._fit3_cuda(s, model, TES3, lo, HI3, GUESS, max_iters=4, row_list=row_list,
                               **_CONT_KW)
    cont = fused_fit._fit3_cont_cuda(s, model, TES3, lo, HI3, GUESS, x0, x0, max_iters=56,
                                     row_list=row_list, **_CONT_KW)
    torch.cuda.synchronize()
    assert not any(bool(o.any()) for o in pre + cont)


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


@pytest.mark.parametrize("model,counter", [("gaussian_rician", "gr_varpro_fit.launches"),
                                           ("rician", "fit3_cont.launches")])
def test_fit_fused_3param_on_cuda_uses_the_kernels(card, model, counter):
    sig, _ = _make_data(5000, TES3, seed=1)
    before = profiler.counter(counter)
    r = fused_fit.fit_fused(sig, TES3, LO3, HI3, model=model, guess=GUESS, ftol=1e-2, gtol=1e-2)
    assert profiler.counter(counter) == before + 1
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
    before = profiler.counter("conv_s2d.launches")
    got = conv_s2d.conv_s2d(x, w, b, res, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert profiler.counter("conv_s2d.launches") == before + 1
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
    before = profiler.counter("conv_s2d.launches")
    lab = unet3d.segment_volume(params, vol, use_s2d="kernel", compute_dtype=torch.float32)
    assert profiler.counter("conv_s2d.launches") == before + 3
    dense = unet3d.segment_volume(params, vol, use_s2d=False, compute_dtype=torch.float32)
    assert (lab == dense).mean() >= 0.999
    lab16 = unet3d.segment_volume(params, vol, use_s2d="kernel")
    assert profiler.counter("conv_s2d.launches") == before + 6
    assert (lab16 == dense).mean() >= 0.97


# ------------------------------------------------ stage 2 on the card
# (plain torch ops, no hand kernel: the card against the CPU, at the
# tolerances the CPU tests hold the port to against the JAX package)
def _cavity_mask(shape, seed):
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    m = np.zeros(shape, bool)
    for _ in range(5):
        c = rng.uniform(0.25, 0.75, 3) * np.asarray(shape)
        r = rng.uniform(2.5, 5.0)
        d = np.sqrt((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
        m |= (d <= r) & (d >= r - 1.2)
    return m | (rng.random(shape) > 0.9)


def test_interp_values_and_gradient_on_cuda(card):
    from fetal_t2mapping_tpu_torch.ops import interp

    rng = np.random.default_rng(0)
    vol = torch.from_numpy(rng.uniform(0, 100, (40, 44, 48)).astype(np.float32))
    coords = torch.from_numpy(rng.uniform(-1.5, 49.5, (1 << 16, 3)).astype(np.float32))
    out = {}
    for dev in ("cpu", card):
        c = coords.to(dev, copy=True).requires_grad_(True)
        v = interp.sample_trilinear(vol.to(dev), c, cval=float("nan"))
        torch.where(torch.isnan(v), 0.0, v).square().sum().backward()
        out[str(dev)] = (v.detach().cpu(), c.grad.cpu(),
                         interp.sample_nearest(vol.to(dev), coords.to(dev)).cpu())
    (v0, g0, n0), (v1, g1, n1) = out.values()
    assert torch.equal(torch.isnan(v0), torch.isnan(v1))
    fin = ~torch.isnan(v0)
    assert (v1[fin] - v0[fin]).abs().max() <= 1e-5 * v0[fin].abs().max()
    assert (g1 - g0).abs().max() <= 1e-5 * g0.abs().max()
    assert torch.equal(n0, n1)


def test_tv_slices_stop_on_their_own_on_cuda(card):
    """Each slice of the card's result is the CPU iterate at the card's stop
    for that slice, or one iteration either side, to 1e-5 of the scale; the
    slices stop at different iterations."""
    from fetal_t2mapping_tpu_torch.ops import tv

    rng = np.random.default_rng(10)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, 32)] * 3, indexing="ij")
    clean = 0.3 * (np.sqrt(z ** 2 + y ** 2 + x ** 2) < 0.7) + 1.0
    vol = torch.from_numpy((clean + rng.normal(0, 1.0, clean.shape)
                            * np.geomspace(0.01, 1.0, 32)[:, None, None]).astype(np.float32))
    got = tv.tv_denoise_slices(vol.to(card)).cpu()
    scale = got.abs().max()
    stops = []
    for s in range(vol.shape[0]):
        x1 = vol[s:s + 1].to(card)
        full = tv._tv2d(x1, 0.1, 2e-4, 200)
        lo, hi = 1, 200
        while lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if torch.equal(tv._tv2d(x1, 0.1, 2e-4, mid), full) else (mid + 1, hi)
        stops.append(lo)
        its = [tv._tv2d(vol[s:s + 1], 0.1, 0.0, n)[0] for n in (lo - 1, lo, lo + 1) if n >= 1]
        assert min((u - got[s]).abs().max() for u in its) <= 1e-5 * scale, s
    assert len(set(stops)) >= 4 and max(stops) < 200, stops


@pytest.mark.parametrize("shape", [(48, 52, 56), (60, 64, 1)])
def test_morphology_exact_on_cuda(card, shape):
    from fetal_t2mapping_tpu_torch.ops import morphology

    m = torch.from_numpy(_cavity_mask(shape, seed=7))
    assert torch.equal(morphology.fill_holes(m.to(card)).cpu(), morphology.fill_holes(m))
    img = torch.where(m, 80.0, 0.5)
    assert torch.equal(morphology.build_slice_mask(img.to(card)).cpu(),
                       morphology.build_slice_mask(img))
    if shape[2] > 1:
        for fn, r, box in (("binary_dilate", 4, False), ("binary_erode", 2, False),
                           ("binary_closing", 5, True)):
            f = getattr(morphology, fn)
            assert torch.equal(f(m.to(card), r, box=box).cpu(), f(m, r, box=box)), fn


def test_short_registration_on_cuda(card):
    """Rigid ncc at REG_FAST-like levels, fixed budget and plateau exit:
    the card's solve against the CPU's, to 1e-4 of max(1, |p|)."""
    from fetal_t2mapping_tpu_torch.core.volume import Volume
    from fetal_t2mapping_tpu_torch.recon import registration, resample

    rng = np.random.default_rng(3)
    zz, yy, xx = np.meshgrid(*[np.arange(36)] * 3, indexing="ij")
    data = np.zeros((36,) * 3, np.float32)
    for _ in range(8):
        c, s = rng.uniform(8, 28, 3), rng.uniform(2, 4)
        data += rng.uniform(0.5, 1.5) * np.exp(
            -((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) / (2 * s * s))
    fixed = Volume(data.astype(np.float32), spacing=(1.5, 1.5, 1.5))
    T = np.eye(4)
    T[:3, 3] = [2.0, -1.5, 1.0]
    moving = resample.resample_to_reference(fixed, fixed, transform=T, device="cpu")
    for stop, iters in ((None, (8, 4)), (1e-3, (80, 40))):
        kw = dict(levels=(2, 1), sigmas=(1.0, 0.0), iters=iters, samples=(512, 4096),
                  stop_tol=stop)
        a = registration.register_rigid(fixed, moving, device="cpu", **kw)
        b = registration.register_rigid(fixed, moving, device=card, **kw)
        assert b.params_device.device.type == "cuda"
        err = np.abs(a.params - b.params).max() / max(1.0, np.abs(a.params).max())
        assert err <= 1e-4, (stop, a.params, b.params)
        if stop is not None:
            assert np.array_equal(a.iters_run, b.iters_run)


def _serving_volume(n, seed):
    rng = np.random.default_rng(seed)
    shape = (n, n, n)
    k = rng.uniform(600.0, 5000.0, shape).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, shape).astype(np.float32)
    sig = k[..., None] * np.exp(-np.asarray(TES3, np.float32) / t2[..., None])
    sig = np.maximum(sig + rng.normal(0, 8.0, sig.shape), 1e-2).astype(np.float32)
    ax = (np.arange(n, dtype=np.float32) - (n - 1) / 2) / (n / 2)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    return sig, (zz / 0.75) ** 2 + (yy / 0.85) ** 2 + (xx / 0.65) ** 2 <= 1.0


@pytest.mark.parametrize("model,lo,hi,guess,counters", [
    ("gaussian", LO, HI, None, ("gauss_fit.launches",)),
    ("gaussian_rician", (1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0),
     ("gr_varpro_fit.launches",)),
    ("rician", (1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0),
     ("fit3.launches", "fit3_cont.launches"))])
def test_fit_volume_on_cuda_is_fit_fused_on_the_gathered_voxels(card, model, lo, hi, guess,
                                                                counters):
    """fit_volume on the card, with a buffer over every block, at
    mask_frac and voxel-exact, launches the model's kernels and gives the
    bits of fit_fused on the masked voxels alone."""
    from fetal_t2mapping_tpu_torch.models import fit_volume

    sig, mask = _serving_volume(40, seed=8)
    s, m = torch.from_numpy(sig).to(card), torch.from_numpy(mask).to(card)
    kw = dict(model=model, guess=guess, device=card)
    before = {name: profiler.counter(name) for name in counters}
    layouts = [fit_volume(s, m, TES3, lo, hi, compact=False, **kw),
               fit_volume(s, m, TES3, lo, hi, compact=True, mask_frac=0.6, **kw),
               fit_volume(s, m, TES3, lo, hi, compact=True, mask_frac=0.6, block=1, **kw)]
    torch.cuda.synchronize()
    for name in counters:
        assert profiler.counter(name) - before[name] == 3, name
    ref = fused_fit.fit_fused(s.reshape(-1, 3)[m.reshape(-1)], TES3, lo, hi, **kw)
    sigma = ref.x[:, 2] if ref.x.shape[1] == 3 else torch.zeros_like(ref.fun)
    for res in layouts:
        assert res.t2.device.type == "cuda" and int(res.n_overflow) == 0
        assert int(res.n_masked) == int(mask.sum())
        for got, want in ((res.t2, ref.x[:, 1]), (res.k, ref.x[:, 0]), (res.sigma, sigma),
                          (res.fun, ref.fun), (res.converged, ref.converged),
                          (res.n_iter, ref.n_iter)):
            assert torch.equal(got[m], want)
            assert not got[~m].any()


@pytest.mark.parametrize("model,lo,hi,guess,counters", [
    ("gaussian", LO, HI, None, ("gauss_fit.launches",)),
    ("rician", (1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0),
     ("fit3.launches", "fit3_cont.launches"))])
def test_fit_volume_over_a_two_stream_mesh_is_the_single_call(card, model, lo, hi, guess,
                                                              counters):
    """fit_volume(mesh=) on two streams of one card: at each capacity and
    block size the maps and counts are the single-device call's bits, one
    launch per shard."""
    from fetal_t2mapping_tpu_torch.models import fit_volume
    from fetal_t2mapping_tpu_torch.parallel import voxel_mesh

    sig, mask = _serving_volume(40, seed=9)
    s, m = torch.from_numpy(sig).to(card), torch.from_numpy(mask).to(card)
    mesh = voxel_mesh(devices=[card, card])
    for lay in (dict(compact=False), dict(compact=True, mask_frac=0.6),
                dict(compact=True, mask_frac=0.6, block=1)):
        kw = dict(model=model, guess=guess, **lay)
        one = fit_volume(s, m, TES3, lo, hi, device=card, **kw)
        before = {name: profiler.counter(name) for name in counters}
        two = fit_volume(s, m, TES3, lo, hi, mesh=mesh, **kw)
        torch.cuda.synchronize()
        for name in counters:
            assert profiler.counter(name) - before[name] == 2, name
        for f in one._fields:
            assert torch.equal(getattr(one, f), getattr(two, f)), (lay, f)


def _n4_scene(n, seed=0):
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n)] * 3, indexing="ij")
    tissue = np.where(np.sqrt(z**2 + y**2 + x**2) < 0.6, 1000.0, 600.0)
    tissue = tissue * (1 + 0.02 * rng.standard_normal(tissue.shape))
    field = np.exp(0.6 * (0.7 * z + 0.5 * y * y - 0.3 * x))
    mask = np.sqrt(z**2 + y**2 + x**2) < 0.95
    return np.where(mask, tissue * field, 0.0).astype(np.float32), mask


def test_n4_on_cuda_repeats_bitwise_and_matches_cpu(card):
    """Two card runs give the same bits (the histogram is summed exactly);
    the card is within the CPU tests' 1e-4 of the CPU on the mask, and
    |mean| / std of each update within 5e-3 (tests/test_torch_biasfield.py)."""
    from fetal_t2mapping_tpu_torch.core.volume import Volume
    from fetal_t2mapping_tpu_torch.recon.biasfield import n4_bias_correction

    img, mask = _n4_scene(48)
    vol = Volume(img, spacing=(128 / 48,) * 3)
    mvol = Volume(mask.astype(np.uint8), spacing=(128 / 48,) * 3)
    for kw in (dict(), dict(n_iters=20, ctrl_spacing_mm=(200.0, 100.0, 50.0))):
        a = n4_bias_correction(vol, mvol, device=card, **kw)
        b = n4_bias_correction(vol, mvol, device=card, **kw)
        c = n4_bias_correction(vol, mvol, device="cpu", **kw)
        assert np.array_equal(a.corrected.data, b.corrected.data)
        assert np.array_equal(a.field.data, b.field.data)
        assert np.array_equal(a.field_cv, b.field_cv)
        for x, y in ((a.corrected.data, c.corrected.data), (a.field.data, c.field.data)):
            assert np.max(np.abs(x[mask] - y[mask]) / np.abs(y[mask])) <= 1e-4
        assert np.max(np.abs(1 / a.field_cv - 1 / c.field_cv)) <= 5e-3


def test_roi_tables_on_cuda_equal_cpu(card):
    """Atlas and tissue tables: the card's equal the CPU's (exact counts;
    numpy statistics on the same gathered voxels); per-label moments: exact
    counts, float64 means to 1e-12, two card runs bitwise."""
    import pandas as pd

    from fetal_t2mapping_tpu_torch.analysis.roi import (roi_stats_per_label, t2_per_atlas_roi,
                                                        t2_per_tissue_feta)

    rng = np.random.default_rng(12)
    n = 48
    t2 = rng.uniform(40.0, 400.0, (n, n, n)).astype(np.float32)
    feta = rng.integers(0, 8, (n // 4,) * 3).astype(np.int16)
    feta = np.kron(feta, np.ones((4, 4, 4), np.int16))
    atlas = np.kron(rng.integers(0, 21, (n // 8,) * 3).astype(np.int16), np.ones((8, 8, 8), np.int16))
    labels = [{"index": i, "name": f"r{i}"} for i in range(1, 21)]
    for cls in (2, 5):
        pd.testing.assert_frame_equal(t2_per_atlas_roi(t2, feta, atlas, labels, cls, device=card),
                                      t2_per_atlas_roi(t2, feta, atlas, labels, cls, device="cpu"))
    pd.testing.assert_frame_equal(t2_per_tissue_feta(t2, feta, gt={"gm": 100.0}, device=card),
                                  t2_per_tissue_feta(t2, feta, gt={"gm": 100.0}, device="cpu"))
    a = roi_stats_per_label(t2, atlas, device=card)
    b = roi_stats_per_label(t2, atlas, device=card)
    c = roi_stats_per_label(t2, atlas, device="cpu")
    assert a.equals(b)
    assert np.array_equal(a["n"], c["n"])
    ok = c["n"].to_numpy() > 0
    np.testing.assert_allclose(a["mean"][ok], c["mean"][ok], rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_write_async_from_a_side_stream(card, tmp_path, dtype):
    """The producer computes on a side stream and queues the write at once:
    the writer thread waits for the event recorded on that stream before its
    copy, so the file holds the finished values, and the cache serves the
    cast tensor on the card."""
    from fetal_t2mapping_tpu_torch.core import Volume, nifti, volcache

    path = str(tmp_path / "side.nii.gz")
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        x = torch.rand((96, 128, 128), device=card, generator=torch.Generator(card).manual_seed(1))
        for _ in range(20):                      # keep the stream busy past the queueing
            x = torch.sqrt(x * x + 1.0) * 300.0 - 299.0
        nifti.write_async(path, Volume(x), dtype=dtype)
        cached = nifti.read(path).data
    side.synchronize()
    want = nifti._cast_for_disk(x, dtype).cpu().numpy()
    assert cached.is_cuda and np.array_equal(cached.cpu().numpy(), want)
    nifti.flush_writes()
    volcache.clear()
    got = nifti.read(path).data
    assert got.dtype == np.dtype(dtype) and np.array_equal(got, want)


_MESH_FITS = [("gaussian", LO, HI, None),
              ("gaussian_rician", (1.0, 10.0, 1.0), (1e6, 2000.0, 1e3), (650.0, 110.0, 40.0)),
              ("rician", (1.0, 10.0, 1.0), (1e6, 2000.0, 1e3), (650.0, 110.0, 40.0))]


def _same_fit(a, b, keep=None):
    pairs = [(a.x, b.x), (a.fun, b.fun), (a.converged, b.converged), (a.n_iter, b.n_iter)]
    keep = slice(None) if keep is None else keep
    return all(torch.equal(u[keep], v[keep]) for u, v in pairs)


@pytest.mark.parametrize("model,lo,hi,guess", _MESH_FITS)
def test_two_stream_shards_are_the_single_fit(card, model, lo, hi, guess):
    """Two shards on two streams of one card, five times over: the shards'
    worklists and outputs are allocated on their own streams, so no shard
    reuses memory another shard's kernel still uses, and every call gives
    the single-device bits."""
    from fetal_t2mapping_tpu_torch.parallel import fit_fused_sharded, voxel_mesh

    sig, _ = _make_data(1 << 20, TES3, seed=11)
    s = torch.from_numpy(sig).to(card)
    kw = dict(model=model, guess=guess, ftol=1e-2, gtol=1e-2) if guess else dict(model=model)
    mesh = voxel_mesh(devices=[card, card])
    single = fused_fit.fit_fused(s, TES3, lo, hi, device=card, **kw)
    outs = [fit_fused_sharded(s, TES3, lo, hi, mesh, sync=False, **kw) for _ in range(5)]
    for out in outs:
        assert _same_fit(single, out) and out.n_overflow == 0


@pytest.mark.parametrize("model,lo,hi,guess", _MESH_FITS)
def test_twophase_on_two_streams_is_single_on_handled_voxels(card, model, lo, hi, guess):
    """'twophase' with room for every straggler block equals 'single'
    bitwise on the card, on one device and sharded over two streams."""
    from fetal_t2mapping_tpu_torch.parallel import fit_fused_sharded, voxel_mesh

    sig, _ = _make_data(1 << 18, TES3, seed=12)
    s = torch.from_numpy(sig).to(card)
    kw = dict(model=model, guess=guess, ftol=1e-2, gtol=1e-2) if guess else dict(model=model)
    single = fused_fit.fit_fused(s, TES3, lo, hi, device=card, **kw)
    roomy = dict(strategy="twophase", tail_frac=1.0)
    tp = fused_fit.fit_fused(s, TES3, lo, hi, device=card, **roomy, **kw)
    assert _same_fit(single, tp) and int(tp.n_overflow) == 0
    tps = fit_fused_sharded(s, TES3, lo, hi, voxel_mesh(devices=[card, card]), **roomy, **kw)
    assert _same_fit(single, tps) and int(tps.n_overflow) == 0


def test_mesh_unet_and_registration_on_one_card(card):
    """segment_volume(mesh=) (fp32, TF32 off) gives the unsharded labels,
    and register_rigid(mesh=) stays within the reference's 5e-3 / 0.3 mm
    of the single-device solve, on a two-entry mesh of one card."""
    from fetal_t2mapping_tpu_torch.core import Volume
    from fetal_t2mapping_tpu_torch.labels.unet3d import UNetConfig, random_params, segment_volume
    from fetal_t2mapping_tpu_torch.parallel import voxel_mesh
    from fetal_t2mapping_tpu_torch.recon.registration import register_rigid

    mesh = voxel_mesh(devices=[card, card])
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = UNetConfig(n_levels=3, base_features=8, n_labels=7)
        params = random_params(cfg, seed=6)
        data = np.abs(np.random.default_rng(6).normal(500, 120, (48, 40, 36))).astype(np.float32)
        kw = dict(compute_dtype=torch.float32, use_s2d=False)
        single = segment_volume(params, data, cfg, device=card, **kw)
        assert np.array_equal(segment_volume(params, data, cfg, mesh=mesh, **kw), single)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    rng = np.random.default_rng(3)
    z, y, x = np.meshgrid(*[np.arange(40.0)] * 3, indexing="ij")
    img = sum(float(rng.uniform(50, 150)) * np.exp(-((z - c[0]) ** 2 + (y - c[1]) ** 2
                                                   + (x - c[2]) ** 2) / 30.0)
              for c in rng.uniform(8, 32, (12, 3)))
    fixed = Volume(img.astype(np.float32))
    moving = Volume(np.roll(img, (1, -2, 1), axis=(0, 1, 2)).astype(np.float32))
    kw = dict(levels=(2, 1), sigmas=(1.0, 0.0), iters=(80, 40), lr=0.8, stop_tol=None)
    a = register_rigid(fixed, moving, device=card, **kw).matrix
    b = register_rigid(fixed, moving, mesh=mesh, **kw).matrix
    assert np.abs(a[:3, :3] - b[:3, :3]).max() <= 5e-3
    assert np.abs(a[:3, 3] - b[:3, 3]).max() <= 0.3
