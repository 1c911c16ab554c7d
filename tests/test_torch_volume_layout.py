"""The block layout of ``fit_volume`` (``models/volume_fit``): block
compaction into the fit buffer and the scatter back into six maps, around
one block -> slot map.

On the CPU the plain versions (``_compact_plain``, ``_scatter_plain``) are
held bitwise against the layout they replaced, kept here as
``_legacy_compact`` / ``_legacy_scatter``: ``solver._tail_partition``'s
stable sort of the touched flags, gathers, a filler ``where``, a stack of
six float columns, a whole-grid zero and an ``index_copy_``. The buffer
rows, the slot order, every map (dtype, contiguity, bits), ``n_masked``
and ``n_overflow`` must match, on ragged grids, at block 32, 1 and 7, with
a capacity that overflows and one larger than the grid's blocks, at 3 and
4 echoes, and for fits of 2 and 3 parameters. Each benchmark cell's
request, cut to 24^3, gives the maps of the benchmark's reference fit.
The block layout's fit stops at the touched blocks' rows (``fit_fused``'s
live-row bound) and still gives the maps of the legacy layout around an
unbounded fit; a bounded fit keeps the unbounded fit's bits on its live
rows and writes the others unfitted, at no live row, at the capacity and
past it; every single-device 'single' request counts a bounded pass,
``compact=False`` (a buffer over every block) included, and a mesh or
'twophase' none.

On the card (marker ``cuda``; ``python3 -m pytest --noconftest
tests/test_torch_volume_layout.py``) the kernels of
``csrc/volume_layout.cu`` are held bitwise against the plain versions on
the same cases, ``fit_volume`` counts one compaction and one scatter
launch per request (also over a mesh, whose padding rows the
wrapper fills, and with ``compact=False``), and the benchmark cells' 240^3
requests give the plain layout's buffer and maps. Every fit kernel keeps
its bits under a live-row bound, and a cell's request without the
capacity check (no host read) gives the maps of the call with it and of
``compact=False``. This file
imports no JAX.
"""

import functools
import os
import warnings
from math import prod

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu_torch.models import volume_fit
from fetal_t2mapping_tpu_torch.models.fused_fit import fit_fused, validate_fused_args
from fetal_t2mapping_tpu_torch.models.solver import FitResult, _tail_partition
from fetal_t2mapping_tpu_torch.utils.profiling import profiler

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TES = {3: (114.0, 202.0, 299.0), 4: (114.0, 160.0, 202.0, 299.0)}
LO, HI = (0.0, 10.0), (1e6, 2000.0)
LO3, HI3, GUESS3 = (1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0)
MAPS = ("t2", "k", "sigma", "fun", "converged", "n_iter")
COUNTERS = ("volume_layout.compact.launches", "volume_layout.scatter.launches")


def _grid(name: str, t: int = 3, seed: int = 0):
    """(signal (Z, Y, X, T) float32, mask (Z, Y, X) bool) of a named case."""
    rng = np.random.default_rng(seed)
    nz = {"cube16": 16, "ellipsoid16": 16, "ragged15": 15, "scattered12": 12,
          "empty10": 10, "last_voxel15": 15, "full16": 16}[name]
    shape = (nz, nz, nz)
    k = rng.uniform(600.0, 5000.0, shape).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, shape).astype(np.float32)
    sig = k[..., None] * np.exp(-np.asarray(TES[t], np.float32) / t2[..., None])
    sig = np.maximum(sig + rng.normal(0, 8.0, sig.shape), 1e-2).astype(np.float32)
    if name in ("cube16", "ragged15"):
        mask = np.zeros(shape, bool)
        mask[2:nz - 2, 2:nz - 2, 2:nz - 2] = True
    elif name == "ellipsoid16":
        ax = (np.arange(nz, dtype=np.float32) - (nz - 1) / 2) / (nz / 2)
        zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
        mask = (zz / 0.75) ** 2 + (yy / 0.85) ** 2 + (xx / 0.65) ** 2 <= 1.0
    elif name == "scattered12":
        mask = rng.random(shape) < 0.5
    elif name == "last_voxel15":
        mask = np.zeros(shape, bool)
        mask[-1, -1, -1] = True
    else:
        mask = np.full(shape, name == "full16")
    return torch.from_numpy(sig), torch.from_numpy(mask)


# (grid, echoes, block, mask_frac): ragged grids (15^3 = 3375 voxels), a
# block that does not divide 32, capacity under the touched blocks
# (overflow) and over the grid's blocks (slots past the last block)
CASES = {
    "cube16_b32": ("cube16", 3, 32, 0.6),
    "ellipsoid16_b32": ("ellipsoid16", 3, 32, 0.6),
    "ellipsoid16_b1": ("ellipsoid16", 3, 1, 0.3),
    "ragged15_b32_past_the_blocks": ("ragged15", 3, 32, 1.0),
    "ragged15_b1": ("ragged15", 3, 1, 1.0),
    "ragged15_b7_T4": ("ragged15", 4, 7, 0.8),
    "scattered12_b32_T4": ("scattered12", 4, 32, 1.0),
    "scattered12_b32_overflow": ("scattered12", 3, 32, 0.2),
    "full16_b32_overflow": ("full16", 3, 32, 0.1),
    "empty10_b32": ("empty10", 3, 32, 0.5),
    "last_voxel15_b32": ("last_voxel15", 3, 32, 0.05),
}


def _filler(t: int, model: str = "gaussian"):
    lo, hi, guess = (LO, HI, None) if model == "gaussian" else (LO3, HI3, GUESS3)
    te_t, lo_t, hi_t, guess_t = validate_fused_args(model, TES[t], lo, hi, guess, False)
    return volume_fit._filler_values(te_t, lo_t, hi_t, guess_t)


def _legacy_compact(signal, mask, filler, blk_cap, block):
    """The block compaction ``fit_volume`` ran before the slot map (a copy
    of it): (buffer (blk_cap * block, T), bidx, nb_sel, mb)."""
    zyx, t = signal.shape[:3], signal.shape[3]
    n = prod(zyx)
    n_pad = -(-n // block) * block
    nb = n_pad // block
    flat = signal.reshape(n, t)
    sel = mask.reshape(n) > 0
    if n_pad != n:
        flat = torch.nn.functional.pad(flat, (0, 0, 0, n_pad - n), value=1.0)
        sel = torch.nn.functional.pad(sel, (0, n_pad - n))
    bidx, nb_sel = _tail_partition(~sel.reshape(nb, block).any(dim=1), blk_cap)
    batch = flat.reshape(nb, block * t)[bidx].reshape(blk_cap, block, t)
    mb = sel.reshape(nb, block)[bidx]
    buf = torch.empty((blk_cap * block, t), dtype=torch.float32, device=signal.device)
    filler = torch.tensor(filler.tolist(), dtype=torch.float32, device=signal.device)
    torch.where(mb[..., None], batch, filler, out=buf.view(blk_cap, block, t))
    return buf, bidx, nb_sel, mb


def _legacy_scatter(bidx, nb_sel, mb, res: FitResult, mask, block):
    """The scatter ``fit_volume`` ran before the slot map (a copy of it)."""
    zyx = mask.shape
    n = prod(zyx)
    n_pad = -(-n // block) * block
    nb = n_pad // block
    blk_cap = bidx.shape[0]
    rows = blk_cap * block
    dev = mask.device
    x = res.x[:rows]
    sigma = x[:, 2] if x.shape[1] == 3 else torch.zeros_like(x[:, 0])
    t2, k, fun, conv, nit = x[:, 1], x[:, 0], res.fun[:rows], res.converged[:rows], \
        res.n_iter[:rows]
    valid_blk = torch.arange(blk_cap, device=dev) < nb_sel
    keep = mb & valid_blk[:, None]
    upd = torch.stack([t2, k, sigma, fun, conv.to(torch.float32), nit.to(torch.float32)], dim=1)
    upd = torch.where(keep.reshape(-1, 1), upd, 0.0)
    safe_bidx = torch.where(valid_blk, bidx, nb)
    dense = torch.zeros((nb + 1, block * 6), dtype=torch.float32, device=dev)
    dense.index_copy_(0, safe_bidx, upd.reshape(blk_cap, block * 6))
    dense = dense[:nb].reshape(nb, block, 6)

    def chan(c):
        return dense[:, :, c].reshape(n_pad)[:n].reshape(zyx)

    n_masked = (mask.reshape(n) > 0).sum(dtype=torch.int32)
    return volume_fit.VolumeFitResult(
        t2=chan(0), k=chan(1), sigma=chan(2), fun=chan(3), converged=chan(4) > 0.5,
        n_iter=chan(5).to(torch.int32), n_masked=n_masked,
        n_overflow=n_masked - keep.sum(dtype=torch.int32) + res.n_overflow)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want, what=""):
    """Same shape, dtype and bits (NaN payloads and signed zeros included)."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert torch.equal(_bits(got.cpu()), _bits(want.cpu())), what


def _assert_same_result(got, want):
    for name in MAPS:
        _assert_same(getattr(got, name), getattr(want, name), name)
        assert getattr(got, name).is_contiguous(), name
    _assert_same(got.n_masked, want.n_masked, "n_masked")
    _assert_same(got.n_overflow, want.n_overflow, "n_overflow")


def _slot_order(slot: torch.Tensor) -> torch.Tensor:
    """The kept blocks in slot order, from the block -> slot map."""
    kept = torch.nonzero(slot >= 0).reshape(-1)
    return kept[torch.argsort(slot[kept])]


def _layout(case, dev, compact):
    """(signal, mask, filler, blk_cap, block, buffer, slot, counts) of a case
    through ``compact`` (a plain or a kernel compaction)."""
    name, t, block, mask_frac = CASES[case]
    signal, mask = _grid(name, t)
    signal, mask = signal.to(dev), mask.to(dev)
    n = mask.numel()
    blk_cap = volume_fit._block_capacity(n, mask_frac, block)
    filler = _filler(t)
    buf = torch.full((blk_cap * block, t), float("nan"), device=dev)
    slot, counts = compact(signal.reshape(n, t), mask.reshape(n), filler, blk_cap, block, buf)
    return signal, mask, filler, blk_cap, block, buf, slot, counts


def _check_against_legacy(signal, mask, filler, blk_cap, block, buf, slot, counts):
    want_buf, bidx, nb_sel, mb = _legacy_compact(signal, mask, filler, blk_cap, block)
    _assert_same(buf, want_buf, "buffer")
    n_kept = min(int(nb_sel), blk_cap)
    assert torch.equal(_slot_order(slot).cpu(), bidx[:n_kept].cpu())
    assert slot.dtype == torch.int32 and slot.shape == (-(-mask.numel() // block),)
    assert int(counts[0]) == int(nb_sel)
    assert int(counts[1]) == int(mask.sum())
    assert int(counts[2]) == int((mb & (torch.arange(blk_cap, device=mb.device)
                                        < nb_sel)[:, None]).sum())


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_compaction_is_the_legacy_layout(case):
    """The buffer rows, their order (the slot map's) and the counts equal
    the stable-partition layout's, filler and all."""
    _check_against_legacy(*_layout(case, torch.device("cpu"), volume_fit._compact_plain))


def _fit_rows(rows: int, p: int, layout: str, inner, dev, seed=0) -> FitResult:
    """A fit's outputs over ``rows`` buffer rows: random values with signed
    zeros and NaNs in x; x as (rows, P) rows or a (P, rows) buffer's
    transposed view (the 3-parameter kernels' layout)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((p, rows), generator=g) * 300.0
    x[:, ::17] = -0.0
    x[0, ::29] = float("nan")
    x = x.t().contiguous() if layout == "rows" else x.t()
    fun = torch.rand(rows, generator=g)
    conv = torch.rand(rows, generator=g) < 0.7
    nit = torch.randint(0, 61, (rows,), generator=g, dtype=torch.int32)
    if inner == "tensor":
        inner = torch.tensor(5, dtype=torch.int32, device=dev)
    return FitResult(x=x.to(dev), fun=fun.to(dev), converged=conv.to(dev),
                     n_iter=nit.to(dev), n_overflow=inner)


SCATTERS = [(case, p, layout, inner) for case in ("ragged15_b32_past_the_blocks",
                                                  "ragged15_b7_T4", "ellipsoid16_b1",
                                                  "scattered12_b32_overflow")
            for p, layout in ((2, "rows"), (3, "cols")) for inner in (0, "tensor")]


@pytest.mark.parametrize("case,p,layout,inner", SCATTERS)
def test_plain_scatter_is_the_legacy_scatter(case, p, layout, inner):
    """Every map (dtype, contiguity, bits), n_masked and n_overflow equal
    the whole-grid zero + index_copy_ scatter's, from the same fit rows."""
    dev = torch.device("cpu")
    signal, mask, filler, blk_cap, block, buf, slot, counts = _layout(
        case, dev, volume_fit._compact_plain)
    res = _fit_rows(blk_cap * block, p, layout, inner, dev)
    _, bidx, nb_sel, mb = _legacy_compact(signal, mask, filler, blk_cap, block)
    got = volume_fit._scatter_plain(mask.reshape(-1), block, slot, res, counts, mask.shape)
    _assert_same_result(got, _legacy_scatter(bidx, nb_sel, mb, res, mask, block))


@pytest.mark.parametrize("model", ["gaussian", "rician", "gaussian_rician"])
def test_fit_volume_block_layout_is_the_legacy_layout(model):
    """End to end on the CPU: fit_volume's block layout gives the bits of
    the legacy layout around fit_fused on its buffer (gaussian_rician with
    its VARPRO kernel)."""
    signal, mask = _grid("ragged15" if model == "gaussian" else "empty10", 3)
    if model != "gaussian":
        mask = torch.from_numpy(np.random.default_rng(3).random(mask.shape) < 0.3)
    lo, hi, guess = (LO, HI, None) if model == "gaussian" else (LO3, HI3, GUESS3)
    kw = dict(model=model, guess=guess, ftol=1e-9, gtol=0.0, max_iters=30, varpro3=True)
    got = volume_fit.fit_volume(signal, mask, TES[3], lo, hi, compact=True, mask_frac=1.0,
                                device="cpu", **kw)
    n = mask.numel()
    blk_cap = volume_fit._block_capacity(n, 1.0, 32)
    buf, bidx, nb_sel, mb = _legacy_compact(signal, mask, _filler(3, model), blk_cap, 32)
    res = fit_fused(buf, TES[3], lo, hi, device="cpu", **kw)
    _assert_same_result(got, _legacy_scatter(bidx, nb_sel, mb, res, mask, 32))


def test_capacity_warning_comes_before_the_fit(monkeypatch):
    """The touched-block count is read after the compaction and the
    warning given before the fit is launched; n_overflow counts the
    masked voxels left out."""
    signal, mask = _grid("full16", 3)
    seen = []
    fit = volume_fit._fit

    def spy(*args, **kwargs):
        seen.append(len(caught))
        return fit(*args, **kwargs)

    monkeypatch.setattr(volume_fit, "_fit", spy)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = volume_fit.fit_volume(signal, mask, TES[3], LO, HI, max_iters=8, mask_frac=0.1,
                                    device="cpu")
    assert seen == [1] and "left unfitted" in str(caught[0].message)
    blk_cap = volume_fit._block_capacity(mask.numel(), 0.1, 32)
    assert int(res.n_overflow) == mask.numel() - blk_cap * 32
    assert int(res.n_masked) == mask.numel()


ROW_BOUND = "fit_fused.row_bound.launches"

#: fit_fused's keywords per fit: each fit kernel (rician with its prefix,
#: gaussian_rician's VARPRO), the multistart alone, and the one-pass kernels
FITS = {"gaussian": dict(model="gaussian"),
        "gaussian_full": dict(model="gaussian", full_budget=True),
        "gaussian_rician": dict(model="gaussian_rician", guess=GUESS3, varpro3=True),
        "gaussian_rician_full": dict(model="gaussian_rician", guess=GUESS3, varpro3=True,
                                     full_budget=True),
        "rician": dict(model="rician", guess=GUESS3, prefix3=4),
        "rician_unpruned": dict(model="rician", guess=GUESS3, prefix3=0)}


def _box(model):
    return (LO, HI) if model == "gaussian" else (LO3, HI3)


def _fit_kw(model):
    """fit_volume's keywords of a model's serving fit (rician with its
    4-iteration prefix, gaussian_rician with its VARPRO kernel)."""
    return dict(FITS[model], ftol=1e-9, gtol=0.0, max_iters=60)


@pytest.mark.parametrize("model", ["gaussian", "gaussian_rician", "rician"])
def test_block_layout_fits_only_the_touched_blocks(model):
    """The block layout's fit stops at the touched blocks' rows (72 of 128
    slots here: 44% of the capacity is never fitted), and its six maps,
    n_masked and n_overflow are the bits of the legacy layout around the
    unbounded fit of its whole buffer; one bounded fit pass is counted."""
    signal, mask = _grid("ellipsoid16", 3)
    lo, hi = _box(model)
    blk_cap = volume_fit._block_capacity(mask.numel(), 1.0, 32)
    touched = int(mask.reshape(-1, 32).any(dim=1).sum())
    assert touched / blk_cap <= 0.6
    before = profiler.counter(ROW_BOUND)
    got = volume_fit.fit_volume(signal, mask, TES[3], lo, hi, compact=True, mask_frac=1.0,
                                device="cpu", **_fit_kw(model))
    assert profiler.counter(ROW_BOUND) == before + 1
    buf, bidx, nb_sel, mb = _legacy_compact(signal, mask, _filler(3, model), blk_cap, 32)
    res = fit_fused(buf, TES[3], lo, hi, device="cpu", **_fit_kw(model))
    _assert_same_result(got, _legacy_scatter(bidx, nb_sel, mb, res, mask, 32))


@pytest.mark.parametrize("layout", ["dense", "mesh", "twophase"])
def test_other_layouts_fit_every_row(layout):
    """A voxel mesh and 'twophase' count no bounded pass: they fit every
    row. compact=False (a buffer over every block; the case named "dense")
    is the single-device block layout under 'single' and counts one. It
    and the mesh give the bits of the bounded block layout at mask_frac 1.0."""
    from fetal_t2mapping_tpu_torch.parallel import voxel_mesh

    signal, mask = _grid("ellipsoid16", 3)
    kw = dict(compact=layout != "dense", mask_frac=1.0, device="cpu", **_fit_kw("gaussian"))
    if layout == "mesh":
        kw["mesh"] = voxel_mesh(devices=["cpu"] * 2)
    if layout == "twophase":
        kw["strategy"] = "twophase"
    before = profiler.counter(ROW_BOUND)
    got = volume_fit.fit_volume(signal, mask, TES[3], LO, HI, **kw)
    assert profiler.counter(ROW_BOUND) == before + (layout == "dense")
    if layout != "twophase":
        kw.pop("mesh", None)
        kw["compact"] = True
        _assert_same_result(got, volume_fit.fit_volume(signal, mask, TES[3], LO, HI, **kw))
    assert int(got.n_masked) == int(mask.sum())


@functools.lru_cache(maxsize=None)
def _unbounded(fit: str, dev: str, n: int):
    """(signal (n, 3), the unbounded fit_fused result) of a fit."""
    rng = np.random.default_rng(23)
    k = rng.uniform(600.0, 5000.0, n).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, n).astype(np.float32)
    sig = np.maximum(k[:, None] * np.exp(-np.asarray(TES[3], np.float32) / t2[:, None])
                     + rng.normal(0, 8.0, (n, 3)), 1e-2).astype(np.float32)
    signal = torch.from_numpy(sig).to(dev)
    lo, hi = _box(FITS[fit]["model"])
    return signal, fit_fused(signal, TES[3], lo, hi, device=dev, **_fit_kw(fit))


def _check_row_bound(fit: str, dev: str, n: int, count: int, block: int):
    """fit_fused with a live-row bound of ``count`` blocks of ``block``
    rows: the rows before min(count * block, n) carry the unbounded fit's
    bits, the others 0 / False (converged) / 0 (n_iter)."""
    signal, want = _unbounded(fit, dev, n)
    lo, hi = _box(FITS[fit]["model"])
    bound = (torch.tensor(count, dtype=torch.int32, device=dev), block)
    before = profiler.counter(ROW_BOUND)
    got = fit_fused(signal, TES[3], lo, hi, device=dev, _row_bound=bound, **_fit_kw(fit))
    assert profiler.counter(ROW_BOUND) == before + 1
    live = min(count * block, n)
    for name in ("x", "fun", "converged", "n_iter"):
        g, w = getattr(got, name), getattr(want, name)
        _assert_same(g[:live], w[:live], name)
        _assert_same(g[live:], torch.zeros_like(w[live:]), f"{name} past the bound")
    assert got.n_overflow == 0


#: (count, block) over 256 rows: none live, a partial bound, the capacity
#: (8 blocks of 32), a count past it (an overflowing layout: clamped), and
#: a block that does not divide the kernels' thread blocks
BOUNDS = [(0, 32), (3, 32), (8, 32), (13, 32), (5, 7)]


@pytest.mark.parametrize("count,block", BOUNDS)
@pytest.mark.parametrize("fit", sorted(FITS))
def test_fit_fused_row_bound(fit, count, block):
    _check_row_bound(fit, "cpu", 256, count, block)


def test_fit_fused_refuses_a_row_bound_with_twophase():
    signal, _ = _unbounded("gaussian", "cpu", 256)
    with pytest.raises(ValueError, match="twophase"):
        fit_fused(signal, TES[3], LO, HI, strategy="twophase", device="cpu",
                  _row_bound=(torch.tensor(1, dtype=torch.int32), 32))


@pytest.mark.parametrize("cell", ["lf055_gauss.serve", "hf15_rician.serve", "lf055_gr.serve"])
def test_cell_request_is_the_reference_fit(cell):
    """A benchmark cell's request cut to 24^3 (the capacity raised to hold
    its partly filled blocks), through ``serve._call`` on the CPU:
    every map the judge reads is bitwise the benchmark's reference fit of
    the masked voxels scattered into the grid, and every masked voxel is
    fitted."""
    from t2bench import generate, reference, serve, spec

    c = spec.load(ROOT, cell)
    c.config["grid"] = [24] * 3
    c.traffic.update(mask_frac=0.2)
    it = generate.item(c.config, c.traffic, 2**31 + 22, int(c.traffic["items"]) - 1, "cpu")
    got = serve._call(c.config, c.traffic, "cpu")(it)
    ref = reference.fit(c.config, it.signal[it.mask])
    for key in serve.MAPS:
        _assert_same(getattr(got, key), reference.to_grid(ref[key], it.mask), key)
    assert int(got.n_masked) == it.n_masked > 0 and int(got.n_overflow) == 0


def test_adult_cell_request_is_the_reference_fit():
    """The adult cell's request (tissue layers, CSF's T2 beyond the prior
    box) cut to 32^3, through ``serve._call`` on the CPU: every map
    bitwise the reference's, and CSF's T2 on the box's upper bound in
    both."""
    from t2bench import reference, serve, serve_adult, spec

    c = spec.load(ROOT, "hf15_rician_adult.serve_adult")
    c.config["grid"] = [32] * 3
    c.traffic.update(mask_frac=0.6)
    it, lab = serve_adult.item_labels(c.config, c.traffic, 2**31 + 26, 3, "cpu")
    got = serve._call(c.config, c.traffic, "cpu")(it)
    ref = reference.fit(c.config, it.signal[it.mask])
    for key in serve.MAPS:
        _assert_same(getattr(got, key), reference.to_grid(ref[key], it.mask), key)
    assert int(got.n_masked) == it.n_masked > 0 and int(got.n_overflow) == 0
    csf = it.mask & (lab == 2)
    pinned = got.t2[csf] == float(c.config["upper"][1])
    assert int(csf.sum()) > 100 and float(pinned.double().mean()) > 0.9


# ------------------------------------------------------------------ the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_compaction_kernel_is_the_plain_version(card, case):
    """ft2_layout_compact's buffer, slot map and counts are the plain
    version's bits (and so the legacy layout's); one launch counted."""
    before = profiler.counter(COUNTERS[0])
    got = _layout(case, card, volume_fit._compact_cuda)
    torch.cuda.synchronize()
    assert profiler.counter(COUNTERS[0]) == before + 1
    signal, mask, filler, blk_cap, block, buf, slot, counts = got
    want = _layout(case, card, volume_fit._compact_plain)
    _assert_same(buf, want[5], "buffer")
    _assert_same(slot, want[6], "slot")
    _assert_same(counts[:3], want[7], "counts")
    _check_against_legacy(*got)


@pytest.mark.cuda
def test_compaction_kernel_reads_an_unaligned_mask(card):
    """A mask view that does not start on 16 bytes takes the kernel's byte
    loads and gives the same layout."""
    signal, mask = _grid("scattered12", 3)
    n = mask.numel()
    signal = signal.reshape(n, 3).to(card)
    host = torch.zeros(n + 1, dtype=torch.bool)
    host[1:] = mask.reshape(n)
    shifted = host.to(card)[1:]
    assert shifted.data_ptr() % 16 != 0
    blk_cap = volume_fit._block_capacity(n, 1.0, 32)
    bufs = [torch.empty((blk_cap * 32, 3), device=card) for _ in range(2)]
    got = volume_fit._compact_cuda(signal, shifted, _filler(3), blk_cap, 32, bufs[0])
    want = volume_fit._compact_plain(signal, shifted, _filler(3), blk_cap, 32, bufs[1])
    _assert_same(bufs[0], bufs[1], "buffer")
    _assert_same(got[0], want[0], "slot")
    _assert_same(got[1][:3], want[1], "counts")


@pytest.mark.cuda
@pytest.mark.parametrize("case,p,layout,inner", SCATTERS)
def test_scatter_kernel_is_the_plain_version(card, case, p, layout, inner):
    """ft2_layout_scatter's maps are contiguous tensors of their dtypes
    with the plain version's bits; n_masked, n_overflow equal; one launch."""
    signal, mask, filler, blk_cap, block, buf, slot, counts = _layout(
        case, card, volume_fit._compact_cuda)
    res = _fit_rows(blk_cap * block, p, layout, inner, card)
    flat = mask.reshape(-1)
    before = profiler.counter(COUNTERS[1])
    got = volume_fit._scatter_cuda(flat, block, slot, res, counts, mask.shape)
    torch.cuda.synchronize()
    assert profiler.counter(COUNTERS[1]) == before + 1
    _assert_same_result(got, volume_fit._scatter_plain(flat, block, slot, res, counts[:3],
                                                       mask.shape))


def _counts():
    return [profiler.counter(c) for c in COUNTERS]


#: the fit kernels' launch counters a request of each model moves, one each
FIT_COUNTERS = {"gaussian": ("gauss_fit.launches",),
                "rician": ("fit3.launches", "fit3_cont.launches"),
                "gaussian_rician": ("gr_varpro_fit.launches",)}


@pytest.mark.cuda
@pytest.mark.parametrize("model,block", [("gaussian", 32), ("gaussian", 1), ("rician", 32),
                                         ("gaussian_rician", 32)])
def test_fit_volume_on_cuda_runs_the_layout_kernels(card, model, block):
    """A block-layout request launches one compaction, one fit of its
    model's kernels and one scatter and gives the bits of the legacy
    layout around fit_fused on its buffer; so does compact=False."""
    signal, mask = _grid("ellipsoid16", 3)
    signal, mask = signal.to(card), mask.to(card)
    lo, hi, guess = (LO, HI, None) if model == "gaussian" else (LO3, HI3, GUESS3)
    kw = dict(model=model, guess=guess, ftol=1e-9, gtol=0.0, varpro3=True)
    before = _counts()
    fits_before = [profiler.counter(c) for c in FIT_COUNTERS[model]]
    got = volume_fit.fit_volume(signal, mask, TES[3], lo, hi, compact=True, mask_frac=0.6,
                                block=block, device=card, **kw)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1]
    assert [profiler.counter(c) - b for c, b in zip(FIT_COUNTERS[model], fits_before)] \
        == [1] * len(FIT_COUNTERS[model])
    blk_cap = volume_fit._block_capacity(mask.numel(), 0.6, block)
    buf, bidx, nb_sel, mb = _legacy_compact(signal, mask, _filler(3, model), blk_cap, block)
    res = fit_fused(buf, TES[3], lo, hi, device=card, **kw)
    _assert_same_result(got, _legacy_scatter(bidx, nb_sel, mb, res, mask, block))
    before = _counts()
    volume_fit.fit_volume(signal, mask, TES[3], lo, hi, compact=False, device=card, **kw)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1]


@pytest.mark.cuda
def test_fit_volume_on_cuda_overflow_warns_and_counts(card):
    signal, mask = _grid("full16", 3)
    signal, mask = signal.to(card), mask.to(card)
    with pytest.warns(UserWarning, match="left unfitted"):
        res = volume_fit.fit_volume(signal, mask, TES[3], LO, HI, max_iters=8, mask_frac=0.1,
                                    device=card)
    blk_cap = volume_fit._block_capacity(mask.numel(), 0.1, 32)
    assert int(res.n_overflow) == mask.numel() - blk_cap * 32
    assert int(res.n_masked) == mask.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["single", "twophase"])
def test_fit_volume_on_a_mesh_pads_the_kernels_buffer(card, strategy):
    """fit_volume(mesh=) on two streams of one card: the compaction writes
    the buffer's rows, the wrapper the mesh's padding rows, one compaction
    and one scatter per request; maps and counts as on one device."""
    from fetal_t2mapping_tpu_torch.parallel import voxel_mesh

    signal, mask = _grid("ragged15", 3)
    signal, mask = signal.to(card), mask.to(card)
    mesh = voxel_mesh(devices=[card, card, card])
    kw = dict(compact=True, mask_frac=0.7, strategy=strategy)
    one = volume_fit.fit_volume(signal, mask, TES[3], LO, HI, device=card, **kw)
    before = _counts()
    three = volume_fit.fit_volume(signal, mask, TES[3], LO, HI, mesh=mesh, **kw)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1]
    if strategy == "single":
        _assert_same_result(three, one)
    else:
        assert int(three.n_masked) == int(one.n_masked)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lf055_gauss.serve", "hf15_rician.serve", "lf055_gr.serve"])
def test_cell_requests_are_the_plain_layout(card, cell):
    """The benchmark cell's 16 requests (240^3, seed 20260118): the
    kernels' buffer is the legacy layout's, and their maps, n_masked and
    n_overflow the plain scatter's from the same fit, whose kernels the
    configuration states (its prefix3 and varpro3, not the environment)."""
    from t2bench import generate, reference, spec

    c = spec.load(ROOT, cell)
    te, lo, hi, guess = reference.fit_args(c.config)
    kw = dict(model=c.config["model"], guess=guess, max_iters=int(c.config["max_iters"]),
              ftol=float(c.config["ftol"]), gtol=float(c.config["gtol"]),
              prefix3=int(c.config["prefix3"]), varpro3=bool(c.config.get("varpro3", 0)))
    te_t, lo_t, hi_t, guess_t = validate_fused_args(kw["model"], te, lo, hi, guess, False)
    filler = volume_fit._filler_values(te_t, lo_t, hi_t, guess_t)
    for index in range(int(c.traffic["items"])):
        it = generate.item(c.config, c.traffic, 20260118, index, card)
        n, t = it.mask.numel(), it.signal.shape[3]
        blk_cap = volume_fit._block_capacity(n, float(c.traffic["mask_frac"]), 32)
        flat, flat_mask = it.signal.reshape(n, t), it.mask.reshape(n)
        buf = torch.empty((blk_cap * 32, t), device=card)
        slot, counts = volume_fit._compact_cuda(flat, flat_mask, filler, blk_cap, 32, buf)
        want_buf, _, nb_sel, _ = _legacy_compact(it.signal, it.mask, filler, blk_cap, 32)
        _assert_same(buf, want_buf, f"buffer of request {index}")
        assert int(counts[0]) == int(nb_sel) <= blk_cap
        res = fit_fused(buf, te, lo, hi, sync=False, device=card, **kw)
        got = volume_fit._scatter_cuda(flat_mask, 32, slot, res, counts, it.mask.shape)
        want = volume_fit._scatter_plain(flat_mask, 32, slot, res, counts[:3], it.mask.shape)
        _assert_same_result(got, want)
        assert int(got.n_masked) == it.n_masked and int(got.n_overflow) == 0
        del it, buf, res, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("count,block", [(0, 32), (50, 32), (128, 32), (200, 32), (300, 7)])
@pytest.mark.parametrize("fit", sorted(FITS))
def test_fit_kernels_stop_at_the_row_bound(card, fit, count, block):
    """Every fit kernel (heads, one-pass kernels, the multistart and the
    continuation's sweep) with a device live-row bound over 4096 rows: the
    live rows are the unbounded launch's bits, the rows past them 0."""
    _check_row_bound(fit, "cuda", 4096, count, block)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lf055_gauss.serve", "hf15_rician.serve", "lf055_gr.serve"])
def test_cell_request_bound_needs_no_host_read(card, cell):
    """A benchmark cell's 240^3 request (its largest mask, mask_frac 0.06)
    without the capacity check: the fit takes the touched-block count on
    the device, no host read is made, and the maps are those of the call
    with the check and of compact=False, bit for bit."""
    from t2bench import generate, reference, spec

    c = spec.load(ROOT, cell)
    te, lo, hi, guess = reference.fit_args(c.config)
    kw = dict(model=c.config["model"], guess=guess, max_iters=int(c.config["max_iters"]),
              ftol=float(c.config["ftol"]), gtol=float(c.config["gtol"]),
              prefix3=int(c.config["prefix3"]), varpro3=bool(c.config.get("varpro3", 0)),
              device=card)
    items = [generate.item(c.config, c.traffic, 20260123, i, card)
             for i in range(int(c.traffic["items"]))]
    it = max(items, key=lambda item: item.n_masked)
    del items
    mask_frac = float(c.traffic["mask_frac"])
    reads, bounded = profiler.counter("host_reads"), profiler.counter(ROW_BOUND)
    got = volume_fit.fit_volume(it.signal, it.mask, te, lo, hi, mask_frac=mask_frac,
                                check_capacity=False, **kw)
    torch.cuda.synchronize()
    assert profiler.counter("host_reads") == reads
    assert profiler.counter(ROW_BOUND) == bounded + 1
    _assert_same_result(got, volume_fit.fit_volume(it.signal, it.mask, te, lo, hi,
                                                   mask_frac=mask_frac, **kw))
    _assert_same_result(got, volume_fit.fit_volume(it.signal, it.mask, te, lo, hi,
                                                   compact=False, **kw))
    assert int(got.n_masked) == it.n_masked and int(got.n_overflow) == 0
