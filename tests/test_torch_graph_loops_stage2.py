"""The port's stage-2 loops as in-place steps, the functions that are
captured as CUDA graphs on the card (``fetal_t2mapping_tpu_torch.graphs``):
TV denoising (``ops.tv._tv2d_steps``), the hole fill of ``fill_holes`` and
``build_slice_mask`` (``ops.morphology._fill_holes_steps``) and the N4
levels (``recon.biasfield._n4_level_steps``).

On the CPU each step, driven eagerly, is held bitwise to the eager loop it
replaces (``_tv2d``, ``_fill_holes_loop``, ``_n4_level_loop``): TV stacks
whose slices stop at different iterations, budgets that cut them, a stop
that falls between two host reads of the "any slice active" flag; the
3-D and 2-D fills, a long serpentine flood in each, a fixed point reached
inside a block; N4 levels with their field CVs, and whole corrections
over three levels (the count is fixed: no host read). The ``cuda`` cases
run on the card (``python3 -m pytest --noconftest -m cuda
tests/test_torch_graph_loops*.py``): graph against the eager loop there,
bitwise, with the graphs captured and replayed counted.

Imports nothing of JAX: the JAX package is held against these loops in
``test_torch_ops.py`` and ``test_torch_biasfield.py``.
"""

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu_torch.core.volume import Volume
from fetal_t2mapping_tpu_torch.ops import morphology, tv
from fetal_t2mapping_tpu_torch.recon import biasfield
from fetal_t2mapping_tpu_torch.utils.profiling import profiler

#: the profiler's counters that the graphed loops add to
CAPTURES, REPLAYS, READS = "graphs.captures", "graphs.replays", "host_reads"

torch.set_num_threads(1)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, so NaNs compare equal to themselves."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _assert_bitwise(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert torch.equal(_bits(a), _bits(b)), what


# -------------------------------------------------------------------- TV
def _tv_stack(shape=(8, 40, 44), seed=0):
    """Slices of a disc under noise whose level grows along z, so the
    slices stop at different iterations."""
    rng = np.random.default_rng(seed)
    s, h, w = shape
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    clean = 0.3 * (yy ** 2 + xx ** 2 < 0.5) + 1.0
    noise = rng.normal(0, 1.0, shape) * np.geomspace(0.01, 0.5, s)[:, None, None]
    return torch.from_numpy((clean[None] + noise).astype(np.float32))


TV_CASES = {  # name: (stack seed, eps, max_iter)
    "stops": (0, 2e-4, 200),
    "budget cuts": (1, 2e-4, 23),
    "no stop": (2, 0.0, 17),
}


@pytest.mark.parametrize("case", sorted(TV_CASES))
def test_tv_steps_equal_loop(case):
    seed, eps, max_iter = TV_CASES[case]
    vol = _tv_stack(seed=seed)
    reads = profiler.counter(READS)
    steps = tv._tv2d_steps(vol, 0.1, eps, max_iter, graph=False)
    assert profiler.counter(READS) - reads <= max_iter // tv._CHECK_EVERY
    _assert_bitwise(tv._tv2d(vol, 0.1, eps, max_iter), steps, case)


def _recorded_tv(monkeypatch, vol, max_iter=200):
    """The steps driven eagerly, with the buffers after every step."""
    states = []
    real_step = tv._tv_step

    def recording_step(b, *a):
        real_step(b, *a)
        states.append({k: b[k].clone() for k in ("pz", "py", "e_prev", "e", "i", "more")})

    monkeypatch.setattr(tv, "_tv_step", recording_step)
    out = tv._tv2d_steps(vol, 0.1, 2e-4, max_iter, graph=False)
    return out, states


def test_tv_stop_between_host_reads(monkeypatch):
    """The last slice stops at an iteration that is not a multiple of
    _CHECK_EVERY: the steps run on to the next host read, and each of them
    leaves the dual fields and the energies as they were."""
    vol = _tv_stack(seed=0)
    reads = profiler.counter(READS)
    out, states = _recorded_tv(monkeypatch, vol)
    # the stop: the first iteration >= 2 at which no slice is active
    t_stop = next(k + 1 for k, st in enumerate(states) if k + 1 >= 2 and not bool(st["more"]))
    every = tv._CHECK_EVERY
    assert t_stop % every != 0 and t_stop < 200
    assert len(states) == -(-t_stop // every) * every
    assert profiler.counter(READS) - reads == len(states) // every    # reads at 10, 20, ...
    for later in states[t_stop:]:
        for k in ("pz", "py", "e_prev", "e"):
            _assert_bitwise(later[k], states[t_stop - 1][k], f"TV {k} after the stop")
    _assert_bitwise(tv._tv2d(vol, 0.1, 2e-4, 200), out, "TV result")


def test_tv_denoise_slices_on_cpu_is_the_loop():
    vol = _tv_stack(seed=3)
    captures, reads = profiler.counter(CAPTURES), profiler.counter(READS)
    _assert_bitwise(tv._tv2d(vol, 0.1, 2e-4, 200), tv.tv_denoise_slices(vol), "tv")
    assert (profiler.counter(CAPTURES), profiler.counter(READS)) == (captures, reads)


# ------------------------------------------------------------- hole fill
def _cavities(shape, seed):
    """Random blobs with holes: a thresholded smooth field."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape)
    for a in range(3):
        if shape[a] > 2:
            f = f + np.roll(f, 1, a) + np.roll(f, -1, a)
    return f > 0.3


def _spiral(n=40, depth=3):
    """tests/test_torch_ops.py's long flood: a walled slab whose single
    opening leads through baffles, many more flood steps than one block."""
    m = np.ones((depth, n, n), bool)
    m[1, 1:-1, 1:-1] = False
    for k in range(2, n - 2, 4):
        m[1, k, (1 if k % 8 == 2 else 3):(n - 3 if k % 8 == 2 else n - 1)] = True
    m[1, 0, 1] = False
    return m


FILL_CASES = {  # name: (mask, axes)
    "3-D cavities": (lambda: _cavities((20, 30, 30), 1), (0, 1, 2)),
    "3-D long flood": (_spiral, (0, 1, 2)),
    "2-D cavities": (lambda: _cavities((26, 28, 30), 9), (0, 1)),
    "2-D long flood": (lambda: np.ascontiguousarray(_spiral().transpose(1, 2, 0)), (0, 1)),
}


@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_fill_holes_steps_equal_loop(case):
    make, axes = FILL_CASES[case]
    m = torch.from_numpy(make())
    loop = morphology._fill_holes_loop(m, axes)
    _assert_bitwise(loop, morphology._fill_holes_steps(m, axes, graph=False), case)
    # cavities get filled; the flood reaches the whole corridor
    assert bool((loop & ~m).any()) == case.endswith("cavities")


@pytest.mark.parametrize("case", ["3-D long flood", "2-D long flood"])
def test_fill_fixed_point_between_host_reads(case):
    """The flood reaches its fixed point inside a block: the host reads once
    per block, the block after the one that reached it changes nothing,
    and the result is the loop's."""
    make, axes = FILL_CASES[case]
    m = torch.from_numpy(make())
    outside, reach = morphology._fill_seed(m, axes)
    n_steps = 0
    while True:
        nxt = morphology._dilate_cross(reach, axes) & outside
        if torch.equal(nxt, reach):
            break
        reach, n_steps = nxt, n_steps + 1
    every = morphology._FILL_CHECK_EVERY
    assert n_steps > every and n_steps % every != 0
    reads = profiler.counter(READS)
    out = morphology._fill_holes_steps(m, axes, graph=False)
    assert profiler.counter(READS) - reads == -(-n_steps // every) + 1
    _assert_bitwise(out, m | (outside & ~reach), case)


def test_fill_holes_and_slice_mask_on_cpu_are_the_loop():
    m = torch.from_numpy(_cavities((20, 30, 30), 2))
    img = torch.where(torch.from_numpy(_cavities((26, 28, 30), 4)), 80.0, 0.5)
    captures, reads = profiler.counter(CAPTURES), profiler.counter(READS)
    _assert_bitwise(morphology.fill_holes(m), morphology._fill_holes_loop(m, (0, 1, 2)),
                    "fill_holes")
    bw = morphology._fill_holes_loop(img > 1.0, (0, 1))
    want = morphology._box_pool(morphology._box_pool(bw, 2, True, axes=(0, 1)), 2, False,
                                axes=(0, 1))
    _assert_bitwise(morphology.build_slice_mask(img), want, "build_slice_mask")
    assert (profiler.counter(CAPTURES), profiler.counter(READS)) == (captures, reads)


# -------------------------------------------------------------------- N4
def _n4_scene(n=24, seed=0):
    """tests/test_torch_biasfield.py's scene: two tissue classes under a
    smooth multiplicative field, in a sphere; 4 mm voxels."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n)] * 3, indexing="ij")
    r = np.sqrt(z ** 2 + y ** 2 + x ** 2)
    tissue = np.where(r < 0.6, 1000.0, 600.0) * (1 + 0.02 * rng.standard_normal(r.shape))
    field = np.exp(0.6 * (0.7 * z + 0.5 * y * y - 0.3 * x))
    mask = r < 0.95
    img = np.where(mask, tissue * field, 0.0).astype(np.float32)
    return (Volume(img, spacing=(4.0,) * 3), Volume(mask.astype(np.uint8), spacing=(4.0,) * 3))


def _level_inputs(n=24, seed=0):
    vol, mask = _n4_scene(n, seed)
    mask_f = torch.from_numpy(mask.data).to(torch.float32)
    data = torch.from_numpy(vol.data)
    return torch.log(torch.clamp_min(data, 1e-6)) * mask_f, mask_f


N4_CASES = {  # name: (n_iters, n_bins, sigma_vox)
    "6 iterations": (6, 200, (3.0, 3.0, 3.0)),
    "anisotropic, 64 bins": (4, 64, (2.0, 3.0, 4.5)),
}


@pytest.mark.parametrize("case", sorted(N4_CASES))
def test_n4_level_steps_equal_loop(case):
    n_iters, n_bins, sigma = N4_CASES[case]
    v, mask_f = _level_inputs()
    kw = dict(n_iters=n_iters, n_bins=n_bins, fwhm=0.15, wiener_eps=0.01, sigma_vox=sigma)
    v_in = v.clone()
    reads = profiler.counter(READS)
    steps = biasfield._n4_level_steps(v, mask_f, graph=False, **kw)
    assert profiler.counter(READS) == reads                  # a fixed count: nothing read
    _assert_bitwise(v, v_in, "the input log image is left alone")
    loop = biasfield._n4_level_loop(v, mask_f, **kw)
    for a, b, what in zip(loop, steps, ("v", "bias", "field_cv")):
        _assert_bitwise(a, b, f"{case} {what}")
    assert steps[2].shape == (n_iters,) and bool((steps[2] > 0).all())


def test_n4_correction_through_steps(monkeypatch):
    """n4_bias_correction over three levels, its levels through the steps,
    is bitwise the eager loops' (corrected, field, every level's CVs)."""
    vol, mask = _n4_scene(seed=1)
    kw = dict(n_iters=5, ctrl_spacing_mm=(200.0, 100.0, 50.0), device="cpu")
    loop = biasfield.n4_bias_correction(vol, mask, **kw)
    counters = []
    real_step = biasfield._n4_step

    def counting_step(b, *a, **k):
        real_step(b, *a, **k)
        counters.append(int(b["it"]))

    with monkeypatch.context() as mp:
        mp.setattr(biasfield, "_n4_level",
                   lambda v, m, **k: biasfield._n4_level_steps(v, m, graph=False, **k))
        mp.setattr(biasfield, "_n4_step", counting_step)
        steps = biasfield.n4_bias_correction(vol, mask, **kw)
    assert counters == [1, 2, 3, 4, 5] * 3
    for name in ("corrected", "field"):
        np.testing.assert_array_equal(getattr(loop, name).data, getattr(steps, name).data)
    np.testing.assert_array_equal(loop.field_cv, steps.field_cv)
    assert loop.field_cv.shape == (15,)


def test_n4_on_cpu_is_the_loop():
    vol, mask = _n4_scene(seed=2)
    captures = profiler.counter(CAPTURES)
    res = biasfield.n4_bias_correction(vol, mask, n_iters=3, device="cpu")
    assert profiler.counter(CAPTURES) == captures
    v, mask_f = _level_inputs(seed=2)
    sigma = tuple(100.0 / 4.0 / biasfield._SQRT8LN2 for _ in range(3))
    _, _, cvs = biasfield._n4_level_loop(v, mask_f, n_iters=3, n_bins=200, fwhm=0.15,
                                         wiener_eps=0.01, sigma_vox=sigma)
    np.testing.assert_array_equal(res.field_cv, cvs.numpy())


# ------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TV_CASES))
def test_tv_graph_equals_eager_on_card(card, case):
    seed, eps, max_iter = TV_CASES[case]
    vol = _tv_stack(seed=seed).to(card)
    captures, replays = profiler.counter(CAPTURES), profiler.counter(REPLAYS)
    graph = tv.tv_denoise_slices(vol, 0.1, eps, max_iter)
    assert profiler.counter(CAPTURES) == captures + 1 and profiler.counter(REPLAYS) > replays
    _assert_bitwise(tv._tv2d(vol, 0.1, eps, max_iter), graph, f"{case} on the card")


@pytest.mark.cuda
def test_tv_stop_between_host_reads_on_card(card):
    vol = _tv_stack(seed=0).to(card)
    replays, reads = profiler.counter(REPLAYS), profiler.counter(READS)
    graph = tv._tv2d_steps(vol, 0.1, 2e-4, 200, graph=True)
    n_steps = profiler.counter(REPLAYS) - replays + 1
    assert n_steps % tv._CHECK_EVERY == 0 and n_steps < 200
    assert profiler.counter(READS) - reads == n_steps // tv._CHECK_EVERY
    _assert_bitwise(tv._tv2d(vol, 0.1, 2e-4, 200), graph, "TV on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_fill_holes_graph_equals_eager_on_card(card, case):
    make, axes = FILL_CASES[case]
    m = torch.from_numpy(make()).to(card)
    captures = profiler.counter(CAPTURES)
    graph = morphology._fill_holes(m, axes)
    assert profiler.counter(CAPTURES) == captures + 1
    _assert_bitwise(morphology._fill_holes_loop(m, axes), graph, f"{case} on the card")


@pytest.mark.cuda
def test_slice_mask_and_fill_holes_graphs_on_card(card):
    m = torch.from_numpy(_cavities((48, 52, 56), 5))
    img = torch.where(torch.from_numpy(_cavities((48, 52, 56), 6)), 80.0, 0.5)
    captures = profiler.counter(CAPTURES)
    _assert_bitwise(morphology.fill_holes(m.to(card)), morphology.fill_holes(m), "fill_holes")
    _assert_bitwise(morphology.build_slice_mask(img.to(card)), morphology.build_slice_mask(img),
                    "build_slice_mask")
    assert profiler.counter(CAPTURES) == captures + 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(N4_CASES))
def test_n4_level_graph_equals_eager_on_card(card, case):
    n_iters, n_bins, sigma = N4_CASES[case]
    v, mask_f = (t.to(card) for t in _level_inputs(n=40))
    kw = dict(n_iters=n_iters, n_bins=n_bins, fwhm=0.15, wiener_eps=0.01, sigma_vox=sigma)
    captures, replays, reads = (profiler.counter(c) for c in (CAPTURES, REPLAYS, READS))
    graph = biasfield._n4_level(v, mask_f, **kw)
    assert (profiler.counter(CAPTURES) - captures,
            profiler.counter(REPLAYS) - replays) == (1, n_iters - 1)
    assert profiler.counter(READS) == reads
    for a, b, what in zip(biasfield._n4_level_loop(v, mask_f, **kw), graph,
                          ("v", "bias", "field_cv")):
        _assert_bitwise(a, b, f"{case} {what} on the card")


@pytest.mark.cuda
def test_n4_correction_graph_equals_eager_on_card(card, monkeypatch):
    vol, mask = _n4_scene(n=40, seed=1)
    kw = dict(n_iters=6, ctrl_spacing_mm=(200.0, 100.0, 50.0), device=card)
    captures = profiler.counter(CAPTURES)
    graph = biasfield.n4_bias_correction(vol, mask, **kw)
    assert profiler.counter(CAPTURES) == captures + 3
    with monkeypatch.context() as mp:
        mp.setattr(biasfield, "_n4_level_steps",
                   lambda v, m, graph, **k: biasfield._n4_level_loop(v, m, **k))
        eager = biasfield.n4_bias_correction(vol, mask, **kw)
    for name in ("corrected", "field"):
        np.testing.assert_array_equal(getattr(graph, name).data, getattr(eager, name).data)
    np.testing.assert_array_equal(graph.field_cv, eager.field_cv)
