"""The fit kernels' parameter structs, packed once per configuration
(``models/fused_fit._kernel_params_cached``).

On the CPU: for each struct (gauss, gr, fit3) at 2, 3 and 8 echoes, and
for each benchmark cell's configuration with the arguments its launches
take, the cached array is the uncached packer's, bit for bit, and
read-only; equal arguments, in any container, return the same object and
pack nothing; a change of any one field (an echo time, a bound, the
guess, ftol, gtol, stall_tol, or 0.0 to -0.0) packs anew; the cache keeps
at most 64 structs; threads that share it each get their key's bits; the
plain versions pack nothing.

On the card (marker ``cuda``; ``python3 -m pytest --noconftest
tests/test_torch_params_cache.py``): three ``fit_volume`` requests of
each model count one pack (rician's prefix and continuation share it),
and give the maps of a request made with the cache cleared; a mesh's
shard threads pack once or twice. This file imports no JAX.
"""

import math
import os
import sys
import threading

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu_torch.models import fused_fit
from fetal_t2mapping_tpu_torch.models.fused_fit import validate_fused_args
from fetal_t2mapping_tpu_torch.utils.profiling import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKS = "fit_fused.params.packs"
TES = {2: (114.0, 299.0), 3: (114.0, 202.0, 299.0),
       8: (60.0, 90.0, 114.0, 150.0, 202.0, 250.0, 299.0, 350.0)}
#: a configuration of each struct: (lo, hi, guess), None for gauss's guess
ARGS = {"gauss": ((0.0, 10.0), (1e6, 2000.0), None),
        "gr": ((1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0)),
        "fit3": ((1.0, 10.0, 1e-2), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0))}
TOLS = (1e-9, 0.0, 1e-3)
CELLS = ("lf055_gauss.serve", "hf15_rician.serve", "lf055_gr.serve")
MAPS = ("t2", "k", "sigma", "fun", "converged", "n_iter")


@pytest.fixture(autouse=True)
def empty_cache():
    fused_fit._packed_params.cache_clear()
    yield
    fused_fit._packed_params.cache_clear()


def _uncached(kind, te, lo, hi, guess, ftol, gtol, stall_tol):
    args = (te, lo, hi) if kind == "gauss" else (te, lo, hi, guess)
    return fused_fit._PACKERS[kind](*args, ftol, gtol, stall_tol)


def _assert_bits(got, want):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _cell_args(cell):
    """(struct, te, lo, hi, guess, ftol, gtol, stall_tol) as the cell's
    launches take them: validated as ``fit_fused`` does, with the stall
    tolerance ``_fit_pass`` derives for the cell's kernel."""
    from t2bench import spec

    c = spec.load(ROOT, cell).config
    model, ftol = c["model"], float(c["ftol"])
    te, lo, hi, guess = validate_fused_args(model, c["te"], c["lower"], c["upper"],
                                            c.get("initial_guess"), False)
    if model == "gaussian":
        return "gauss", te, lo, hi, None, ftol, float(c["gtol"]), max(ftol, 1e-3)
    if c.get("varpro3", 0):
        return "gr", te, lo, hi, guess, ftol, float(c["gtol"]), max(ftol, 1e-3)
    return "fit3", te, lo, hi, guess, ftol, float(c["gtol"]), max(ftol, 1e-6)


@pytest.mark.parametrize("t", sorted(TES))
@pytest.mark.parametrize("kind", sorted(ARGS))
def test_cached_struct_is_the_packers(kind, t):
    lo, hi, guess = ARGS[kind]
    args = (kind, TES[t], lo, hi, guess, *TOLS)
    before = profiler.counter(PACKS)
    got = fused_fit._kernel_params_cached(*args)
    assert profiler.counter(PACKS) == before + 1
    _assert_bits(got, _uncached(*args))
    assert not got.flags.writeable
    with pytest.raises(ValueError, match="read-only"):
        got[0] = 1.0


@pytest.mark.parametrize("cell", CELLS)
def test_cell_struct_is_the_packers(cell):
    """Each cell's configuration, with the arguments its launches take:
    the bits of the uncached packer, packed once over repeated calls (the
    rician cell's prefix and continuation launches make two a request)."""
    args = _cell_args(cell)
    before = profiler.counter(PACKS)
    got = [fused_fit._kernel_params_cached(*args) for _ in range(4)]
    assert profiler.counter(PACKS) == before + 1
    assert all(g is got[0] for g in got)
    _assert_bits(got[0], _uncached(*args))
    assert not got[0].flags.writeable


@pytest.mark.parametrize("kind", sorted(ARGS))
def test_equal_arguments_return_the_same_array(kind):
    """Equal values are one key whatever holds them: tuples or lists,
    floats or the ints of equal value."""
    lo, hi, guess = ARGS[kind]
    first = fused_fit._kernel_params_cached(kind, TES[3], lo, hi, guess, *TOLS)
    before = profiler.counter(PACKS)
    again = [fused_fit._kernel_params_cached(kind, TES[3], lo, hi, guess, *TOLS),
             fused_fit._kernel_params_cached(kind, [114, 202, 299], list(lo), list(hi),
                                             None if guess is None else list(guess), *TOLS)]
    assert all(a is first for a in again)
    assert profiler.counter(PACKS) == before


def _fields(kind):
    """(name, index) of every key field of ``kind``'s arguments."""
    lo, _, guess = ARGS[kind]
    out = [("te", i) for i in range(3)] + [(g, i) for g in ("lo", "hi") for i in range(len(lo))]
    if guess is not None:
        out += [("guess", i) for i in range(3)]
    return out + [("ftol", None), ("gtol", None), ("stall_tol", None)]


FIELDS = [(kind, name, i) for kind in sorted(ARGS) for name, i in _fields(kind)]


@pytest.mark.parametrize("kind,name,index", FIELDS)
def test_a_changed_field_packs_anew(kind, name, index):
    """One field moved by one float64 ulp packs a new struct, the
    uncached packer's for the moved arguments; the old key still hits."""
    lo, hi, guess = ARGS[kind]
    fields = dict(te=TES[3], lo=lo, hi=hi, guess=guess, ftol=TOLS[0], gtol=TOLS[1],
                  stall_tol=TOLS[2])
    order = ("te", "lo", "hi", "guess", "ftol", "gtol", "stall_tol")
    base = fused_fit._kernel_params_cached(kind, *(fields[k] for k in order))
    if index is None:
        fields[name] = math.nextafter(fields[name], math.inf)
    else:
        vals = list(fields[name])
        vals[index] = math.nextafter(vals[index], math.inf)
        fields[name] = tuple(vals)
    args = (kind, *(fields[k] for k in order))
    before = profiler.counter(PACKS)
    moved = fused_fit._kernel_params_cached(*args)
    assert profiler.counter(PACKS) == before + 1
    assert moved is not base
    _assert_bits(moved, _uncached(*args))
    assert fused_fit._kernel_params_cached(kind, TES[3], lo, hi, guess, *TOLS) is base
    assert profiler.counter(PACKS) == before + 1


def test_negative_zero_is_its_own_key():
    """0.0 and -0.0 are equal floats but pack other bits (gauss's lower k
    bound is in its head): each gets the packer's own struct."""
    hi = ARGS["gauss"][1]
    plus = fused_fit._kernel_params_cached("gauss", TES[3], (0.0, 10.0), hi, None, *TOLS)
    minus = fused_fit._kernel_params_cached("gauss", TES[3], (-0.0, 10.0), hi, None, *TOLS)
    assert minus is not plus and minus.tobytes() != plus.tobytes()
    _assert_bits(minus, _uncached("gauss", TES[3], (-0.0, 10.0), hi, None, *TOLS))
    _assert_bits(plus, _uncached("gauss", TES[3], (0.0, 10.0), hi, None, *TOLS))


def test_the_cache_is_bounded():
    """At most 64 structs are kept, the least recently used dropped first:
    after 65 distinct configurations the first packs again."""
    lo, hi, guess = ARGS["fit3"]
    assert fused_fit._packed_params.cache_info().maxsize == 64
    keys = [(TES[3], lo, hi, guess, 1e-9 * (1 + i), 0.0, 1e-6) for i in range(65)]
    first = fused_fit._kernel_params_cached("fit3", *keys[0])
    for key in keys[1:]:
        fused_fit._kernel_params_cached("fit3", *key)
    assert fused_fit._packed_params.cache_info().currsize == 64
    before = profiler.counter(PACKS)
    again = fused_fit._kernel_params_cached("fit3", *keys[0])
    assert profiler.counter(PACKS) == before + 1
    assert again is not first
    _assert_bits(again, first)
    before = profiler.counter(PACKS)
    fused_fit._kernel_params_cached("fit3", *keys[-1])
    assert profiler.counter(PACKS) == before


def test_threads_sharing_the_cache_get_their_keys_bits():
    """16 threads over 80 keys (more than the cache holds, so entries are
    dropped while others read them), with a short switch interval: every
    array returned is its key's uncached struct, read-only."""
    lo, hi, guess = ARGS["gr"]
    keys = [("gr" if i % 2 else "fit3", TES[3], lo, hi, guess, 1e-9 * (1 + i), 0.0, 1e-3)
            for i in range(80)]
    want = {i: _uncached(*key).tobytes() for i, key in enumerate(keys)}
    errors = []

    def work(seed):
        order = np.random.default_rng(seed).permutation(len(keys))
        try:
            for i in np.concatenate([order, order]):
                got = fused_fit._kernel_params_cached(*keys[i])
                if got.tobytes() != want[i] or got.flags.writeable:
                    errors.append(i)
        except Exception as exc:     # recorded, and asserted empty below
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []


def test_plain_versions_pack_nothing():
    """A fit on a CPU tensor runs the plain versions, which compute their
    own tables: no struct is packed."""
    rng = np.random.default_rng(3)
    t2 = rng.uniform(20.0, 500.0, 64).astype(np.float32)
    sig = (2000.0 * np.exp(-np.asarray(TES[3], np.float32)[None, :] / t2[:, None]))
    before = profiler.counter(PACKS)
    for model, (lo, hi, guess) in (("gaussian", ARGS["gauss"]), ("rician", ARGS["fit3"])):
        fused_fit.fit_fused(sig.astype(np.float32), TES[3], lo, hi, model=model, guess=guess,
                            max_iters=8, device="cpu")
    assert profiler.counter(PACKS) == before


# ----------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _request(dev, seed=0, n=24, t=3):
    """(signal (n, n, n, t), mask): an ellipsoid of decays on a zero grid."""
    rng = np.random.default_rng(seed)
    ax = (np.arange(n, dtype=np.float32) - (n - 1) / 2) / (n / 2)
    zz, yy, xx = np.meshgrid(ax, ax, ax, indexing="ij")
    mask = (zz / 0.75) ** 2 + (yy / 0.85) ** 2 + (xx / 0.65) ** 2 <= 1.0
    k = rng.uniform(900.0, 5000.0, mask.shape).astype(np.float32)
    t2 = rng.uniform(30.0, 500.0, mask.shape).astype(np.float32)
    sig = k[..., None] * np.exp(-np.asarray(TES[t], np.float32) / t2[..., None])
    sig = np.maximum(sig + rng.normal(0, 8.0, sig.shape), 1e-2).astype(np.float32)
    sig[~mask] = 0.0
    return torch.from_numpy(sig).to(dev), torch.from_numpy(mask).to(dev)


#: a request of each model, as its cell runs it: (model, kw)
MODELS = {"gaussian": dict(lo=(600.0, 10.0), hi=(10000.0, 600.0), guess=(650.0, 165.0)),
          "rician": dict(lo=(850.0, 30.0, 7.0), hi=(30000.0, 600.0, 200.0),
                         guess=(17.0, 40.0, 0.15), prefix3=4),
          "gaussian_rician": dict(lo=(550.0, 10.0, 2.0), hi=(10000.0, 600.0, 1000.0),
                                  guess=(650.0, 110.0, 40.0), varpro3=True)}


def _maps(res):
    return [getattr(res, key) for key in MAPS]


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(MODELS))
def test_requests_pack_once_per_model(card, model):
    """Three requests of one model count one pack (rician's prefix and
    continuation launch with one key); a fourth, with the cache cleared,
    packs again and gives the third's maps, bit for bit."""
    from fetal_t2mapping_tpu_torch.models.volume_fit import fit_volume

    signal, mask = _request(card)
    kw = dict(MODELS[model], model=model, mask_frac=0.6, device=card)
    before = profiler.counter(PACKS)
    got = [fit_volume(signal, mask, TES[3], **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert profiler.counter(PACKS) == before + 1
    fused_fit._packed_params.cache_clear()
    fresh = fit_volume(signal, mask, TES[3], **kw)
    torch.cuda.synchronize()
    assert profiler.counter(PACKS) == before + 2
    for a, b in zip(_maps(got[2]), _maps(fresh)):
        assert torch.equal(a, b)
    assert int(fresh.n_masked) == int(mask.sum())


@pytest.mark.cuda
def test_mesh_threads_pack_once_or_twice(card):
    """Two shard threads on one card may miss at once on the first
    request: one or two packs, none after."""
    from fetal_t2mapping_tpu_torch.models.volume_fit import fit_volume
    from fetal_t2mapping_tpu_torch.parallel import voxel_mesh

    signal, mask = _request(card)
    mesh = voxel_mesh(devices=[card, card])
    kw = dict(MODELS["rician"], model="rician", mask_frac=0.6)
    before = profiler.counter(PACKS)
    one = fit_volume(signal, mask, TES[3], mesh=mesh, **kw)
    torch.cuda.synchronize()
    assert 1 <= profiler.counter(PACKS) - before <= 2
    first = profiler.counter(PACKS)
    two = fit_volume(signal, mask, TES[3], mesh=mesh, **kw)
    torch.cuda.synchronize()
    assert profiler.counter(PACKS) == first
    for a, b in zip(_maps(one), _maps(two)):
        assert torch.equal(a, b)
