"""The port's ``fit_fused(strategy='twophase')`` (plain PyTorch versions,
CPU) against its own 'single' strategy and against the JAX package's
two-phase driver (``pallas_fit._fit_fused_impl``, interpret mode on CPU).

Against 'single' (tolerance: none, bitwise). Each kernel freezes a voxel
once it has converged, and a refit block starts from scratch from the same
start as the single pass, so every voxel the rounds handled — all of them
when the buffer has room — carries the bits of 'single'. The rest, the
unconverged voxels of blocks no round covered, keep their phase-1 result
and are counted in ``n_overflow``, which equals the count recomputed on the
host from the phase-1 flags.

Against the reference: parameters on identifiable voxels inside the bands
``bench.py:638-652`` sets between two codegens of one kernel (gaussian:
params 1e-3 relative, objective 1e-2; 3-parameter: k and T2 1e-2,
objective 3e-2; convergence rates within 0.01), at the pipeline's
tolerances (ftol 1e-9, gtol 0), on the voxels both packages' rounds
handled. ``n_overflow`` follows from each package's own phase-1 flags;
where the two packages leave different voxels unrefit, the witness is the
voxels whose phase-1 ``converged`` flag differs between them (ROADMAP, "A
known difference, not a fault": after 10 iterations at ftol 1e-9 the two
gaussian fits have taken a different number of accepted steps on many
voxels, though both converge to the same answer).
"""

from math import gcd

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu.models import pallas_fit as ref
from fetal_t2mapping_tpu_torch.models import fused_fit as port
from fetal_t2mapping_tpu_torch.models.volume_fit import fit_volume

torch.set_num_threads(1)

TES = (114.0, 202.0, 299.0)
FITS = {  # model: (lo, hi, guess)
    "gaussian": ((0.0, 10.0), (1e6, 2000.0), None),
    "gaussian_rician": ((1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0)),
    "rician": ((1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0)),
}
N = 2048


def _make_data(n, seed):
    """bench.py:120-127's generator; the identifiable voxels."""
    rng = np.random.default_rng(seed)
    te = np.asarray(TES, np.float32)
    k = rng.uniform(600.0, 5000.0, n).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, n).astype(np.float32)
    sig = (k[:, None] * np.exp(-te[None, :] / t2[:, None])).astype(np.float32)
    sig = np.maximum(sig + rng.normal(0, 8.0, sig.shape).astype(np.float32), 1e-2)
    return sig, k * np.exp(-TES[-1] / t2) >= 24.0


def _same(a, b, keep=slice(None)):
    return all(torch.equal(torch.as_tensor(u)[keep], torch.as_tensor(v)[keep])
               for u, v in ((a.x, b.x), (a.fun, b.fun), (a.converged, b.converged),
                            (a.n_iter, b.n_iter)))


def host_overflow(conv1, tail_block, tail_frac, rounds=2):
    """The voxels 'twophase' leaves unrefit, from the phase-1 flags: the
    unconverged voxels of the straggler blocks past the first rounds *
    cap_b of them, in block order."""
    n = conv1.size
    nbk = -(-n // tail_block)
    c = np.ones(nbk * tail_block, bool)
    c[:n] = conv1
    quantum = 128 // gcd(tail_block, 128)
    cap_b = max(quantum, -(-int(nbk * tail_frac) // quantum) * quantum)
    left = np.zeros(nbk, bool)
    left[np.flatnonzero(~c.reshape(nbk, tail_block).all(1))[rounds * cap_b:]] = True
    return np.repeat(left, tail_block)[:n] & ~conv1


@pytest.fixture(scope="module", params=sorted(FITS))
def case(request):
    model = request.param
    lo, hi, guess = FITS[model]
    sig, ident = _make_data(N, seed=len(model))
    kw = dict(model=model, guess=guess, device="cpu")
    single = port.fit_fused(sig, TES, lo, hi, **kw)
    phase1 = port.fit_fused(sig, TES, lo, hi, max_iters=10, **kw)
    return model, lo, hi, guess, sig, ident, single, phase1.converged.numpy()


def test_twophase_with_room_is_single_bitwise(case):
    model, lo, hi, guess, sig, _, single, conv1 = case
    assert not conv1.all()                        # phase 1 leaves stragglers
    tp = port.fit_fused(sig, TES, lo, hi, model=model, guess=guess, strategy="twophase",
                        tail_frac=1.0, device="cpu")
    assert _same(single, tp)
    assert int(tp.n_overflow) == 0 and tp.n_overflow.dtype == torch.int32


@pytest.mark.parametrize("tail_frac,tail_rounds", [(None, 2), (0.01, 1)])
def test_twophase_handled_voxels_are_single_and_overflow_is_counted(case, tail_frac,
                                                                    tail_rounds):
    """At the default capacity and a starved one (one round of 128 voxels
    or 16 blocks, n_overflow > 0): every voxel but the overflow equals
    'single'; n_overflow is the host count."""
    model, lo, hi, guess, sig, _, single, conv1 = case
    tp = port.fit_fused(sig, TES, lo, hi, model=model, guess=guess, strategy="twophase",
                        tail_frac=tail_frac, tail_rounds=tail_rounds, device="cpu")
    bc = port.resolve_tail_block(None, model)
    over = host_overflow(conv1, bc, port.resolve_tail_frac(tail_frac, bc), tail_rounds)
    assert int(tp.n_overflow) == int(over.sum())
    if tail_frac is not None:
        assert int(tp.n_overflow) > 0
    assert _same(single, tp, torch.from_numpy(~over))
    # the overflow voxels keep their phase-1 result: unconverged
    assert not tp.converged[torch.from_numpy(over)].any()


def test_twophase_matches_reference_driver(case):
    """The port's twophase against the reference's in interpret mode:
    parameters in the bench bands; each n_overflow is its package's host
    count from its own phase-1 flags, and a difference between the two
    counts comes with voxels whose phase-1 flag differs (the witness)."""
    model, lo, hi, guess, sig, ident, _, conv1 = case
    p = port.fit_fused(sig, TES, lo, hi, model=model, guess=guess, strategy="twophase",
                       device="cpu")
    r = ref.fit_fused(sig, TES, lo, hi, model=model, guess=guess, strategy="twophase",
                      interpret=True)
    r1 = ref.fit_fused(sig, TES, lo, hi, model=model, guess=guess, strategy="single",
                       max_iters=10, interpret=True)
    conv1_r = np.asarray(r1.converged)
    bc = port.resolve_tail_block(None, model)
    frac = port.resolve_tail_frac(None, bc)
    over_p, over_r = host_overflow(conv1, bc, frac), host_overflow(conv1_r, bc, frac)
    assert int(p.n_overflow) == int(over_p.sum())
    assert int(r.n_overflow) == int(over_r.sum())
    if (over_p != over_r).any():
        witness = np.flatnonzero(conv1 != conv1_r)
        print(f"{model}: n_overflow port {int(p.n_overflow)}, reference {int(r.n_overflow)}; "
              f"phase-1 flags differ on voxels {witness.tolist()}")
        assert witness.size > 0
    # the bands on the voxels that both packages' rounds handled
    handled = ~over_p & ~over_r
    both = ident & handled
    x_p, x_r = p.x.numpy(), np.asarray(r.x)
    rel = np.abs(x_p - x_r) / np.maximum(np.abs(x_r), 1.0)
    f_rel = (np.abs(p.fun.numpy() - np.asarray(r.fun))
             / np.maximum(np.abs(np.asarray(r.fun)), 1.0))
    if model == "gaussian":
        assert rel[both].max() <= 1e-3 and f_rel[both].max() <= 1e-2
    else:
        assert rel[both][:, :2].max() <= 1e-2 and f_rel[both].max() <= 3e-2
    conv_p, conv_r = p.converged.numpy()[handled], np.asarray(r.converged)[handled]
    assert abs(conv_p.mean() - conv_r.mean()) <= 0.01


def test_fit_volume_twophase(case):
    """fit_volume(strategy='twophase') on a volume, dense and compacted:
    starved of capacity, its n_overflow is the inner fit's count (> 0; the
    buffer itself has room), as the reference's fit_volume adds it, and a
    masked voxel differs from 'single' only where it is one of those,
    unconverged."""
    model, lo, hi, guess, *_ = case
    sig, _ = _make_data(20 * 24 * 24, seed=7)
    vol = sig.reshape(20, 24, 24, 3)
    mask = np.zeros((20, 24, 24), bool)
    mask[2:18, 2:22, 2:22] = True
    m = torch.from_numpy(mask)
    kw = dict(model=model, guess=guess, mask_frac=1.0, device="cpu")
    for compact in (False, True):
        single = fit_volume(vol, mask, TES, lo, hi, compact=compact, **kw)
        tp = fit_volume(vol, mask, TES, lo, hi, compact=compact, strategy="twophase",
                        tail_frac=0.01, **kw)
        assert int(single.n_overflow) == 0 and int(tp.n_overflow) > 0
        differ = torch.zeros_like(m)
        for name in ("t2", "k", "sigma", "fun", "converged", "n_iter"):
            differ |= getattr(single, name) != getattr(tp, name)
        assert not (differ & ~m).any()
        assert not tp.converged[differ].any()
        assert int(differ.sum()) <= int(tp.n_overflow)


@pytest.mark.parametrize("tail_block", [0, 3, 12, 256])
def test_bad_tail_block_is_rejected(tail_block):
    sig = np.ones((128, 3), np.float32)
    with pytest.raises(ValueError, match="tail_block must divide 128"):
        port.fit_fused(sig, TES, (0.0, 10.0), (1e6, 2000.0), strategy="twophase",
                       tail_block=tail_block, device="cpu")
    with pytest.raises(ValueError, match="tail_block must divide 128"):
        ref.fit_fused(sig, TES, (0.0, 10.0), (1e6, 2000.0), strategy="twophase",
                      tail_block=tail_block, interpret=True)


def test_unknown_strategy_is_rejected():
    with pytest.raises(ValueError, match="unknown strategy"):
        port.fit_fused(np.ones((8, 3), np.float32), TES, (0.0, 10.0), (1e6, 2000.0),
                       strategy="threephase", device="cpu")


def test_tail_resolvers_match_reference():
    for model in FITS:
        for tb in (None, 1, 8, 32):
            assert port.resolve_tail_block(tb, model) == ref.resolve_tail_block(tb, model)
    for frac in (None, 0.1):
        for tb in (1, 8):
            assert port.resolve_tail_frac(frac, tb) == ref.resolve_tail_frac(frac, tb)
    assert port.resolve_strategy("auto") == "single"
    assert port.resolve_strategy("twophase") == "twophase"
