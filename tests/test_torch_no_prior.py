"""The port's no-prior 3-parameter fit (``fit_stack`` with ``prior=False``:
``fit_batch_multistart`` over the log-linear, grid and guess starts) on the
CPU against the JAX package's on the CPU, and on the card against the CPU.

The data is the first 16^3 block of the seed-23 240^3 session that
``chip_smoke.py`` phase 10 fits (``tests/data/no_prior_block.npz``, made by
``python -c "import numpy as np, chip_smoke as cs; b = {m: cs.no_prior_block(m)
for m in ('gaussian_rician', 'rician')}; np.savez_compressed(
'tests/data/no_prior_block.npz', **{f'{m}_echoes': np.stack(e) for m, (e, i, t)
in b.items()}, **{f'{m}_ident': i for m, (e, i, t) in b.items()})"``).

The bands are the bench's (bench.py:638-652: k and T2 1e-2 relative,
objective 3e-2) on the identifiable voxels both sides converged, the
convergence rates within 0.01, and a voxel outside them needs a witness,
as in ``test_torch_twophase.py``: the float64 objectives at the two answers
within each other's band (two equally good minima), or rounding-sensitive
(one side's own answer leaves the bands when the echoes move by one
float32 ulp), the voxels refitted alone (a voxel's answer does not depend
on its batch).

Voxel 127 of the gaussian_rician block has neither. Three echoes and three
parameters: it has an exact interpolant (sigma ~239, objective ~1e-8), and
the sigma = 2 face of its box holds a saddle of the objective (the (k, T2)
optimum there, objective 0.584, where g_sigma < 0 and H_sigma,sigma < 0).
A start near that saddle takes Newton steps whose sigma part, damped with
lambda < 1, points into the bound; the float32 objective cannot resolve
their decrease, so whether the first trial steps are accepted (and the
start stops at the saddle: the attempted step vanishes) or rejected until
lambda > 1 turns the sigma step inward (and the start reaches the
interpolant) turns on rounding. The port's CPU reaches the interpolant;
the JAX package and the port on the card stop at the saddle. The card
rounds three ops of the fit differently from the CPU for the same inputs
(``chip_smoke.ROUNDING_OPS``: the sum and the mean over the echoes, the
exponential); replaying the card's bits at those three ops on the CPU
(``tests/data/no_prior_card_bits_gaussian_rician_127.npz``, written by
``chip_smoke.localise_no_prior()`` on an NVIDIA H100 80GB HBM3, torch
2.11.0+cu128) gives the card's answer bit for bit, and that answer lies in
the JAX package's bands.

The ``cuda`` case holds the card against the CPU on the block as
``chip_smoke.py`` phase 10 does (``guess_bands``, with its third witness:
the CPU's fit with ``ROUNDING_OPS`` evaluated on the card).
"""

import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.core.stack import EchoStack
from fetal_t2mapping_tpu_torch.core.volume import Volume
from fetal_t2mapping_tpu_torch.models import t2map
from fetal_t2mapping_tpu_torch.models.oracle import _objective

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
MODELS = {"gaussian_rician": (True, (114.0, 202.0, 299.0)),
          "rician": (False, (115.0, 202.0, 299.0))}
BANDS = (1e-2, 3e-2)
VOXEL = 127   # gaussian_rician: the card and the JAX package stop at the saddle
CARD_BITS = os.path.join(DATA, "no_prior_card_bits_gaussian_rician_127.npz")


def _block(model):
    """(echoes (3, 16, 16, 16) float32, identifiable voxels (16, 16, 16))."""
    d = np.load(os.path.join(DATA, "no_prior_block.npz"))
    return d[f"{model}_echoes"], d[f"{model}_ident"]


def _cols(o):
    """(x (k, T2, sigma), fun, converged) of a fit_stack output of either
    package, voxels in the volume's flat order."""
    x = np.stack([np.asarray(getattr(o, n).data).ravel() for n in ("k", "t2", "sigma")], axis=1)
    return x, np.asarray(o.fun.data).ravel(), np.asarray(o.converged.data).ravel() > 0.5


def _port(model, echoes, device="cpu"):
    low_field, tes = MODELS[model]
    mask = Volume(np.ones(echoes[0].shape, np.uint8))
    stack = EchoStack.from_volumes([Volume(np.ascontiguousarray(e)) for e in echoes],
                                   [mask] * len(tes), tes)
    return _cols(t2map.fit_stack(stack, C.fit_config(model, low_field, prior=False),
                                 device=device))


def _ref(model, echoes):
    from fetal_t2mapping_tpu import config as ref_C
    from fetal_t2mapping_tpu.core import stack as ref_stack
    from fetal_t2mapping_tpu.core.volume import Volume as RefVolume
    from fetal_t2mapping_tpu.models import t2map as ref_t2map

    low_field, tes = MODELS[model]
    mask = RefVolume(np.ones(echoes[0].shape, np.uint8))
    stack = ref_stack.EchoStack.from_volumes([RefVolume(np.ascontiguousarray(e))
                                              for e in echoes], [mask] * len(tes), tes)
    return _cols(ref_t2map.fit_stack(stack, ref_C.fit_config(model, low_field, prior=False)))


def _outside(a, b, ident):
    """The ``ident`` voxels where fits a and b leave the bands."""
    rel_x = (np.abs(a[0] - b[0]) / np.maximum(np.abs(b[0]), 1.0))[:, :2].max(axis=1)
    rel_f = np.abs(a[1] - b[1]) / np.maximum(np.abs(b[1]), 1.0)
    return ident & ~((rel_x <= BANDS[0]) & (rel_f <= BANDS[1]))


def _witnessed(model, echoes, a, b, out, fit_a, fit_b):
    """Per voxel of ``out`` (flat indices outside the bands between fits
    a and b): (equally good, rounding-sensitive), the one-ulp fits of each
    side (``fit_a`` / ``fit_b`` of echoes) run on those voxels alone."""
    te = np.asarray(MODELS[model][1], np.float64)
    sig = np.stack([e.ravel() for e in echoes], axis=1)
    objective = _objective(model)
    f64 = np.array([[objective(x[i].astype(np.float64), te, sig[i].astype(np.float64))
                     for x in (a[0], b[0])] for i in out]).reshape(-1, 2)
    equal = np.abs(f64[:, 0] - f64[:, 1]) <= BANDS[1] * np.maximum(np.abs(f64).min(axis=1), 1.0)
    sensitive = np.zeros(out.size, bool)
    sub = [c[:, None, None] for c in sig[out].T]
    for fit in (fit_a, fit_b) if out.size else ():
        own = fit(sub)
        for towards in (np.inf, 0.0):
            other = fit([np.nextafter(e, np.float32(towards)) for e in sub])
            sensitive |= _outside(other, own, np.ones(out.size, bool))
    return equal, sensitive


@pytest.mark.parametrize("model", sorted(MODELS))
def test_no_prior_block_matches_reference(model):
    """The port's CPU fit of the block against the JAX package's: every
    voxel outside the bands has a witness, but gaussian_rician's voxel 127,
    which is the only one without (see test_card_exponent_bits_give_the_
    card_answer for why)."""
    echoes, ident = _block(model)
    port, ref = _port(model, echoes), _ref(model, echoes)
    assert port[0].shape == (echoes[0].size, 3) and np.isfinite(port[0]).all()
    assert abs(float(port[2].mean()) - float(ref[2].mean())) <= 0.01
    both = ident.ravel() & port[2] & ref[2]
    assert both.sum() >= 16
    out = np.flatnonzero(_outside(port, ref, both))
    equal, sensitive = _witnessed(model, echoes, port, ref, out,
                                  lambda e: _port(model, e), lambda e: _ref(model, e))
    bare = out[~equal & ~sensitive].tolist()
    print(f"{model}: {out.size} of {both.sum()} outside the bands, {int(equal.sum())} equally "
          f"good, {int(sensitive.sum())} rounding-sensitive, without either {bare}")
    assert bare == ([VOXEL] if model == "gaussian_rician" else [])


class CardBits(TorchDispatchMode):
    """Replays the card's recorded results (``chip_smoke.card_bits``) at
    the ops in ``names``: the exponential per element by its input bits,
    the sum and the mean per call by the input's bits and the two shapes.
    Counts the values replaced (``hits``) and those the record lacks
    (``misses``, left as the CPU computed them)."""

    NAMES = ("aten.sum.dim_IntList", "aten.mean.dim", "aten.exp.default")

    def __init__(self, names=NAMES):
        super().__init__()
        d = np.load(CARD_BITS)
        self.names, self.hits, self.misses = set(names), 0, 0
        self.exp = dict(zip(d["exp_in"].tolist(), d["exp_out"].tolist()))
        self.red = {}
        i = o = 0
        for kind, si, so in zip(d["red_kind"], d["red_in_shape"], d["red_out_shape"]):
            si, so = tuple(int(v) for v in si if v >= 0), tuple(int(v) for v in so if v >= 0)
            ni, no = int(np.prod(si)), int(np.prod(so))
            key = (self.NAMES[kind], si, so, d["red_in"][i:i + ni].tobytes())
            self.red[key] = d["red_out"][o:o + no].reshape(so)
            i, o = i + ni, o + no

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if name not in self.names:
            return out
        x = args[0].detach().contiguous().numpy()
        if name == "aten.exp.default":
            bits = out.detach().contiguous().numpy().copy().ravel().view(np.int32)
            for j, k in enumerate(x.ravel().view(np.int32).tolist()):
                if k in self.exp:
                    bits[j] = self.exp[k]
                    self.hits += 1
                else:
                    self.misses += 1
            return torch.from_numpy(bits.view(np.float32).reshape(tuple(out.shape)))
        card = self.red.get((name, x.shape, tuple(out.shape), x.tobytes()))
        if card is None:
            self.misses += 1
            return out
        self.hits += 1
        return torch.from_numpy(card.copy())


def _multistart_127(names=None):
    """Voxel 127's no-prior fit on the CPU through chip_smoke's recorded
    eager loop (fit_stack's starts, multistart and argmin), with the card's
    bits replayed at ``names``: (x, f, the replay mode or None)."""
    import chip_smoke as cs

    d = np.load(CARD_BITS)
    cfg = C.fit_config("gaussian_rician", True, prior=False)
    mode = CardBits(names) if names is not None else None
    if mode is None:
        r = cs.multistart_steps(d["signal"], d["tes"], cfg, "cpu")
    else:
        with mode:
            r = cs.multistart_steps(d["signal"], d["tes"], cfg, "cpu")
    return r["x"][r["best"][0], 0], r["f"][r["best"][0], 0], mode


def test_recorded_loop_is_fit_stack_at_voxel_127():
    """chip_smoke's recorded loop gives fit_stack's answer, bit for bit: the
    replays below run the fit the pipeline runs."""
    echoes, _ = _block("gaussian_rician")
    sig = echoes.reshape(3, -1)[:, VOXEL]
    assert np.array_equal(np.load(CARD_BITS)["signal"][0].view(np.int32), sig.view(np.int32))
    x, f, _ = _multistart_127()
    port = _port("gaussian_rician", [c.reshape(1, 1, 1) for c in sig])
    assert np.array_equal(x.view(np.int32), port[0][0].view(np.int32))
    assert np.array_equal(np.float32(f).view(np.int32), port[1][:1].view(np.int32)[0])


@pytest.mark.parametrize("replay", ["none", "reductions", "all"])
def test_card_bits_give_the_card_answer(replay):
    """Voxel 127 on the CPU: without the card's bits, the interpolant; with
    the card's sums and means over the echoes, the saddle on the sigma
    bound (in the card's bands); with its sums, means and exponentials,
    the card's answer bit for bit, every value the CPU asked for found in
    the record."""
    d = np.load(CARD_BITS)
    names = {"none": None, "reductions": CardBits.NAMES[:2], "all": CardBits.NAMES}[replay]
    x, f, mode = _multistart_127(names)
    card_x, card_f = d["card_x"], d["card_f"]
    if replay == "none":
        assert f < 1e-6 and x[2] > 100.0
        return
    assert _outside((x[None], np.float32(f)[None]), (card_x[None], card_f[None]),
                    np.ones(1, bool)).sum() == 0
    assert x[2] == 2.0 and mode.hits > 0
    if replay == "all":
        assert mode.misses == 0
        assert np.array_equal(x.view(np.int32), card_x.view(np.int32))


def test_voxel_127_card_answer_is_the_saddle_the_reference_finds():
    """The card's answer at voxel 127 in float64: on the sigma bound, the
    gradient points into the box and the curvature along sigma is negative
    (a saddle, not a minimum of the box); the interpolant is ~1e-8 of its
    objective; and the JAX package's CPU answer lies in the card's bands."""
    from fetal_t2mapping_tpu_torch.models.signal import make_value_grad_hess

    d = np.load(CARD_BITS)
    fgh = make_value_grad_hess("gaussian_rician")
    x = torch.from_numpy(d["card_x"][None].astype(np.float64))
    f, g, h = fgh(x, torch.from_numpy(d["tes"].astype(np.float64)),
                  torch.from_numpy(d["signal"].astype(np.float64)))
    assert float(g[0, 2]) < 0.0 and float(h[0, 2, 2]) < 0.0 and float(f[0]) > 0.5
    echoes, _ = _block("gaussian_rician")
    sig = [c.reshape(1, 1, 1) for c in echoes.reshape(3, -1)[:, VOXEL]]
    port, ref = _port("gaussian_rician", sig), _ref("gaussian_rician", sig)
    assert float(port[1][0]) < 1e-6 * float(f[0])
    assert _outside(ref, (d["card_x"][None], d["card_f"][None]), np.ones(1, bool)).sum() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(MODELS))
def test_no_prior_block_card_vs_cpu(model):
    """The block on the card against the CPU, gated as chip_smoke.py phase
    10 gates it: no voxel outside the bands without a witness."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    import chip_smoke as cs

    echoes, ident = _block(model)
    cfg = C.fit_config(model, MODELS[model][0], prior=False)
    tes = MODELS[model][1]
    text = cs.guess_bands(model, lambda e, dev: t2map.fit_stack(cs.fully_masked(e, tes), cfg,
                                                                device=dev),
                          list(echoes), tes, ident, "card vs CPU on the 16^3 block",
                          label="no prior", per_voxel=True, show=None)
    print(text)
    assert "without a witness: 0 []" in text
