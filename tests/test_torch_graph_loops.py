"""The port's two solver loops as in-place steps, the functions that are
captured as CUDA graphs on the card (``fetal_t2mapping_tpu_torch.graphs``):
the convergence-trace sampler (``solver._fit_batch_traced_steps``) and the
registration levels (``registration._level_while_steps`` /
``_level_scan_steps``).

On the CPU each step, driven eagerly, is held bitwise to the eager loop it
replaces (``_fit_batch_traced_loop``, ``_level_while``, ``_level_scan``):
the traces of the three models at both tolerance sets; whole rigid and
affine solves (ncc, mi, cr; one pair and two) with their parameters,
histories, stop iterations and best metrics; and a plateau stop that falls
between two host reads of the active flag. The ``cuda`` cases run on the
card (``python3 -m pytest --noconftest tests/test_torch_graph_loops.py``):
graph against the eager loop there, bitwise, and a second call that
replays the cached trace graph.

Imports nothing of JAX: the JAX package is held against these loops in
``test_torch_solver.py`` and ``test_torch_registration.py``.
"""

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu_torch import graphs
from fetal_t2mapping_tpu_torch.core.volume import Volume
from fetal_t2mapping_tpu_torch.models import init, solver
from fetal_t2mapping_tpu_torch.recon import registration as reg
from fetal_t2mapping_tpu_torch.recon.resample import resample_to_reference

torch.set_num_threads(1)

TES = (114.0, 202.0, 299.0)
BOUNDS = {  # config's low-field gaussian box and the bench's 3-parameter boxes
    "gaussian": ((600.0, 10.0), (10000.0, 600.0)),
    "gaussian_rician": ((1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0)),
    "rician": ((1.0, 10.0, 1e-2), (1e6, 2000.0, 1000.0)),
}
TOLS = {"pipeline": (1e-9, 0.0), "bench": (1e-2, 1e-2)}
# a short patience, so the plateau exit stops most levels inside the budget
REG_SMALL = dict(levels=(2, 1), sigmas=(1.0, 0.0), iters=(60, 40), samples=(512, 512),
                 stop_window=8)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, so NaNs compare equal to themselves."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bitwise(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert torch.equal(_bits(a), _bits(b)), what


def _signal(model, n=50, seed=4):
    rng = np.random.default_rng(seed)
    te = np.asarray(TES, np.float32)
    k = rng.uniform(700.0, 5000.0, n).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, n).astype(np.float32)
    a = k[:, None] * np.exp(-te[None, :] / t2[:, None])
    if model == "gaussian":
        sig = np.maximum(a + rng.normal(0, 8.0, a.shape), 1e-2)
    else:   # Rician magnitude
        sig = np.hypot(a + rng.normal(0, 8.0, a.shape), rng.normal(0, 8.0, a.shape))
    return torch.from_numpy(sig.astype(np.float32))


def _traced_pair(model, tol, device, n=50, seed=4):
    """(eager loop, in-place steps) on the same inputs; the steps as a
    graph where ``device`` is a card."""
    lo, hi = BOUNDS[model]
    ftol, gtol = TOLS[tol]
    sig = _signal(model, n, seed).to(device)
    x0 = init.loglinear_init(sig, TES, lo, hi)
    kw = dict(model=model, max_iters=60, ftol=ftol, gtol=gtol)
    loop = solver._fit_batch_traced_loop(sig, TES, x0, lo, hi, **kw)
    steps = solver._fit_batch_traced_steps(sig, TES, x0, lo, hi, graph=sig.is_cuda, **kw)
    return loop, steps


def _assert_traced_equal(loop, steps, what):
    (ra, ta), (rb, tb) = loop, steps
    for name in ("x", "fun", "converged", "n_iter"):
        _assert_bitwise(getattr(ra, name), getattr(rb, name), f"{what} {name}")
    assert set(ta) == set(tb) == {"f_val", "step_size", "active"}
    for name in ta:
        _assert_bitwise(ta[name], tb[name], f"{what} trace {name}")


@pytest.mark.parametrize("tol", sorted(TOLS))
@pytest.mark.parametrize("model", sorted(BOUNDS))
def test_traced_steps_equal_loop(model, tol):
    loop, steps = _traced_pair(model, tol, "cpu")
    _assert_traced_equal(loop, steps, f"{model} {tol}")
    assert loop[1]["f_val"].shape == (60, 50)
    # some voxels converge inside the budget, so the freeze is exercised
    assert 0 < int(loop[1]["active"][-1].sum()) < 50 or bool(loop[0].converged.all())


def test_fit_batch_traced_on_cpu_is_the_loop():
    lo, hi = BOUNDS["rician"]
    sig = _signal("rician", seed=9)
    x0 = init.loglinear_init(sig, TES, lo, hi)
    kw = dict(model="rician", max_iters=60, ftol=1e-9, gtol=0.0)
    _assert_traced_equal(solver._fit_batch_traced_loop(sig, TES, x0, lo, hi, **kw),
                         solver.fit_batch_traced(sig, TES, x0, lo, hi, **kw), "rician")


# ---------------------------------------------------------- registration
def _blob(n=28, spacing=1.5, seed=3):
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    data = np.zeros((n,) * 3, np.float32)
    for _ in range(6):
        cz, cy, cx = rng.uniform(6, n - 6, 3)
        s, a = rng.uniform(2, 4), rng.uniform(0.5, 1.5)
        data += a * np.exp(-((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return Volume(data.astype(np.float32), spacing=(spacing,) * 3, origin=(-20.0,) * 3)


def _rigid(rx, ry, rz, t, center):
    cx, sx, cy, sy, cz, sz = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz)
    R = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
         @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
         @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = center - R @ center + np.asarray(t)
    return T


@pytest.fixture(scope="module")
def reg_scene():
    fixed = _blob()
    c = np.asarray(fixed.center_world())
    movings = [resample_to_reference(fixed, fixed, transform=_rigid(*pose, c), device="cpu")
               for pose in ((0.05, -0.04, 0.06, [2.0, -1.5, 1.0]),
                            (-0.03, 0.05, -0.02, [-1.5, 1.0, -2.0]))]
    # a cross-contrast copy for the histogram metrics
    movings = [m.with_data(200.0 * np.sqrt(np.asarray(m.data) / 1.5)) for m in movings]
    return fixed, movings


def _with_steps(monkeypatch, graph=False):
    """Route _register's levels through the in-place steps (on the CPU it
    runs the eager loops)."""
    monkeypatch.setattr(reg, "_level_while", lambda *a: reg._level_while_steps(*a, graph=graph))
    monkeypatch.setattr(reg, "_level_scan", lambda *a: reg._level_scan_steps(*a, graph=graph))


def _solve(fixed, movings, mode, metric, device="cpu", **kw):
    fn = reg.register_rigid_multi if mode == "rigid" else reg.register_affine_multi
    return fn(fixed, movings, metric=metric, device=device, **dict(REG_SMALL, **kw))


def _assert_solves_equal(a, b, what):
    for ra, rb in zip(a, b, strict=True):
        _assert_bitwise(ra.params_device, rb.params_device, f"{what} params")
        for ha, hb in zip(ra._solve["hist"], rb._solve["hist"], strict=True):
            _assert_bitwise(ha, hb, f"{what} history")
        if ra.iters_run is None:
            assert rb.iters_run is None
        else:
            np.testing.assert_array_equal(ra.iters_run, rb.iters_run, err_msg=what)
            _assert_bitwise(ra._solve["final_f"], rb._solve["final_f"], f"{what} best_f")
        assert ra.host_syncs == rb.host_syncs, what


@pytest.mark.parametrize("pairs", [1, 2])
@pytest.mark.parametrize("mode", ["rigid", "affine"])
@pytest.mark.parametrize("metric", ["ncc", "mi", "cr"])
def test_level_while_steps_equal_loop(reg_scene, monkeypatch, metric, mode, pairs):
    fixed, movings = reg_scene
    lr = {"rigid": 0.5, "affine": 0.02}[mode]
    loop = _solve(fixed, movings[:pairs], mode, metric, lr=lr)
    with monkeypatch.context() as mp:
        _with_steps(mp)
        steps = _solve(fixed, movings[:pairs], mode, metric, lr=lr)
    _assert_solves_equal(loop, steps, f"{metric} {mode} x{pairs}")
    assert (loop[0].iters_run < np.asarray(REG_SMALL["iters"])).any()   # a level stopped early


@pytest.mark.parametrize("metric", ["ncc", "mi"])
def test_level_scan_steps_equal_loop(reg_scene, monkeypatch, metric):
    fixed, movings = reg_scene
    loop = _solve(fixed, movings, "rigid", metric, stop_tol=None, iters=(8, 5))
    with monkeypatch.context() as mp:
        _with_steps(mp)
        steps = _solve(fixed, movings, "rigid", metric, stop_tol=None, iters=(8, 5))
    _assert_solves_equal(loop, steps, f"scan {metric}")
    assert loop[0].iters_run is None and loop[0].metric_history.shape == (13,)


def _toy_f_g(target):
    """A convex bowl per pair, ``f(p) = sum((p - target)^2)``: Adam at a
    fixed rate circles its minimum, so the plateau exit fires."""
    def f_g(p):
        d = p - target
        return (d * d).sum(-1), 2.0 * d
    return f_g


def test_stop_between_host_reads():
    """The level stops at an iteration that is not a multiple of
    _CHECK_EVERY: the steps run after the stop until the next host read
    are not committed, in the loop and in the in-place steps alike."""
    target = torch.tensor([[1.0, -2.0, 0.5], [0.3, 0.2, -0.1]])
    params = torch.zeros_like(target)
    lr = torch.tensor(0.3)
    args = (_toy_f_g(target), params, lr, 200, 1e-3, 7)
    loop = reg._level_while(*args)
    steps = reg._level_while_steps(*args, graph=False)
    t_end = int(loop[2])
    assert t_end < 200 and t_end % reg._CHECK_EVERY != 0
    assert loop[4] == steps[4] == t_end // reg._CHECK_EVERY + 1     # host reads
    for a, b, what in zip(loop[:4], steps[:4], ("best_p", "hist", "t_end", "best_f")):
        _assert_bitwise(a, b, what)
    assert bool((loop[1][t_end:] == loop[3][None, :]).all())      # tail reads the best


def test_bias_table_rows_are_the_eager_denominators():
    table = reg._bias_table(150, torch.device("cpu"))
    assert table.shape[0] >= 150
    for t in (1, 2, 3, 7, 150):
        d1, d2 = reg._bias_denominators(t, torch.device("cpu"))
        _assert_bitwise(table[t - 1, 0], d1, f"1 - 0.9^{t}")
        _assert_bitwise(table[t - 1, 1], d2, f"1 - 0.999^{t}")


# ------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tol", sorted(TOLS))
@pytest.mark.parametrize("model", sorted(BOUNDS))
def test_traced_graph_equals_eager_on_card(card, model, tol):
    loop, graph = _traced_pair(model, tol, card)
    _assert_traced_equal(loop, graph, f"{model} {tol}")
    # a second call with other inputs replays the cached graph: no capture
    captures, replays = graphs.CAPTURES, graphs.REPLAYS
    loop2, graph2 = _traced_pair(model, tol, card, seed=11)
    assert graphs.CAPTURES == captures and graphs.REPLAYS == replays + 60
    _assert_traced_equal(loop2, graph2, f"{model} {tol} (cached graph)")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,metric", [("rigid", "ncc"), ("rigid", "mi"), ("affine", "cr")])
def test_registration_graph_equals_eager_on_card(card, reg_scene, monkeypatch, mode, metric):
    fixed, movings = reg_scene
    lr = {"rigid": 0.5, "affine": 0.02}[mode]
    replays = graphs.REPLAYS
    graph = _solve(fixed, movings, mode, metric, device=card, lr=lr)
    n_exec = [int(t) for t in graph[0].iters_run]
    # one replay per iteration after each level's first, up to the host read
    # that saw the stop
    assert graphs.REPLAYS - replays >= sum(n_exec) - len(n_exec)
    with monkeypatch.context() as mp:
        mp.setattr(reg, "_level_while_steps", lambda *a, graph: reg._level_while(*a))
        mp.setattr(reg, "_level_scan_steps", lambda *a, graph: reg._level_scan(*a))
        eager = _solve(fixed, movings, mode, metric, device=card, lr=lr)
    _assert_solves_equal(graph, eager, f"{metric} {mode} on the card")
