"""The port's registration against the JAX package's, on the same seeded
volumes (tests/test_recon.py's smooth blob scenes at 36^3).

What is held, and to what:
- the metric's sample set (world points and fixed values): equal;
- each metric's value and gradient in the parameters at fixed, non-zero
  parameters, rigid and affine: 1e-5 of the value and 1e-4 of the
  gradient's largest entry (sums over 2^14 samples in another order);
- the solved parameters with ``stop_tol=None`` (the fixed-budget Adam, no
  data-dependent stop) on REG_FAST-like levels: 1e-4 of max(1, |p|)
  (measured: at most 3e-6);
- the plateau early exit: the same per-level iteration counts, and the
  solved transform within the fixed-budget tolerance where the stop is the
  same;
- the multi-pair engine against the single-pair one (the port's single
  solve IS the engine with one pair: equal), against the JAX multi-pair
  engine, and with zero-padded movings of other shapes;
- recovery of a known pose, as the JAX package's own tests require.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu.core.volume import Volume as RefVolume
from fetal_t2mapping_tpu.recon import registration as ref_reg
from fetal_t2mapping_tpu.recon.resample import resample_to_reference as ref_resample_to_reference
from fetal_t2mapping_tpu_torch.core.volume import Volume
from fetal_t2mapping_tpu_torch.parallel import voxel_mesh
from fetal_t2mapping_tpu_torch.recon import registration as reg
from fetal_t2mapping_tpu_torch.recon.resample import resample_to_reference

from test_recon import FAST_REG, _blob_volume, _rigid_world_matrix

torch.set_num_threads(1)

REG_FAST = dict(levels=(2, 1), sigmas=(1.0, 0.0), iters=(8, 4), samples=(512, 512))
PARAM_RTOL = 1e-4
METRICS = ("ncc", "mse", "mi", "cr")


def _port(v) -> Volume:
    return Volume(np.array(v.data), spacing=v.spacing, origin=v.origin, direction=v.direction)


def _pair(seed, rx, ry, rz, t, shape=(36, 36, 36), spacing=(1.5, 1.5, 1.5)):
    fixed = _blob_volume(shape=shape, spacing=spacing, seed=seed)
    T = _rigid_world_matrix(rx, ry, rz, t, np.asarray(fixed.center_world()))
    return fixed, ref_resample_to_reference(fixed, fixed, transform=T), T


@pytest.fixture(scope="module")
def scene():
    fixed, moving, T = _pair(3, 0.05, -0.04, 0.06, [2.0, -1.5, 1.0])
    return fixed, moving, T


def _assert_params_close(got, ref, rtol=PARAM_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))
    assert err <= rtol, f"params differ by {err:.3e} (> {rtol:g}): {got} vs {ref}"


def _assert_recovers(fixed, T_true, matrix, rot_atol=0.02, trans_atol=1.0):
    center = np.asarray(fixed.center_world())
    comp = T_true @ matrix
    np.testing.assert_allclose(comp[:3, :3], np.eye(3), atol=rot_atol)
    assert np.abs(comp[:3, 3] - center + comp[:3, :3] @ center).max() < trans_atol


# ------------------------------------------------------------- sample set
@pytest.mark.parametrize("masked", [False, True])
def test_sample_set_equal(scene, masked):
    fixed = scene[0]
    data = np.asarray(fixed.data)
    mask = (data > np.percentile(data, 70)) if masked else None
    for max_points in (512, 1 << 14):
        r_pts, r_vals = ref_reg._fixed_level_operands(fixed, jnp.asarray(data), fixed.spacing,
                                                      max_points, mask)
        p_pts, p_vals = reg._fixed_level_operands(_port(fixed), torch.from_numpy(data),
                                                  fixed.spacing, max_points, mask)
        np.testing.assert_array_equal(p_pts.numpy(), np.asarray(r_pts))
        np.testing.assert_array_equal(p_vals.numpy(), np.asarray(r_vals))


def test_mask_pyramid_equal(scene):
    mask = np.asarray(scene[0].data) > 0.3
    for a, b in zip(reg._mask_pyramid(mask, (4, 2, 1)), ref_reg._mask_pyramid(mask, (4, 2, 1))):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- metric + grad
def _ref_metric(kind, mode, fixed, moving, level, params):
    levels, sigmas = (2, 1), (1.0, 0.0)
    f_dat, f_sp = ref_reg._device_pyramid(fixed, levels, sigmas)[level]
    m_dat, m_sp = ref_reg._device_pyramid(moving, levels, sigmas)[level]
    ops = ref_reg._level_inputs(fixed, f_dat, f_sp, moving, m_dat, m_sp, max_points=1 << 14)
    center = np.asarray(fixed.center_world(), np.float32)
    if mode == "rigid":
        scale = np.float32(np.linalg.norm(np.asarray(fixed.physical_extent)) / 2.0)
        tf = lambda p: ref_reg._rigid_matrix(p, center, scale)
    else:
        tf = lambda p: ref_reg._affine_matrix(
            jnp.concatenate([p[:9], p[9:] * ref_reg._AFFINE_T_SCALE]), center)
    f, g = jax.value_and_grad(ref_reg._make_metric_fn(kind, tf, *ops))(jnp.asarray(params))
    return float(f), np.asarray(g)


def _port_metric(kind, mode, fixed, moving, level, params):
    fixed, moving = _port(fixed), _port(moving)
    levels, sigmas = (2, 1), (1.0, 0.0)
    f_pyr = reg._device_pyramid(torch.from_numpy(np.array(fixed.data)), fixed.spacing,
                                levels, sigmas)
    m_pyr = reg._device_pyramid(torch.from_numpy(np.array(moving.data)), moving.spacing,
                                levels, sigmas)
    pts, vals = reg._fixed_level_operands(fixed, *f_pyr[level], 1 << 14)
    mov = reg._moving_level_operands([moving], [m_pyr], level)
    center = torch.as_tensor(np.asarray(fixed.center_world(), np.float32))
    scale = torch.as_tensor(np.float32(np.linalg.norm(np.asarray(fixed.physical_extent)) / 2.0))
    metric = reg._make_metric_fn(kind, reg._transform_fn(mode, center, scale), pts, vals, mov)
    f, g = reg._value_and_grad(metric, torch.from_numpy(params)[None])
    return float(f[0]), g[0].numpy()


@pytest.mark.parametrize("kind", METRICS)
@pytest.mark.parametrize("mode", ["rigid", "affine"])
def test_metric_value_and_gradient(scene, kind, mode):
    fixed, moving, _ = scene
    rng = np.random.default_rng(4)
    params = (rng.normal(0, 1.0, 6) if mode == "rigid"
              else rng.normal(0, 0.02, 12)).astype(np.float32)
    for level in (0, 1):
        f_r, g_r = _ref_metric(kind, mode, fixed, moving, level, params)
        f_p, g_p = _port_metric(kind, mode, fixed, moving, level, params)
        assert abs(f_p - f_r) <= 1e-5 * max(abs(f_r), 1e-3), (level, f_p, f_r)
        err = float(np.abs(g_p - g_r).max()) / float(np.abs(g_r).max())
        assert err <= 1e-4, (level, err, g_p, g_r)


# ------------------------------------------------------------ full solves
@pytest.mark.parametrize("kind", METRICS)
@pytest.mark.parametrize("mode", ["rigid", "affine"])
def test_fixed_budget_params_match_reference(scene, kind, mode):
    fixed, moving, _ = scene
    fn, pfn = ((ref_reg.register_rigid, reg.register_rigid) if mode == "rigid"
               else (ref_reg.register_affine, reg.register_affine))
    ref = fn(fixed, moving, metric=kind, stop_tol=None, **REG_FAST)
    got = pfn(_port(fixed), _port(moving), metric=kind, stop_tol=None, device="cpu", **REG_FAST)
    _assert_params_close(got.params, ref.params)
    np.testing.assert_allclose(got.metric_history, ref.metric_history, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.matrix, ref.matrix, atol=1e-4)
    assert got.iters_run is None and got.host_syncs == 0


def test_early_exit_matches_reference():
    """A solve that plateaus inside its budget: the per-level stops agree
    with the JAX while_loop's, and the host read the active flag every
    _CHECK_EVERY iterations only."""
    fixed, moving, T = _pair(5, 0.04, 0.02, -0.05, [2.0, 2.0, -2.0], shape=(24, 24, 24),
                             spacing=(2.0, 2.0, 2.0))
    ref = ref_reg.register_rigid(fixed, moving, **FAST_REG)
    got = reg.register_rigid(_port(fixed), _port(moving), device="cpu", **FAST_REG)
    np.testing.assert_array_equal(got.iters_run, ref.iters_run)
    assert got.iters_run.sum() < sum(FAST_REG["iters"])          # it did stop early
    _assert_params_close(got.params, ref.params)
    assert abs(got.final_metric - ref.final_metric) <= 1e-5
    np.testing.assert_allclose(got.metric_history, ref.metric_history, rtol=1e-4, atol=1e-6)
    assert got.host_syncs <= sum(int(np.ceil(n / reg._CHECK_EVERY)) for n in got.iters_run)
    _assert_recovers(fixed, T, got.matrix)


def test_multi_engine_matches_reference_and_single():
    fixed, mov1, T1 = _pair(7, 0.03, -0.02, 0.04, [2.0, -1.5, 1.0])
    _, mov2, T2 = _pair(7, -0.04, 0.03, -0.03, [-2.0, 2.0, -1.0])
    kw = dict(REG_FAST, stop_tol=None)
    refs = ref_reg.register_rigid_multi(fixed, [mov1, mov2], **kw)
    gots = reg.register_rigid_multi(_port(fixed), [_port(mov1), _port(mov2)], device="cpu", **kw)
    for g, r, m in zip(gots, refs, (mov1, mov2)):
        _assert_params_close(g.params, r.params)
        single = reg.register_rigid(_port(fixed), _port(m), device="cpu", **kw)
        _assert_params_close(g.params, single.params, rtol=1e-5)
    # one pair: the single solve is the engine with P = 1
    (one,) = reg.register_rigid_multi(_port(fixed), [_port(mov1)], device="cpu", **kw)
    single = reg.register_rigid(_port(fixed), _port(mov1), device="cpu", **kw)
    np.testing.assert_array_equal(one.params, single.params)
    np.testing.assert_array_equal(one.metric_history, single.metric_history)


def test_multi_padding_path_matches_reference():
    """Movings of other shapes sit zero-padded in the flat buffer; the
    metric uses their true extents (JAX: m_dims), so each pair solves as
    alone."""
    fixed, mov1, _ = _pair(9, 0.03, -0.02, 0.04, [2.0, -1.5, 1.0])
    _, mov2_full, _ = _pair(9, -0.04, 0.03, -0.03, [-2.0, 2.0, -1.0])
    mov2 = RefVolume(np.asarray(mov2_full.data)[2:-3, 1:-2, 3:], spacing=mov2_full.spacing,
                     origin=tuple(np.asarray(mov2_full.origin)
                                  + np.asarray([3, 1, 2]) * np.asarray(mov2_full.spacing)))
    kw = dict(REG_FAST, stop_tol=None, metric="mi")
    refs = ref_reg.register_rigid_multi(fixed, [mov1, mov2], **kw)
    gots = reg.register_rigid_multi(_port(fixed), [_port(mov1), _port(mov2)], device="cpu", **kw)
    for g, r, m in zip(gots, refs, (mov1, mov2)):
        _assert_params_close(g.params, r.params)
        single = reg.register_rigid(_port(fixed), _port(m), device="cpu", **kw)
        _assert_params_close(g.params, single.params, rtol=1e-5)


def test_affine_multi_matches_reference(scene):
    fixed, moving, _ = scene
    kw = dict(REG_FAST, stop_tol=None, metric="cr")
    (r,) = ref_reg.register_affine_multi(fixed, [moving], **kw)
    (g,) = reg.register_affine_multi(_port(fixed), [_port(moving)], device="cpu", **kw)
    _assert_params_close(g.params, r.params)


@pytest.mark.parametrize("mask_kind", ["array", "auto"])
def test_fixed_mask_matches_reference(scene, mask_kind):
    fixed, moving, _ = scene
    data = np.asarray(fixed.data)
    mask = (data > np.percentile(data, 60)) if mask_kind == "array" else "auto"
    fixed_auto = RefVolume(data * 100.0, spacing=fixed.spacing, origin=fixed.origin)
    moving_auto = RefVolume(np.asarray(moving.data) * 100.0, spacing=moving.spacing,
                            origin=moving.origin)
    f, m = (fixed, moving) if mask_kind == "array" else (fixed_auto, moving_auto)
    kw = dict(REG_FAST, stop_tol=None, fixed_mask=mask)
    ref = ref_reg.register_rigid(f, m, **kw)
    got = reg.register_rigid(_port(f), _port(m), device="cpu", **kw)
    _assert_params_close(got.params, ref.params)


# -------------------------------------------------------------- recovery
def test_rigid_recovers_pose():
    """tests/test_recon.py's recovery scene and gates; the JAX package's
    solve of it lands on the same transform."""
    fixed, moving, T = _pair(3, 0.05, -0.04, 0.06, [3.0, -2.0, 2.5], shape=(24, 24, 24),
                             spacing=(2.0, 2.0, 2.0))
    got = reg.register_rigid(_port(fixed), _port(moving), device="cpu", **FAST_REG)
    _assert_recovers(fixed, T, got.matrix)
    ref = ref_reg.register_rigid(fixed, moving, **FAST_REG)
    np.testing.assert_allclose(got.matrix, ref.matrix, atol=1e-3)
    warped = resample_to_reference(_port(moving), _port(fixed), transform=got.matrix,
                                   device="cpu")
    inner = np.s_[4:-4, 4:-4, 4:-4]
    ncc = np.corrcoef(np.asarray(fixed.data)[inner].ravel(), warped.data[inner].ravel())[0, 1]
    assert ncc > 0.98
    assert got.final_metric < -0.9


def test_multi_each_pair_recovers_its_pose():
    fixed, mov1, T1 = _pair(3, 0.05, -0.04, 0.06, [3.0, -2.0, 2.5], shape=(24, 24, 24),
                            spacing=(2.0, 2.0, 2.0))
    _, mov2, T2 = _pair(3, -0.06, 0.03, -0.02, [-2.5, 3.0, -1.5], shape=(24, 24, 24),
                        spacing=(2.0, 2.0, 2.0))
    regs = reg.register_rigid_multi(_port(fixed), [_port(mov1), _port(mov2)], device="cpu",
                                    **FAST_REG)
    for T, r in zip((T1, T2), regs):
        _assert_recovers(fixed, T, r.matrix, rot_atol=0.03, trans_atol=1.2)


def test_warm_start_and_device_views(scene):
    fixed, moving, _ = scene
    full = reg.register_rigid(_port(fixed), _port(moving), device="cpu", **FAST_REG)
    # params_device feeds straight back as init_params (the hf->lf chain)
    warm = reg.register_rigid(_port(fixed), _port(moving), init_params=full.params_device,
                              device="cpu", **dict(FAST_REG, iters=(16, 8)))
    assert warm.final_metric <= full.final_metric + 0.01
    assert torch.is_tensor(full.matrix_device) and full.matrix_device.dtype == torch.float32
    np.testing.assert_array_equal(full.matrix, full.matrix_device.numpy().astype(np.float64))
    assert full.params.shape == (6,)


def test_register_and_resample_matches_reference(scene):
    fixed, moving, _ = scene
    kw = dict(REG_FAST, stop_tol=None)
    ref = np.asarray(ref_reg.register_and_resample(fixed, moving, **kw).data)
    got = reg.register_and_resample(_port(fixed), _port(moving), device="cpu", **kw).data
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_argument_errors(scene):
    fixed, moving = _port(scene[0]), _port(scene[1])
    with pytest.raises(ValueError, match="samples"):
        reg.register_rigid(fixed, moving, samples=(512,), device="cpu", **{
            k: v for k, v in REG_FAST.items() if k != "samples"})
    with pytest.raises(ValueError, match="lengths differ"):
        reg.register_rigid(fixed, moving, levels=(2, 1), sigmas=(1.0,), iters=(4, 2),
                           samples=(64, 64), device="cpu")
    with pytest.raises(ValueError, match="init_params"):
        reg.register_rigid_multi(fixed, [moving], init_params=np.zeros((2, 6)),
                                 device="cpu", **REG_FAST)
    with pytest.raises(ValueError, match="fixed_mask"):
        reg.register_rigid(fixed, moving, fixed_mask="nope", device="cpu", **REG_FAST)
    with pytest.raises(ValueError, match="empty"):
        reg.register_rigid(fixed, moving, fixed_mask=np.zeros(fixed.shape, bool),
                           device="cpu", **REG_FAST)
    # a mesh with more devices than a level has samples (the sharded
    # registration itself: tests/test_torch_mesh.py)
    with pytest.raises(ValueError, match="metric samples"):
        reg.register_rigid(fixed, moving, mesh=voxel_mesh(devices=["cpu"] * 5),
                           **dict(REG_FAST, samples=(1, 1)))
    assert reg.register_rigid_multi(fixed, [], device="cpu") == []
