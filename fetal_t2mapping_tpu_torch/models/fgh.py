"""Hand-fused (value, gradient, Hessian) of the 3-parameter fit objectives.

The counterpart of ``fetal_t2mapping_tpu.models.fgh`` for the
gaussian_rician and rician models, in plain elementwise PyTorch: each
function takes a parameter tuple of tensors of any shape (one value per
voxel in the fits), the per-echo signal list ``s`` and the static echo
times ``te``, unrolls the echo axis in Python and returns (f, g, H) with
g and H as tuples. These are the math of the 3-parameter kernels' plain
versions (``models.fused_fit``), and the CUDA kernels in ``csrc/fit3.cu``
follow them op for op.

Objectives (the reference's, run_t2mapping.py:129-177):
- gaussian_rician: f = mean_t (s - sqrt(k^2 e^2 + sigma^2))^2, e = exp(-te/t2)
- rician:          f = -sum_t [log s - log sigma^2 - (|s|-|m|)^2/(2 sigma^2)
                              + log i0e(x)],  x = m s / sigma^2, m = k e
  in the fp32-stable squared-difference form (see the JAX package's
  module docstring).

Constants enter as float32 values, as the reference's Python floats do.
Every division by a constant is a true division by a device scalar: a
tensor divided by a Python float on CUDA is a multiply by its reciprocal,
which rounds differently from the kernels' IEEE division.
"""

from __future__ import annotations

import functools

import torch

# Abramowitz & Stegun 9.8.1-9.8.4 polynomial approximations (|eps|<2e-7),
# on the exponentially scaled functions so large x never overflows.
_I0_SMALL = (1.0, 3.5156229, 3.0899424, 1.2067492, 0.2659732, 0.0360768, 0.0045813)
_I0_LARGE = (0.39894228, 0.01328592, 0.00225319, -0.00157565, 0.00916281,
             -0.02057706, 0.02635537, -0.01647633, 0.00392377)
_I1_SMALL = (0.5, 0.87890594, 0.51498869, 0.15084934, 0.02658733, 0.00301532,
             0.00032411)
_I1_LARGE = (0.39894228, -0.03988024, -0.00362018, 0.00163801, -0.01031555,
             0.02282967, -0.02895312, 0.01787654, -0.00420059)

_LOG_EPS = 1e-20


@functools.lru_cache(maxsize=256)
def _scalar_on(c: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(c, dtype=dtype, device=device)


def scalar(c: float, like: torch.Tensor) -> torch.Tensor:
    """``c`` as a 0-dim tensor on ``like``'s device (cached per device)."""
    return _scalar_on(float(c), like.dtype, like.device)


def cdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE division on every backend."""
    return x / scalar(c, x)


def rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x as an IEEE division (``c / tensor`` is reciprocal * c)."""
    return scalar(c, x) / x


def _poly(coeffs, z):
    """Horner from the last coefficient, as the reference's ``_poly``."""
    acc = torch.full_like(z, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc = acc * z + c
    return acc


def i0e(x):
    """exp(-|x|) * I0(x), elementwise, fp32-safe for all x >= 0."""
    x = torch.abs(x)
    small = _poly(_I0_SMALL, torch.square(cdiv(x, 3.75))) * torch.exp(-x)
    r = rdiv(3.75, torch.clamp(x, min=3.75))
    large = _poly(_I0_LARGE, r) / torch.sqrt(torch.clamp(x, min=3.75))
    return torch.where(x < 3.75, small, large)


def i1e(x):
    """exp(-|x|) * I1(x) for x >= 0 (odd part folded into the caller)."""
    x = torch.abs(x)
    small = _poly(_I1_SMALL, torch.square(cdiv(x, 3.75))) * x * torch.exp(-x)
    r = rdiv(3.75, torch.clamp(x, min=3.75))
    large = _poly(_I1_LARGE, r) / torch.sqrt(torch.clamp(x, min=3.75))
    return torch.where(x < 3.75, small, large)


def bessel_ratio(x):
    """R(x) = I1(x)/I0(x), the score of the Rician log-likelihood."""
    return i1e(x) / torch.clamp(i0e(x), min=1e-30)


def _exps(t2, te):
    u_inv = -1.0 / t2
    return [torch.exp(t * u_inv) for t in te]


# ------------------------------------------------------- gaussian_rician
def gaussian_rician_fgh(params, s, te, e_list=None):
    """Full-Newton (f, g, H) of the first-moment Rician-corrected mean-SSE.

    Model M = sqrt(q), q = a^2 + sigma^2, a = k exp(-te/t2); second
    derivatives via d2M = d2q/(2M) - dq_x dq_y/(4 M^3). ``e_list``: the
    precomputed [exp(-te_i/t2)] at ``params`` (the fits carry it)."""
    k, t2, sg = params
    inv_t = 1.0 / len(te)
    e_all = _exps(t2, te) if e_list is None else e_list
    zero = torch.zeros_like(k)
    f = zero
    g = [zero] * 3
    h = [[zero] * 3 for _ in range(3)]
    sg2 = sg * sg
    inv_t2 = 1.0 / t2
    for st, t, e in zip(s, te, e_all):
        a = k * e
        u = rdiv(t, t2 * t2)
        a2 = a * a
        q = a2 + sg2
        M = torch.sqrt(torch.clamp(q, min=1e-30))
        r = st - M
        inv_m = 1.0 / M
        qk = 2.0 * k * e * e
        qt = 2.0 * a2 * u
        qs = 2.0 * sg
        mk = 0.5 * qk * inv_m
        mt = 0.5 * qt * inv_m
        ms = 0.5 * qs * inv_m
        qkk = 2.0 * e * e
        qkt = 4.0 * k * e * e * u
        qtt = 4.0 * a2 * u * (u - inv_t2)
        qss = torch.full_like(k, 2.0)
        inv_m3 = inv_m * inv_m * inv_m

        def d2m(qxy, qx, qy):
            return 0.5 * qxy * inv_m - 0.25 * qx * qy * inv_m3

        mkk = d2m(qkk, qk, qk)
        mkt = d2m(qkt, qk, qt)
        mtt = d2m(qtt, qt, qt)
        mss = d2m(qss, qs, qs)
        mks = d2m(0.0, qk, qs)
        mts = d2m(0.0, qt, qs)
        d2 = ((mkk, mkt, mks), (mkt, mtt, mts), (mks, mts, mss))
        f = f + r * r * inv_t
        dm = (mk, mt, ms)
        c2 = 2.0 * inv_t
        for i in range(3):
            g[i] = g[i] - c2 * r * dm[i]
            for j in range(i, 3):
                h[i][j] = h[i][j] + c2 * (dm[i] * dm[j] - r * d2[i][j])
    for i in range(3):
        for j in range(i):
            h[i][j] = h[j][i]
    return f, tuple(g), tuple(tuple(row) for row in h)


def gaussian_rician_value_e(params, s, te):
    """(objective, [exp(-te/t2)]); the exponentials feed the next fgh call."""
    k, t2, sg = params
    es = _exps(t2, te)
    f = torch.zeros_like(k)
    for st, e in zip(s, es):
        a = k * e
        r = st - torch.sqrt(a * a + sg * sg)
        f = f + r * r
    return cdiv(f, float(len(te))), es


# ---------------------------------------------------------------- rician
def rician_fgh(params, s, te, e_list=None):
    """Full-Newton (f, g, H) of the negative Rician log-likelihood, in the
    fp32-stable identity form. Uses R = I1/I0 and R' = 1 - R/x - R^2; the
    x->0 limit of R/x is 1/2 (series below x = 1e-4)."""
    k, t2, sg = params
    e_all = _exps(t2, te) if e_list is None else e_list
    sg2 = sg * sg
    inv_s2 = 1.0 / sg2
    inv_s3 = inv_s2 / sg
    two_t2 = 2.0 / t2
    zero = torch.zeros_like(k)
    f = zero
    g = [zero] * 3
    h = [[zero] * 3 for _ in range(3)]
    for st, t, e in zip(s, te, e_all):
        m = k * e
        u = rdiv(t, t2 * t2)
        x = m * st * inv_s2
        i0 = i0e(x)
        R = i1e(x) / torch.clamp(i0, min=1e-30)
        r_over_x = torch.where(x > 1e-4, R / torch.clamp(x, min=1e-30),
                               0.5 - cdiv(torch.square(x), 16.0))
        Rp = 1.0 - r_over_x - R * R

        d_sm = torch.abs(st) - torch.abs(m)
        L = (torch.log(torch.clamp(st, min=_LOG_EPS)) - torch.log(sg2)
             - d_sm * d_sm * 0.5 * inv_s2
             + torch.log(torch.clamp(i0, min=1e-30)))
        f = f - L

        core = (-m + R * st) * inv_s2
        n_ = -2.0 * sg2 + st * st + m * m - 2.0 * R * m * st
        g[0] = g[0] - e * core
        g[1] = g[1] - m * u * core
        g[2] = g[2] - n_ * inv_s3

        W = Rp * st * st * inv_s2 - 1.0
        mw_rs = m * W + R * st
        hkk = e * e * inv_s2 * W
        hkt = e * u * (core * sg2 + m * W) * inv_s2
        htt = m * u * (u - two_t2) * core + m * m * u * u * inv_s2 * W
        hks = -2.0 * e * inv_s3 * mw_rs
        hts = -2.0 * m * u * inv_s3 * mw_rs
        dN = -4.0 * sg + 4.0 * Rp * m * m * st * st * inv_s3
        hss = dN * inv_s3 - 3.0 * n_ * inv_s3 / sg
        h[0][0] = h[0][0] - hkk
        h[0][1] = h[0][1] - hkt
        h[1][1] = h[1][1] - htt
        h[0][2] = h[0][2] - hks
        h[1][2] = h[1][2] - hts
        h[2][2] = h[2][2] - hss
    h[1][0], h[2][0], h[2][1] = h[0][1], h[0][2], h[1][2]
    return f, tuple(g), tuple(tuple(row) for row in h)


def rician_value_e(params, s, te):
    """(objective, [exp(-te/t2)]); the exponentials feed the next fgh call."""
    k, t2, sg = params
    es = _exps(t2, te)
    sg2 = sg * sg
    f = torch.zeros_like(k)
    for st, e in zip(s, es):
        m = k * e
        x = m * st / sg2
        d_sm = torch.abs(st) - torch.abs(m)
        L = (torch.log(torch.clamp(st, min=_LOG_EPS)) - torch.log(sg2)
             - d_sm * d_sm * 0.5 / sg2
             + torch.log(torch.clamp(i0e(x), min=1e-30)))
        f = f - L
    return f, es


FGH = {"gaussian_rician": gaussian_rician_fgh, "rician": rician_fgh}
VALUE_E = {"gaussian_rician": gaussian_rician_value_e, "rician": rician_value_e}
