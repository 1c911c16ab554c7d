"""T2-relaxometry signal models and fit objectives (PyTorch).

The counterparts of ``fetal_t2mapping_tpu.models.signal``, written for
batches: parameters are (..., P) tensors or per-parameter columns, the
signal is (..., T) and every reduction runs over the last (echo) axis.

- gaussian:         S(TE) = k * exp(-TE/T2);            mean-SSE objective
- gaussian_rician:  S(TE) = sqrt(k^2 exp(-2TE/T2) + sigma^2); mean-SSE
- rician:           negative Rician log-likelihood with exp-scaled Bessel I0,
                    in the fp32-stable form -(|s|-|m|)^2/(2 sg^2) of the
                    reference's -(s^2+m^2)/(2 sg^2) + |x| (see models.fgh)
"""

from __future__ import annotations

import torch
from torch.func import grad, hessian, vmap

MODEL_NAMES = ("gaussian", "gaussian_rician", "rician")

_LOG_EPS = 1e-20  # guards log() against exact-zero signal in padded voxels


def check_model(model: str) -> None:
    """Raise ValueError for a name that is not one of ``MODEL_NAMES``."""
    if model not in MODEL_NAMES:
        raise ValueError(f"unknown model {model!r}; expected one of {MODEL_NAMES}")


def gauss_model(te, k, t2):
    """Mono-exponential decay k*exp(-te/t2) (broadcasting)."""
    return k * torch.exp(-te / t2)


def gauss_rician_model(te, k, t2, sigma):
    """First-moment Rician-bias-corrected decay sqrt(k^2 e^{-2te/t2} + sigma^2)."""
    return torch.sqrt(torch.square(gauss_model(te, k, t2)) + torch.square(sigma))


def predict_signal(model: str, params, te):
    """Predicted signal from per-parameter columns ``params``. As in the
    reference, every model but 'gaussian' (rician too) predicts with the
    first-moment gaussian_rician curve."""
    check_model(model)
    if model == "gaussian":
        return gauss_model(te, params[0], params[1])
    return gauss_rician_model(te, params[0], params[1], params[2])


def gauss_objective(x: torch.Tensor, te: torch.Tensor,
                    signal: torch.Tensor) -> torch.Tensor:
    """Mean-SSE objective: x (..., 2), te (T,), signal (..., T) -> (...)."""
    r = signal - gauss_model(te, x[..., 0:1], x[..., 1:2])
    return torch.mean(torch.square(r), dim=-1)


def gauss_rician_objective(x, te, signal):
    """Mean-SSE of the gaussian_rician curve: x (..., 3) -> (...)."""
    r = signal - gauss_rician_model(te, x[..., 0:1], x[..., 1:2], x[..., 2:3])
    return torch.mean(torch.square(r), dim=-1)


def rician_objective(x, te, signal):
    """Negative Rician log-likelihood: x (..., 3) -> (...)."""
    k, t2, sigma = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    m = gauss_model(te, k, t2)
    s2 = torch.square(sigma)
    xb = m * signal / s2
    d_sm = torch.abs(signal) - torch.abs(m)   # stable identity; see module doc
    ll = torch.sum(
        torch.log(torch.clamp(signal, min=_LOG_EPS))
        - torch.log(s2)
        - torch.square(d_sm) / (2.0 * s2)
        + torch.log(torch.special.i0e(xb)),
        dim=-1)
    return -ll


_OBJECTIVES = {
    "gaussian": gauss_objective,
    "gaussian_rician": gauss_rician_objective,
    "rician": rician_objective,
}


def make_objective(model: str):
    """Batched f(x (..., P), te (T,), signal (..., T)) -> (...)."""
    check_model(model)
    return _OBJECTIVES[model]


def _gauss_fgh(x: torch.Tensor, te: torch.Tensor, signal: torch.Tensor):
    """Hand-fused (f, grad, Hessian) of the gaussian objective, batched.

    x (..., 2), te (T,), signal (..., T) -> f (...), g (..., 2),
    H (..., 2, 2). One exp per echo; full Newton (second-order residual
    terms included), the algebra of the JAX package's ``_gauss_fgh``."""
    k, t2 = x[..., 0:1], x[..., 1:2]
    inv_t = 1.0 / signal.shape[-1]
    e = torch.exp(-te / t2)
    a = k * e                      # model
    r = signal - a                 # residual
    u = te / (t2 * t2)             # d(-te/t2)/dt2
    ae_u = a * u                   # dm/dt2 = k e u

    f = torch.sum(r * r, dim=-1) * inv_t
    g_k = -2.0 * inv_t * torch.sum(r * e, dim=-1)
    g_t = -2.0 * inv_t * torch.sum(r * ae_u, dim=-1)
    # Hessian: 2/T * sum(dm_x dm_y - r * d2m_xy)
    h_kk = 2.0 * inv_t * torch.sum(e * e, dim=-1)
    h_kt = 2.0 * inv_t * torch.sum(e * u * (a - r), dim=-1)   # d2m/dkdt2 = e u
    d2m_tt = ae_u * u - 2.0 * a * u / t2                       # k e (u^2 - 2u/t2)
    h_tt = 2.0 * inv_t * torch.sum(ae_u * ae_u - r * d2m_tt, dim=-1)
    g = torch.stack([g_k, g_t], dim=-1)
    H = torch.stack([torch.stack([h_kk, h_kt], dim=-1),
                     torch.stack([h_kt, h_tt], dim=-1)], dim=-2)
    return f, g, H


def make_value_grad_hess(model: str):
    """Batched (f, g, H) evaluator: x (N, P), te (T,), signal (N, T) ->
    f (N,), g (N, P), H (N, P, P). Hand-derived for gaussian; autodiff of
    the per-voxel objective (``torch.func``, vmapped over voxels) for the
    3-parameter models, as the reference takes ``jax.grad``/``jax.hessian``."""
    obj = make_objective(model)
    if model == "gaussian":
        return _gauss_fgh
    g_fn = vmap(grad(obj), in_dims=(0, None, 0))
    h_fn = vmap(hessian(obj), in_dims=(0, None, 0))

    def fgh(x, te, signal):
        return obj(x, te, signal), g_fn(x, te, signal), h_fn(x, te, signal)

    return fgh
