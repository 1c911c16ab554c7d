"""T2-relaxometry signal model and the gaussian fit objective (PyTorch).

The counterparts of ``fetal_t2mapping_tpu.models.signal`` for the gaussian
model, S(TE) = k * exp(-TE/T2) with a mean-SSE objective, written for
batches: parameters are (..., P) tensors or per-parameter columns, the
signal is (..., T) and every reduction runs over the last (echo) axis.
The 3-parameter models are not ported yet (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import torch

MODEL_NAMES = ("gaussian", "gaussian_rician", "rician")

_NOT_PORTED = ("the {model!r} model is not ported to fetal_t2mapping_tpu_torch "
               "yet (ROADMAP Queue 1 item 5: 3-parameter fits)")


def require_gaussian(model: str) -> None:
    """Raise for any model but 'gaussian': unknown names with ValueError,
    the unported 3-parameter models with NotImplementedError."""
    if model not in MODEL_NAMES:
        raise ValueError(f"unknown model {model!r}; expected one of {MODEL_NAMES}")
    if model != "gaussian":
        raise NotImplementedError(_NOT_PORTED.format(model=model))


def gauss_model(te, k, t2):
    """Mono-exponential decay k*exp(-te/t2) (broadcasting)."""
    return k * torch.exp(-te / t2)


def predict_signal(model: str, params, te):
    """Predicted signal from per-parameter columns ``params`` (k, t2)."""
    require_gaussian(model)
    return gauss_model(te, params[0], params[1])


def gauss_objective(x: torch.Tensor, te: torch.Tensor,
                    signal: torch.Tensor) -> torch.Tensor:
    """Mean-SSE objective: x (..., 2), te (T,), signal (..., T) -> (...)."""
    r = signal - gauss_model(te, x[..., 0:1], x[..., 1:2])
    return torch.mean(torch.square(r), dim=-1)


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
