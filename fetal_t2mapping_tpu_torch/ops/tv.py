"""Total-variation (Chambolle) denoising of the slices of a volume.

The counterpart of ``fetal_t2mapping_tpu.ops.tv``: slice-wise 2-D TV
denoising with skimage.restoration.denoise_tv_chambolle's dual projection
and defaults (weight 0.1, eps 2e-4, at most 200 iterations), as the
reference invokes it (utils/qmri_utils.py:393-405).

Each slice stops on its own energy test. The JAX package runs one
``lax.while_loop`` per slice under ``vmap``; here all slices step in
lock-step and a per-slice active mask freezes each slice at its own stop,
so a slice's result does not depend on when the others stop. The host
reads the mask every ``_CHECK_EVERY`` iterations and leaves once no slice
is active: frozen slices are left unchanged by the extra steps, so the
result is that of a test every iteration.
"""

from __future__ import annotations

import torch

_CHECK_EVERY = 10


def _grad2d(u: torch.Tensor):
    """Forward differences along the last two axes; zero at the trailing edge."""
    gz = torch.zeros_like(u)
    gz[..., :-1, :] = u[..., 1:, :] - u[..., :-1, :]
    gy = torch.zeros_like(u)
    gy[..., :, :-1] = u[..., :, 1:] - u[..., :, :-1]
    return gz, gy


def _div2d(pz: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Adjoint of -_grad2d (backward-difference divergence)."""
    dz = torch.cat([pz[..., :1, :], pz[..., 1:-1, :] - pz[..., :-2, :], -pz[..., -2:-1, :]], dim=-2)
    dy = torch.cat([py[..., :, :1], py[..., :, 1:-1] - py[..., :, :-2], -py[..., :, -2:-1]], dim=-1)
    return dz + dy


def _energy(u, img, weight):
    gz, gy = _grad2d(u)
    return (torch.square(u - img).sum(dim=(-2, -1))
            + weight * torch.sqrt(torch.square(gz) + torch.square(gy)).sum(dim=(-2, -1)))


def _tv2d(image: torch.Tensor, weight: float, eps: float, max_iter: int) -> torch.Tensor:
    """Chambolle TV of a (S, H, W) stack of slices, each with its own stop."""
    img = image.to(torch.float32)
    tau = 1.0 / 4.0  # 1/(2*ndim) for 2-D, as in skimage
    pz = torch.zeros_like(img)
    py = torch.zeros_like(img)
    e0 = _energy(img, img, weight)
    e_prev, e = e0.clone(), e0.clone()
    tol = eps * e0
    for i in range(max_iter):
        active = torch.abs(e_prev - e) >= tol if i >= 2 else torch.ones_like(e0, dtype=torch.bool)
        if i % _CHECK_EVERY == 0 and i >= 2 and not bool(active.any()):
            break
        gz, gy = _grad2d(img + _div2d(pz, py))
        norm = torch.sqrt(torch.square(gz) + torch.square(gy))
        # sign: _div2d is the NEGATIVE of skimage's d, so the dual ascent
        # step is +tau*g under this convention
        den = 1.0 + (tau / weight) * norm
        pz_new = (pz + tau * gz) / den
        py_new = (py + tau * gy) / den
        e_new = _energy(img + _div2d(pz_new, py_new), img, weight)
        a3 = active[:, None, None]
        pz = torch.where(a3, pz_new, pz)
        py = torch.where(a3, py_new, py)
        e_prev, e = torch.where(active, e, e_prev), torch.where(active, e_new, e)
    return img + _div2d(pz, py)


def tv_denoise_slices(volume: torch.Tensor, weight: float = 0.1, eps: float = 2e-4,
                      max_iter: int = 200) -> torch.Tensor:
    """Denoise each (y, x) slice of a (z, y, x) volume independently
    (the reference iterates data.shape[0] 2-D slices, :398-399)."""
    return _tv2d(volume, weight, eps, max_iter)
