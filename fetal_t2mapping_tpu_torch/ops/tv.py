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

On the CPU the loop runs eagerly (``_tv2d``, the plain version). On a CUDA
tensor its body is a step on preallocated buffers (``_tv_step``: the dual
fields, both energies, the iteration counter and the "any slice active"
flag on the device), captured once as a CUDA graph and replayed per
iteration (``_tv2d_steps``; the reference's ``lax.while_loop``), with the
same results and the same host reads.
"""

from __future__ import annotations

import torch

from .. import graphs

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


def _tv_step(b, weight: float, tau: float):
    """One iteration of ``_tv2d`` on the buffers ``b``, in place. The
    active mask comes from the energies and the device counter ``b["i"]``
    (every slice is active before the third iteration); ``b["more"]``
    receives whether any slice is active at the next one."""
    img, pz, py, e_prev, e = b["img"], b["pz"], b["py"], b["e_prev"], b["e"]
    active = (torch.abs(e_prev - e) >= b["tol"]) | (b["i"] < 2)
    gz, gy = _grad2d(img + _div2d(pz, py))
    norm = torch.sqrt(torch.square(gz) + torch.square(gy))
    den = 1.0 + (tau / weight) * norm
    pz_new = (pz + tau * gz) / den
    py_new = (py + tau * gy) / den
    e_new = _energy(img + _div2d(pz_new, py_new), img, weight)
    a3 = active[:, None, None]
    pz_out, py_out = torch.where(a3, pz_new, pz), torch.where(a3, py_new, py)
    e_prev_out, e_out = torch.where(active, e, e_prev), torch.where(active, e_new, e)
    for buf, new in ((pz, pz_out), (py, py_out), (e_prev, e_prev_out), (e, e_out)):
        buf.copy_(new)
    b["i"].add_(1)
    b["more"].copy_(((torch.abs(e_prev - e) >= b["tol"]) | (b["i"] < 2)).any())


def _tv2d_steps(image: torch.Tensor, weight: float, eps: float, max_iter: int, *,
                graph: bool) -> torch.Tensor:
    """``_tv2d`` through the in-place ``_tv_step``: driven eagerly
    (``graph=False``), or on the card captured once as a CUDA graph (the
    first iteration runs eagerly as the capture's warm-up) and replayed for
    every further iteration. The host reads ``b["more"]`` before
    iterations 10, 20, ... (``graphs.read``), as ``_tv2d`` reads its mask."""
    img = image.to(torch.float32)
    e0 = _energy(img, img, weight)
    b = dict(img=img, pz=torch.zeros_like(img), py=torch.zeros_like(img),
             e_prev=e0.clone(), e=e0.clone(), tol=eps * e0,
             i=torch.zeros((), dtype=torch.int64, device=img.device),
             more=torch.ones((), dtype=torch.bool, device=img.device))

    def step():
        _tv_step(b, weight, 1.0 / 4.0)

    run = graphs.stepper(step, img.device, graph)
    for i in range(max_iter):
        if i % _CHECK_EVERY == 0 and i >= 2 and not graphs.read(b["more"]):
            break
        run()
    return img + _div2d(b["pz"], b["py"])


def tv_denoise_slices(volume: torch.Tensor, weight: float = 0.1, eps: float = 2e-4,
                      max_iter: int = 200) -> torch.Tensor:
    """Denoise each (y, x) slice of a (z, y, x) volume independently
    (the reference iterates data.shape[0] 2-D slices, :398-399), on the
    volume's device: on a CUDA tensor as a replayed CUDA graph."""
    if torch.is_tensor(volume) and volume.device.type == "cuda":
        return _tv2d_steps(volume, weight, eps, max_iter, graph=True)
    return _tv2d(volume, weight, eps, max_iter)
