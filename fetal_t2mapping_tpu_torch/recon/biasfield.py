"""N4-style bias field correction on the device.

The counterpart of ``fetal_t2mapping_tpu.recon.biasfield`` (the
reference's SimpleITK ``N4BiasFieldCorrectionImageFilter`` calls,
utils/qmri_utils.py:254-357: per-acquisition correction and a log-bias
field shared across echo times).

Algorithm (N4ITK, Tustison et al. 2010, as the JAX package re-derives it):
1. v = log(image) over the (foreground) mask.
2. Iterate, ``n_iters`` times per resolution level:
   a. Sharpen the intensity histogram of the current corrected image by
      Wiener deconvolution of a Gaussian bias kernel (FWHM in log space),
      then form the conditional expectation E[u|v] per bin, with real FFTs
      over the 1-D histogram.
   b. Fit a smooth field to the per-voxel residual v - E[u|v](v) by masked
      separable Gaussian smoothing (a Nadaraya-Watson smoother whose sigma
      plays N4's control-point-spacing role).
   c. Accumulate it into the total log-bias field and subtract it.
3. The iteration count is fixed; ``field_cv`` reports the coefficient of
   variation of each update (std / |mean| over the volume, in float64: the
   mean is a cancelling sum, and the JAX package's float32 value of it
   differs from a float64 one by up to ~2%).

The loop stays on the device with no host read per iteration; ``field_cv``
is downloaded once. The soft histogram (a scatter-add in the JAX package)
is summed in 32.32 fixed point with integer adds, which are exact in any
order, so two runs give the same bits. The smoothing's denominator,
smooth(mask), is the same in every iteration of a level and is computed
once per level.

The corrected image is exp(v - bias_total); the returned field is
exp(bias_total) (multiplicative bias, image = true * field).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.volume import Volume
from ..device import resolve_device
from ..ops.filtering import gaussian_smooth3d
from .resample import to_tensor

_SQRT8LN2 = 2.3548200450309493  # FWHM = sigma * sqrt(8 ln 2)
_FIXED_ONE = 2.0 ** 32          # histogram weight 1.0 in fixed point


def _soft_histogram(i0: torch.Tensor, i1: torch.Tensor, w1: torch.Tensor,
                    mask_f: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Linear-interpolated histogram of the masked voxels: weight 1 - w1 to
    bin i0 and w1 to bin i1. Each weight is rounded to a multiple of
    2^-32 (an error below 2.4e-10 per voxel) and the bins are summed as
    int64, exactly and so in no particular order; the float32 result is
    the exact sum rounded once."""
    m = mask_f.reshape(-1)
    w1 = w1.reshape(-1)
    q0 = torch.round(m * (1.0 - w1) * _FIXED_ONE).to(torch.int64)
    q1 = torch.round(m * w1 * _FIXED_ONE).to(torch.int64)
    hist = torch.zeros(n_bins, dtype=torch.int64, device=m.device)
    hist.index_add_(0, i0.reshape(-1), q0).index_add_(0, i1.reshape(-1), q1)
    return (hist.to(torch.float64) / _FIXED_ONE).to(torch.float32)


def _sharpen_update(v: torch.Tensor, mask_f: torch.Tensor, n_bins: int, fwhm: float,
                    wiener_eps: float) -> torch.Tensor:
    """One histogram-sharpening pass: per-voxel residual bias v - E[u|v]."""
    inside = mask_f > 0
    vmin = torch.where(inside, v, torch.inf).amin()
    vmax = torch.where(inside, v, -torch.inf).amax()
    span = torch.clamp_min(vmax - vmin, 1e-6)
    scale = span.new_tensor(float(n_bins - 1)) / span

    pos = (v - vmin) * scale
    i0 = torch.clamp(torch.floor(pos), 0, n_bins - 1).to(torch.int64)
    w1 = torch.clamp(pos - i0.to(v.dtype), 0.0, 1.0)
    i1 = torch.clamp(i0 + 1, max=n_bins - 1)
    hist = _soft_histogram(i0, i1, w1, mask_f, n_bins)

    # Wiener-deconvolve the Gaussian bias kernel from the histogram
    dev = v.device
    sigma_bins = (fwhm / _SQRT8LN2) * scale
    n_pad = 2 * n_bins                               # linear (non-circular) conv
    freqs = torch.fft.rfftfreq(n_pad, device=dev)
    # FT of a unit-area Gaussian with std sigma_bins (in bins)
    fk = torch.exp(-2.0 * (math.pi * freqs * sigma_bins) ** 2)
    hv = torch.fft.rfft(hist, n_pad)
    hu = torch.fft.irfft(hv * fk / (fk * fk + wiener_eps), n_pad)[:n_bins]
    hu = torch.clamp_min(hu, 0.0)

    # E[u|v] = conv(u * p_u, F) / conv(p_u, F), evaluated at each bin
    centers = vmin + torch.arange(n_bins, dtype=v.dtype, device=dev) / scale
    fu = torch.fft.rfft(hu, n_pad)
    fuu = torch.fft.rfft(hu * centers, n_pad)
    d2 = ((torch.arange(n_pad, device=dev) - n_pad // 2) ** 2).to(torch.float32)
    g = torch.exp(-0.5 * d2 / torch.clamp_min(sigma_bins, 1e-3) ** 2)
    gk = torch.fft.rfft(torch.roll(g, n_pad // 2 + n_pad % 2), n_pad)
    den = torch.fft.irfft(fu * gk, n_pad)[:n_bins]
    num = torch.fft.irfft(fuu * gk, n_pad)[:n_bins]
    e_u = num / torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    e_u = torch.where(den > 1e-12, e_u, centers)     # empty bins: identity

    # E[u|v] per voxel (linear interpolation over bins)
    expected = e_u[i0] * (1.0 - w1) + e_u[i1] * w1
    return (v - expected) * mask_f


def _n4_level(v: torch.Tensor, mask_f: torch.Tensor, *, n_iters: int, n_bins: int,
              fwhm: float, wiener_eps: float,
              sigma_vox: Tuple[float, float, float]):
    """One resolution level: (v, the level's log-bias, (n_iters,) field CVs)."""
    den = torch.clamp_min(gaussian_smooth3d(mask_f, sigma_vox), 1e-6)
    bias = torch.zeros_like(v)
    cvs = []
    for _ in range(n_iters):
        residual = _sharpen_update(v, mask_f, n_bins, fwhm, wiener_eps)
        field = gaussian_smooth3d(residual * mask_f, sigma_vox) / den
        v = v - field
        bias = bias + field
        f64 = field.to(torch.float64)
        cvs.append(torch.std(f64, correction=0)
                   / torch.clamp_min(torch.abs(torch.mean(f64)), 1e-6))
    return v, bias, torch.stack(cvs)


@dataclasses.dataclass(frozen=True)
class BiasFieldResult:
    corrected: Volume
    field: Volume          # multiplicative bias (image = true * field)
    field_cv: np.ndarray   # per-iteration coefficient of variation of update


def n4_bias_correction(image: Volume, mask: Optional[Volume] = None, *,
                       n_iters: int = 40, n_bins: int = 200, fwhm: float = 0.15,
                       wiener_eps: float = 0.01, ctrl_spacing_mm=100.0,
                       device="cuda") -> BiasFieldResult:
    """N4-style multiplicative bias correction of one volume on ``device``.

    Args:
        image: intensity volume (non-positive voxels are treated as
            background, as ITK's default foreground thresholding does).
        mask: optional foreground mask; default = image > 0.
        n_iters: fixed iteration count PER resolution level.
        n_bins / fwhm / wiener_eps: histogram-sharpening knobs (N4 defaults).
        ctrl_spacing_mm: smoothing scale(s) in mm — plays the role of N4's
            B-spline control-point spacing. A sequence runs ITK-style
            coarse-to-fine multi-resolution (each level refines the
            accumulated log-bias, e.g. (200, 100, 50)).
        device: 'cuda' (default) or 'cpu'.

    Returns:
        BiasFieldResult with host (numpy) volumes.
    """
    dev = resolve_device(device)
    data = to_tensor(image.data, dev, torch.float32)
    if mask is not None:
        mask_f = (to_tensor(mask.data, dev) > 0).to(torch.float32)
    else:
        mask_f = (data > 0).to(torch.float32)
    v = torch.log(torch.clamp_min(data, 1e-6)) * mask_f

    spacings = ((float(ctrl_spacing_mm),) if np.isscalar(ctrl_spacing_mm)
                else tuple(float(c) for c in ctrl_spacing_mm))
    bias_total = torch.zeros_like(v)
    cv_levels = []
    for ctrl in spacings:
        sigma_vox = tuple(ctrl / max(s, 1e-3) / _SQRT8LN2
                          for s in image.spacing[::-1])   # data is (z, y, x)
        v, bias_lvl, cvs = _n4_level(v, mask_f, n_iters=n_iters, n_bins=n_bins, fwhm=fwhm,
                                     wiener_eps=wiener_eps, sigma_vox=sigma_vox)
        bias_total = bias_total + bias_lvl
        cv_levels.append(cvs)

    field = torch.exp(bias_total).cpu().numpy()
    corrected = torch.where(mask_f > 0, torch.exp(v), data).cpu().numpy()
    return BiasFieldResult(
        corrected=image.with_data(corrected),
        field=image.with_data(field),
        field_cv=torch.cat(cv_levels).cpu().numpy(),
    )


def _host(data) -> np.ndarray:
    if torch.is_tensor(data):
        data = data.cpu().numpy()
    return np.asarray(data, np.float32)


def shared_log_bias(images, masks=None, device="cuda", **kwargs):
    """Shared-bias variant: estimate one field per image, average the log
    fields, and correct every image with the shared field (the reference's
    ``run_biasfield_correction2`` behaviour, utils/qmri_utils.py:296-357 —
    the receive-coil bias is TE-independent, so pooling echoes stabilizes
    the estimate). The pooling is host numpy, as in the JAX package.

    Returns (corrected_list, shared_field Volume).
    """
    if masks is None:
        masks = [None] * len(images)
    logs = []
    for img, msk in zip(images, masks):
        res = n4_bias_correction(img, msk, device=device, **kwargs)
        logs.append(np.log(np.maximum(res.field.data, 1e-6)))
    shared = np.exp(np.mean(logs, axis=0)).astype(np.float32)
    out = []
    for img in images:
        data = _host(img.data)
        corrected = np.where(shared > 1e-6, data / shared, data)
        out.append(img.with_data(corrected.astype(np.float32)))
    return out, images[0].with_data(shared)
