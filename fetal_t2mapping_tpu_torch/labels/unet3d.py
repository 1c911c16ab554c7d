"""3-D U-Net inference for brain segmentation (SynthSeg topology) in PyTorch.

The counterpart of ``fetal_t2mapping_tpu.labels.unet3d``: the network that
stands in for FreeSurfer's ``mri_synthseg`` (SynthSeg's published topology,
Billot et al. 2023: 5 levels, 2 conv(3^3)+ELU per level, 24 features
doubling per level, nearest upsampling with skip concatenation, optional
per-level folded batch norm). The host part — configuration, weight
shapes, random and loaded weights, and the exact space-to-depth (S2D)
weight transforms — is a copy of the reference's numpy code, so the same
seed gives the same arrays in both packages. Weights reach the device once
per parameter tree through :func:`to_torch_params` /
:func:`to_torch_s2d_params`.

Layouts: every public function takes and returns the reference's
channels-last tensors (N, D, H, W, C); each conv converts at its boundary
(a permuted view, so cuDNN sees channels_last_3d and nothing is copied).
Conv weights are held as (out, in, k, k, k); the S2D 2^3 kernels as the
packed (8C, C') matrices of ``conv_s2d.pack_taps``.

Numerics: ``compute_dtype`` (bf16 on CUDA, fp32 on the CPU by default, as
the reference picks bf16 on its accelerator) is the operand type of every
conv; biases, BN affines and the head's products are fp32. One difference
from the reference is known and accepted: a bf16 ``F.conv3d`` rounds its
output to bf16 before the bias is added, where the reference adds the bias
to an fp32 conv output (``preferred_element_type``). So bf16 logits differ
from the reference's by one bf16 rounding per conv; the gate there is label
agreement (``bench.py:970-977``), not bitwise equality. In fp32 the port
and the reference differ only in the order of fp32 sums. The S2D convs of
``conv_impl="kernel"`` (``conv_s2d``) keep the fp32 accumulator up to the
epilogue, as the reference's Pallas kernel does.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import conv_s2d as _conv_s2d_mod
from .conv_s2d import pack_taps

# SynthSeg's output label numbering (FreeSurfer aseg ids)
SYNTHSEG_LABELS: Tuple[int, ...] = (
    0, 2, 3, 4, 5, 7, 8, 10, 11, 12, 13, 14, 15, 16, 17, 18, 24, 26, 28,
    41, 42, 43, 44, 46, 47, 49, 50, 51, 52, 53, 54, 58, 60,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    n_levels: int = 5
    n_conv_per_level: int = 2
    base_features: int = 24
    kernel: int = 3
    n_labels: int = len(SYNTHSEG_LABELS)
    # SynthSeg's released weights carry one BatchNormalization per level,
    # folded by the converter into scale/shift vectors bn_down{lvl}_s/_b
    # and bn_up{lvl}_s/_b applied after each level's conv+ELU stack
    batch_norm: bool = False

    @property
    def divisor(self) -> int:
        return 2 ** (self.n_levels - 1)


def _conv_shapes(cfg: UNetConfig) -> List[Tuple[str, int, int]]:
    """(name, c_in, c_out) for every conv layer, encoder then decoder."""
    shapes = []
    feats = [cfg.base_features * 2 ** lv for lv in range(cfg.n_levels)]
    c_in = 1
    for lv in range(cfg.n_levels):
        for i in range(cfg.n_conv_per_level):
            c_out = feats[lv]
            shapes.append((f"enc{lv}_{i}", c_in, c_out))
            c_in = c_out
    for lv in range(cfg.n_levels - 2, -1, -1):
        c_in = c_in + feats[lv]          # skip concatenation
        for i in range(cfg.n_conv_per_level):
            c_out = feats[lv]
            shapes.append((f"dec{lv}_{i}", c_in, c_out))
            c_in = c_out
    shapes.append(("head", c_in, cfg.n_labels))
    return shapes


def _bn_shapes(cfg: UNetConfig) -> List[Tuple[str, int]]:
    """(name, channels) for every per-level folded BN affine (if any)."""
    if not cfg.batch_norm:
        return []
    feats = [cfg.base_features * 2 ** lv for lv in range(cfg.n_levels)]
    shapes = [(f"bn_down{lv}", feats[lv]) for lv in range(cfg.n_levels)]
    shapes += [(f"bn_up{lv}", feats[lv]) for lv in range(cfg.n_levels - 2, -1, -1)]
    return shapes


def random_params(cfg: UNetConfig = UNetConfig(), seed: int = 0) -> Dict[str, np.ndarray]:
    """He-initialized parameter tree with the exact shapes real weights need
    (numpy, DHWIO kernels; the reference's arrays for the same seed)."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    for name, c_in, c_out in _conv_shapes(cfg):
        k = 1 if name == "head" else cfg.kernel
        fan_in = c_in * k ** 3
        params[name + "_w"] = rng.normal(
            0, np.sqrt(2.0 / fan_in), (k, k, k, c_in, c_out)).astype(np.float32)
        params[name + "_b"] = np.zeros(c_out, np.float32)
    for name, c in _bn_shapes(cfg):
        params[name + "_s"] = (1.0 + rng.normal(0, 0.05, c)).astype(np.float32)
        params[name + "_b"] = rng.normal(0, 0.05, c).astype(np.float32)
    return params


def load_params(path: str) -> Dict[str, np.ndarray]:
    """Load a converted-weights .npz manifest (keys as in random_params)."""
    with np.load(path) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


def config_from_params(params: Dict[str, np.ndarray]) -> UNetConfig:
    """Infer the architecture a parameter tree implies (shapes are the
    source of truth)."""
    enc_levels = set()
    convs = set()
    for k in params:
        if k.startswith("enc") and k.endswith("_w"):
            lv, i = k[3:-2].split("_")
            enc_levels.add(int(lv))
            convs.add(int(i))
    if not enc_levels or "head_w" not in params:
        raise ValueError("parameter tree lacks enc*/head conv weights")
    return UNetConfig(
        n_levels=max(enc_levels) + 1,
        n_conv_per_level=max(convs) + 1,
        base_features=int(params["enc0_0_w"].shape[-1]),
        kernel=int(params["enc0_0_w"].shape[0]),
        n_labels=int(params["head_w"].shape[-1]),
        batch_norm=any(k.startswith("bn_") for k in params),
    )


def validate_params(params: Dict[str, np.ndarray], cfg: UNetConfig) -> None:
    """Raise unless every conv weight/bias matches the cfg's exact shapes."""
    expect = {}
    for name, c_in, c_out in _conv_shapes(cfg):
        k = 1 if name == "head" else cfg.kernel
        expect[name + "_w"] = (k, k, k, c_in, c_out)
        expect[name + "_b"] = (c_out,)
    for name, c in _bn_shapes(cfg):
        expect[name + "_s"] = (c,)
        expect[name + "_b"] = (c,)
    missing = sorted(set(expect) - set(params))
    extra = sorted(set(params) - set(expect))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing={missing} extra={extra}")
    for k, shape in expect.items():
        if tuple(params[k].shape) != shape:
            raise ValueError(f"{k}: shape {tuple(params[k].shape)} != expected {shape}")


# ---------------------------------------------------------------------------
# Space-to-depth level 0, host side (copied from the reference). Level 0's
# 24-channel full-resolution convs are rewritten EXACTLY on a half-resolution
# grid with 8x the channels: an "in-form" tensor (D/2+1)^3 whose slot r of
# cell q holds x[2q + r - 1], a 2^3 VALID conv, and an "out-form" tensor
# (D/2)^3 whose slot r of cell q is y[2q + r]. The out-form's 8 slots are the
# 2x2x2 maxpool block; the level-1 decoder output enters S2D space through
# an upsample-folded coarse kernel, so the 2x upsample never materializes.
# ---------------------------------------------------------------------------


def _s2d_kernel(w: np.ndarray) -> np.ndarray:
    """Exact S2D transform of a 3^3 stride-1 SAME conv kernel.

    (3,3,3,ci,co) -> (2,2,2,8ci,8co) operating on in-form input and
    producing out-form output (channel slots ordered (rz,ry,rx) with the
    original channel minor)."""
    w = np.asarray(w)
    if w.shape[:3] != (3, 3, 3):
        raise ValueError(f"S2D transform needs a 3^3 kernel, got {w.shape}")
    ci, co = w.shape[3:]
    out = np.zeros((2, 2, 2, 8 * ci, 8 * co), w.dtype)
    subs = [(a, b, c) for a in range(2) for b in range(2) for c in range(2)]
    for uz, uy, ux in subs:                      # in-form cell offset
        for si, (riz, riy, rix) in enumerate(subs):      # input sub-slot
            for so, (roz, roy, rox) in enumerate(subs):  # output sub-slot
                tz = 2 * uz + riz - 1 - roz
                ty = 2 * uy + riy - 1 - roy
                tx = 2 * ux + rix - 1 - rox
                if max(abs(tz), abs(ty), abs(tx)) <= 1:
                    out[uz, uy, ux,
                        si * ci:(si + 1) * ci,
                        so * co:(so + 1) * co] = w[tz + 1, ty + 1, tx + 1]
    return out


# The upsampled tensor is piecewise constant (up[j] = z[j//2]), so the dense
# 3-tap conv over it collapses, per output sub-position r, onto 2 coarse
# taps; _UP_FOLD[r, v, t] selects which dense taps t feed coarse tap v-1.
_UP_FOLD = np.array([[[1, 0, 0], [0, 1, 1], [0, 0, 0]],
                     [[0, 0, 0], [1, 1, 0], [0, 0, 1]]], np.float32)


def _fold_upsample_kernel(w_up: np.ndarray) -> np.ndarray:
    """(3,3,3,c_up,c0) dense kernel acting on upsample(z) -> (3,3,3,c_up,8c0)
    coarse-grid kernel producing the out-form directly (slot-major output
    channels, matching _s2d_kernel's layout)."""
    w_up = np.asarray(w_up)
    c_up, c0 = w_up.shape[3:]
    out = np.zeros((3, 3, 3, c_up, 8 * c0), w_up.dtype)
    subs = [(a, b, c) for a in range(2) for b in range(2) for c in range(2)]
    for so, (rz, ry, rx) in enumerate(subs):
        folded = np.einsum("vt,wu,xs,tusio->vwxio",
                           _UP_FOLD[rz], _UP_FOLD[ry], _UP_FOLD[rx],
                           w_up.astype(np.float32)).astype(w_up.dtype)
        out[..., so * c0:(so + 1) * c0] = folded
    return out


def s2d_level0_params(params: Dict, cfg: UNetConfig) -> Dict[str, np.ndarray]:
    """Transform every level-0 conv weight/bias into S2D form (host-side,
    once per model). enc0_* and dec0_{i>=1} become 2^3 in-form kernels
    ((2,2,2,8ci,8co), bias (8co,)); dec0_0 splits into a skip-branch S2D
    kernel and an upsample-folded coarse kernel (see _fold_upsample_kernel)."""
    out: Dict[str, np.ndarray] = {}
    c0 = cfg.base_features
    for i in range(cfg.n_conv_per_level):
        out[f"enc0_{i}_w"] = _s2d_kernel(np.asarray(params[f"enc0_{i}_w"]))
        out[f"enc0_{i}_b"] = np.tile(np.asarray(params[f"enc0_{i}_b"]), 8)
        w = np.asarray(params[f"dec0_{i}_w"])
        out[f"dec0_{i}_b"] = np.tile(np.asarray(params[f"dec0_{i}_b"]), 8)
        if i == 0:
            # dense input is concat([skip (c0), upsampled (c_up)])
            out["dec0_0_skip_w"] = _s2d_kernel(w[:, :, :, :c0, :])
            out["dec0_0_up_w"] = _fold_upsample_kernel(w[:, :, :, c0:, :])
        else:
            out[f"dec0_{i}_w"] = _s2d_kernel(w)
    if cfg.batch_norm:
        # per-level folded BN affines on out-form tensors: slot-major
        # channel layout (slot*c0 + c), so the per-channel vectors tile x8
        for name in ("bn_down0", "bn_up0"):
            out[name + "_s"] = np.tile(np.asarray(params[name + "_s"]), 8)
            out[name + "_b"] = np.tile(np.asarray(params[name + "_b"]), 8)
    return out


def pad_to_divisor(data: np.ndarray, divisor: int) -> Tuple[np.ndarray, Tuple[slice, ...]]:
    """Zero-pad (z, y, x) up to multiples of ``divisor``; returns (padded, crop)."""
    pads = [(-len_ % divisor) for len_ in data.shape]
    padded = np.pad(data, [(0, p) for p in pads])
    crop = tuple(slice(0, s) for s in data.shape)
    return padded, crop


# ---------------------------------------------------------------------------
# Weights on the device
# ---------------------------------------------------------------------------


def _tensor(a, device, dtype):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _conv_weight(w: np.ndarray, device, dtype) -> torch.Tensor:
    """DHWIO (k,k,k,ci,co) -> (co, ci, k, k, k), channels_last_3d."""
    w = torch.as_tensor(np.asarray(w, np.float32)).permute(4, 3, 0, 1, 2)
    return w.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last_3d)


def to_torch_params(params: Dict[str, np.ndarray], device="cuda",
                    dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy, DHWIO kernels, the layout of
    load_params) -> tensors on ``device``: conv weights (out, in, k, k, k)
    in ``dtype``; biases and BN scale/shift in fp32."""
    dev = resolve_device(device)
    return {k: (_conv_weight(v, dev, dtype) if k.endswith("_w")
                else _tensor(v, dev, torch.float32))
            for k, v in params.items()}


def to_torch_s2d_params(s2d_params: Dict[str, np.ndarray], device="cuda",
                        dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """``s2d_level0_params`` output -> tensors on ``device``: the 2^3 S2D
    kernels as packed (8C, C') matrices (``pack_taps``) and the folded
    upsample kernel as (8c0, c_up, 3, 3, 3), both in ``dtype``; biases and
    the tiled BN vectors in fp32."""
    dev = resolve_device(device)
    out = {}
    for k, v in s2d_params.items():
        if k == "dec0_0_up_w":
            out[k] = _conv_weight(v, dev, dtype)
        elif k.endswith("_w"):
            out[k] = _tensor(pack_taps(np.asarray(v, np.float32)), dev, dtype).contiguous()
        else:
            out[k] = _tensor(v, dev, torch.float32)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _conv(x: torch.Tensor, w: torch.Tensor, b, compute_dtype=torch.float32) -> torch.Tensor:
    """3-D conv, NDHWC in and out, SAME padding, one ``F.conv3d`` on the
    channels-last view. Operands in ``compute_dtype``; returns fp32 conv +
    bias (``b`` may be None for no bias)."""
    xc = x.to(compute_dtype).permute(0, 4, 1, 2, 3)
    y = F.conv3d(xc, w.to(compute_dtype), padding="same")
    y = y.permute(0, 2, 3, 4, 1).float()
    if b is not None:
        y = y + b
    return y.contiguous()


def _elu(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return F.elu(x).to(compute_dtype)


def _bn(x, params, name, cfg, compute_dtype=torch.float32):
    """Folded inference-time batch norm: per-channel x*s + b (no-op unless
    cfg.batch_norm). s/b stay fp32; the result is cast back to the
    activation dtype."""
    if not cfg.batch_norm:
        return x
    return (x * params[name + "_s"] + params[name + "_b"]).to(compute_dtype)


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    n, d, h, w, c = x.shape
    return x.reshape(n, d // 2, 2, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4, 6))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    n, d, h, w, c = x.shape
    x = x[:, :, None, :, None, :, None, :].expand(n, d, 2, h, 2, w, 2, c)
    return x.reshape(n, 2 * d, 2 * h, 2 * w, c)


def unet_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: UNetConfig = UNetConfig(), compute_dtype=torch.float32) -> torch.Tensor:
    """Dense forward: (N, D, H, W, 1) float32 -> (N, D, H, W, n_labels)
    fp32 logits. ``params`` from :func:`to_torch_params`; D/H/W multiples of
    cfg.divisor (use pad_to_divisor)."""
    skips = []
    for lv in range(cfg.n_levels):
        for i in range(cfg.n_conv_per_level):
            x = _elu(_conv(x, params[f"enc{lv}_{i}_w"], params[f"enc{lv}_{i}_b"],
                           compute_dtype), compute_dtype)
        x = _bn(x, params, f"bn_down{lv}", cfg, compute_dtype)
        if lv < cfg.n_levels - 1:
            skips.append(x)
            x = _maxpool2(x)
    for lv in range(cfg.n_levels - 2, -1, -1):
        x = torch.cat([skips[lv], _upsample2(x)], dim=-1)
        for i in range(cfg.n_conv_per_level):
            x = _elu(_conv(x, params[f"dec{lv}_{i}_w"], params[f"dec{lv}_{i}_b"],
                           compute_dtype), compute_dtype)
        x = _bn(x, params, f"bn_up{lv}", cfg, compute_dtype)
    return _conv(x, params["head_w"], params["head_b"], compute_dtype)


def _slab_bounds(z: int, divisor: int, n_shards: int) -> List[int]:
    """z-slab boundaries for ``n_shards`` shards, each slab a whole number
    of ``divisor``-slice blocks (so every pooling level splits at a cell
    boundary); a shard gets no slab when there are fewer blocks than
    shards."""
    n_blk = z // divisor
    return [divisor * (k * n_blk // n_shards) for k in range(n_shards + 1)]


def _conv_halo(xs: List[torch.Tensor], ws: List[torch.Tensor], bs, compute_dtype):
    """:func:`_conv` of a volume held as z slabs, one per shard: each slab
    takes the kernel's half-width of slices from its neighbours' edges (a
    zero slab at the volume's faces, as SAME padding), then convolves
    VALID in z and SAME in y and x on its own device."""
    h = ws[0].shape[2] // 2
    out = []
    for i, x in enumerate(xs):
        dev = x.device
        if h:
            edge = (x.shape[0], h) + tuple(x.shape[2:])
            lo = xs[i - 1][:, -h:].to(dev) if i else x.new_zeros(edge)
            hi = xs[i + 1][:, :h].to(dev) if i + 1 < len(xs) else x.new_zeros(edge)
            x = torch.cat([lo, x, hi], dim=1)
        w = ws[i]
        xc = x.to(compute_dtype).permute(0, 4, 1, 2, 3)
        y = F.conv3d(xc, w.to(compute_dtype), padding=(0, w.shape[3] // 2, w.shape[4] // 2))
        y = y.permute(0, 2, 3, 4, 1).float()
        if bs[i] is not None:
            y = y + bs[i]
        out.append(y.contiguous())
    return out


def unet_apply_sharded(params: List[Dict[str, torch.Tensor]], xs: List[torch.Tensor],
                       cfg: UNetConfig = UNetConfig(),
                       compute_dtype=torch.float32) -> List[torch.Tensor]:
    """:func:`unet_apply` with the volume split into z slabs, one per
    shard, each on its device with its copy of the weights (``params[i]``
    on ``xs[i]``'s device): every 3^3 conv first exchanges one slice of
    halo with the neighbouring slabs; pooling, upsampling, the skips and
    the elementwise steps stay inside a slab (each slab is a whole number
    of ``cfg.divisor`` slices). Returns each slab's fp32 logits."""
    def each(fn, *lists):
        return [fn(*args) for args in zip(*lists)]

    def conv_elu(xs, key):
        ys = _conv_halo(xs, [p[key + "_w"] for p in params], [p[key + "_b"] for p in params],
                        compute_dtype)
        return [_elu(y, compute_dtype) for y in ys]

    def bn(xs, name):
        return each(lambda x, p: _bn(x, p, name, cfg, compute_dtype), xs, params)

    skips = []
    for lv in range(cfg.n_levels):
        for i in range(cfg.n_conv_per_level):
            xs = conv_elu(xs, f"enc{lv}_{i}")
        xs = bn(xs, f"bn_down{lv}")
        if lv < cfg.n_levels - 1:
            skips.append(xs)
            xs = [_maxpool2(x) for x in xs]
    for lv in range(cfg.n_levels - 2, -1, -1):
        xs = each(lambda s, x: torch.cat([s, _upsample2(x)], dim=-1), skips[lv], xs)
        for i in range(cfg.n_conv_per_level):
            xs = conv_elu(xs, f"dec{lv}_{i}")
        xs = bn(xs, f"bn_up{lv}")
    return _conv_halo(xs, [p["head_w"] for p in params], [p["head_b"] for p in params],
                      compute_dtype)


def _s2d_in(x: torch.Tensor) -> torch.Tensor:
    """Dense (N, D, H, W, C) -> in-form (N, D/2+1, H/2+1, W/2+1, 8C).

    Slot (rz,ry,rx) of cell q holds x[2q + r - 1] (zeros beyond the
    volume, matching SAME conv padding)."""
    n, d, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    xp = xp.reshape(n, (d + 2) // 2, 2, (h + 2) // 2, 2, (w + 2) // 2, 2, c)
    xp = xp.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return xp.reshape(n, (d + 2) // 2, (h + 2) // 2, (w + 2) // 2, 8 * c)


def _s2d_regrid(y: torch.Tensor) -> torch.Tensor:
    """Out-form (N, Q, Q, Q, 8C) -> in-form (N, Q+1, Q+1, Q+1, 8C).

    Out-form slot r of cell q is y[2q+r]; in-form slot r of cell q is
    y[2q+r-1] — per dimension, slot 0 is the previous cell's slot 1 and
    slot 1 is this cell's slot 0 (zeros at the borders)."""
    n, qz, qy, qx, c8 = y.shape
    c = c8 // 8
    y = y.reshape(n, qz, qy, qx, 2, 2, 2, c)
    y = F.pad(y, (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1))
    y = torch.stack([y[:, r:r + qz + 1, :, :, 1 - r] for r in range(2)], dim=4)
    y = torch.stack([y[:, :, r:r + qy + 1, :, :, 1 - r] for r in range(2)], dim=5)
    y = torch.stack([y[:, :, :, r:r + qx + 1, :, :, 1 - r] for r in range(2)], dim=6)
    return y.reshape(n, qz + 1, qy + 1, qx + 1, c8)


def _slot_maxpool(t: torch.Tensor, c0: int) -> torch.Tensor:
    """2x maxpool of an out-form tensor: the max over its 8 sub-position
    slots (slot-major channels, slot*c0 + c)."""
    n, qz, qy, qx, _ = t.shape
    return t.reshape(n, qz, qy, qx, 8, c0).amax(dim=4)


def _conv_s2d(x: torch.Tensor, w_packed: torch.Tensor, b,
              compute_dtype=torch.float32) -> torch.Tensor:
    """2^3 VALID conv: in-form (N,Q+1,..,8ci) -> out-form (N,Q,..,8co), one
    ``F.conv3d``; ``w_packed`` is (8*8ci, 8co) from pack_taps. Returns fp32
    conv + bias."""
    c_in, c_out = w_packed.shape[0] // 8, w_packed.shape[1]
    w = w_packed.reshape(2, 2, 2, c_in, c_out).permute(4, 3, 0, 1, 2)
    xc = x.to(compute_dtype).permute(0, 4, 1, 2, 3)
    y = F.conv3d(xc, w.to(compute_dtype))
    return (y.permute(0, 2, 3, 4, 1).float() + b).contiguous()


def unet_apply_s2d(params: Dict[str, torch.Tensor], s2d_params: Dict[str, torch.Tensor],
                   x: torch.Tensor, cfg: UNetConfig = UNetConfig(),
                   compute_dtype=torch.float32, return_logits: bool = False,
                   conv_impl: str = "torch") -> torch.Tensor:
    """Forward with level 0 in space-to-depth form — the same network as
    unet_apply (same weights, reordered). Returns per-voxel class indices
    (N, D, H, W) int64 (argmax in out-form, before the depth-to-space), or
    the fp32 logits with ``return_logits``.

    ``params`` / ``s2d_params`` from :func:`to_torch_params` /
    :func:`to_torch_s2d_params`. ``conv_impl="kernel"`` runs every
    192-channel S2D conv (enc0_1.., dec0_0's skip branch with the folded
    upsample branch as residual, dec0_1..) through ``conv_s2d.conv_s2d``
    (the hand-written CUDA kernel on a CUDA tensor); ``"torch"`` uses one
    ``F.conv3d`` each. enc0_0 (K = 8 * 8 = 64) and the folded upsample conv
    stay ``F.conv3d`` either way, as the reference leaves them to XLA."""
    if cfg.n_levels < 2 or cfg.kernel != 3:
        raise ValueError("S2D path needs n_levels >= 2 and 3^3 kernels")
    if conv_impl not in ("torch", "kernel"):
        raise ValueError(f"conv_impl must be 'torch'|'kernel', got {conv_impl!r}")
    n, d, h, w, _ = x.shape
    if conv_impl == "kernel" and n != 1:
        raise ValueError("conv_impl='kernel' supports a single volume (N=1)")

    def s2d_conv_elu(t_inform, wkey, bkey, residual=None):
        """ELU(S2D-conv(t) [+ residual]); t_inform batched in-form,
        residual batched out-form fp32."""
        if conv_impl == "kernel":
            res0 = None if residual is None else residual[0]
            out = _conv_s2d_mod.conv_s2d(t_inform[0], s2d_params[wkey], s2d_params[bkey],
                                         residual=res0, activation="elu",
                                         compute_dtype=compute_dtype)
            return out[None]
        pre = _conv_s2d(t_inform, s2d_params[wkey], s2d_params[bkey], compute_dtype)
        if residual is not None:
            pre = pre + residual
        return _elu(pre, compute_dtype)

    # --- level-0 encoder in S2D space
    t = _s2d_in(x)
    for i in range(cfg.n_conv_per_level):
        if i:
            t = s2d_conv_elu(_s2d_regrid(t), f"enc0_{i}_w", f"enc0_{i}_b")
        else:
            t = _elu(_conv_s2d(t, s2d_params["enc0_0_w"], s2d_params["enc0_0_b"],
                               compute_dtype), compute_dtype)
    t = _bn(t, s2d_params, "bn_down0", cfg, compute_dtype)
    skip0 = t                                     # out-form, 8*base channels
    c0 = cfg.base_features
    t = _slot_maxpool(t, c0)
    # --- levels 1..n-1 (dense, unchanged)
    skips = []
    for lv in range(1, cfg.n_levels):
        for i in range(cfg.n_conv_per_level):
            t = _elu(_conv(t, params[f"enc{lv}_{i}_w"], params[f"enc{lv}_{i}_b"],
                           compute_dtype), compute_dtype)
        t = _bn(t, params, f"bn_down{lv}", cfg, compute_dtype)
        if lv < cfg.n_levels - 1:
            skips.append(t)
            t = _maxpool2(t)
    for lv in range(cfg.n_levels - 2, 0, -1):
        t = torch.cat([skips[lv - 1], _upsample2(t)], dim=-1)
        for i in range(cfg.n_conv_per_level):
            t = _elu(_conv(t, params[f"dec{lv}_{i}_w"], params[f"dec{lv}_{i}_b"],
                           compute_dtype), compute_dtype)
        t = _bn(t, params, f"bn_up{lv}", cfg, compute_dtype)
    # --- level-0 decoder in S2D space: dec0_0 = skip branch (S2D conv on the
    # regridded skip) + the upsample-folded branch (3^3 SAME conv on the
    # coarse dec1 output) as the residual
    t_up = _conv(t, s2d_params["dec0_0_up_w"], None, compute_dtype)
    t = s2d_conv_elu(_s2d_regrid(skip0), "dec0_0_skip_w", "dec0_0_b", residual=t_up)
    del t_up
    for i in range(1, cfg.n_conv_per_level):
        t = s2d_conv_elu(_s2d_regrid(t), f"dec0_{i}_w", f"dec0_{i}_b")
    t = _bn(t, s2d_params, "bn_up0", cfg, compute_dtype)
    # --- 1^3 head per slot (products of compute_dtype values, fp32 sums),
    # argmax, then depth-to-space the labels
    wh = params["head_w"].reshape(params["head_w"].shape[0], c0).t()
    logits = (t.reshape(n, d // 2, h // 2, w // 2, 8, c0).to(compute_dtype).float()
              @ wh.to(compute_dtype).float()) + params["head_b"]
    if return_logits:
        lg = logits.reshape(n, d // 2, h // 2, w // 2, 2, 2, 2, cfg.n_labels)
        lg = lg.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return lg.reshape(n, d, h, w, cfg.n_labels)
    cls = torch.argmax(logits, dim=-1)             # (n, Q, Q, Q, 8)
    cls = cls.reshape(n, d // 2, h // 2, w // 2, 2, 2, 2)
    cls = cls.permute(0, 1, 4, 2, 5, 3, 6)
    return cls.reshape(n, d, h, w)


# Weights are converted and uploaded once per parameter tree, device, dtype
# and program: repeated segment_volume calls (one per recon volume) reuse
# them. Strong refs to the source params keep ids stable; tiny capacity.
_PARAMS_CACHE: "dict[tuple, tuple]" = {}


def _params_cached(params: Dict, cfg: UNetConfig, device: torch.device,
                   dtype: torch.dtype, s2d: bool):
    """(dense tensors, S2D tensors or None) for ``params``, cached."""
    key = (id(params), device, dtype, s2d)
    hit = _PARAMS_CACHE.get(key)
    if hit is not None and hit[0] is params and hit[1] == cfg:
        return hit[2]
    value = (to_torch_params(params, device, dtype),
             to_torch_s2d_params(s2d_level0_params(params, cfg), device, dtype)
             if s2d else None)
    if len(_PARAMS_CACHE) >= 4:
        _PARAMS_CACHE.pop(next(iter(_PARAMS_CACHE)))
    _PARAMS_CACHE[key] = (params, cfg, value)
    return value


def _resolve_use_s2d(use_s2d):
    """None -> the FT2_UNET_S2D env var: 'kernel' or 'pallas' selects the
    hand kernel, '1'/'true'/'yes'/'on'/'xla' the F.conv3d S2D program,
    anything else (or unset) the dense program."""
    if use_s2d is None:
        env = os.environ.get("FT2_UNET_S2D", "").strip().lower()
        if env in ("kernel", "pallas"):
            return "kernel"
        return env in ("1", "true", "yes", "on", "xla")
    if use_s2d not in (False, True, "kernel"):
        raise ValueError(f"use_s2d must be False, True or 'kernel', got {use_s2d!r}")
    return use_s2d


def segment_volume(params: Dict, data: np.ndarray,
                   cfg: Optional[UNetConfig] = None,
                   labels: Optional[Sequence[int]] = None,
                   compute_dtype: Optional[torch.dtype] = None,
                   use_s2d=None, mesh=None, device="cuda") -> np.ndarray:
    """Segment one (z, y, x) intensity volume -> int16 SynthSeg label map.

    Intensities are robust-max normalized on the host (SynthSeg's
    inference-time preprocessing); the class argmax is mapped through
    ``labels``. cfg and labels default to what the parameter tree implies.
    ``compute_dtype`` defaults to bfloat16 on CUDA and float32 on the CPU.
    ``use_s2d`` selects the space-to-depth level-0 program: False, True
    (``F.conv3d`` S2D convs) or ``"kernel"`` (the 192-channel S2D convs
    through ``conv_s2d``'s hand-written CUDA kernel on a GPU); None reads
    FT2_UNET_S2D (see _resolve_use_s2d). ``device`` defaults to "cuda" and
    raises without a GPU.

    ``mesh`` (a ``parallel.VoxelMesh``) replaces ``device``: the padded
    volume's z axis is split into one slab per mesh device, with the
    weights on each, and the convs exchange halos
    (:func:`unet_apply_sharded`); the labels are the unsharded forward's.
    z is zero-padded up to a multiple of lcm(divisor, mesh size), as the
    reference does: where that exceeds the single-device padding, labels
    near the far z face see more zero context. The S2D program is not laid
    out for slabs: ``use_s2d`` with a mesh raises."""
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    use_s2d = _resolve_use_s2d(use_s2d)
    if mesh is not None and use_s2d:
        raise ValueError("use_s2d and mesh are mutually exclusive (the S2D "
                         "rearranges are not laid out for spatial sharding)")
    if cfg is None:
        cfg = config_from_params(params)
    if use_s2d and (cfg.kernel != 3 or cfg.n_levels < 2):
        raise ValueError(
            f"use_s2d needs 3^3 kernels and n_levels >= 2 (got kernel="
            f"{cfg.kernel}, n_levels={cfg.n_levels})")
    if labels is None:
        labels = (SYNTHSEG_LABELS if cfg.n_labels == len(SYNTHSEG_LABELS)
                  else tuple(range(cfg.n_labels)))
    data = np.asarray(data, np.float32)
    scale = np.percentile(data[data > 0], 99.5) if (data > 0).any() else 1.0
    norm = np.clip(data / max(scale, 1e-6), 0.0, 1.0)
    padded, crop = pad_to_divisor(norm, cfg.divisor)
    if mesh is not None:
        # z must also split evenly over the mesh; the crop strips the extra
        divisor = math.lcm(cfg.divisor, mesh.size)
        padded = np.pad(padded, ((0, -padded.shape[0] % divisor), (0, 0), (0, 0)))
    x = torch.from_numpy(np.ascontiguousarray(padded, np.float32))[None, ..., None].to(dev)
    if mesh is not None:
        return _segment_sharded(params, x, cfg, compute_dtype, mesh, np.asarray(labels, np.int16),
                                crop)
    tp, ts2d = _params_cached(params, cfg, dev, compute_dtype, bool(use_s2d))
    with torch.inference_mode():
        if use_s2d:
            conv_impl = "kernel" if use_s2d == "kernel" else "torch"
            cls = unet_apply_s2d(tp, ts2d, x, cfg, compute_dtype, conv_impl=conv_impl)
        else:
            cls = torch.argmax(unet_apply(tp, x, cfg, compute_dtype), dim=-1)
        cls = cls[0].cpu().numpy()
    lut = np.asarray(labels, np.int16)
    return lut[cls[crop]]


def _segment_sharded(params: Dict, x: torch.Tensor, cfg: UNetConfig, compute_dtype, mesh,
                     lut: np.ndarray, crop) -> np.ndarray:
    """segment_volume's forward over a mesh: one z slab of the padded
    volume ``x`` (on the mesh's first device) per shard that gets one, the
    class argmax per slab, gathered on the first device."""
    bounds = _slab_bounds(x.shape[1], cfg.divisor, mesh.size)
    devs = [d for d, a, b in zip(mesh.devices, bounds, bounds[1:]) if b > a]
    spans = [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]
    with torch.inference_mode():
        xs = [x[:, a:b].to(d) for (a, b), d in zip(spans, devs)]
        tps = [_params_cached(params, cfg, d, compute_dtype, False)[0] for d in devs]
        logits = unet_apply_sharded(tps, xs, cfg, compute_dtype)
        cls = torch.cat([torch.argmax(lg, dim=-1).to(x.device) for lg in logits], dim=1)
        cls = cls[0].cpu().numpy()
    return lut[cls[crop]]
