"""Fused S2D conv of the U-Net's level 0: the counterpart of
``fetal_t2mapping_tpu.labels.pallas_conv``.

The 2^3 VALID "S2D conv" of an in-form tensor (Qz+1, Qy+1, Qx+1, C) into
the out-form (Qz, Qy, Qx, C') — ``unet3d._conv_s2d`` — as one im2col
matmul (M, 8C) @ (8C, C') with bias, the decoder's upsample-branch
residual and the ELU fused into the epilogue. At SynthSeg's level 0,
C = C' = 192 and K = 8C = 1536.

On a CUDA tensor :func:`conv_s2d` launches the hand-written kernel
``csrc/conv_s2d.cu`` — bf16 through its wgmma + TMA implicit GEMM, fp32
through its SIMT path; on a CPU tensor it runs the plain PyTorch version
:func:`_conv_s2d_plain`. There is no other branch.

What the bf16 kernel needs from here: the tile plan (:func:`tile_plan`,
tiles of TILE_Y x TILE_X out-form voxels of one z-plane by TILE_N output
channels) and the weight as a K-major copy padded to whole TILE_K channel
chunks per tap (:func:`kmajor_weight`), made once per weight tensor and
kept in a small cache keyed on the tensor.

Numerics (both versions, as the reference): operands rounded to
``compute_dtype``, products and sums in fp32, bias and residual (rounded to
``compute_dtype`` first, as ``pallas_conv.py:155`` does) added in fp32,
ELU as ``where(acc > 0, acc, exp(min(acc, 0)) - 1)`` (not ``expm1``), one
rounding to ``compute_dtype`` at the end. Kernel and plain version differ
only in the order of the fp32 sums.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import build
from ..utils.profiling import profiler

_ACTIVATIONS = ("elu", None)
#: the bf16 kernel's tile: out-form voxels along x and y (one z-plane),
#: output channels, and the K chunk (channels of one tap) per pipeline
#: stage — conv_s2d.cu's kTileX, kTileY, kBN, kBK
TILE_X, TILE_Y, TILE_N, TILE_K = 16, 8, 192, 64


class TilePlan(NamedTuple):
    """The bf16 kernel's grid of output tiles. The kernel numbers them with
    the channel tile fastest, then x, y and z (one tile per z-plane)."""
    tiles_x: int
    tiles_y: int
    tiles_z: int
    tiles_n: int

    @property
    def total(self) -> int:
        return self.tiles_n * self.tiles_x * self.tiles_y * self.tiles_z


def tile_plan(qz: int, qy: int, qx: int, c_out: int) -> TilePlan:
    """The tiles covering an out-form (qz, qy, qx, c_out): ragged edges
    fall in partial tiles, whose rows and channels past the grid the
    kernel drops at the store."""
    return TilePlan(-(-qx // TILE_X), -(-qy // TILE_Y), qz, -(-c_out // TILE_N))


def padded_channels(c: int) -> int:
    """C rounded up to whole TILE_K chunks: the per-tap K of the weight copy."""
    return -(-c // TILE_K) * TILE_K


def kmajor_weight(w_packed: torch.Tensor, c: int) -> torch.Tensor:
    """(8C, C') ``pack_taps`` weight -> the bf16 kernel's K-major copy
    (C', 8 Cp), Cp = :func:`padded_channels` (C): row n holds output
    channel n's taps in pack order, each tap's C weights followed by
    Cp - C zeros. Same dtype and device as ``w_packed``."""
    k, c_out = w_packed.shape
    if k != 8 * c:
        raise ValueError(f"w_packed {tuple(w_packed.shape)} != (8*{c}, c_out)")
    cp = padded_channels(c)
    wk = w_packed.new_zeros((c_out, 8, cp))
    wk[:, :, :c] = w_packed.reshape(8, c, c_out).permute(2, 0, 1)
    return wk.reshape(c_out, 8 * cp)


# K-major copies by source tensor: (weakref to the source, copy). The key
# holds the source's version counter, so an in-place update misses; an
# inference tensor has none (and cannot be updated in place outside
# inference mode).
_KMAJOR_CACHE: "dict[tuple, tuple]" = {}
_KMAJOR_CACHE_SIZE = 8


def _kmajor_cached(w_packed: torch.Tensor, c: int, dtype: torch.dtype) -> torch.Tensor:
    version = None if w_packed.is_inference() else w_packed._version
    key = (w_packed.data_ptr(), tuple(w_packed.shape), w_packed.dtype, w_packed.device,
           version, dtype)
    hit = _KMAJOR_CACHE.get(key)
    if hit is not None and hit[0]() is w_packed:
        return hit[1]
    wk = kmajor_weight(w_packed.to(dtype), c).contiguous()
    if len(_KMAJOR_CACHE) >= _KMAJOR_CACHE_SIZE:
        _KMAJOR_CACHE.pop(next(iter(_KMAJOR_CACHE)))
    _KMAJOR_CACHE[key] = (weakref.ref(w_packed), wk)
    return wk


def check_kernel_args(c: int, c_out: int, compute_dtype: torch.dtype) -> None:
    """Raise for what csrc/conv_s2d.cu does not take: an operand type other
    than float32 or bfloat16, or C or C' not a multiple of 8 (16-byte rows,
    as TMA and the 16-byte copies need)."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the conv_s2d kernel takes float32 or bfloat16, got {compute_dtype}")
    if c % 8 or c_out % 8:
        raise ValueError(f"the conv_s2d kernel needs C and C' multiples of 8, got {c}, {c_out}")


def pack_taps(w2: np.ndarray) -> np.ndarray:
    """(2,2,2,C,C') S2D kernel (unet3d._s2d_kernel layout) -> (8C, C')
    matmul weight, rows tap-major (uz,uy,ux) with channel minor — the order
    in which both versions concatenate the tap operands."""
    w2 = np.asarray(w2)
    kz, ky, kx, c_in, c_out = w2.shape
    if (kz, ky, kx) != (2, 2, 2):
        raise ValueError(f"expected a 2^3 S2D kernel, got {w2.shape}")
    return w2.reshape(8 * c_in, c_out)


def _check_shapes(x_inform, w_packed, bias, residual, activation):
    if x_inform.dim() != 4:
        raise ValueError(f"x_inform must be (Qz+1, Qy+1, Qx+1, C), got {tuple(x_inform.shape)}")
    qz1, qy1, qx1, c = x_inform.shape
    qz, qy, qx = qz1 - 1, qy1 - 1, qx1 - 1
    if min(qz, qy, qx) < 1:
        raise ValueError(f"x_inform {tuple(x_inform.shape)} has an empty out-form grid")
    if w_packed.dim() != 2 or w_packed.shape[0] != 8 * c:
        raise ValueError(f"w_packed {tuple(w_packed.shape)} != (8*{c}, c_out)")
    c_out = w_packed.shape[1]
    if tuple(bias.shape) != (c_out,):
        raise ValueError(f"bias {tuple(bias.shape)} != ({c_out},)")
    if residual is not None and tuple(residual.shape) != (qz, qy, qx, c_out):
        raise ValueError(f"residual {tuple(residual.shape)} != {(qz, qy, qx, c_out)}")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation must be 'elu' or None, got {activation!r}")
    return qz, qy, qx, c, c_out


def conv_s2d(x_inform: torch.Tensor, w_packed: torch.Tensor, bias: torch.Tensor,
             residual: Optional[torch.Tensor] = None, *,
             activation: Optional[str] = "elu",
             compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused S2D conv: in-form (Qz+1, Qy+1, Qx+1, C) -> out-form
    (Qz, Qy, Qx, C') in ``compute_dtype``, with bias (+ optional
    pre-activation residual, e.g. the decoder's upsample branch) and ELU
    applied in the epilogue.

    ``w_packed`` is ``pack_taps(w2)``. On CUDA the kernel takes float32 or
    bfloat16 ``compute_dtype``, C and C' multiples of 8, and every tensor on
    ``x_inform``'s device, contiguous after the cast; anything else raises.
    """
    qz, qy, qx, c, c_out = _check_shapes(x_inform, w_packed, bias, residual, activation)
    if x_inform.device.type == "cpu":
        return _conv_s2d_plain(x_inform, w_packed, bias, residual,
                               activation=activation, compute_dtype=compute_dtype)
    if x_inform.device.type != "cuda":
        raise ValueError(f"unsupported device {x_inform.device}")
    return _conv_s2d_cuda(x_inform, w_packed, bias, residual, activation=activation,
                          compute_dtype=compute_dtype, shape=(qz, qy, qx, c, c_out))


def _conv_s2d_plain(x_inform: torch.Tensor, w_packed: torch.Tensor, bias: torch.Tensor,
                    residual: Optional[torch.Tensor] = None, *,
                    activation: Optional[str] = "elu",
                    compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the 8 tap slices concatenated
    along channels into (M, 8C), one fp32 matmul of the compute_dtype-rounded
    operands (a product of two bf16 values is exact in fp32), then the
    reference's epilogue (pallas_conv.py:82-91)."""
    qz, qy, qx, c, c_out = _check_shapes(x_inform, w_packed, bias, residual, activation)
    m = qz * qy * qx
    x = x_inform.to(compute_dtype).float()
    cols = [x[uz:uz + qz, uy:uy + qy, ux:ux + qx, :].reshape(m, c)
            for uz in (0, 1) for uy in (0, 1) for ux in (0, 1)]
    acc = torch.cat(cols, dim=-1) @ w_packed.to(compute_dtype).float()
    acc = acc + bias.float()
    if residual is not None:
        acc = acc + residual.to(compute_dtype).float().reshape(m, c_out)
    if activation == "elu":
        acc = torch.where(acc > 0, acc, torch.exp(torch.clamp(acc, max=0.0)) - 1.0)
    return acc.reshape(qz, qy, qx, c_out).to(compute_dtype)


def _check_geometry(lib) -> None:
    """Raise unless the library's tile is the one :func:`tile_plan` uses."""
    got = (ctypes.c_int * 4)()
    lib.ft2_conv_s2d_geometry(got)
    if tuple(got) != (TILE_X, TILE_Y, TILE_N, TILE_K):
        raise RuntimeError(f"conv_s2d.cu's tile {tuple(got)} differs from conv_s2d.py's "
                           f"{(TILE_X, TILE_Y, TILE_N, TILE_K)}")


def _conv_s2d_cuda(x_inform, w_packed, bias, residual, *, activation, compute_dtype,
                   shape):
    """Launch csrc/conv_s2d.cu on x_inform's device and current stream."""
    qz, qy, qx, c, c_out = shape
    check_kernel_args(c, c_out, compute_dtype)
    dev = x_inform.device
    bf16 = compute_dtype == torch.bfloat16
    args = {"x_inform": x_inform.to(compute_dtype),
            "w_packed": (_kmajor_cached(w_packed, c, compute_dtype) if bf16
                         else w_packed.to(compute_dtype)),
            "bias": bias.to(torch.float32)}
    if residual is not None:
        args["residual"] = residual.to(compute_dtype)
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x_inform on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((qz, qy, qx, c_out), dtype=compute_dtype, device=dev)
    lib = build.load_lib("conv_s2d")
    res = args.get("residual")
    ptrs = (args["x_inform"].data_ptr(), args["w_packed"].data_ptr(), args["bias"].data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr())
    elu = int(activation == "elu")
    with torch.cuda.device(dev):
        if bf16:
            _check_geometry(lib)
            plan = tile_plan(qz, qy, qx, c_out)
            err = lib.ft2_conv_s2d_bf16(*ptrs, qz, qy, qx, c, c_out, elu, plan.tiles_x,
                                        plan.tiles_y, plan.tiles_n, build.stream(dev))
        else:
            err = lib.ft2_conv_s2d_f32(*ptrs, qz, qy, qx, c, c_out, elu, build.stream(dev))
    build.check_launch(err, "conv_s2d")
    profiler.count("conv_s2d.launches")
    return out
