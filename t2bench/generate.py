"""The one traffic generator: echo volumes and masks made from ``--seed``.

Adapted from ``chip_smoke.py`` at commit 69168b9 (``make_data``,
``make_data3``, ``_write_session``, ``_write_session3``, ``session_mask``):
the same per-voxel draws (k and T2 uniform over the configuration's
ranges, additive Gaussian noise clipped at the floor, or the magnitude of
complex Gaussian noise for the rician data) and the same ellipsoid shape
(half-axes 0.75 / 0.85 / 0.65 of the half-grid, bench.py:438-440), here
drawn on the device with a ``torch.Generator`` in a few large calls, and
with the ellipsoid scaled to a mask share and shifted from the centre.

The mask is the fetal brain; the echoes are zero outside a head region
(the brain's ellipsoid grown by the traffic's ``head_scale``), as a
stage-2 reconstruction is zero outside its field of view, so that the
gzip that reads and writes the volumes does a reconstruction's work.

Every seed gets the same mask shares (evenly spaced over the traffic's
range) in the same order, so that the work of a run, and how a cohort's
loads, fits and writes overlap, does not depend on its seed; the seed
picks the shifts and the voxels (and the serve driver's order of calls).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

# bench.py:438-440's ellipsoid, whose share of the cube is pi abc / 6 = 21.7%
HALF_AXES = (0.75, 0.85, 0.65)


def derive(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws of run ``seed``: the same
    (seed, stream) always gives the same number, for any whole ``seed``."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def mask_shares(share_range: Sequence[float], n: int) -> List[float]:
    """``n`` mask shares evenly spaced over ``share_range``."""
    lo, hi = share_range
    return [lo + (hi - lo) * (i + 0.5) / n for i in range(n)]


def shifts(n: int, jitter: int, seed: int) -> np.ndarray:
    """(n, 3) whole-voxel shifts of the ellipsoids' centres in [-jitter, jitter]."""
    return np.random.default_rng(derive(seed, 2)).integers(-jitter, jitter + 1, (n, 3))


def ellipsoid_mask(grid: Sequence[int], share: float, shift: Sequence[int], device,
                   grow: float = 1.0) -> torch.Tensor:
    """(Z, Y, X) bool: the ellipsoid of half-axes ``HALF_AXES`` scaled so
    that it covers ``share`` of the grid, centred ``shift`` voxels off the
    grid's centre, with its half-axes then multiplied by ``grow``."""
    scale = grow * (6.0 * share / (math.pi * math.prod(HALF_AXES))) ** (1.0 / 3.0)
    acc = None
    for axis, (n, half, off) in enumerate(zip(grid, HALF_AXES, shift)):
        c = (torch.arange(n, dtype=torch.float32, device=device) - ((n - 1) / 2 + off)) / (n / 2)
        term = torch.square(c / (half * scale))
        shape = [1, 1, 1]
        shape[axis] = n
        term = term.reshape(shape)
        acc = term if acc is None else acc + term
    return acc <= 1.0


def echoes(data: dict, te: Sequence[float], grid: Sequence[int], gen: torch.Generator,
           device) -> torch.Tensor:
    """(Z, Y, X, T) float32 echoes of voxels with k and T2 drawn uniformly
    from ``data['k']`` and ``data['t2']``: ``k exp(-te / T2)`` plus noise of
    ``data['sigma']``, either added and clipped at ``data['floor']``
    ('gaussian'), or as the magnitude of the complex signal ('rician')."""
    shape = tuple(grid)
    k = torch.empty(shape, dtype=torch.float32, device=device).uniform_(*data["k"], generator=gen)
    t2 = torch.empty(shape, dtype=torch.float32, device=device).uniform_(*data["t2"], generator=gen)
    out = torch.empty(shape + (len(te),), dtype=torch.float32, device=device)
    sigma = float(data["sigma"])
    for j, t in enumerate(te):
        a = k * torch.exp(-float(t) / t2)
        re = a + sigma * torch.randn(shape, generator=gen, device=device)
        if data["noise"] == "gaussian":
            out[..., j] = torch.clamp(re, min=float(data["floor"]))
        elif data["noise"] == "rician":
            out[..., j] = torch.hypot(re, sigma * torch.randn(shape, generator=gen, device=device))
        else:
            raise ValueError(f"unknown noise {data['noise']!r}")
    return out


class Item(NamedTuple):
    """One request: its echoes, its mask and the masked count."""
    signal: torch.Tensor      # (Z, Y, X, T) float32
    mask: torch.Tensor        # (Z, Y, X) bool
    n_masked: int
    share: float


def item(config: dict, traffic: dict, seed: int, index: int, device) -> Item:
    """Item ``index`` of run ``seed``: the same call gives the same bits.
    The echoes are zero outside the head region."""
    n = int(traffic["items"])
    share = mask_shares(traffic["mask_share"], n)[index]
    shift = shifts(n, int(traffic["center_jitter"]), seed)[index]
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, 3, index))
    grid = config["grid"]
    mask = ellipsoid_mask(grid, share, shift, device)
    signal = echoes(config["data"], config["te"], grid, gen, device)
    head = ellipsoid_mask(grid, share, shift, device, grow=float(traffic["head_scale"]))
    signal.mul_(head[..., None])
    return Item(signal, mask, int(mask.sum()), share)


def items(config: dict, traffic: dict, seed: int, device) -> List[Item]:
    """Every item of run ``seed``, in the order the traffic sends them."""
    return [item(config, traffic, seed, i, device) for i in range(int(traffic["items"]))]
