"""Convert released SynthSeg Keras weights (.h5) to the unet3d .npz manifest.

The reference reaches SynthSeg through FreeSurfer's ``mri_synthseg`` binary
(reference utils/qmri_utils.py:424-466). The published model weights live in
the FreeSurfer tree as a Keras HDF5 file, e.g.::

    $FREESURFER_HOME/models/synthseg_1.0.h5

(also distributed from the SynthSeg repository, Billot et al. 2023). This
converter maps that file onto the parameter tree ``labels.unet3d`` consumes,
so ``SynthSegRunner(mode='torch')`` runs the segmentation on the GPU
instead of shelling out to FreeSurfer's binary::

    python -m fetal_t2mapping_tpu_torch.labels.convert_synthseg \
        $FREESURFER_HOME/models/synthseg_1.0.h5 synthseg_1.0.npz
    FT2_SYNTHSEG_WEIGHTS=synthseg_1.0.npz  # picked up by SynthSegRunner

A copy of ``fetal_t2mapping_tpu.labels.convert_synthseg`` checked against
the port's ``unet3d``: the same .npz, key by key and bitwise. h5py is
imported inside ``convert`` only.

Layer-name mapping (SynthSeg builds its U-Net with neuron's ``unet``; layer
names follow its ``unet_conv_downarm_{level}_{conv}`` /
``unet_conv_uparm_{level}_{conv}`` / ``unet_likelihood`` convention; Keras
Conv3D kernels are stored (kz, ky, kx, c_in, c_out) — the layout unet3d
uses directly):

    unet_conv_downarm_L_I -> encL_I      (encoder, level L, conv I)
    unet_conv_uparm_*_I   -> dec{...}_I  (decoder; uparm groups sorted by
                                          their level index map onto decoder
                                          levels deepest-first)
    unet_likelihood       -> head        (1x1x1 conv to label logits)
    unet_bn_down_L        -> bn_downL    (per-level BatchNormalization —
    unet_bn_up_*          -> bn_up{...}   SynthSeg trains with
                                          batch_norm=-1; gamma/beta/mean/var
                                          fold into inference scale/shift)

The converter is deliberately defensive: it discovers every kernel/bias
dataset in the file regardless of the exact group nesting, prints the
mapping it inferred, and cross-checks every shape against the architecture
implied by the weights themselves (see unet3d.config_from_params). The
numerical correctness of the conversion + forward pass is pinned by
tests/test_synthseg_weights.py (the JAX package's converter) and
tests/test_torch_convert_synthseg.py (this one, against the JAX
package's) on fixture weight files written in the same Keras layout.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Tuple

import numpy as np

_DOWN = re.compile(r"conv_downarm_(\d+)_(\d+)")
_UP = re.compile(r"conv_uparm_(\d+)_(\d+)")
_HEAD = re.compile(r"likelihood")
# SynthSeg trains with batch_norm=-1: neuron's conv_enc/conv_dec insert ONE
# BatchNormalization per level after the level's convs, named
# {prefix}_bn_down_{level} / {prefix}_bn_up_{level}. Their
# gamma/beta/moving_mean/moving_variance fold into per-channel scale/shift
# at inference (Keras default epsilon 1e-3).
_BN_DOWN = re.compile(r"bn_down_(\d+)")
_BN_UP = re.compile(r"bn_up_(\d+)")
_BN_LEAVES = ("gamma", "beta", "moving_mean", "moving_variance")
_BN_EPS = 1e-3


def _collect_conv_weights(h5file):
    """Walk the HDF5 tree; return ({layer: (kernel, bias)}, {bn_layer:
    {leaf: array}}, skipped).

    Handles both Keras layouts: datasets named ``.../kernel:0`` under a
    layer group, and plain ``kernel``/``bias`` names. Real released files
    carry more than conv weights — Keras ``optimizer_weights`` slots (Adam
    moments reuse the ``kernel``/``bias`` leaf names), training metadata —
    all of which are SKIPPED and reported, never mistaken for model convs.
    BatchNormalization parameters belonging to the unet's per-level BN
    layers (bn_down_*/bn_up_*) are COLLECTED (SynthSeg's released weights
    carry them; skipping them would convert a numerically wrong model);
    norm parameters outside that naming are skipped+reported.
    """
    import h5py

    found: Dict[str, Dict[str, np.ndarray]] = {}
    bn_found: Dict[str, Dict[str, np.ndarray]] = {}
    skipped: List[str] = []

    def visit(name, obj):
        if not isinstance(obj, h5py.Dataset):
            return
        parts = name.split("/")
        leaf = parts[-1].split(":")[0]
        if "optimizer_weights" in parts or leaf in ("m", "v", "iter",
                                                    "iterations"):
            skipped.append(f"{name} (optimizer state)")
            return
        if leaf in _BN_LEAVES:
            for part in reversed(parts):
                if _BN_DOWN.search(part) or _BN_UP.search(part):
                    bn_found.setdefault(part, {})[leaf] = np.asarray(
                        obj, np.float32)
                    return
            skipped.append(f"{name} (norm parameters outside the unet "
                           f"bn_down_*/bn_up_* naming: {leaf})")
            return
        if leaf not in ("kernel", "bias"):
            skipped.append(f"{name} (non-conv dataset: {leaf})")
            return
        if leaf == "kernel" and np.ndim(obj) != 5:
            skipped.append(f"{name} (kernel ndim {np.ndim(obj)}, not a "
                           "Conv3D weight)")
            return
        layer = name.rsplit("/", 2)[-2] if "/" in name else name
        # the layer NAME is the path component carrying the unet tag
        for part in reversed(parts):
            if _DOWN.search(part) or _UP.search(part) or _HEAD.search(part):
                layer = part
                break
        found.setdefault(layer, {})[leaf] = np.asarray(obj, np.float32)

    h5file.visititems(visit)
    out = {}
    for layer, d in found.items():
        if "kernel" not in d:
            skipped.append(f"{layer} (bias without kernel)")
            continue
        if d.get("bias") is None:
            raise ValueError(
                f"conv layer {layer!r} has a kernel but no bias dataset — "
                "not a Keras SynthSeg layout this converter understands")
        out[layer] = (d["kernel"], d["bias"])
    for layer, d in bn_found.items():
        missing = sorted(set(_BN_LEAVES) - set(d))
        if missing:
            raise ValueError(
                f"BatchNormalization layer {layer!r} is missing datasets "
                f"{missing} — not a Keras SynthSeg layout this converter "
                "understands")
    return out, bn_found, skipped


def _fold_bn(d: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """(gamma, beta, moving_mean, moving_variance) -> inference (scale,
    shift): y = x*s + b with s = gamma/sqrt(var+eps), b = beta - mean*s."""
    s = d["gamma"] / np.sqrt(d["moving_variance"] + _BN_EPS)
    return s.astype(np.float32), (d["beta"] - d["moving_mean"] * s
                                  ).astype(np.float32)


def _check_single_unet(down, up, head_names: List[str]) -> None:
    """Reject multi-U-Net cascades (the ``--robust`` variant) loudly.

    ``mri_synthseg --robust`` (which the reference invokes,
    utils/qmri_utils.py:445) loads a DIFFERENT architecture — a cascade of
    several U-Nets (denoiser + segmenter) whose layer names carry distinct
    prefixes before the conv_downarm/uparm tags. Silently converting one
    stack of it would produce a wrong segmenter; name the problem instead.
    """
    prefixes = set()
    for name in ([n for _, _, n in down] + [n for _, _, n in up]
                 + head_names):
        for pat in (_DOWN, _UP, _HEAD):
            m = pat.search(name)
            if m:
                prefixes.add(name[: m.start()].rstrip("_") or "<none>")
                break
    if len(prefixes) > 1 or len(head_names) > 1:
        raise ValueError(
            "this file contains MULTIPLE U-Net stacks (layer prefixes: "
            f"{sorted(prefixes)}, {len(head_names)} likelihood heads) — it "
            "looks like the SynthSeg --robust cascade variant, which is a "
            "different architecture this converter does not translate; "
            "convert the plain synthseg_1.0/2.0 single-U-Net weights "
            "instead")


def convert(h5_path: str, npz_path: str, *, verbose: bool = True) -> Dict[str, np.ndarray]:
    """Read a SynthSeg Keras .h5, write the unet3d .npz manifest."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        layers, bn_layers, skipped = _collect_conv_weights(f)
    if not layers:
        raise ValueError(f"no conv kernel/bias datasets found in {h5_path!r}")

    down: List[Tuple[int, int, str]] = []
    up: List[Tuple[int, int, str]] = []
    heads: List[str] = []
    for name in layers:
        m = _DOWN.search(name)
        if m:
            down.append((int(m.group(1)), int(m.group(2)), name))
            continue
        m = _UP.search(name)
        if m:
            up.append((int(m.group(1)), int(m.group(2)), name))
            continue
        if _HEAD.search(name):
            heads.append(name)
        else:
            skipped.append(f"{name} (conv layer outside the unet naming)")
    if not heads or not down or not up:
        raise ValueError(
            f"unrecognized layer naming in {h5_path!r}: need "
            f"conv_downarm_*/conv_uparm_*/likelihood, got {sorted(layers)}")
    _check_single_unet(down, up, heads)
    head = heads[0]

    n_levels = max(lv for lv, _, _ in down) + 1
    params: Dict[str, np.ndarray] = {}
    mapping = []
    for lv, i, name in sorted(down):
        k, b = layers[name]
        params[f"enc{lv}_{i}_w"] = k
        params[f"enc{lv}_{i}_b"] = b
        mapping.append((name, f"enc{lv}_{i}"))
    # uparm level indices vary between neuron versions (some count up from
    # the bottleneck); sort the GROUPS by their index and assign decoder
    # levels deepest-first, which is the build order of both conventions
    up_levels = sorted({lv for lv, _, _ in up})
    dec_levels = list(range(n_levels - 2, -1, -1))
    if len(up_levels) != len(dec_levels):
        raise ValueError(
            f"decoder level count mismatch: {len(up_levels)} uparm groups "
            f"for {n_levels} levels")
    for src_lv, dst_lv in zip(up_levels, dec_levels):
        for lv, i, name in sorted(up):
            if lv != src_lv:
                continue
            k, b = layers[name]
            params[f"dec{dst_lv}_{i}_w"] = k
            params[f"dec{dst_lv}_{i}_b"] = b
            mapping.append((name, f"dec{dst_lv}_{i}"))
    k, b = layers[head]
    params["head_w"] = k
    params["head_b"] = b
    mapping.append((head, "head"))

    if bn_layers:
        bn_down: List[Tuple[int, str]] = []
        bn_up: List[Tuple[int, str]] = []
        for name in bn_layers:
            m = _BN_DOWN.search(name)
            if m:
                bn_down.append((int(m.group(1)), name))
            else:
                bn_up.append((int(_BN_UP.search(name).group(1)), name))
        if (sorted(lv for lv, _ in bn_down) != list(range(n_levels))
                or len(bn_up) != n_levels - 1):
            raise ValueError(
                f"BatchNormalization layer count mismatch: "
                f"{len(bn_down)} bn_down / {len(bn_up)} bn_up layers for a "
                f"{n_levels}-level unet (need one per encoder level and one "
                "per decoder level)")
        for lv, name in sorted(bn_down):
            s, b = _fold_bn(bn_layers[name])
            params[f"bn_down{lv}_s"] = s
            params[f"bn_down{lv}_b"] = b
            mapping.append((name, f"bn_down{lv}"))
        # bn_up indices count the DECODER loop (0 = deepest) in SynthSeg's
        # neuron fork; sort-and-assign-deepest-first also tolerates names
        # that continue the downarm level count, like the uparm convs
        for (_, name), dst_lv in zip(sorted(bn_up), dec_levels):
            s, b = _fold_bn(bn_layers[name])
            params[f"bn_up{dst_lv}_s"] = s
            params[f"bn_up{dst_lv}_b"] = b
            mapping.append((name, f"bn_up{dst_lv}"))

    # architecture self-check: every shape must be consistent with the
    # config the weights imply (raises otherwise)
    from .unet3d import config_from_params, validate_params

    cfg = config_from_params(params)
    validate_params(params, cfg)

    if verbose:
        for src, dst in mapping:
            suffix = "_s" if dst.startswith("bn_") else "_w"
            print(f"  {src:40s} -> {dst:10s} {params[dst + suffix].shape}")
        for name in skipped:
            print(f"  skipped: {name}")
        print(f"config: {cfg}")

    np.savez(npz_path, **params)
    return params


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        raise SystemExit(
            "usage: python -m fetal_t2mapping_tpu_torch.labels.convert_synthseg "
            "<synthseg_weights.h5> <out.npz>")
    convert(argv[0], argv[1])


if __name__ == "__main__":
    main()
