"""The three voxel-mesh surfaces, each against its single-device result.

The reference scales with a 20-process fork over voxels on one machine
(reference run_t2mapping.py:442). This port scales over a voxel mesh
(``parallel.VoxelMesh``: a tuple of devices, one shard per entry):

1. **The volume fit** — ``fit_volume(mesh=)`` builds the layout's dense
   batch on the first device, fits it sharded over the mesh and scatters
   the maps there: bitwise the single-device maps.
2. **The registration** — ``register_rigid(mesh=)`` shards the
   fixed-image samples; the metric's partial sums meet on the first device.
3. **The U-Net** — ``segment_volume(mesh=)`` splits the volume's z axis
   into slabs that exchange a halo per conv: the single-device labels.

Run:  python -m fetal_t2mapping_tpu_torch.examples.multichip [n_devices]
          [--devices cuda:0 cuda:0]
(the first n_devices visible GPUs by default; two streams of one card, or a
CPU mesh, are asked for with --devices.)
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from ..core.volume import Volume
from ..entry import dryrun_mesh
from ..labels.unet3d import UNetConfig, random_params, segment_volume
from ..models.volume_fit import fit_volume
from ..parallel.mesh import VOXEL_AXIS
from ..recon.registration import register_rigid
from ..recon.resample import resample_to_reference

TES = (114.0, 202.0, 299.0)
LO, HI = (0.0, 10.0), (10000.0, 2000.0)


def sharded_fit(mesh, rng) -> dict:
    """fit_volume over the mesh against the same request on its first device."""
    n_dev = mesh.size
    z, y, x = 4 * n_dev, 24, 24
    t2 = rng.uniform(40.0, 400.0, (z, y, x)).astype(np.float32)
    k = rng.uniform(650.0, 900.0, (z, y, x)).astype(np.float32)
    te = np.asarray(TES, np.float32)
    vol = (k[..., None] * np.exp(-te / t2[..., None])).astype(np.float32)
    mask = rng.random((z, y, x)) < 0.5

    kw = dict(mask_frac=1.0, max_iters=25)
    single = fit_volume(vol, mask, TES, LO, HI, device=mesh.devices[0], **kw)
    sharded = fit_volume(vol, mask, TES, LO, HI, mesh=mesh, **kw)
    t2_s, t2_1 = sharded.t2.cpu().numpy()[mask], single.t2.cpu().numpy()[mask]
    rel_truth = np.abs(t2_s - t2[mask]) / t2[mask]
    return {
        "n_masked": int(mask.sum()),
        "bitwise": all(torch.equal(getattr(sharded, f), getattr(single, f))
                       for f in sharded._fields),
        "max_shard_vs_single_rel": float(np.abs(t2_s - t2_1).max() / np.abs(t2_1).max()),
        "max_rel_t2_err_vs_truth": float(rel_truth.max()),
        "overflow": int(sharded.n_overflow),
    }


def sharded_registration(mesh, rng) -> dict:
    """register_rigid(mesh=) recovering a known pose."""
    n = 28
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    gz, gy, gx = np.meshgrid(ax, ax, ax, indexing="ij")
    img = (np.exp(-4 * (gz ** 2 + gy ** 2 + gx ** 2))
           * (1 + 0.4 * np.sin(7 * gx) * np.cos(5 * gy)
              + 0.2 * np.sin(6 * gz))).astype(np.float32)
    fixed = Volume(img)
    center = np.asarray(fixed.center_world())
    rot, trans = 0.04, np.array([1.5, -1.0, 1.0])
    c, s = np.cos(rot), np.sin(rot)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    T[:3, 3] = center - T[:3, :3] @ center + trans
    moving = resample_to_reference(fixed, fixed, transform=T, device=mesh.devices[0])

    reg = register_rigid(fixed, moving, mesh=mesh, metric="ncc",
                         levels=(2, 1), sigmas=(1.0, 0.0), iters=(150, 100),
                         stop_tol=None)
    comp = T @ reg.matrix
    rot_err = float(np.arccos(np.clip((np.trace(comp[:3, :3]) - 1) / 2, -1, 1)))
    t_err = float(np.abs(comp[:3, 3] - center + comp[:3, :3] @ center).max())
    return {"rot_err_rad": rot_err, "trans_err_mm": t_err}


@contextlib.contextmanager
def _no_tf32():
    """fp32 convs and matmuls in full precision on the card (cuDNN and
    cuBLAS default to TF32), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sharded_unet(mesh, rng) -> dict:
    """z-sharded U-Net labels against the single-device forward (fp32)."""
    cfg = UNetConfig(n_levels=3, base_features=4, n_labels=7)
    params = random_params(cfg, seed=2)
    data = np.abs(rng.normal(400.0, 90.0, (4 * mesh.size, 20, 16))).astype(np.float32)
    with _no_tf32():
        single = segment_volume(params, data, cfg, compute_dtype=torch.float32,
                                device=mesh.devices[0])
        sharded = segment_volume(params, data, cfg, compute_dtype=torch.float32, mesh=mesh)
    return {"label_agreement": float((single == sharded).mean()),
            "n_labels": int(len(np.unique(sharded)))}


def main(n_devices: int = 2, devices=None) -> dict:
    """The three surfaces over a mesh of ``devices`` (or the first
    ``n_devices`` visible GPUs; fewer raise); returns their stats."""
    mesh = dryrun_mesh(len(devices) if devices is not None else n_devices, devices)
    rng = np.random.default_rng(0)
    stats = {
        "n_devices": mesh.size,
        "devices": [str(d) for d in mesh.devices],
        "fit": sharded_fit(mesh, rng),
        "registration": sharded_registration(mesh, rng),
        "unet": sharded_unet(mesh, rng),
    }
    print(f"mesh: {stats['devices']} over axis {VOXEL_AXIS!r}")
    f = stats["fit"]
    print(f"fit_volume(mesh=) ({f['n_masked']} masked voxels): bitwise {f['bitwise']}, "
          f"shard-vs-single max rel {f['max_shard_vs_single_rel']:.2e}, "
          f"vs truth {f['max_rel_t2_err_vs_truth']:.2e}, overflow {f['overflow']}")
    r = stats["registration"]
    print(f"register_rigid(mesh=): recovered pose to "
          f"{r['rot_err_rad']:.4f} rad / {r['trans_err_mm']:.2f} mm")
    u = stats["unet"]
    print(f"segment_volume(mesh=): sharded-vs-single label agreement "
          f"{u['label_agreement']:.4f} ({u['n_labels']} labels)", flush=True)
    return stats


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=2)
    ap.add_argument("--devices", nargs="+", default=None)
    args = ap.parse_args()
    main(args.n_devices, devices=args.devices)
