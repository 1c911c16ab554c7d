"""Pluggable SynthSeg adapter (external pretrained segmentation CNN).

The counterpart of ``fetal_t2mapping_tpu.labels.synthseg``: a directory of
recon NIfTIs in, a directory of ``*_synthseg.nii.gz`` int16 label NIfTIs
out, with four backends:

- 'subprocess': invoke a user-provided command template per directory pair
  (default ``mri_synthseg --i {input} --o {output} --robust --threads 4 --cpu``)
- 'torch':     the 3-D U-Net of :mod:`.unet3d` on ``device`` (default
  "cuda"; raises without a GPU), or with its z axis sharded over ``mesh``
  (a ``parallel.VoxelMesh``); weights from ``weights`` or
  $FT2_SYNTHSEG_WEIGHTS (.npz manifest). FT2_UNET_S2D selects the program.
- 'callable':  any Python function f(input_dir, output_dir)
- 'fake':      deterministic threshold-based labeler for tests/pipelines
  without FreeSurfer (foreground -> WM id 2, bright -> GM id 3)

The 'subprocess' and 'callable' modes hand files to code with its own
I/O, so queued writes (``nifti.write_async``) land first; 'torch' and
'fake' read through ``nifti.read``, which serves them from the volume
cache.
"""

from __future__ import annotations

import dataclasses
import os
import shlex
import shutil
import subprocess
from typing import Callable, Optional

import numpy as np

from ..core import nifti
from ..core.volume import host_array

DEFAULT_CMD = "mri_synthseg --i {input} --o {output} --robust --threads 4 --cpu"


def _out_name(path: str) -> str:
    return os.path.basename(path).replace(".nii.gz", "_synthseg.nii.gz")


@dataclasses.dataclass
class SynthSegRunner:
    mode: str = "subprocess"  # 'subprocess' | 'torch' | 'callable' | 'fake'
    command_template: str = DEFAULT_CMD
    fn: Optional[Callable[[str, str], None]] = None
    weights: Optional[str] = None  # .npz for mode='torch' ($FT2_SYNTHSEG_WEIGHTS)
    device: str = "cuda"           # mode='torch' runs the U-Net here
    mesh: Optional[object] = None  # parallel.VoxelMesh: mode='torch' shards z over it

    def available(self) -> bool:
        if self.mode == "subprocess":
            return shutil.which(self.command_template.split()[0]) is not None
        if self.mode == "torch":
            return bool(self.weights or os.environ.get("FT2_SYNTHSEG_WEIGHTS"))
        return True

    def run(self, input_dir: str, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        if self.mode in ("subprocess", "callable"):
            nifti.flush_writes(force=True)
        if self.mode == "subprocess":
            # split the TEMPLATE, then substitute paths as whole argv
            # elements — paths with spaces must not be word-split
            argv = [a.format(input=input_dir, output=output_dir)
                    for a in shlex.split(self.command_template)]
            subprocess.run(argv, check=True)
        elif self.mode == "torch":
            self._torch(input_dir, output_dir)
        elif self.mode == "callable":
            if self.fn is None:
                raise ValueError("mode='callable' requires fn")
            self.fn(input_dir, output_dir)
        elif self.mode == "fake":
            self._fake(input_dir, output_dir)
        else:
            raise ValueError(f"unknown mode {self.mode!r}")

    def _torch(self, input_dir: str, output_dir: str) -> None:
        from . import unet3d

        weights = self.weights or os.environ.get("FT2_SYNTHSEG_WEIGHTS")
        if not weights:
            raise ValueError(
                "mode='torch' needs converted SynthSeg weights "
                "(weights=... or FT2_SYNTHSEG_WEIGHTS)")
        params = unet3d.load_params(weights)
        for path in nifti.list_volumes(input_dir):
            vol = nifti.read(path)
            labels = unet3d.segment_volume(params, host_array(vol.data),
                                           mesh=self.mesh, device=self.device)
            nifti.write(os.path.join(output_dir, _out_name(path)),
                        vol.with_data(labels), dtype=np.int16)

    @staticmethod
    def _fake(input_dir: str, output_dir: str) -> None:
        for path in nifti.list_volumes(input_dir):
            vol = nifti.read(path)
            data = host_array(vol.data).astype(np.float32, copy=False)
            fg = data > np.percentile(data, 60)
            bright = data > np.percentile(data, 85)
            labels = np.zeros(data.shape, np.int16)
            labels[fg] = 2      # aseg left-cerebral-WM
            labels[bright] = 3  # aseg left-cerebral-GM
            nifti.write(os.path.join(output_dir, _out_name(path)),
                        vol.with_data(labels), dtype=np.int16)
