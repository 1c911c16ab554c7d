"""The control of ``correct``: the reference one precision lower, judged.

    python3 -m t2bench.control --workload <cell> --seeds <n> [<n> ...]

Makes a cell's items from each seed at the cell's own size, fits them with
the reference in float32 and in bfloat16 (the precision below the
configurations' float32), puts the bfloat16 maps in the program's place and
prints, a JSON line per seed, the ``off_share`` the judge reads for them.
The benchmark's own runs never run it; its readings set the upper end of
the ``off_share`` limit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import torch

from . import generate, reference, spec


def maps(config: dict, it: generate.Item, keys, dtype) -> dict:
    """The maps ``keys`` of item ``it``, fitted by the reference in ``dtype``."""
    s = it.signal[it.mask]
    out = reference.fit(config, s, dtype=dtype)
    return {key: reference.to_grid(out[key], it.mask) for key in keys}


def off_share(cell: spec.Cell, seed: int, device, dtype=torch.bfloat16) -> float:
    """The judge's ``off_share`` of the reference in ``dtype`` against the
    reference in float32, over the cell's items of ``seed``, on the maps
    the cell's driver judges."""
    keys = importlib.import_module(f"t2bench.{cell.traffic['driver']}").MAPS
    off = masked = 0
    for i in range(int(cell.traffic["items"])):
        it = generate.item(cell.config, cell.traffic, seed, i, device)
        want = maps(cell.config, it, keys, torch.float32)
        got = maps(cell.config, it, keys, dtype)
        off += reference.off_voxels(got, want)
        masked += it.n_masked
    return off / masked


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("t2bench.control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load(os.getcwd(), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        share = off_share(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "off_share": share,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
