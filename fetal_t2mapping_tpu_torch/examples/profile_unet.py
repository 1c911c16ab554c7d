"""Where one U-Net forward's device time goes, op by op.

Times ``segment_volume`` (SynthSeg's full width, random weights from a
seed) on a synthetic n^3 volume, then records ``reps`` more forwards under
``torch.profiler`` and sums each device op's self time: the counterpart of
the reference's xplane breakdown of its jitted forward. By default the
level-0 convs take the space-to-depth program through the hand-written
kernel (``use_s2d='kernel'``, what ``FT2_UNET_S2D=kernel`` selects), so
``conv_s2d_bf16`` (``csrc/conv_s2d.cu``) has a row of its own; ``dense``
and ``s2d`` select the plain conv3d programs. On the CPU (``--device cpu``)
the table lists CPU ops instead of kernels.

Run:  python -m fetal_t2mapping_tpu_torch.examples.profile_unet [n=160]
          [reps=20] [impl=kernel] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..device import resolve_device
from ..labels.unet3d import UNetConfig, random_params, segment_volume

IMPLS = {"dense": False, "s2d": True, "kernel": "kernel"}


def _self_time_us(event, cuda: bool) -> float:
    """An event's own time: on CUDA the device time of a kernel or copy
    (0 for a host op, whose launches the device rows already count)."""
    if not cuda:
        return event.self_cpu_time_total
    if not str(event.device_type).endswith("CUDA"):
        return 0.0
    t = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if t is None else t


def op_table(prof, cuda: bool, reps: int) -> list:
    """Per-op rows (name, ms per forward, launches per forward, share of
    the ops' summed self time), largest first; on CUDA the kernels and
    copies that ran on the device."""
    rows = []
    for e in prof.key_averages():
        us = _self_time_us(e, cuda)
        if us > 0:
            rows.append([e.key, us / 1e3 / reps, e.count / reps])
    total = sum(r[1] for r in rows) or 1.0
    rows.sort(key=lambda r: -r[1])
    return [{"name": n, "ms": ms, "count": c, "share": ms / total} for n, ms, c in rows]


def main(n: int = 160, reps: int = 20, impl: str = "kernel", device="cuda") -> dict:
    """Profile ``reps`` forwards at n^3 on ``device``; returns the wall ms
    per forward (labels downloaded included), the ops' summed self ms per
    forward and the per-op table (``op_table``)."""
    from torch.profiler import ProfilerActivity, profile

    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {sorted(IMPLS)}; got {impl!r}")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cfg = UNetConfig()
    params = random_params(cfg)
    data = np.random.default_rng(0).uniform(0, 1, (n, n, n)).astype(np.float32)

    def step():
        return segment_volume(params, data, cfg, use_s2d=IMPLS[impl], device=dev)

    step()                                        # weights to the device, kernels loaded
    t0 = time.perf_counter()
    for _ in range(reps):
        step()                                    # labels come back to the host: synced
    wall_ms = (time.perf_counter() - t0) / reps * 1e3

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(reps):
            step()
    rows = op_table(prof, cuda, reps)
    op_ms = sum(r["ms"] for r in rows)
    dtype = "bfloat16" if cuda else "float32"
    print(f"unet {n}^3 forward ({impl}, {dtype}, {dev}): wall {wall_ms:.1f} ms/iter "
          f"(labels downloaded), {'device' if cuda else 'CPU'} op self time "
          f"{op_ms:.1f} ms/iter")
    print("\ntop 15 ops:")
    for r in rows[:15]:
        print(f"  {r['share'] * 100:5.1f}%  {r['ms']:7.2f} ms  x{r['count']:g}  {r['name'][:90]}")
    return {"wall_ms": wall_ms, "op_ms": op_ms, "rows": rows}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=160)
    ap.add_argument("reps", nargs="?", type=int, default=20)
    ap.add_argument("impl", nargs="?", default="kernel", choices=sorted(IMPLS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n, args.reps, args.impl, device=args.device)
