"""Run one cell of the benchmark and print its result line.

    python3 -m t2bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: ``BENCHMARK.json`` names the cell. Exits
non-zero without a result where CUDA or the cell's cards are missing, or
where the process holds JAX or the JAX package once the window has closed.
The last line of standard output is the result as one JSON object; the
last lines of standard error are the numbers that decide ``correct``, each
beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
#: top-level module names that no run may hold (compared whole: the
#: program's name begins with the JAX package's)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fetal_t2mapping_tpu"})


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def _cache_dirs() -> None:
    """Kernel caches of the libraries the program runs on, at fixed paths
    inside the checkout (the program's own nvcc builds go to its
    ``_build/``)."""
    base = os.path.join(ROOT, ".t2bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(base, sub))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_dirs()

    from . import harness, spec

    cell = spec.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"t2bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    held = forbidden_modules()
    if held:
        print(f"t2bench: the run loaded {held}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
