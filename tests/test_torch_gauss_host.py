"""The gaussian fit kernel's per-voxel code (csrc/gauss_fit.cu, above the
"kernel and C entry" marker) compiled as host C++ with g++, with its fit
split at the head/tail boundary, held bitwise against the same code in one
pass and against the plain PyTorch version ``fused_fit._gauss_fit_plain``
on the CPU.

On the card ``ft2_gauss_fit`` runs two kernels: the head (one thread per
voxel) runs the init, the grid scan and a few loop turns, writes the voxels
that stopped and pushes the carried state of the others into a worklist; a
persistent tail resumes each slot for the rest of the budget, in whatever
order its lanes take them. Here the head runs voxel by voxel, the slots go
into the same slot layout (each slot packed in float4s with the voxel's
signal), and the tail takes them in reverse order, for several head
lengths: the result of every voxel must not change.

Both sides take exp and log through float64 and round to float32 once
(``-ffp-contract=off`` keeps g++ from fusing anything). Needs g++; the test
skips when it is missing.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu_torch import build
from fetal_t2mapping_tpu_torch.models import fused_fit

torch.set_num_threads(1)

TES3 = (114.0, 202.0, 299.0)
TES6 = (114.0, 150.0, 202.0, 250.0, 299.0, 350.0)
BOXES = {  # the low-field prior box (config._FIT_TABLE) and the no-prior one
    "prior": ((600.0, 10.0), (10000.0, 600.0), False),
    "no_prior": ((0.0, 10.0), (10000.0, 2000.0), True),
}
TOLERANCES = {  # bench.py's gaussian rows; the pipeline's (config.FitConfig)
    "bench": dict(ftol=1e-2, gtol=1e-2, stall_tol=1e-2),
    "pipeline": dict(ftol=1e-9, gtol=0.0, stall_tol=1e-3),
}
MAX_ITERS = 60
N_VOX = 300

MARKER = "// ---- kernel and C entry"

HOST_MAIN = r"""
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

static inline float f64_expf(float x) { return (float)std::exp((double)x); }
static inline float f64_logf(float x) { return (float)std::log((double)x); }
#define expf f64_expf
#define logf f64_logf

#include "gauss_per_voxel.inc"

namespace {

template <int T>
void put(float* out, long n, long i, const Gauss<T>& v, bool conv) {
  out[i] = v.k;
  out[n + i] = v.t2;
  out[2 * n + i] = v.f;
  out[3 * n + i] = conv ? 1.0f : 0.0f;
  out[4 * n + i] = v.nit;
}

// head_iters < 0: one pass (fit_voxel). Else the head over every voxel,
// its pushes into a worklist of n slots of slot_rows<T>() floats, then the
// tail over the slots from the last to the first. Counts the slots pushed
// and those pushed with e still the grid scan's row.
template <int T>
void fit(const float* sig, long n, const GaussParams& p, int max_iters, int head_iters,
         bool no_prior, float* out, long& pushed, long& from_grid) {
  std::vector<float> rows((size_t)slot_rows<T>() * n);
  pushed = from_grid = 0;
  for (long i = 0; i < n; ++i) {
    float s[T];
    for (int t = 0; t < T; ++t) s[t] = sig[i * T + t];
    const KBox b = k_box(s[0], p, no_prior);
    Gauss<T> v;
    bool conv;
    if (head_iters < 0) {
      conv = fit_voxel<T>(s, p, b, max_iters, 3, false, v);
    } else if (head_voxel<T>(s, p, b, max_iters, 3, head_iters, v, conv)) {
      from_grid += v.grid >= 0;
      save_slot<T>(rows.data(), pushed++, (int)i, s, v);
      continue;
    }
    put<T>(out, n, i, v, conv);
  }
  for (long slot = pushed - 1; slot >= 0; --slot) {
    float s[T];
    Gauss<T> v;
    const int i = load_slot<T>(rows.data(), slot, s, v);
    const KBox b = k_box(s[0], p, no_prior);
    bool conv = false;
    int left = max_iters - head_iters;
    while (!tail_step<T>(s, p, b, 3, v, conv, left)) {
    }
    put<T>(out, n, i, v, conv);
  }
}

std::vector<float> read_floats(const char* path, size_t count) {
  std::vector<float> v(count);
  FILE* f = std::fopen(path, "rb");
  if (!f || std::fread(v.data(), sizeof(float), count, f) != count) std::exit(3);
  std::fclose(f);
  return v;
}

}  // namespace

// gauss_host T max_iters head_iters no_prior n params.bin signal.bin out.bin
//   out.bin: k, t2, f, converged (0/1), n_iter, each (n,) float32; prints
//   the slots pushed and those pushed with e from the grid scan
int main(int argc, char** argv) {
  if (argc != 9) return 2;
  const int T = std::atoi(argv[1]), it = std::atoi(argv[2]), head = std::atoi(argv[3]);
  const bool no_prior = std::atoi(argv[4]) != 0;
  const long n = std::atol(argv[5]);
  std::vector<float> pf = read_floats(argv[6], kParamFloats);
  GaussParams p;
  std::memcpy(&p, pf.data(), sizeof(p));
  std::vector<float> sig = read_floats(argv[7], (size_t)n * T), out(5 * (size_t)n);
  long pushed, from_grid;
  if (T == 3) fit<3>(sig.data(), n, p, it, head, no_prior, out.data(), pushed, from_grid);
  else if (T == 6) fit<6>(sig.data(), n, p, it, head, no_prior, out.data(), pushed, from_grid);
  else return 2;
  FILE* f = std::fopen(argv[8], "wb");
  std::fwrite(out.data(), sizeof(float), out.size(), f);
  std::fclose(f);
  std::printf("%ld %ld\n", pushed, from_grid);
  return 0;
}
"""


@pytest.fixture(scope="module")
def gauss_host(tmp_path_factory):
    """The host build of gauss_fit.cu's per-voxel code (path of the binary)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build gauss_fit.cu's per-voxel code for the host")
    d = tmp_path_factory.mktemp("gauss_host")
    with open(build.KERNEL_SOURCES["gauss_fit"]) as f:
        src = f.read()
    assert MARKER in src
    (d / "gauss_per_voxel.inc").write_text(src.split(MARKER)[0])
    shutil.copy(os.path.join(build.CSRC, "fit_common.cuh"), d / "fit_common.cuh")
    (d / "shim").mkdir()
    (d / "shim" / "cuda_runtime.h").write_text(
        "#pragma once\nstruct alignas(16) float4 { float x, y, z, w; };\n")
    (d / "gauss_host.cpp").write_text(HOST_MAIN)
    exe = d / "gauss_host"
    cmd = [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fno-strict-aliasing",
           "-D__device__=", "-D__forceinline__=inline", f"-I{d / 'shim'}", f"-I{d}",
           str(d / "gauss_host.cpp"), "-o", str(exe)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return exe


class _F64Math:
    """``torch`` with exp and log taken through float64 and rounded to
    float32 once, like the host build's."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def exp(x):
        return torch.exp(x.double()).float()

    @staticmethod
    def log(x):
        return torch.log(x.double()).float()


@pytest.fixture
def f64_math(monkeypatch):
    monkeypatch.setattr(fused_fit, "torch", _F64Math())


def _signal(tes, seed):
    """bench.py's generator (k ~ U(600, 5000), T2 ~ U(20, 500), noise
    sigma 8, clipped at 1e-2) and edge rows: all NaN, one NaN echo, all 0,
    saturated at the k bound, far above it, flat, and at the clip."""
    rng = np.random.default_rng(seed)
    te = np.asarray(tes, np.float32)
    k = rng.uniform(600.0, 5000.0, N_VOX).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, N_VOX).astype(np.float32)
    sig = (k[:, None] * np.exp(-te[None, :] / t2[:, None])).astype(np.float32)
    sig = np.maximum(sig + rng.normal(0, 8.0, sig.shape).astype(np.float32), 1e-2)
    sig[0] = np.nan
    sig[1, 1] = np.nan
    sig[2] = 0.0
    sig[3] = 1e4
    sig[4] = 1e20
    sig[5] = 1000.0
    sig[6] = 1e-2
    return np.ascontiguousarray(sig, np.float32)


def _same_bits(a, b):
    return (a == b) | (np.isnan(a) & np.isnan(b))


def _params(tes, box, tol):
    lo, hi, _ = BOXES[box]
    kw = TOLERANCES[tol]
    return fused_fit._kernel_params(tes, lo, hi, kw["ftol"], kw["gtol"], kw["stall_tol"])


def _run_host(exe, tmp_path, tes, params, sig, no_prior, head_iters, max_iters=MAX_ITERS):
    (tmp_path / "params.bin").write_bytes(np.asarray(params, np.float32).tobytes())
    (tmp_path / "signal.bin").write_bytes(sig.tobytes())
    out = subprocess.run([str(exe), str(len(tes)), str(max_iters), str(head_iters),
                          str(int(no_prior)), str(N_VOX), str(tmp_path / "params.bin"),
                          str(tmp_path / "signal.bin"), str(tmp_path / "out.bin")],
                         capture_output=True, text=True, check=True)
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(5, N_VOX)
    pushed, from_grid = map(int, out.stdout.split())
    return got, pushed, from_grid


@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("tol", sorted(TOLERANCES))
@pytest.mark.parametrize("tes", [TES3, TES6], ids=["3te", "6te"])
def test_host_one_pass_is_bitwise_the_plain_version(gauss_host, f64_math, tmp_path, tes, tol,
                                                    box):
    sig = _signal(tes, seed=len(tes))
    lo, hi, no_prior = BOXES[box]
    got, _, _ = _run_host(gauss_host, tmp_path, tes, _params(tes, box, tol), sig, no_prior,
                          head_iters=-1)
    k, t2, f, conv, nit = fused_fit._gauss_fit_plain(
        torch.from_numpy(sig), tes, lo, hi, max_iters=MAX_ITERS, no_prior=no_prior,
        full_budget=False, stall_iters=3, **TOLERANCES[tol])
    want = np.stack([k.numpy(), t2.numpy(), f.numpy(), conv.numpy().astype(np.float32),
                     nit.numpy().astype(np.float32)])
    assert np.isfinite(want[:, 7:]).all()
    same = _same_bits(got, want).all(axis=0)
    assert same.all(), f"{(~same).sum()} of {N_VOX} voxels differ, first {np.flatnonzero(~same)[:5]}"


@pytest.mark.parametrize("head_iters", [0, 1, 2, MAX_ITERS])
@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("tol", sorted(TOLERANCES))
@pytest.mark.parametrize("tes", [TES3, TES6], ids=["3te", "6te"])
def test_host_head_and_tail_are_bitwise_one_pass(gauss_host, tmp_path, tes, tol, box,
                                                 head_iters):
    """Head + worklist + tail (slots taken in reverse) give every voxel the
    bits of one pass, and the slots pushed are the voxels still
    unconverged after the head's loop turns. With no turn in the head,
    every voxel is pushed straight from the scan, those where a grid
    candidate beat the log-linear init with e still the candidate's
    float64-built row, which the slot carries."""
    sig = _signal(tes, seed=len(tes))
    params = _params(tes, box, tol)
    no_prior = BOXES[box][2]
    one, _, _ = _run_host(gauss_host, tmp_path, tes, params, sig, no_prior, head_iters=-1)
    head, _, _ = _run_host(gauss_host, tmp_path, tes, params, sig, no_prior, head_iters=-1,
                           max_iters=min(head_iters, MAX_ITERS))
    running = int((head[3] <= 0.5).sum()) if head_iters < MAX_ITERS else 0
    split, pushed, from_grid = _run_host(gauss_host, tmp_path, tes, params, sig, no_prior,
                                         head_iters=head_iters)
    same = _same_bits(split, one).all(axis=0)
    assert same.all(), f"{(~same).sum()} of {N_VOX} voxels differ, first {np.flatnonzero(~same)[:5]}"
    assert pushed == running
    if head_iters == 0:
        assert pushed == N_VOX and from_grid >= 1
    assert head_iters >= MAX_ITERS or running >= 1
    # the all-NaN row stops on lambda >= 1e6 (no step is ever accepted)
    assert np.isnan(one[0, 0]) and one[3, 0] == 1.0 and one[4, 0] == 0.0
