"""The gaussian_rician VARPRO kernel's per-voxel code (csrc/gr_varpro_fit.cu,
above the "kernel and C entry" marker) compiled as host C++ with g++, with
its fit split at the head/tail boundary, held bitwise against the same code
in one pass and against the plain PyTorch version
``fused_fit._gr_varpro_fit_plain`` on the CPU.

On the card ``ft2_gr_varpro_fit`` runs two kernels: the head (one thread per
voxel) runs the prelude and a few outer iterations, writes the voxels that
stopped and pushes the carried state of the others into a worklist; a
persistent tail resumes each slot for the rest of the budget, in whatever
order its lanes take them. Here the head runs voxel by voxel, the slots go
into the same row layout, and the tail takes them in reverse order, for
several head lengths: the result of every voxel must not change.

Both sides take exp, log and sqrt through float64 and round to float32 once
(``-ffp-contract=off`` keeps g++ from fusing anything), and the reciprocal
square root is 1/sqrt on both. Needs g++; the test skips when it is missing.
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
LO, HI, GUESS = (1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0)
TOLERANCES = {  # bench.py's 3-parameter rows; the pipeline's (config.FitConfig)
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
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#define expf f64_expf
#define logf f64_logf

#include "gr_varpro_per_voxel.inc"

namespace {

// head_iters < 0: one pass (fit_voxel). Else the head over every voxel,
// its pushes into a worklist of 8 + T rows of n slots, then the tail over
// the slots from the last to the first. Returns the slots pushed.
template <int T>
long fit(const float* sig, long n, const GrParams& p, int max_iters, int head_iters,
         float* x, float* st) {
  std::vector<float> rows((size_t)slot_rows<T>() * n);
  long pushed = 0;
  for (long i = 0; i < n; ++i) {
    float s[T], xo[3], so[3];
    for (int t = 0; t < T; ++t) s[t] = sig[i * T + t];
    if (head_iters < 0) {
      fit_voxel<T>(s, p, max_iters, 3, false, xo, so);
    } else {
      Outer<T> o;
      if (head_voxel<T>(s, p, max_iters, 3, head_iters, o)) {
        save_slot<T>(rows.data(), n, pushed++, (int)i, o);
        continue;
      }
      finish<T>(p, o, xo, so);
    }
    for (int c = 0; c < 3; ++c) {
      x[c * n + i] = xo[c];
      st[c * n + i] = so[c];
    }
  }
  for (long slot = pushed - 1; slot >= 0; --slot) {
    Outer<T> o;
    const int i = load_slot<T>(rows.data(), n, slot, o);
    float s[T], xo[3], so[3];
    for (int t = 0; t < T; ++t) s[t] = sig[(long)i * T + t];
    int left = max_iters - head_iters;
    while (!tail_step<T>(s, p, 3, o, left)) {
    }
    finish<T>(p, o, xo, so);
    for (int c = 0; c < 3; ++c) {
      x[c * n + i] = xo[c];
      st[c * n + i] = so[c];
    }
  }
  return pushed;
}

std::vector<float> read_floats(const char* path, size_t count) {
  std::vector<float> v(count);
  FILE* f = std::fopen(path, "rb");
  if (!f || std::fread(v.data(), sizeof(float), count, f) != count) std::exit(3);
  std::fclose(f);
  return v;
}

}  // namespace

// gr_varpro_host T max_iters head_iters n params.bin signal.bin out.bin
//   out.bin: x (3, n) then stats (3, n), float32; prints the slots pushed
int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const int T = std::atoi(argv[1]), it = std::atoi(argv[2]), head = std::atoi(argv[3]);
  const long n = std::atol(argv[4]);
  std::vector<float> pf = read_floats(argv[5], kParamFloats);
  GrParams p;
  std::memcpy(&p, pf.data(), sizeof(p));
  std::vector<float> sig = read_floats(argv[6], (size_t)n * T), out(6 * (size_t)n);
  long pushed;
  if (T == 3) pushed = fit<3>(sig.data(), n, p, it, head, out.data(), out.data() + 3 * n);
  else if (T == 6) pushed = fit<6>(sig.data(), n, p, it, head, out.data(), out.data() + 3 * n);
  else return 2;
  FILE* f = std::fopen(argv[7], "wb");
  std::fwrite(out.data(), sizeof(float), out.size(), f);
  std::fclose(f);
  std::printf("%ld\n", pushed);
  return 0;
}
"""


@pytest.fixture(scope="module")
def gr_host(tmp_path_factory):
    """The host build of gr_varpro_fit.cu's per-voxel code (path of the binary)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build gr_varpro_fit.cu's per-voxel code for the host")
    d = tmp_path_factory.mktemp("gr_varpro_host")
    with open(build.KERNEL_SOURCES["gr_varpro_fit"]) as f:
        src = f.read()
    assert MARKER in src
    (d / "gr_varpro_per_voxel.inc").write_text(src.split(MARKER)[0])
    shutil.copy(os.path.join(build.CSRC, "fit_common.cuh"), d / "fit_common.cuh")
    (d / "shim").mkdir()
    (d / "shim" / "cuda_runtime.h").write_text("#pragma once\n")
    (d / "gr_varpro_host.cpp").write_text(HOST_MAIN)
    exe = d / "gr_varpro_host"
    cmd = [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-D__device__=",
           "-D__forceinline__=inline", f"-I{d / 'shim'}", f"-I{d}", str(d / "gr_varpro_host.cpp"),
           "-o", str(exe)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return exe


class _F64Math:
    """``torch`` with exp, log and sqrt taken through float64 and rounded to
    float32 once, and rsqrt as 1/sqrt, like the host build's."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def exp(x):
        return torch.exp(x.double()).float()

    @staticmethod
    def log(x):
        return torch.log(x.double()).float()

    @staticmethod
    def sqrt(x):
        return torch.sqrt(x.double()).float()

    @staticmethod
    def rsqrt(x):
        return 1.0 / torch.sqrt(x.double()).float()


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
    sig[3] = 1e6
    sig[4] = 1e20
    sig[5] = 1000.0
    sig[6] = 1e-2
    return np.ascontiguousarray(sig, np.float32)


def _same_bits(a, b):
    return (a == b) | (np.isnan(a) & np.isnan(b))


def _run_host(exe, tmp_path, tes, params, sig, head_iters, max_iters=MAX_ITERS):
    (tmp_path / "params.bin").write_bytes(np.asarray(params, np.float32).tobytes())
    (tmp_path / "signal.bin").write_bytes(sig.tobytes())
    out = subprocess.run([str(exe), str(len(tes)), str(max_iters), str(head_iters), str(N_VOX),
                          str(tmp_path / "params.bin"), str(tmp_path / "signal.bin"),
                          str(tmp_path / "out.bin")], capture_output=True, text=True, check=True)
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(2, 3, N_VOX)
    return got, int(out.stdout)


@pytest.mark.parametrize("tol", sorted(TOLERANCES))
@pytest.mark.parametrize("tes", [TES3, TES6], ids=["3te", "6te"])
def test_host_one_pass_is_bitwise_the_plain_version(gr_host, f64_math, tmp_path, tes, tol):
    kw = TOLERANCES[tol]
    sig = _signal(tes, seed=len(tes))
    params = fused_fit._gr_kernel_params(tes, LO, HI, GUESS, kw["ftol"], kw["gtol"],
                                         kw["stall_tol"])
    got, _ = _run_host(gr_host, tmp_path, tes, params, sig, head_iters=-1)
    x, st = fused_fit._gr_varpro_fit_plain(torch.from_numpy(sig), tes, LO, HI, GUESS,
                                           max_iters=MAX_ITERS, full_budget=False,
                                           stall_iters=3, **kw)
    want = np.stack([x.numpy(), st.numpy()])
    assert np.isfinite(want[:, :, 7:]).all()
    same = _same_bits(got, want).all(axis=(0, 1))
    assert same.all(), f"{(~same).sum()} of {N_VOX} voxels differ, first {np.flatnonzero(~same)[:5]}"


@pytest.mark.parametrize("head_iters", [0, 1, 2, MAX_ITERS])
@pytest.mark.parametrize("budget", [MAX_ITERS, 8])
@pytest.mark.parametrize("tol", sorted(TOLERANCES))
@pytest.mark.parametrize("tes", [TES3, TES6], ids=["3te", "6te"])
def test_host_head_and_tail_are_bitwise_one_pass(gr_host, tmp_path, tes, tol, budget,
                                                 head_iters):
    """Head + worklist + tail (slots taken in reverse) give every voxel the
    bits of one pass, and the slots pushed are the voxels still unconverged
    after the head's iterations. At a budget of 8 many voxels stop on the
    budget itself; the all-NaN row stops only on lambda >= 1e6 (after 14
    iterations, no accepted step)."""
    kw = TOLERANCES[tol]
    sig = _signal(tes, seed=len(tes))
    params = fused_fit._gr_kernel_params(tes, LO, HI, GUESS, kw["ftol"], kw["gtol"],
                                         kw["stall_tol"])
    one, _ = _run_host(gr_host, tmp_path, tes, params, sig, head_iters=-1, max_iters=budget)
    split, pushed = _run_host(gr_host, tmp_path, tes, params, sig, head_iters=head_iters,
                              max_iters=budget)
    same = _same_bits(split, one).all(axis=(0, 1))
    assert same.all(), f"{(~same).sum()} of {N_VOX} voxels differ, first {np.flatnonzero(~same)[:5]}"
    head, _ = _run_host(gr_host, tmp_path, tes, params, sig, head_iters=-1,
                        max_iters=min(head_iters, budget))
    running = int((head[1, 1] <= 0.5).sum()) if head_iters < budget else 0
    assert pushed == running
    assert head_iters >= budget or pushed >= 1
    assert np.isnan(one[1, 0, 0]) and one[1, 2, 0] == 0.0
    assert one[1, 1, 0] == (1.0 if budget >= 14 else 0.0)
