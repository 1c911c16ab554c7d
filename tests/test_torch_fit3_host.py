"""The multistart kernel's per-start code and its argmin (csrc/fit3.cu,
above the "kernel and C entry" marker) compiled as host C++ with g++, held
bitwise against the plain PyTorch version ``fused_fit._fit3_plain`` on the
CPU.

On the card ``ft2_fit3_multistart`` runs one thread per (voxel, start):
each of a block's three warps runs one start over 32 voxels, writes its
(x, f, convf, nit) to shared memory, and after the barrier one thread per
voxel keeps the start that ``argmin_start`` picks. Here one voxel's three
starts run in turn through the same ``run_start`` and the same
``argmin_start`` picks the winner: the barrier and the shared memory are
the order of the calls.

Both sides take exp and log through float64 and round to float32 once
(``-ffp-contract=off`` keeps g++ from fusing anything); torch's CPU exp,
log and sqrt are not correctly rounded, so the plain version's calls in
``fused_fit`` and ``fgh`` go through float64 too. Needs g++; the test
skips when it is missing.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu_torch import build
from fetal_t2mapping_tpu_torch.models import fgh, fused_fit

torch.set_num_threads(1)

TES3 = (114.0, 202.0, 299.0)
TES6 = (114.0, 150.0, 202.0, 250.0, 299.0, 350.0)
LO, HI, GUESS = (1.0, 10.0, 1.0), (1e6, 2000.0, 1000.0), (650.0, 110.0, 40.0)
LO_RICIAN = LO[:2] + (max(LO[2], 1e-2),)
TOLS = dict(ftol=1e-2, gtol=1e-2, stall_tol=1e-2)     # bench.py's 3-parameter rows
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

#include "fit3_per_start.inc"

namespace {

// One block's work for each voxel: the three starts (one warp each on the
// card), then the winner after the barrier.
template <class Model, int T>
void fit(const float* sig, long n, const Fit3Params& p, int max_iters, float* x, float* st) {
  for (long i = 0; i < n; ++i) {
    float s[T], ls[T], cand[3][6];
    for (int t = 0; t < T; ++t) s[t] = sig[i * T + t];
    for (int start = 0; start < 3; ++start) {
      Model::template prepare<T>(s, ls);
      run_start<Model, T>(s, ls, p, max_iters, start, cand[start]);
    }
    const int w = argmin_start(cand[0][3], cand[1][3], cand[2][3]);
    for (int c = 0; c < 3; ++c) {
      x[c * n + i] = cand[w][c];
      st[c * n + i] = cand[w][3 + c];
    }
  }
}

template <class Model>
bool fit_t(int T, const float* sig, long n, const Fit3Params& p, int it, float* x, float* st) {
  if (T == 3) fit<Model, 3>(sig, n, p, it, x, st);
  else if (T == 6) fit<Model, 6>(sig, n, p, it, x, st);
  else return false;
  return true;
}

// The continuation as the card runs it: the sweep enters every voxel's
// loop (x0 clipped, the objective there) and writes a voxel that enters
// converged, or with no budget, or pushes its entered state; then the tail
// over the worklist's slots from the last to the first. Returns the slots
// pushed.
template <class Model, int T>
long cont(const float* sig, long n, const Fit3Params& p, int max_iters, const float* x0,
          const float* st0, float* x, float* st) {
  std::vector<float> rows((size_t)kContRows * n);
  long pushed = 0;
  auto write = [&](const Newton<T>& nt, long i) {
    for (int c = 0; c < 3; ++c) x[c * n + i] = nt.x[c];
    st[i] = nt.f;
    st[n + i] = nt.convf;
    st[2 * n + i] = nt.nit;
  };
  for (long i = 0; i < n; ++i) {
    float s[T], ls[T];
    for (int t = 0; t < T; ++t) s[t] = sig[i * T + t];
    Model::template prepare<T>(s, ls);
    Newton<T> nt;
    for (int c = 0; c < 3; ++c) nt.x[c] = x0[c * n + i];
    nt.convf = st0[n + i];
    nt.nit = st0[2 * n + i];
    newton3_begin<Model, T>(s, ls, p, nt);
    if (cont_runs(nt.convf, max_iters)) save_cont_slot<T>(rows.data(), n, pushed++, (int)i, nt);
    else write(nt, i);
  }
  for (long slot = pushed - 1; slot >= 0; --slot) {
    Newton<T> nt;
    const int i = load_cont_slot<T>(rows.data(), n, slot, p, nt);
    float s[T], ls[T];
    for (int t = 0; t < T; ++t) s[t] = sig[(long)i * T + t];
    Model::template prepare<T>(s, ls);
    int left = max_iters;
    while (!cont_step<Model, T>(s, ls, p, nt, left)) {
    }
    write(nt, i);
  }
  return pushed;
}

template <class Model>
long cont_t(int T, const float* sig, long n, const Fit3Params& p, int it, const float* x0,
            const float* st0, float* x, float* st) {
  if (T == 3) return cont<Model, 3>(sig, n, p, it, x0, st0, x, st);
  if (T == 6) return cont<Model, 6>(sig, n, p, it, x0, st0, x, st);
  std::exit(2);
}

std::vector<float> read_floats(const char* path, size_t count) {
  std::vector<float> v(count);
  FILE* f = std::fopen(path, "rb");
  if (!f || std::fread(v.data(), sizeof(float), count, f) != count) std::exit(3);
  std::fclose(f);
  return v;
}

}  // namespace

// fit3_host model T max_iters n params.bin signal.bin out.bin
//   out.bin: x (3, n) then stats (3, n), float32
// fit3_host cont model T max_iters n params.bin signal.bin start.bin out.bin
//   start.bin: x0 (3, n) then st0 (3, n); prints the slots pushed
// fit3_host argmin f0 f1 f2: prints the winning start
int main(int argc, char** argv) {
  if (argc == 5 && std::string(argv[1]) == "argmin") {
    std::printf("%d\n", argmin_start(std::strtof(argv[2], nullptr), std::strtof(argv[3], nullptr),
                                     std::strtof(argv[4], nullptr)));
    return 0;
  }
  if (argc == 10 && std::string(argv[1]) == "cont") {
    const int model = std::atoi(argv[2]), T = std::atoi(argv[3]), it = std::atoi(argv[4]);
    const long n = std::atol(argv[5]);
    std::vector<float> pf = read_floats(argv[6], kParamFloats);
    Fit3Params p;
    std::memcpy(&p, pf.data(), sizeof(p));
    std::vector<float> sig = read_floats(argv[7], (size_t)n * T);
    std::vector<float> start = read_floats(argv[8], 6 * (size_t)n), out(6 * (size_t)n);
    const float *x0 = start.data(), *st0 = start.data() + 3 * n;
    const long pushed = model == 0
        ? cont_t<GaussRician>(T, sig.data(), n, p, it, x0, st0, out.data(), out.data() + 3 * n)
        : cont_t<Rician>(T, sig.data(), n, p, it, x0, st0, out.data(), out.data() + 3 * n);
    FILE* f = std::fopen(argv[9], "wb");
    std::fwrite(out.data(), sizeof(float), out.size(), f);
    std::fclose(f);
    std::printf("%ld\n", pushed);
    return 0;
  }
  if (argc != 8) return 2;
  const int model = std::atoi(argv[1]), T = std::atoi(argv[2]), it = std::atoi(argv[3]);
  const long n = std::atol(argv[4]);
  std::vector<float> pf = read_floats(argv[5], kParamFloats);
  Fit3Params p;
  std::memcpy(&p, pf.data(), sizeof(p));
  std::vector<float> sig = read_floats(argv[6], (size_t)n * T), out(6 * (size_t)n);
  const bool ok = model == 0 ? fit_t<GaussRician>(T, sig.data(), n, p, it, out.data(), out.data() + 3 * n)
                             : fit_t<Rician>(T, sig.data(), n, p, it, out.data(), out.data() + 3 * n);
  if (!ok) return 2;
  FILE* f = std::fopen(argv[7], "wb");
  std::fwrite(out.data(), sizeof(float), out.size(), f);
  std::fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def fit3_host(tmp_path_factory):
    """The host build of fit3.cu's per-start code (path of the binary)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build fit3.cu's per-start code for the host")
    d = tmp_path_factory.mktemp("fit3_host")
    with open(build.KERNEL_SOURCES["fit3"]) as f:
        src = f.read()
    assert MARKER in src
    (d / "fit3_per_start.inc").write_text(src.split(MARKER)[0])
    shutil.copy(os.path.join(build.CSRC, "fit_common.cuh"), d / "fit_common.cuh")
    (d / "shim").mkdir()
    (d / "shim" / "cuda_runtime.h").write_text("#pragma once\n")
    (d / "fit3_host.cpp").write_text(HOST_MAIN)
    exe = d / "fit3_host"
    cmd = [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-D__device__=",
           "-D__forceinline__=inline", f"-I{d / 'shim'}", f"-I{d}", str(d / "fit3_host.cpp"),
           "-o", str(exe)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return exe


class _F64Math:
    """``torch`` with exp, log and sqrt taken through float64 and rounded to
    float32 once, like the host build's."""

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


@pytest.fixture
def f64_math(monkeypatch):
    shim = _F64Math()
    monkeypatch.setattr(fused_fit, "torch", shim)
    monkeypatch.setattr(fgh, "torch", shim)


def _signal(tes, seed):
    """bench.py's generator (k ~ U(600, 5000), T2 ~ U(20, 500), noise
    sigma 8, clipped at 1e-2) and a few edge rows: the noise floor,
    a flat row and a row at the clip."""
    rng = np.random.default_rng(seed)
    te = np.asarray(tes, np.float32)
    k = rng.uniform(600.0, 5000.0, N_VOX).astype(np.float32)
    t2 = rng.uniform(20.0, 500.0, N_VOX).astype(np.float32)
    sig = (k[:, None] * np.exp(-te[None, :] / t2[:, None])).astype(np.float32)
    sig = np.maximum(sig + rng.normal(0, 8.0, sig.shape).astype(np.float32), 1e-2)
    sig[0] = 8.0
    sig[1] = 1000.0
    sig[2] = 1e-2
    return np.ascontiguousarray(sig, np.float32)


def _same_bits(a, b):
    return (a == b) | (np.isnan(a) & np.isnan(b))


@pytest.mark.parametrize("max_iters", [4, 60])
@pytest.mark.parametrize("tes", [TES3, TES6], ids=["3te", "6te"])
@pytest.mark.parametrize("model", ["gaussian_rician", "rician"])
def test_host_multistart_is_bitwise_the_plain_version(fit3_host, f64_math, tmp_path, model,
                                                      tes, max_iters):
    lo = LO_RICIAN if model == "rician" else LO
    sig = _signal(tes, seed=len(tes) + max_iters)
    params = fused_fit._fit3_kernel_params(tes, lo, HI, GUESS, TOLS["ftol"], TOLS["gtol"],
                                           TOLS["stall_tol"])
    (tmp_path / "params.bin").write_bytes(np.asarray(params, np.float32).tobytes())
    (tmp_path / "signal.bin").write_bytes(sig.tobytes())
    subprocess.run([str(fit3_host), str(fused_fit._MODEL_ID[model]), str(len(tes)),
                    str(max_iters), str(N_VOX), str(tmp_path / "params.bin"),
                    str(tmp_path / "signal.bin"), str(tmp_path / "out.bin")], check=True)
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(2, 3, N_VOX)
    x, st = fused_fit._fit3_plain(torch.from_numpy(sig), model, tes, lo, HI, GUESS,
                                  max_iters=max_iters, **TOLS)
    want = np.stack([x.numpy(), st.numpy()])
    assert np.isfinite(want).all()
    same = _same_bits(got, want).all(axis=(0, 1))
    assert same.all(), f"{(~same).sum()} of {N_VOX} voxels differ, first {np.flatnonzero(~same)[:5]}"


@pytest.mark.parametrize("fs", [(1.0, 2.0, 3.0), (3.0, 1.0, 1.0), (2.0, 2.0, 1.0),
                                (np.nan, 0.0, -1.0), (0.0, np.nan, -1.0), (1.0, 1.0, np.nan),
                                (np.inf, -np.inf, -np.inf)],
                         ids=lambda fs: "_".join(str(v) for v in fs))
def test_host_argmin_start_is_numpys_argmin(fit3_host, fs):
    """The winner is jnp.argmin's (= np.argmin's): the first minimum, or
    the first NaN."""
    out = subprocess.run([str(fit3_host), "argmin", *(repr(float(v)) for v in fs)],
                         capture_output=True, text=True, check=True).stdout
    assert int(out) == int(np.argmin(np.asarray(fs, np.float32)))


@pytest.mark.parametrize("start", ["prefix", "all_running", "no_budget"])
@pytest.mark.parametrize("tes", [TES3, TES6], ids=["3te", "6te"])
@pytest.mark.parametrize("model", ["gaussian_rician", "rician"])
def test_host_continuation_sweep_and_tail_are_bitwise_the_plain_version(
        fit3_host, f64_math, tmp_path, model, tes, start):
    """The continuation's sweep (every voxel's f re-evaluated at the clipped
    x0; converged voxels written), worklist of entered states (e recomputed
    on resuming) and tail (slots taken in reverse) against
    ``_fit3_cont_plain``: from the plain 4-iteration
    prefix, from the same x0 with every voxel running (the largest tail),
    and with no budget (every voxel written by the sweep)."""
    lo = LO_RICIAN if model == "rician" else LO
    sig = _signal(tes, seed=len(tes) + 1)
    x0, st0 = fused_fit._fit3_plain(torch.from_numpy(sig), model, tes, lo, HI, GUESS,
                                    max_iters=4, **TOLS)
    if start == "all_running":
        # no voxel enters converged; a few enter with convf0 NaN or 0.25,
        # which the resumed loop carries (nmax keeps the NaN)
        st0 = st0.clone()
        st0[1] = 0.0
        st0[1, :4] = float("nan")
        st0[1, 4:8] = 0.25
    max_iters = 0 if start == "no_budget" else 56
    params = fused_fit._fit3_kernel_params(tes, lo, HI, GUESS, TOLS["ftol"], TOLS["gtol"],
                                           TOLS["stall_tol"])
    (tmp_path / "params.bin").write_bytes(np.asarray(params, np.float32).tobytes())
    (tmp_path / "signal.bin").write_bytes(sig.tobytes())
    (tmp_path / "start.bin").write_bytes(torch.cat([x0, st0]).numpy().astype(np.float32).tobytes())
    out = subprocess.run([str(fit3_host), "cont", str(fused_fit._MODEL_ID[model]), str(len(tes)),
                          str(max_iters), str(N_VOX), str(tmp_path / "params.bin"),
                          str(tmp_path / "signal.bin"), str(tmp_path / "start.bin"),
                          str(tmp_path / "out.bin")], capture_output=True, text=True, check=True)
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(2, 3, N_VOX)
    x, st = fused_fit._fit3_cont_plain(torch.from_numpy(sig), model, tes, lo, HI, GUESS, x0, st0,
                                       max_iters=max_iters, **TOLS)
    want = np.stack([x.numpy(), st.numpy()])
    assert np.isfinite(want[0]).all() and np.isfinite(want[1, 0]).all()
    same = _same_bits(got, want).all(axis=(0, 1))
    assert same.all(), f"{(~same).sum()} of {N_VOX} voxels differ, first {np.flatnonzero(~same)[:5]}"
    running = ~(st0[1] > 0.5).numpy() if max_iters else np.zeros(N_VOX, bool)
    assert int(out.stdout) == running.sum()
    assert start != "all_running" or running.all()
    # a voxel the sweep wrote keeps its x0 (in the box already), convf0 and
    # nit0, and its f re-evaluated there is the prefix's f to the bit
    done = ~running
    assert done.any() == (start != "all_running")
    assert _same_bits(got[0][:, done], x0.numpy()[:, done]).all()
    assert _same_bits(got[1][:, done], st0.numpy()[:, done]).all()
