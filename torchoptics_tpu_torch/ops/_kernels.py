"""Build and load the port's hand-written CUDA kernels.

Each source (``*.cu``) under ``torchoptics_tpu_torch/csrc/`` is compiled
on first use with ``nvcc`` for ``sm_90a``, all of them at once, one process
each; the objects are then linked into one shared library with a plain C
interface, which is loaded with ``ctypes``. The library goes into
``build/kernels/`` beside the package, under a file name keyed by a hash of
the sources, the headers they share (``*.cuh``) and the flags, so a changed
source or header is rebuilt and an unchanged one is reused; the compiler's
``-Xptxas -v`` report (registers, spills, local and shared memory per
kernel) is kept beside it as ``<library>.log``. Nothing here runs at import
time: the package imports where there is no ``nvcc`` and no GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# No --use_fast_math, and no FMA contraction (-fmad=false): the failure masks
# compare against EPS, and one ulp moved by a fused multiply-add flips masks
# on lanes at a threshold and breaks bit-identity with the plain PyTorch
# version (measured on an H100: contracted, 5 of 2.46M masks flip on the
# c x 3 double-Gauss; uncontracted, plain mode is bit-identical at the same
# kernel time).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")
PTXAS_REPORT = ("-Xptxas", "-v")


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers() -> list:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for candidate in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "need the CUDA toolkit to build")


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives: a
    changed header rebuilds every source, as a changed source does."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtorchoptics_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmd, what):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the sources unless the library for them already exists.
    Raises with nvcc's output when it fails."""
    out = library_path()
    if out.exists():
        return out
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # Build in a temporary directory and rename, so a concurrent or
    # interrupted build never leaves a half-written library under the final
    # name.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, *PTXAS_REPORT, "-c", "-o", str(obj),
                                    str(src)], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True), src)
                 for src, obj in zip(sources, objects)]
        report, failed = [], []
        for proc, src in procs:
            text = proc.communicate()[0]
            report.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(report))
        lib = Path(tmp) / out.name
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objects)], "nvcc link")
        Path(tmp, "report.log").write_text("".join(report))
        os.replace(Path(tmp, "report.log"), out.with_suffix(".log"))
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures:
    a pointer or the stream is ``c_void_p``, an ``int`` is ``c_int`` and a
    ``float`` is ``c_float``."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # Inputs (the last is n_legs), angle_thr, sizes, outputs (the last is
    # opl) or cotangents (the last is dopl), the stream.
    for kernel, n_in, n_int in (("k1", 11, 6), ("k2", 12, 7), ("k3", 13, 8), ("k4", 14, 9)):
        fwd, bwd = getattr(lib, f"{kernel}_fwd_launch"), getattr(lib, f"{kernel}_bwd_launch")
        fwd.argtypes = [p] * n_in + [f] + [i] * n_int + [p] * 12 + [p]
        bwd.argtypes = [p] * n_in + [f] + [p] * 10 + [i] * n_int + [p] * 5 + [p]
        fwd.restype = bwd.restype = i
    lib.k1_error_string.argtypes = [i]
    lib.k1_error_string.restype = ctypes.c_char_p
    # P2: patches, psfs, out, n_patch, n_ch, ph, pw, kh, kw, the stream.
    lib.p2_svola_launch.argtypes = [p] * 3 + [i] * 6 + [p]
    # P2's d/dpsf: patches, cotangent, partials, dpsf, n_patch, n_ch, ph, pw,
    # kh, kw, the stream; and the partials' length and the launches of its
    # main kernel for those sizes.
    lib.p2_dpsf_launch.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.p2_dpsf_partials.argtypes = lib.p2_dpsf_launches.argtypes = [i] * 6
    lib.p2_dpsf_partials.restype = ctypes.c_longlong
    lib.p2_dpsf_launches.restype = i
    # P2's FFT route, forward and d/dpsf: patches, psfs or cotangent, out,
    # the column and row lengths' twiddles, scratch, n_patch, n_ch, ph, pw,
    # kh, kw, the stream; its scratch floats for n_patch, n_ch, ph, pw, kh,
    # adjoint.
    lib.p2_fft_launch.argtypes = lib.p2_dpsf_fft_launch.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.p2_fft_launch.restype = lib.p2_dpsf_fft_launch.restype = i
    lib.p2_fft_scratch.argtypes = [i] * 6
    lib.p2_fft_scratch.restype = ctypes.c_longlong
    # P1: x, scale, k1, k2, iters, n, op, out, the stream.
    lib.p1_chain_launch.argtypes = [p, p, f, f, i, i, i, p, p]
    lib.p2_svola_launch.restype = lib.p2_dpsf_launch.restype = lib.p1_chain_launch.restype = i
    # S1, the PSF splat: x, y, gx, gy, sigma_x, sigma_y, weights (or null),
    # partials, windows (or null), out, n_grids, n_ch, n_rays, n_y, n_x,
    # span, float64, windowed, the stream; its adjoint: the same inputs, the
    # cotangent, dx, dy, dweights (or null), the bins' partials, dgx, dgy,
    # dsigma_x, dsigma_y (null without bins), the sizes, float64, bins, the
    # stream; the forward's tiles of a half grid: n_y, n_x, windowed, where
    # to write (tile rows, tile columns, tiles down, tiles across).
    lib.s1_fwd_launch.argtypes = [p] * 10 + [i] * 8 + [p]
    lib.s1_bwd_launch.argtypes = [p] * 16 + [i] * 8 + [p]
    lib.s1_fwd_launch.restype = lib.s1_bwd_launch.restype = i
    lib.s1_fwd_tiles.argtypes = [i, i, i, p]
    lib.s1_fwd_tiles.restype = None
    # The windowed forward's scratch, int32s: n_pairs, n_rays, n_spans, n_y.
    lib.s1_fwd_window_ints.argtypes = [ctypes.c_longlong, i, i, i]
    lib.s1_fwd_window_ints.restype = ctypes.c_longlong
    # S1's tensor-core probe: A, B, C, d_mma, d_fma, cases, m16n8k4, the
    # stream; the FP64 rate kernel: steps, blocks, kind, out, the stream.
    lib.s1_dmma_probe.argtypes = [p] * 5 + [i, i, p]
    lib.s1_fp64_rate.argtypes = [i, i, i, p, p]
    lib.s1_dmma_probe.restype = lib.s1_fp64_rate.restype = i
    # The adjoint's window threshold: its probe (float64, kind, out, the
    # stream), the q's it checks, q_max itself.
    lib.s1_exp_zero_probe.argtypes = [i, i, p, p]
    lib.s1_exp_zero_probe.restype = i
    lib.s1_exp_zero_samples.argtypes = [i, i]
    lib.s1_exp_zero_samples.restype = ctypes.c_ulonglong
    lib.s1_q_max.argtypes = [i]
    lib.s1_q_max.restype = ctypes.c_double
    for name in ("k1_max_surf", "k1_max_w", "k1_bwd_block", "k3_max_asph", "p2_max_kw",
                 "p2_dpsf_max_kw", "p2_fft_max_len", "p2_fft_launches", "s1_chunk"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    for name in ("k1_fwd_specialized", "k2_fwd_specialized", "k2_bwd_specialized",
                 "p2_specialized_kw", "p2_dpsf_specialized_kw", "p2_fft_len"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = i
    # The population forwards' resident blocks per SM: mode, allow_backward,
    # masked, n_surf (K2) or n_asph (K4), where to write the block's threads.
    for fn in (lib.k2_fwd_blocks_per_sm, lib.k4_fwd_blocks_per_sm):
        fn.argtypes = [i] * 4 + [p]
        fn.restype = i
    # The exhaustive checks of div_half_pi and sqrt_from_eps: two mismatch
    # counts (device int64), the stream.
    lib.k1_exact_checks.argtypes = [p, p]
    lib.k1_exact_checks.restype = i
    return lib
