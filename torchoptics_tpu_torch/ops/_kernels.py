"""Build and load the port's hand-written CUDA kernels.

The sources under ``torchoptics_tpu_torch/csrc/`` are compiled on first use
with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, which is loaded with ``ctypes``. The library goes into
``build/kernels/`` beside the package, under a file name keyed by a hash of
the sources and flags, so a changed source is rebuilt and an unchanged one is
reused. Nothing here runs at import time: the package imports where there is
no ``nvcc`` and no GPU.
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
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for candidate in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "need the CUDA toolkit to build")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtorchoptics_kernels_{digest.hexdigest()[:16]}.so"


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
    # Compile to a temporary name and rename, so a concurrent or interrupted
    # build never leaves a half-written library under the final name.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k1_fwd_launch.argtypes = [p] * 7 + [i] * 6 + [p] * 9 + [p]
    lib.k1_fwd_launch.restype = i
    lib.k1_fwd_error_string.argtypes = [i]
    lib.k1_fwd_error_string.restype = ctypes.c_char_p
    lib.k1_fwd_max_surf.argtypes = []
    lib.k1_fwd_max_surf.restype = i
    lib.k1_fwd_max_w.argtypes = []
    lib.k1_fwd_max_w.restype = i
    return lib
