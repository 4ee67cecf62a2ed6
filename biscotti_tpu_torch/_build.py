"""Build and load the port's hand-written CUDA kernel.

The source `csrc/krum_scores.cu` has a plain C interface. It is compiled by
`nvcc` for Hopper (`sm_90a`) into `build/libkrum_scores-<digest>.so` at first
use, where the digest covers the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. The library is loaded with
`ctypes`; every pointer and the stream go across as `c_void_p`.

Nothing is built or loaded at import time: the CPU tests import every module
of the port on a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent
SOURCE = PKG / "csrc" / "krum_scores.cu"
BUILD = PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"libkrum_scores-{digest}.so"


def build() -> str:
    """Compile the library if it is not built yet. Returns the compiler's
    report ("" if it was already built); raises with it if nvcc fails."""
    out = library_path()
    if out.exists():
        return ""
    BUILD.mkdir(parents=True, exist_ok=True)
    # unique temporary name, then an atomic rename: another process never
    # loads a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with its C signatures declared (built first if
    needed)."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    # (x, sq, out, n, d, k, stream) -> cudaError_t
    lib.krum_scores_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.krum_scores_f32.restype = ctypes.c_int
    lib.krum_error_string.argtypes = [ctypes.c_int]
    lib.krum_error_string.restype = ctypes.c_char_p
    return lib
