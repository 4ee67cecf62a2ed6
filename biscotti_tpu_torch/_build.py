"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` has a plain C interface. It is compiled by
`nvcc` for Hopper (`sm_90a`) into `build/lib<name>-<digest>.so` at first use,
where the digest covers that source and the flags, so an edited source is
rebuilt and a stale library is never loaded. A library is loaded with
`ctypes`, its C signatures declared; every pointer and the stream go across
as `c_void_p`.

    krum_scores  kernel B1, Krum scores        (ops/krum_cuda.py; three CUDA
                 kernels a call: pad, fp32 Gram, row select)
    oncurve      kernel B2, on-curve validator (crypto/kernels/cuda_validate.py)

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
BUILD = PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _krum_signatures(lib: ctypes.CDLL) -> None:
    # (x, sq, out, xp, dist, partials, counters,
    #  n, d, n_pad, d_pad, splits, k, stream) -> cudaError_t
    lib.krum_scores_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.krum_scores_f32.restype = ctypes.c_int
    lib.krum_error_string.argtypes = [ctypes.c_int]
    lib.krum_error_string.restype = ctypes.c_char_p


def _oncurve_signatures(lib: ctypes.CDLL) -> None:
    # (xy, out, bad, n, stream) -> cudaError_t
    lib.oncurve_mask_i64.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_longlong, ctypes.c_void_p]
    lib.oncurve_mask_i64.restype = ctypes.c_int
    lib.oncurve_error_string.argtypes = [ctypes.c_int]
    lib.oncurve_error_string.restype = ctypes.c_char_p


SIGNATURES = {"krum_scores": _krum_signatures,
              "oncurve": _oncurve_signatures}
KERNELS = tuple(SIGNATURES)


def source(name: str) -> Path:
    return PKG / "csrc" / f"{name}.cu"


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


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile the named library unless it is built already. Returns the
    compiler's report ("" if it was already built); raises with the report
    if nvcc fails."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD.mkdir(parents=True, exist_ok=True)
    # unique temporary name, then an atomic rename: another process never
    # loads a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The named library with its C signatures declared (built first if
    needed)."""
    build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    SIGNATURES[name](lib)
    return lib
