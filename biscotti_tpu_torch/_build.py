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
    ed25519_ladder  kernels B3a-B3d, the crypto ladders: msm double-and-add,
                 fixed-base walk, grid validate-and-points, point add and
                 the tree sums (crypto/kernels/cuda_ladder.py)

`crypto/_native.py` builds the host EC library with `g++` through the same
`digest_path` and `compile_once`.

Nothing is built or loaded at import time: the CPU tests import every module
of the port on a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent
BUILD = PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _krum_signatures(lib: ctypes.CDLL) -> None:
    # (x, sq, out, xp, amax, dist, partials, counters,
    #  n, d, n_pad, d_pad, splits, k, stream) -> cudaError_t
    lib.krum_scores_f32.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
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


def _ladder_signatures(lib: ctypes.CDLL) -> None:
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # (bits, words, points or table, out, bad, m, stream) -> cudaError_t
    for fn in (lib.ed25519_msm_ladder, lib.ed25519_fixed_walk):
        fn.argtypes = [p, i, p, p, p, n, p]
        fn.restype = ctypes.c_int
    # (xy, ok, pts or null, bad, cells, stream) and (a, b, out, bad, n,
    # stream)
    for fn in (lib.ed25519_grid_points, lib.ed25519_point_add):
        fn.argtypes = [p, p, p, p, n, p]
        fn.restype = ctypes.c_int
    lib.ed25519_error_string.argtypes = [ctypes.c_int]
    lib.ed25519_error_string.restype = ctypes.c_char_p
    # (pts, out, bad, rows, cols, stream)
    lib.ed25519_point_tree.argtypes = [p, p, p, n, n, p]
    lib.ed25519_point_tree.restype = ctypes.c_int
    # (xy, grid_ok, out, bad, rows, cols, row_cells, stream)
    lib.ed25519_grid_tree.argtypes = [p, p, p, p, n, n, n, p]
    lib.ed25519_grid_tree.restype = ctypes.c_int
    lib.ed25519_tree_groups.argtypes = []
    lib.ed25519_tree_groups.restype = ctypes.c_int


SIGNATURES = {"krum_scores": _krum_signatures,
              "oncurve": _oncurve_signatures,
              "ed25519_ladder": _ladder_signatures}
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


def digest_path(stem: str, src: Path, flags, extra: bytes = b"") -> Path:
    """`build/lib<stem>-<digest>.so`, the digest over the source, the flags
    and `extra` (whatever else binds the binary, such as the host)."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                            + extra).hexdigest()[:12]
    return BUILD / f"lib{stem}-{digest}.so"


def compile_once(compiler: str, flags, src: Path, out: Path) -> str:
    """Compile `src` into `out` unless it is built already. Returns the
    compiler's report, which is kept beside the library (`<out>.log`), so
    a call that finds the library built returns the report of the build
    that made it; raises with the report if the compile fails. The
    compile runs under a file lock per library, into a temporary name
    renamed into place, so processes that start together (test workers)
    build it once and none loads a half-written library."""
    log = out.with_name(out.name + ".log")
    if out.exists():
        return log.read_text() if log.exists() else ""
    out.parent.mkdir(parents=True, exist_ok=True)
    stem = out.name.rsplit("-", 1)[0]
    with open(out.parent / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return log.read_text() if log.exists() else ""
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed on "
                               f"{src.name}:\n{proc.stdout}")
        log.write_text(proc.stdout)  # before the library: a library's
        os.replace(tmp, out)         # report is there whenever it is
    return proc.stdout


def library_path(name: str) -> Path:
    return digest_path(name, source(name), NVCC_FLAGS)


def build(name: str) -> str:
    """Compile the named CUDA library unless it is built already; returns
    nvcc's report of the build that made it."""
    return compile_once(nvcc(), NVCC_FLAGS, source(name), library_path(name))


def ptxas_report(log: str) -> dict:
    """{entry function: {"registers", "spill_stores", "spill_loads"}} from
    nvcc's -Xptxas=-v report (names as compiled, mangled for templates)."""
    report: dict = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = report.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current is not None:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return report


def sass_mix(lib: Path, kernel: str):
    """{opcode: count} of the SASS of every entry function of the built
    library `lib` whose name holds `kernel` (each template instance), read
    with the toolkit's cuobjdump, or why it could not be read."""
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return "not measured: no cuobjdump beside nvcc"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120).stdout
    mix, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            mix[m.group(1)] = mix.get(m.group(1), 0) + 1
    return dict(sorted(mix.items(), key=lambda kv: -kv[1]))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The named library with its C signatures declared (built first if
    needed)."""
    build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    SIGNATURES[name](lib)
    return lib
