"""ctypes bridge to the repo's C++ crypto library (counterpart of
`biscotti_tpu/crypto/_native.py`).

The library is the repo's own source, `native/ed25519_msm.cpp`, built with
`g++` and the flags of `native/Makefile` into
`biscotti_tpu_torch/build/libbiscotti_native-<digest>.so` at first use,
where the digest covers the source, the compiler, the flags and the host
CPU's instruction sets (`-march=native` binds a library to the host that
built it): an edited source is rebuilt, and a stale library or one built
on another machine is never loaded. The build is `_build.compile_once`'s,
as for the CUDA kernels. Nothing is written under `native/`, and the
reference's own build product there is never loaded.

`available()` is False, and says why (`load_error()`), where no `g++` is
found or the library fails its self-check; the callers then take the
python-int paths, which are the parity oracle. Negative scalars are
handled here by negating the point — the C side sees small non-negative
scalars, which keeps Pippenger window counts minimal for quantized
updates.
"""

from __future__ import annotations

import ctypes
import platform
import shutil
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from biscotti_tpu_torch import _build
from biscotti_tpu_torch.crypto import ed25519 as ed

SOURCE = Path(__file__).resolve().parents[2] / "native" / "ed25519_msm.cpp"
# native/Makefile's CXXFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall", "-Wextra", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
# why the native plane is unavailable ("" while loaded / not yet probed),
# announced once on stderr: the python-int paths keep every caller
# correct, but a ~30x slower miner crypto must not pass unnoticed
_load_error = ""


def _host_tag() -> bytes:
    """The instruction sets `-march=native` compiles for: the CPU's flags
    line, so a build directory copied from another machine is never
    loaded here."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.encode()
    except OSError:
        pass
    return platform.machine().encode()


def library_path(cxx: str) -> Path:
    return _build.digest_path("biscotti_native", SOURCE, CXX_FLAGS,
                              cxx.encode() + _host_tag())


def build() -> Path:
    """The library's path, compiling it first unless it is built already.
    Raises where no g++ is found or the compile fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native EC library is built "
                           "from native/ed25519_msm.cpp with g++")
    out = library_path(cxx)
    _build.compile_once(cxx, CXX_FLAGS, SOURCE, out)
    return out


def load_error() -> str:
    """Human-readable reason the native library is unavailable, or ""
    when it loaded. Probes the loader."""
    _load()
    return _load_error


def _selfcheck(lib: ctypes.CDLL) -> bool:
    """Cross-check the loaded binary against the pure-Python backend on a
    small random instance; a stale or tampered .so is refused."""
    import secrets

    scalars = [int.from_bytes(secrets.token_bytes(16), "little") + 1
               for _ in range(4)]
    points = [ed.scalar_mult(i + 2, ed.BASE) for i in range(4)]
    expect = ed.IDENTITY
    for s, p in zip(scalars, points):
        expect = ed.point_add(expect, ed.scalar_mult(s % ed.Q, p))
    sbuf = b"".join((s % ed.Q).to_bytes(32, "little") for s in scalars)
    pbuf = b"".join(_point_bytes(p) for p in points)
    out = ctypes.create_string_buffer(64)
    if lib.ed25519_msm(sbuf, pbuf, 4, out) != 0:
        return False
    return ed.point_equal(point_from_xy64(out.raw), expect)


def _declare(lib: ctypes.CDLL) -> None:
    """The C signatures of every exported entry point."""
    lib.ed25519_msm.restype = ctypes.c_int
    lib.ed25519_msm.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.ed25519_batch_commit.restype = ctypes.c_int
    lib.ed25519_batch_commit.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.ed25519_batch_commit_signed.restype = ctypes.c_int
    lib.ed25519_batch_commit_signed.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p,
    ]
    lib.ed25519_load_xy_batch.restype = ctypes.c_int
    lib.ed25519_load_xy_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.ed25519_msm_signed.restype = ctypes.c_int
    lib.ed25519_msm_signed.argtypes = [
        # points arg is c_void_p: accepts bytes AND mutable buffers (the
        # VSS intake accumulator passes its bytearray zero-copy)
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.ed25519_vss_rlc_scalars.restype = ctypes.c_int
    lib.ed25519_vss_rlc_scalars.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.c_char_p,
    ]
    lib.ed25519_vss_st_accum.restype = ctypes.c_int
    lib.ed25519_vss_st_accum.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.c_char_p,
    ]
    lib.ed25519_vss_blind_rows.restype = ctypes.c_int
    lib.ed25519_vss_blind_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.ed25519_decompress_batch.restype = ctypes.c_int
    lib.ed25519_decompress_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.ed25519_load_xy_sum.restype = ctypes.c_int
    lib.ed25519_load_xy_sum.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_char_p,
    ]
    lib.ed25519_load_xy_sum_ptrs.restype = ctypes.c_int
    lib.ed25519_load_xy_sum_ptrs.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.ed25519_xy_accum.restype = ctypes.c_int
    lib.ed25519_xy_accum.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.ed25519_ext_accum.restype = ctypes.c_int
    lib.ed25519_ext_accum.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted, _load_error
    if _load_attempted:
        return _lib
    _load_attempted = True
    try:
        path = build()
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        if _selfcheck(lib):
            _lib = lib
        else:
            _load_error = (f"{path} failed the cross-backend self-check "
                           "(stale or tampered binary)")
    except (RuntimeError, OSError, AttributeError,
            subprocess.TimeoutExpired) as e:
        _load_error = str(e)
    if _lib is None:
        print(f"[crypto/_native] native EC backend unavailable: "
              f"{_load_error} — the pure-Python paths run instead "
              f"(correct, parity-tested, ~30x slower miner crypto)",
              file=sys.stderr)
    return _lib


def available() -> bool:
    return _load() is not None


def _loaded() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    return lib


def _fe_bytes(v: int) -> bytes:
    return (v % ed.P).to_bytes(32, "little")


def _buf_addr(obj) -> Tuple[int, int, object]:
    """(address, byte length, keepalive) for a bytes-like object or a
    C-contiguous numpy array — zero-copy either way. The keepalive must
    stay referenced for the duration of the native call: the address
    points into the object's own storage."""
    if isinstance(obj, bytes):
        addr = ctypes.cast(ctypes.c_char_p(obj), ctypes.c_void_p).value
        return addr or 0, len(obj), obj
    if isinstance(obj, bytearray):
        raw = (ctypes.c_char * len(obj)).from_buffer(obj)
        return ctypes.addressof(raw), len(obj), (obj, raw)
    # numpy (or anything with the array interface); a non-contiguous view
    # degrades to one copy rather than corrupt reads
    import numpy as _np

    arr = _np.ascontiguousarray(obj)
    return int(arr.ctypes.data), arr.nbytes, arr


def point_from_xy64(buf: bytes) -> ed.Point:
    """Unpack one 64-byte little-endian affine (x, y) pair — the native
    library's output wire shape — into an extended-coordinate point."""
    x = int.from_bytes(buf[:32], "little")
    y = int.from_bytes(buf[32:64], "little")
    return (x, y, 1, (x * y) % ed.P)


def _point_bytes(p: ed.Point) -> bytes:
    x, y, z, t = p
    return _fe_bytes(x) + _fe_bytes(y) + _fe_bytes(z) + _fe_bytes(t)


def msm(scalars: Sequence[int], points: Sequence[ed.Point]) -> ed.Point:
    lib = _loaded()
    if len(scalars) != len(points):
        raise ValueError("scalar/point length mismatch")
    sbuf = bytearray()
    pbuf = bytearray()
    n = 0
    for s, p in zip(scalars, points):
        s = s % ed.Q
        if s == 0:
            continue
        # keep scalars short: a value in the top half of Z_q is a small
        # negative — use |s| with the negated point instead
        if s > ed.Q // 2:
            s = ed.Q - s
            p = ed.point_neg(p)
        sbuf += s.to_bytes(32, "little")
        pbuf += _point_bytes(p)
        n += 1
    if n == 0:
        return ed.IDENTITY
    out = ctypes.create_string_buffer(64)
    rc = lib.ed25519_msm(bytes(sbuf), bytes(pbuf), n, out)
    if rc != 0:
        raise RuntimeError(f"native msm failed: {rc}")
    return point_from_xy64(out.raw)


def load_xy_batch(xy: bytes, n: int) -> Optional[bytes]:
    """n×64B affine (x,y) pairs → n×128B extended buffer, with canonicity
    and on-curve validation (NOT subgroup — fold cofactor 8 into scalars).
    None if any point is invalid."""
    lib = _loaded()
    if len(xy) != 64 * n:
        raise ValueError("xy buffer length mismatch")
    out = ctypes.create_string_buffer(128 * n)
    rc = lib.ed25519_load_xy_batch(xy, n, out)
    if rc != 0:
        return None
    return out.raw


def vss_rlc_scalars(xs: Sequence[int], gammas_buf: bytes, c_chunks: int,
                    k: int) -> Tuple[bytes, bytes]:
    """Fused RLC → MSM-ready buffers: returns (scalars 32B·C·k magnitudes
    with cofactor 8 folded in, signs C·k bytes) consumable directly by
    msm_signed_raw. gammas_buf: S·C packed (lo u64, hi u64) pairs."""
    lib = _loaded()
    s = len(xs)
    if len(gammas_buf) != 16 * s * c_chunks:
        raise ValueError("gamma buffer length mismatch")
    import struct

    xbuf = struct.pack(f"<{s}q", *[int(x) for x in xs])
    out_s = ctypes.create_string_buffer(32 * c_chunks * k)
    out_sign = ctypes.create_string_buffer(c_chunks * k)
    rc = lib.ed25519_vss_rlc_scalars(xbuf, gammas_buf, s, c_chunks, k,
                                     out_s, out_sign)
    if rc != 0:
        raise RuntimeError(f"native vss_rlc_scalars failed: {rc}")
    return out_s.raw, out_sign.raw


def decompress_batch(compressed: bytes, n: int) -> Optional[List[ed.Point]]:
    """RFC 8032 decompression of n packed 32-byte points in one native
    call; None if any fails (caller falls back / rejects)."""
    lib = _loaded()
    if len(compressed) != 32 * n:
        raise ValueError("compressed buffer length mismatch")
    out = ctypes.create_string_buffer(128 * n)
    rc = lib.ed25519_decompress_batch(compressed, n, out)
    if rc != 0:
        return None
    raw = out.raw
    pts: List[ed.Point] = []
    for i in range(n):
        o = raw[128 * i: 128 * (i + 1)]
        x = int.from_bytes(o[:32], "little")
        y = int.from_bytes(o[32:64], "little")
        t = int.from_bytes(o[96:128], "little")
        pts.append((x, y, 1, t))
    return pts


def vss_blind_rows_raw(blinds_buf: bytes, xs: Sequence[int], c_chunks: int,
                       k: int) -> Optional[bytes]:
    """Evaluate all blinding polynomials at all share points mod q.
    blinds_buf: C·k 32-byte little-endian canonical (< q) coefficients;
    returns S·C·32 bytes row-major, or None on invalid share points."""
    lib = _loaded()
    if len(blinds_buf) != 32 * c_chunks * k:
        raise ValueError("blind buffer length mismatch")
    import struct

    s = len(xs)
    xbuf = struct.pack(f"<{s}q", *[int(x) for x in xs])
    out = ctypes.create_string_buffer(32 * s * c_chunks)
    rc = lib.ed25519_vss_blind_rows(blinds_buf, xbuf, s, c_chunks, k, out)
    if rc != 0:
        return None
    return out.raw


def vss_st_accum(gammas_buf: bytes, rows_buf, blinds_buf,
                 s: int, c_chunks: int) -> Optional[Tuple[int, int]]:
    """(Σγ·row, Σγ·t_val) over all S·C cells — the lhs accumulators of the
    VSS check. rows_buf/blinds_buf may be bytes or C-contiguous numpy
    arrays (int64 rows, uint8 blinds) — passed zero-copy. Returns None if
    any blind value is non-canonical (≥ q)."""
    lib = _loaded()
    cells = s * c_chunks
    rows_addr, rows_len, keep_r = _buf_addr(rows_buf)
    blinds_addr, blinds_len, keep_b = _buf_addr(blinds_buf)
    if (len(gammas_buf) != 16 * cells or rows_len != 8 * cells
            or blinds_len != 32 * cells):
        raise ValueError("buffer length mismatch")
    out_s = ctypes.create_string_buffer(40)
    out_t = ctypes.create_string_buffer(56)
    rc = lib.ed25519_vss_st_accum(gammas_buf, ctypes.c_void_p(rows_addr),
                                  ctypes.c_void_p(blinds_addr),
                                  s, c_chunks, out_s, out_t)
    del keep_r, keep_b
    if rc != 0:
        return None
    return (int.from_bytes(out_s.raw, "little", signed=True),
            int.from_bytes(out_t.raw, "little"))


def load_xy_sum(xy: bytes, n_batches: int, n: int) -> Optional[bytes]:
    """Fused validate + pointwise sum: n_batches back-to-back batches of
    n×64B affine pairs → the summed n×128B extended batch (msm-ready).
    None if any point is non-canonical or off-curve."""
    lib = _loaded()
    if len(xy) != 64 * n_batches * n:
        raise ValueError("xy buffer length mismatch")
    out = ctypes.create_string_buffer(128 * n)
    rc = lib.ed25519_load_xy_sum(xy, n_batches, n, out)
    if rc != 0:
        return None
    return out.raw


def load_xy_sum_ptrs(batches: Sequence, n: int) -> Optional[bytes]:
    """load_xy_sum over SEPARATE per-batch buffers (bytes or C-contiguous
    numpy arrays of n×64 bytes each) — no concatenation copy. The miner's
    round intake hands each worker's commitment grid straight from its
    numpy storage. None if any point is non-canonical or off-curve."""
    lib = _loaded()
    n_batches = len(batches)
    if n_batches == 0 or n == 0:
        # mirror the native core's rc=1 on degenerate input: callers treat
        # None as "reject", never as an exception
        return None
    ptrs = (ctypes.c_void_p * n_batches)()
    keep = []
    for i, b in enumerate(batches):
        addr, nbytes, ka = _buf_addr(b)
        if nbytes != 64 * n:
            raise ValueError("batch buffer length mismatch")
        ptrs[i] = addr
        keep.append(ka)
    out = ctypes.create_string_buffer(128 * n)
    rc = lib.ed25519_load_xy_sum_ptrs(ptrs, n_batches, n, out)
    del keep
    if rc != 0:
        return None
    return out.raw


def xy_accum(acc: bytearray, xy, n: int) -> Optional[int]:
    """acc[i] += xy[i] over one n×64B affine grid, acc the mutable
    n×128B extended accumulator (initialize with load_xy_batch). Returns
    None on success or the index of the first invalid point, in which
    case acc is UNTOUCHED (validation is a separate first pass)."""
    lib = _loaded()
    if len(acc) != 128 * n:
        raise ValueError("accumulator length mismatch")
    xy_addr, xy_len, keep = _buf_addr(xy)
    if xy_len != 64 * n:
        raise ValueError("xy buffer length mismatch")
    raw = (ctypes.c_char * len(acc)).from_buffer(acc)
    rc = lib.ed25519_xy_accum(ctypes.addressof(raw),
                              ctypes.c_void_p(xy_addr), n)
    del keep, raw
    if rc != 0:
        return rc - 1
    return None


def ext_accum(acc: bytearray, ext: bytes, n: int) -> None:
    """acc[i] += ext[i] pointwise over two n×128B extended buffers — the
    per-wave fold of the incremental intake accumulator."""
    lib = _loaded()
    if len(acc) != 128 * n or len(ext) != 128 * n:
        raise ValueError("extended buffer length mismatch")
    raw = (ctypes.c_char * len(acc)).from_buffer(acc)
    rc = lib.ed25519_ext_accum(ctypes.addressof(raw),
                               ctypes.c_char_p(ext), n)
    del raw
    if rc != 0:
        raise RuntimeError(f"native ext_accum failed: {rc}")


def scalarmult_noreduce(k: int, p: ed.Point) -> ed.Point:
    """k·P WITHOUT the mod-q reduction the msm wrapper applies — the
    subgroup-membership check ℓ·P == identity needs the full group-order
    scalar to survive (reduced it is 0). k must fit 32 bytes."""
    lib = _loaded()
    out = ctypes.create_string_buffer(64)
    rc = lib.ed25519_msm(int(k).to_bytes(32, "little"), _point_bytes(p),
                         1, out)
    if rc != 0:
        raise RuntimeError(f"native scalarmult failed: {rc}")
    return point_from_xy64(out.raw)


def msm_signed_raw(scalars_buf: bytes, signs_buf: bytes,
                   points_buf, n: int) -> ed.Point:
    """MSM over pre-packed (magnitude, sign, point) buffers — zero python
    marshalling on the hot path. points_buf may be bytes OR a mutable
    buffer (bytearray/numpy) passed zero-copy — the VSS intake
    accumulator hands its running extended buffer straight in."""
    lib = _loaded()
    p_addr, p_len, keep = _buf_addr(points_buf)
    if (p_len != 128 * n or len(scalars_buf) != 32 * n
            or len(signs_buf) != n):
        raise ValueError("buffer length mismatch")
    out = ctypes.create_string_buffer(64)
    rc = lib.ed25519_msm_signed(scalars_buf, signs_buf,
                                ctypes.c_void_p(p_addr), n, out)
    del keep
    if rc != 0:
        raise RuntimeError(f"native msm failed: {rc}")
    return point_from_xy64(out.raw)


def msm_raw(scalars: Sequence[int], points_buf: bytes, n: int) -> ed.Point:
    """MSM over an already-validated 128B/point buffer (from
    load_xy_batch) — skips the per-point python int marshalling.

    Scalars may be SIGNED and UNREDUCED (|s| < 2²⁵⁶): short magnitudes keep
    Pippenger's window count down, and signs ride a separate byte map with
    on-the-fly point negation in C++."""
    lib = _loaded()
    if len(points_buf) != 128 * n or len(scalars) != n:
        raise ValueError("buffer length mismatch")
    sbuf = bytearray()
    signs = bytearray(n)
    for i, s in enumerate(scalars):
        s = int(s)
        if s < 0:
            signs[i] = 1
            s = -s
        if s >> 256:
            s %= ed.Q
        sbuf += s.to_bytes(32, "little")
    out = ctypes.create_string_buffer(64)
    rc = lib.ed25519_msm_signed(bytes(sbuf), bytes(signs), points_buf, n, out)
    if rc != 0:
        raise RuntimeError(f"native msm failed: {rc}")
    return point_from_xy64(out.raw)


def batch_commit_signed_raw(mags_buf: bytes, signs_buf: bytes,
                            b_buf: bytes, n: int) -> bytes:
    """Pedersen batch commit over pre-packed buffers: mags n×32B LE
    magnitudes (< q), signs n bytes, b n×32B LE canonical blinds. The
    zero-python-marshalling twin of batch_commit_xy."""
    lib = _loaded()
    if (len(mags_buf) != 32 * n or len(signs_buf) != n
            or len(b_buf) != 32 * n):
        raise ValueError("buffer length mismatch")
    # lazy: commitments imports this module (a module-level import would
    # be circular)
    from biscotti_tpu_torch.crypto.commitments import H_POINT

    out = ctypes.create_string_buffer(64 * n)
    rc = lib.ed25519_batch_commit_signed(mags_buf, signs_buf, b_buf,
                                         _point_bytes(ed.BASE),
                                         _point_bytes(H_POINT), n, out)
    if rc != 0:
        raise RuntimeError(f"native batch_commit failed: {rc}")
    return out.raw


def batch_commit_xy(a: Sequence[int], b: Sequence[int]) -> bytes:
    """[aᵢ·G + bᵢ·H] as a packed n×64B affine (x,y) buffer — worker-side
    VSS coefficient commitments (fixed-base comb path in C++). Data
    scalars travel as signed magnitudes so negative quantized coefficients
    stay a few bytes wide instead of dense q−|a| values."""
    if len(a) != len(b):
        raise ValueError("scalar length mismatch")
    n = len(a)
    if n == 0:
        return b""
    mags = bytearray()
    signs = bytearray(n)
    for i, s in enumerate(a):
        v = int(s)
        if not -ed.Q < v < ed.Q:
            v %= ed.Q
        if v < 0:
            signs[i] = 1
            v = -v
        mags += v.to_bytes(32, "little")
    bbuf = b"".join((int(s) % ed.Q).to_bytes(32, "little") for s in b)
    return batch_commit_signed_raw(bytes(mags), bytes(signs), bbuf, n)
