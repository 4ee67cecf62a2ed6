"""The port's native EC plane (`biscotti_tpu_torch/crypto/_native.py`, the
repo's native/ed25519_msm.cpp built by the port itself) against the JAX
package's python-int oracle and its outputs: the cases of
tests/test_native_msm.py, plus the port's build rules. Tolerance: exact
(group elements equal, bytes equal, validity verdicts equal)."""

import os
import random

import numpy as np
import pytest

from biscotti_tpu.crypto import commitments as rcm
from biscotti_tpu.crypto import ed25519 as red
from biscotti_tpu_torch import _build
from biscotti_tpu_torch.crypto import _native
from biscotti_tpu_torch.crypto import commitments as cm
from biscotti_tpu_torch.crypto import ed25519 as ed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T8 = bytes.fromhex(
    "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a")


@pytest.fixture(scope="module")
def key():
    assert _native.available(), _native.load_error()
    return cm.CommitKey.generate(48)


def test_native_matches_reference_oracle_random(key):
    rng = random.Random(42)
    for _ in range(3):
        scalars = [rng.randrange(-10**13, 10**13) for _ in range(48)]
        assert ed.point_equal(_native.msm(scalars, key.points),
                              rcm._msm_python(scalars, key.points))


def test_native_edge_cases(key):
    n = len(key.points)
    assert ed.is_identity(_native.msm([0] * n, key.points))
    assert ed.is_identity(_native.msm([], []))
    one_hot = [0] * n
    one_hot[7] = 1
    assert ed.point_equal(_native.msm(one_hot, key.points), key.points[7])
    one_hot[7] = ed.Q  # the group order collapses to zero
    assert ed.is_identity(_native.msm(one_hot, key.points))
    s = [ed.Q - 5, 5] + [0] * (n - 2)
    assert ed.point_equal(_native.msm(s, key.points),
                          rcm._msm_python(s, key.points))
    with pytest.raises(ValueError):
        _native.msm([1, 2], key.points[:1])
    assert ed.is_identity(_native.scalarmult_noreduce(ed.Q, ed.BASE))


def test_wide_window_signed_msm_matches_reference_oracle(key):
    """n = 6144 leaves the window chooser's C=4 floor; ~170-bit signed
    magnitudes like the VSS RLC's, through both scalar encodings."""
    rng = random.Random(7)
    n = 6144
    points = (key.points * (n // len(key.points) + 1))[:n]
    scalars = [rng.randrange(-(1 << 170), 1 << 170) for _ in range(n)]
    scalars[0], scalars[1] = 0, (1 << 170) - 1
    want = rcm._msm_python(scalars, points)
    assert ed.point_equal(_native.msm(scalars, points), want)
    sbuf = b"".join(abs(s).to_bytes(32, "little") for s in scalars)
    signs = bytes(1 if s < 0 else 0 for s in scalars)
    pbuf = b"".join(_native._point_bytes(p) for p in points)
    assert ed.point_equal(_native.msm_signed_raw(sbuf, signs, pbuf, n), want)
    assert ed.point_equal(_native.msm_raw(scalars, pbuf, n), want)


def test_decompress_batch_matches_reference():
    rng = random.Random(11)
    comp = [red.point_compress(red.scalar_mult(rng.randrange(1, ed.Q),
                                               red.BASE)) for _ in range(32)]
    pts = _native.decompress_batch(b"".join(comp), len(comp))
    assert pts is not None
    for c, p in zip(comp, pts):
        assert ed.point_equal(p, red.point_decompress(c))
    assert _native.decompress_batch(
        b"".join(comp[:3]) + (ed.P + 1).to_bytes(32, "little"), 4) is None
    ident = (1).to_bytes(32, "little")
    ok = _native.decompress_batch(ident, 1)
    assert ok is not None and ed.point_equal(ok[0], ed.IDENTITY)
    signed_zero = (1 | (1 << 255)).to_bytes(32, "little")
    assert _native.decompress_batch(signed_zero, 1) is None
    for _ in range(40):
        cand = rng.randrange(1 << 256).to_bytes(32, "little")
        a, b = _native.decompress_batch(cand, 1), red.point_decompress(cand)
        assert (a is None) == (b is None)
        if a is not None:
            assert ed.point_equal(a[0], b)


def test_signed_batch_commit_matches_reference():
    rng = random.Random(13)
    a = ([rng.randrange(-10**9, 10**9) for _ in range(20)]
         + [0, 1, -1, ed.Q - 1, -(ed.Q - 1)])
    b = [rng.randrange(ed.Q) for _ in a]
    b[3] = 0
    raw = _native.batch_commit_xy(a, b)
    assert raw == rcm.batch_pedersen_commit_xy(a, b)
    for i, (ai, bi) in enumerate(zip(a, b)):
        want = red.point_add(red.base_mult(ai % ed.Q),
                             red.scalar_mult(bi, rcm.H_POINT))
        assert ed.point_equal(_native.point_from_xy64(raw[64 * i: 64 * i + 64]),
                              want)


def test_backends_agree_on_torsioned_points():
    t8 = red.point_decompress(T8)
    y_tors = ed.point_add(ed.scalar_mult(987654321, ed.BASE), t8)
    rng = random.Random(17)
    for s in (ed.Q - 3, ed.Q // 2 + 12345, rng.randrange(ed.Q // 2, ed.Q)):
        assert ed.point_equal(_native.msm([s, 7], [y_tors, ed.BASE]),
                              rcm._msm_python([s, 7], [y_tors, ed.BASE]))


def test_commit_update_uses_native_transparently(key):
    q = np.array([123456, -654321, 0, 42] * 12, dtype=np.int64)
    want = red.point_compress(rcm._msm_python([int(v) for v in q], key.points))
    assert cm.commit_update(q, key) == want


def test_grid_loaders_match_the_python_loader():
    raw = rcm.batch_pedersen_commit_xy(list(range(1, 9)), list(range(9, 17)))
    grid = np.frombuffer(raw, np.uint8).reshape(8, 64).copy()
    ext = _native.load_xy_batch(grid.tobytes(), 8)
    pts = [cm._xy_to_point(grid[i].tobytes()) for i in range(8)]
    assert ext == b"".join(_native._point_bytes(p) for p in pts)
    bad = grid.copy()
    bad[5, 0] ^= 1
    assert _native.load_xy_batch(bad.tobytes(), 8) is None
    assert _native.load_xy_sum_ptrs([grid, bad], 8) is None
    summed = _native.load_xy_sum_ptrs([grid, grid], 8)
    assert summed == _native.load_xy_sum(grid.tobytes() * 2, 2, 8)
    acc = bytearray(ext)
    assert _native.xy_accum(acc, bad, 8) == 5 and bytes(acc) == ext
    assert _native.xy_accum(acc, grid, 8) is None
    _native.ext_accum(acc, ext, 8)
    for i in range(8):
        got = acc[128 * i: 128 * i + 128]
        x, y, z, t = (int.from_bytes(got[32 * j: 32 * j + 32], "little")
                      for j in range(4))
        assert ed.point_equal((x, y, z, t), ed.scalar_mult(3, pts[i]))


def test_build_writes_only_its_own_library(tmp_path, monkeypatch):
    """The port compiles native/ed25519_msm.cpp into its own build
    directory, under a digest of source, compiler and flags (the
    compiler's report kept beside the library); it writes nothing under
    native/ and never loads the reference's library."""
    import shutil

    native_dir = os.path.join(REPO, "native")
    default = _native.library_path(shutil.which("g++"))
    assert default.parent == _build.PKG / "build"
    # names only: the reference's own `make -C native` may refresh its
    # library from another test process meanwhile
    before = sorted(os.listdir(native_dir))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    out = _native.build()
    assert out.parent == tmp_path / "build" and out.exists()
    assert out.name.startswith("libbiscotti_native-") and out.suffix == ".so"
    assert _native.build() == out  # built once
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [out.name, out.name + ".log", "libbiscotti_native.lock"])
    assert sorted(os.listdir(native_dir)) == before
    assert not any(f.startswith("libbiscotti_native-") or "lock" in f
                   for f in before)


def test_compile_once_digests_and_reports_failure(tmp_path, monkeypatch):
    """The one build procedure the CUDA kernels and the native library
    share: the digest moves with the source and the extra bytes, the
    compiler's report is kept beside the library and returned again when
    the library is found built, and a failed compile raises with the
    compiler's report and leaves no library behind."""
    import ctypes
    import shutil

    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    src = tmp_path / "probe.cpp"
    src.write_text('extern "C" int probe() { int unused; return 7; }\n')
    flags = ("-O1", "-fPIC", "-shared", "-Wall")
    out = _build.digest_path("probe", src, flags)
    assert out != _build.digest_path("probe", src, flags, b"host")
    report = _build.compile_once(shutil.which("g++"), flags, src, out)
    assert "unused" in report
    assert ctypes.CDLL(str(out)).probe() == 7
    assert _build.compile_once(shutil.which("g++"), flags, src, out) == report
    src.write_text("this is not C++\n")
    bad = _build.digest_path("probe", src, flags)
    assert bad != out
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on probe.cpp"):
        _build.compile_once(shutil.which("g++"), flags, src, bad)
    assert not bad.exists()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [out.name, out.name + ".log", "libprobe.lock"])


def test_without_gpp_the_plane_is_unavailable_and_says_why(monkeypatch,
                                                           capsys):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_load_attempted", False)
    monkeypatch.setattr(_native, "_load_error", "")
    assert not _native.available()
    assert "g++ not found" in _native.load_error()
    assert capsys.readouterr().err.count("native EC backend unavailable") == 1
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _native.msm([1], [ed.BASE])
