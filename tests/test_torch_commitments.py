"""The port's commitments plane (`biscotti_tpu_torch/crypto/commitments.py`)
against the JAX package's (`biscotti_tpu/crypto/commitments.py`).

Every case runs the port in three modes: `native` (its C++ plane, built
from native/ed25519_msm.cpp), `python` (the python-int oracle paths, the
native plane switched off in both packages) and, for the seams that call
the device plane, `armed` (the plane armed on the CPU). The reference runs
disarmed. Tolerance: exact — commitment, Schnorr and VSS bytes equal, and
every verdict, rejected sid and member set equal.

One case differs between the reference's own two backends, and the port
follows each: `vss_verify_multi` over a zero-width grid (k = 0) is False
on the native plane and True on the python path. So the `native` case
requires both native planes loaded. The reference builds its library in
place (`make -C native`, `native/Makefile`: `-o $@`) in every process
that loads it; a test worker that loads it while another worker's linker
is still writing it reads a short file twice and falls back to python
for good. `_reference_native` loads it again once that build has
settled.
"""

import fcntl
import hashlib
import os
import time

import numpy as np
import pytest

from biscotti_tpu.crypto import _native as rnative
from biscotti_tpu.crypto import commitments as rcm
from biscotti_tpu.crypto import ed25519 as red
from biscotti_tpu.ops import secretshare as rss
from biscotti_tpu_torch import _build
from biscotti_tpu_torch.crypto import _native
from biscotti_tpu_torch.crypto import commitments as cm
from biscotti_tpu_torch.crypto import ed25519 as ed
from biscotti_tpu_torch.crypto import kernels
from biscotti_tpu_torch.ops import secretshare as ss

# an order-8 point of edwards25519 (tests/test_native_msm.py:134)
T8 = bytes.fromhex(
    "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a")


def _python_paths(monkeypatch):
    monkeypatch.setattr(_native, "available", lambda: False)
    monkeypatch.setattr(rnative, "available", lambda: False)


def _settled(path: str, quiet_s: float = 1.0, timeout_s: float = 180.0) -> None:
    """Wait until `path`'s size and mtime (or its absence) have held for
    `quiet_s` seconds: no linker is writing it any more."""
    deadline = time.monotonic() + timeout_s
    last, since = object(), time.monotonic()
    while time.monotonic() < deadline:
        try:
            st = os.stat(path)
            now = (st.st_size, st.st_mtime_ns)
        except FileNotFoundError:
            now = None
        if now != last:
            last, since = now, time.monotonic()
        elif time.monotonic() - since >= quiet_s:
            return
        time.sleep(0.1)


def _reference_native(monkeypatch) -> None:
    """Require the reference's native plane. Where this process lost a
    concurrent build of it, reset its load state and load it again once
    the library on disk has settled, one test worker at a time (three
    times at most: a build that started before the library existed may
    still link over it once)."""
    if not rnative.available():
        _build.BUILD.mkdir(parents=True, exist_ok=True)
        with open(_build.BUILD / "reference-native.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            for _ in range(3):
                _settled(os.path.abspath(rnative._LIB_PATHS[0]))
                monkeypatch.setattr(rnative, "_lib", None)
                monkeypatch.setattr(rnative, "_load_attempted", False)
                monkeypatch.setattr(rnative, "_load_error", "")
                if rnative.available():
                    break
    assert rnative.available(), rnative.load_error()


def _native_planes(monkeypatch) -> None:
    assert _native.available(), _native.load_error()
    _reference_native(monkeypatch)


@pytest.fixture(params=["native", "python"])
def backend(request, monkeypatch):
    if request.param == "python":
        _python_paths(monkeypatch)
    else:
        _native_planes(monkeypatch)
    return request.param


@pytest.fixture(params=["native", "python", "armed"])
def mode(request, monkeypatch):
    if request.param == "python":
        _python_paths(monkeypatch)
    if request.param == "native":
        _native_planes(monkeypatch)
    if request.param == "armed":
        kernels.set_enabled(True, device="cpu")
    try:
        yield request.param
    finally:
        kernels.set_enabled(False)


def _chunks(d, k, seed):
    q = np.random.default_rng(seed).integers(-10**4, 10**4, d).astype(np.int64)
    return q, ss.to_chunks(q, k)


# ----------------------------------------------------- keys, commit, Schnorr


def test_generators_equal_reference(backend):
    assert cm.H_POINT == rcm.H_POINT
    for label in (b"x", b"pedersen-H", b"commit-key\x00\x00\x00\x00"):
        assert cm._hash_to_point(label) == rcm._hash_to_point(label)
    assert cm.decompress_point(ed.point_compress(ed.base_mult(5))) \
        == rcm.decompress_point(red.point_compress(red.base_mult(5)))
    assert cm.decompress_point(b"\xff" * 32) is None
    assert ed.point_equal(cm.base_mult_fast(12345), red.base_mult(12345))


def test_commit_key_and_commit_update_equal_reference(backend):
    key, rkey = cm.CommitKey.generate(24), rcm.CommitKey.generate(24)
    enc = key.serialize()
    assert enc == rkey.serialize()
    back = cm.CommitKey.deserialize(enc)
    assert all(ed.point_equal(p, r) for p, r in zip(back.points, key.points))
    assert np.array_equal(key.device_buf(24), rkey.device_buf(24))
    assert key.native_buf(24) == rkey.native_buf(24)
    rng = np.random.default_rng(1)
    for q in (np.array([120000, -34567, 0, 999, -1], np.int64),
              rng.integers(-10**6, 10**6, 24).astype(np.int64)):
        c = cm.commit_update(q, key)
        assert c == rcm.commit_update(q, rkey)
        assert cm.verify_commitment(c, q, key)
        q2 = q.copy()
        q2[3] += 1
        assert not cm.verify_commitment(c, q2, key)
    assert not cm.verify_commitment(c, np.zeros(64, np.int64), key)  # too big
    a, b = np.array([5, -3, 11], np.int64), np.array([2, 9, -4], np.int64)
    ca = ed.point_decompress(cm.commit_update(a, key))
    cb = ed.point_decompress(cm.commit_update(b, key))
    assert ed.point_compress(ed.point_add(ca, cb)) == cm.commit_update(a + b, key)


def _schnorr_items():
    seeds = [bytes([i]) * 32 for i in range(4)]
    msgs = [b"m%d" % i for i in range(4)]
    return [(ed.public_key(s), m, cm.schnorr_sign(s, m))
            for s, m in zip(seeds, msgs)]


def test_schnorr_bytes_and_verdicts_equal_reference(mode):
    for seed, msg in ((b"\x07" * 32, b"commitment-bytes"), (b"t" * 32, b"")):
        sig = cm.schnorr_sign(seed, msg)
        assert sig == rcm.schnorr_sign(seed, msg)
        pk = ed.public_key(seed)
        assert cm.schnorr_verify(pk, msg, sig)
        assert not cm.schnorr_verify(pk, b"other", sig)
        bad = bytearray(sig)
        bad[10] ^= 1
        assert cm.schnorr_verify(pk, msg, bytes(bad)) \
            == rcm.schnorr_verify(pk, msg, bytes(bad)) is False
    trips = _schnorr_items()
    assert cm.batch_schnorr_verify(trips) is True
    assert rcm.batch_schnorr_verify(trips) is True
    tampered = list(trips)
    tampered[1] = (tampered[1][0], b"tampered", tampered[1][2])
    assert cm.batch_schnorr_verify(tampered) \
        == rcm.batch_schnorr_verify(tampered) is False
    short = list(trips)
    short[0] = (short[0][0], short[0][1], short[0][2][:63])
    assert cm.batch_schnorr_verify(short) is False


def test_torsioned_pubkey_single_and_batch_verdicts_agree(mode):
    t8 = ed.point_decompress(T8)
    x = 123456789
    pub = ed.point_compress(ed.point_add(ed.base_mult(x), t8))
    k = 987654321
    r = ed.point_compress(ed.base_mult(k))
    c = int.from_bytes(hashlib.sha512(r + pub + b"msg").digest(),
                       "little") % ed.Q
    sig = r + ((k + c * x) % ed.Q).to_bytes(32, "little")
    for msg, want in ((b"msg", True), (b"other", False)):
        assert cm.schnorr_verify(pub, msg, sig) is want
        assert cm.batch_schnorr_verify([(pub, msg, sig)]) is want
        assert rcm.batch_schnorr_verify([(pub, msg, sig)]) is want


# --------------------------------------------------- batch commitment RLC


def _intake(d=30, w=4, seed=5):
    rng = np.random.default_rng(seed)
    key = cm.CommitKey.generate(d, label=b"cryptokernel-test")
    qs = [rng.integers(-500, 500, d).astype(np.int64) for _ in range(w)]
    items = [(cm.commit_update(q, key), q) for q in qs]
    entropy = bytes(rng.integers(0, 256, 16 * w, dtype=np.uint8))
    return key, items, entropy


def test_batch_verify_commitments_verdicts_equal_reference(mode):
    key, items, entropy = _intake()
    rkey = rcm.CommitKey.generate(30, label=b"cryptokernel-test")
    assert [c for c, _ in items] == [rcm.commit_update(q, rkey)
                                     for _, q in items]
    bad = list(items)
    bad[2] = (bad[2][0], bad[2][1] + 1)
    mal = list(items)
    mal[0] = (b"\x01" * 31, mal[0][1])
    for case, want in ((items, True), (bad, False), (mal, False),
                       (items[:0], True)):
        got = cm.batch_verify_commitments(case, key, entropy=entropy)
        assert got is rcm.batch_verify_commitments(case, rkey,
                                                   entropy=entropy) is want
    assert cm.find_bad_commitments(bad, key) \
        == rcm.find_bad_commitments(bad, rkey) == [2]
    # a torsioned commitment: decompresses, but fails the subgroup check
    tors = ed.point_compress(ed.point_add(
        ed.point_decompress(items[1][0]), ed.point_decompress(T8)))
    bad_t = list(items)
    bad_t[1] = (tors, bad_t[1][1])
    assert cm.batch_verify_commitments(bad_t, key, entropy=entropy) \
        is rcm.batch_verify_commitments(bad_t, rkey, entropy=entropy) is False


# ------------------------------------------------------------------- VSS


def test_vss_commit_and_blind_rows_equal_reference(backend):
    _, chunks = _chunks(64, 10, 3)
    comms, blinds = cm.vss_commit_chunks(chunks, b"s" * 32, b"ctx")
    rcomms, rblinds = rcm.vss_commit_chunks(chunks, b"s" * 32, b"ctx")
    assert comms.dtype == np.uint8 and np.array_equal(comms, rcomms)
    assert blinds == rblinds
    cb, bb = cm.vss_commit_chunks_bytes(chunks, b"s" * 32, b"ctx2")
    rcb, rbb = rcm.vss_commit_chunks_bytes(chunks, b"s" * 32, b"ctx2")
    assert np.array_equal(cb, rcb) and bb == rbb
    assert cm.vss_digest(comms) == rcm.vss_digest(rcomms)
    xs = [i - ss.SHARE_OFFSET for i in range(15)]
    br = cm.vss_blind_rows(blinds, xs)
    assert np.array_equal(br, rcm.vss_blind_rows(rblinds, xs))
    assert np.array_equal(cm.vss_blind_rows_bytes(bb, 7, 10, xs),
                          rcm.vss_blind_rows_bytes(rbb, 7, 10, xs))
    a = [7, -2, 0, ed.Q - 1, -(ed.Q - 1), 10**9]
    b = [3, 0, ed.Q - 5, 1, 2, 2**130]
    assert cm.batch_pedersen_commit_xy(a, b) == rcm.batch_pedersen_commit_xy(a, b)


def test_chunk_vss_share_verification(backend):
    seed, coeffs = b"\x21" * 32, [120000, -34567, 0, 999]
    vss, blinds = cm.vss_commit_chunk(coeffs, seed, chunk_index=0)
    rvss, rblinds = rcm.vss_commit_chunk(coeffs, seed, chunk_index=0)
    assert vss.commitments == rvss.commitments and blinds == rblinds
    for x in (-10, 1, 7):
        share, blind = cm.eval_poly(coeffs, x), cm.eval_poly(blinds, x)
        assert share == rcm.eval_poly(coeffs, x)
        assert vss.verify_share(x, share, blind)
        assert not vss.verify_share(x, share + 1, blind)
        assert not vss.verify_share(x + 1, share, blind)
    # the share matrix and the VSS prover agree on share values
    q = np.array([7, -2, 3, 0, 11, 5, -9, 1, 4, 8], np.int64)
    shares, xs = ss.make_shares(q, total_shares=20), ss.share_xs(20)
    assert [shares[s, 0] for s in range(20)] == [
        cm.eval_poly([int(v) for v in q], int(x)) for x in xs]


def _multi_cases():
    """tests/test_commitments.py:136-298's instances: one worker's rows
    under every corruption class, and a four-worker group."""
    d, k, total = 64, 10, 20
    q, chunks = _chunks(d, k, 5)
    comms, blinds = cm.vss_commit_chunks(chunks, b"s" * 32, b"ctx")
    xs = [i - ss.SHARE_OFFSET for i in range(total)][:7]
    rows = ss.make_shares(q, k, total)[:7]
    br = cm.vss_blind_rows(blinds, xs)
    bad_rows = rows.copy()
    bad_rows[3, 1] += 1
    bad_blind = br.copy()
    bad_blind[0, 0, 0] ^= 1
    noncanon = br.copy()
    noncanon[2, 2, :] = 255  # ≥ q
    single = {"valid": [(comms, xs, rows, br)],
              "bad_row": [(comms, xs, bad_rows, br)],
              "bad_blind": [(comms, xs, rows, bad_blind)],
              "noncanonical_blind": [(comms, xs, rows, noncanon)],
              "zero_width": [(np.zeros((4, 0, 64), np.uint8), [1, 2],
                              np.zeros((2, 4), np.int64),
                              np.zeros((2, 4, 32), np.uint8))]}
    insts = []
    for w in range(4):
        qw, cw = _chunks(d, k, 100 + w)
        co, bl = cm.vss_commit_chunks(cw, bytes([w]) * 32, b"ctx")
        insts.append((co, xs[:5], ss.make_shares(qw, k, total)[:5],
                      cm.vss_blind_rows(bl, xs[:5])))

    def clone():
        return [(co.copy(), x, r.copy(), b.copy()) for co, x, r, b in insts]

    one_bad, off_curve, collude = clone(), clone(), clone()
    one_bad[2][2][1, 3] += 9
    off_curve[1][0][0, 0, 7] ^= 0x55
    collude[0][2][2, 4] += 5
    collude[3][2][2, 4] -= 5
    group = {"honest": insts, "one_bad": one_bad, "off_curve": off_curve,
             "collude_cancel": collude, "collude_partial": collude[:3]}
    group.update({f"identify_{i}": [inst] for i, inst in enumerate(one_bad)})
    return {**single, **group}


def test_vss_verify_multi_verdicts_equal_reference(backend):
    cases = _multi_cases()
    entropy = bytes(range(256)) * 64
    got = {name: cm.vss_verify_multi(c, entropy=entropy)
           for name, c in cases.items()}
    ref = {name: rcm.vss_verify_multi(c, entropy=entropy)
           for name, c in cases.items()}
    assert got == ref
    assert got.pop("zero_width") is (backend == "python")
    assert [n for n, v in got.items() if v] == [
        "valid", "honest", "collude_cancel", "identify_0", "identify_1",
        "identify_3"]


def _vss_instance(seed=7, k=5, c=6, s=4):
    rng = np.random.default_rng(seed)
    chunks = rng.integers(-200, 200, (c, k)).astype(np.int64)
    comms, blinds = cm.vss_commit_chunks(chunks, b"seed" * 8, b"ctx")
    xs = list(range(1, s + 1))
    rows = np.stack([[cm.eval_poly(chunks[ci], x) for ci in range(c)]
                     for x in xs]).astype(np.int64)
    br = cm.vss_blind_rows(blinds, xs)
    ent = bytes(rng.integers(0, 256, 16 * s * c, dtype=np.uint8))
    return comms, rows, br, xs, ent, (s, c, k)


def _intake_run(mod, waves, xs, ent, dims):
    """(rejected sids of every fold, settle, members) of one intake."""
    acc = mod.VssIntakeBatch(*dims, entropy=ent)
    rejected = []
    for wave in waves:
        for sid, (comms, rows, br) in wave.items():
            assert acc.add(sid, comms, rows, br)
        rejected.append(acc.fold())
    return rejected, acc.verify(xs), sorted(acc.members())


def _intake_cases():
    comms, rows, br, xs, ent, dims = _vss_instance()
    badc = comms.copy()
    badc[0, 0, 0] ^= 1
    rows_bad = rows.copy()
    rows_bad[0, 0] += 1
    good = (comms, rows, br)
    return xs, ent, dims, {
        "honest": ([{1: good, 2: good}], ([[]], True, [1, 2])),
        "off_curve": ([{1: good, 2: (badc, rows, br)}], ([[2]], True, [1])),
        "bad_row": ([{1: (comms, rows_bad, br)}], ([[]], False, [1])),
        # three waves, the second a single bad grid (the native single-grid
        # in-place path), the third a single good one
        "waves": ([{1: good, 2: good}, {3: (badc, rows, br)}, {4: good}],
                  ([[], [3], []], True, [1, 2, 4])),
    }


@pytest.mark.parametrize("case", ["honest", "off_curve", "bad_row", "waves"])
def test_vss_intake_triples_equal_reference(mode, case):
    xs, ent, dims, cases = _intake_cases()
    waves, want = cases[case]
    got = _intake_run(cm, waves, xs, ent, dims)
    assert got == _intake_run(rcm, waves, xs, ent, dims) == want


def test_vss_intake_add_rejects_bad_shapes_and_blinds():
    comms, rows, br, xs, ent, dims = _vss_instance()
    for mod in (cm, rcm):
        acc = mod.VssIntakeBatch(*dims, entropy=ent)
        assert acc.add(1, comms, rows, br)
        assert not acc.add(1, comms, rows, br)  # duplicate sid
        assert not acc.add(2, comms[:, :2], rows, br)
        nc = br.copy()
        nc[0, 0, :] = 255
        assert not acc.add(3, comms, rows, nc)
        assert len(acc) == 1 and acc.verify(xs[:2]) is False
    with pytest.raises(ValueError, match="entropy"):
        cm.VssIntakeBatch(*dims, entropy=ent[:16])


def _fault(*a, **kw):
    raise RuntimeError("backend fault")


def test_vss_intake_device_fault_raises(monkeypatch):
    """No CPU failover (the reference's tests/test_crypto_kernels.py:389-424
    asserts the opposite): a device fault raises out of fold and verify."""
    comms, rows, br, xs, ent, dims = _vss_instance(seed=21)
    kernels.set_enabled(True, device="cpu")
    try:
        acc = cm.VssIntakeBatch(*dims, entropy=ent)
        assert acc.add(1, comms, rows, br) and acc.fold() == []
        assert acc._acc_dev is not None  # the first wave folded on device
        assert acc.add(2, comms, rows, br)
        with monkeypatch.context() as m:
            m.setattr(kernels, "grid_validate_sum", _fault)
            with pytest.raises(RuntimeError, match="backend fault"):
                acc.fold()
        acc2 = cm.VssIntakeBatch(*dims, entropy=ent)
        assert acc2.add(1, comms, rows, br) and acc2.fold() == []
        monkeypatch.setattr(kernels, "msm", _fault)
        with pytest.raises(RuntimeError, match="backend fault"):
            acc2.verify(xs)
        key, items, entropy = _intake()
        with pytest.raises(RuntimeError, match="backend fault"):
            cm.batch_verify_commitments(items, key, entropy=entropy)
        with pytest.raises(RuntimeError, match="backend fault"):
            cm.batch_schnorr_verify(_schnorr_items())
    finally:
        kernels.set_enabled(False)


# ------------------------------------------------ resharing algebra


def _overlay_instance(tag, d=8, k=4, total=6):
    q = np.random.default_rng(1000 + tag).integers(
        -50_000, 50_000, size=d).astype(np.int64)
    comms, blind_bytes = cm.vss_commit_chunks_bytes(
        ss.to_chunks(q, k), bytes([tag]) * 32, b"overlay-prop")
    xs = [int(x) - ss.SHARE_OFFSET for x in range(total)]
    shares = ss.make_shares(q, k, total)
    blind_rows = cm.vss_blind_rows_bytes(blind_bytes, comms.shape[0], k, xs)
    return comms, shares, blind_rows, xs


def test_resharing_algebra_equals_reference(backend):
    insts = [_overlay_instance(t) for t in range(3)]
    grids = [i[0] for i in insts]
    summed = cm.sum_commitment_grids(grids)
    assert np.array_equal(summed, rcm.sum_commitment_grids(grids))
    assert np.array_equal(summed, cm.sum_commitment_grids(grids[::-1]))
    blinds = [i[2] for i in insts]
    assert cm.sum_blind_rows(blinds) == rcm.sum_blind_rows(blinds)
    tens = cm.sum_blind_row_tensors(blinds)
    assert np.array_equal(tens, rcm.sum_blind_row_tensors(blinds))
    xs = insts[0][3]
    rows = np.sum(np.stack([i[1] for i in insts]), axis=0)
    assert cm.vss_verify_multi([(summed, xs, rows, tens)])
    bad = rows.copy()
    bad[0, 0] += 1
    assert not cm.vss_verify_multi([(summed, xs, bad, tens)])
    ev = cm.commitment_eval_xy(summed, 3)
    assert all(ed.point_equal(a, b) for a, b in zip(
        ev, rcm.commitment_eval_xy(summed, 3), strict=True))
    off = summed.copy()
    off[0, 0, 5] ^= 1
    assert cm.commitment_eval_xy(off, 3) is None
    assert cm.sum_commitment_grids([off]) is None

    # a holder re-deals the row it holds at x_old
    comms, shares, blind_rows, xs = insts[0]
    x_old, r = xs[2], 2
    held = shares[r]
    held_blinds = [int.from_bytes(blind_rows[r, c].tobytes(), "little")
                   for c in range(comms.shape[0])]
    coeffs = ss.reshare_coeffs(held[None], 4, b"h" * 32, b"ctx")[0]
    sub_comms, sub_blinds = cm.reshare_commit_row(coeffs, held_blinds,
                                                  b"h" * 32, b"ctx")
    rsub, rblinds = rcm.reshare_commit_row(coeffs, held_blinds, b"h" * 32,
                                           b"ctx")
    assert np.array_equal(sub_comms, rsub) and sub_blinds == rblinds
    xs_new = [1, 2, 3, 4, 5]
    sub_rows = rss.reshare_subshares(coeffs[None], xs_new)[:, 0, :]
    sub_br = cm.vss_blind_rows(sub_blinds, xs_new)
    args = (comms, x_old, sub_comms, xs_new, sub_rows, sub_br)
    assert cm.reshare_verify_deal(*args) is rcm.reshare_verify_deal(*args) is True
    lie = sub_rows.copy()
    lie[1, 0] += 1
    args = (comms, x_old + 1, sub_comms, xs_new, sub_rows, sub_br)
    assert cm.reshare_verify_deal(*args) is rcm.reshare_verify_deal(*args) is False
    args = (comms, x_old, sub_comms, xs_new, lie, sub_br)
    assert cm.reshare_verify_deal(*args) is rcm.reshare_verify_deal(*args) is False


def test_native_and_python_msm_agree_with_reference_oracle(monkeypatch):
    key = cm.CommitKey.generate(48)
    rng = np.random.default_rng(9)
    scalars = [int(v) for v in rng.integers(-10**13, 10**13, 48)]
    scalars[0], scalars[1] = ed.Q - 2, 0
    nat = cm.msm(scalars, key.points)
    monkeypatch.setattr(_native, "available", lambda: False)
    py = cm.msm(scalars, key.points)
    assert ed.point_equal(nat, py)
    assert py == rcm._msm_python(scalars, key.points)


def test_reference_native_reloads_after_a_lost_build(monkeypatch):
    """A reference plane left as a lost concurrent build leaves it (two
    reads of a short file, the python fallback for good) is loaded again
    by `_reference_native`, and the native comparison then holds."""
    monkeypatch.setattr(rnative, "_lib", None)
    monkeypatch.setattr(rnative, "_load_attempted", True)
    monkeypatch.setattr(rnative, "_load_error",
                        "native/libbiscotti_native.so failed to load (file "
                        "too short)")
    assert not rnative.available()
    _native_planes(monkeypatch)
    assert rnative.available() and rnative.load_error() == ""
    cases = _multi_cases()
    assert rcm.vss_verify_multi(cases["zero_width"]) is False
    assert cm.vss_verify_multi(cases["zero_width"]) is False
