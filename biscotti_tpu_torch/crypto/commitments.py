"""Pedersen commitments, Schnorr signatures, and pairing-free verifiable
secret sharing over Edwards25519 — the port's copy of
`biscotti_tpu/crypto/commitments.py`.

The host paths are the reference's, line for line: the native C++ plane
(`_native.py`, built from the repo's `native/ed25519_msm.cpp`) where it
loads, else the python-int oracle. The device seams — the batch
commitment and Schnorr verifiers and `VssIntakeBatch`'s wave fold and
settle — call the port's plane (`crypto/kernels`) on the device it was
armed on (`kernels.armed_device()`). One deliberate difference: where the
reference catches a device fault and finishes on the CPU, here the fault
raises out of the seam. Verdicts and evicted sids are the reference's on
every input.

Reference capabilities being reproduced (SURVEY.md §2.2):
  * polynomial/vector commitment to the quantized update:
    C = Σ qᵢ·PKᵢ over bn256 G1 (ref: DistSys/kyber.go:533-562
    createCommitment, verified by recompute kyber.go:564-577)
  * Schnorr signatures over commitments (ref: kyber.go:873-925)
  * per-share witnesses a miner can check against the sender's commitment
    (ref: kyber.go:611-673 — KZG-style, verified with a bn256 *pairing*)

Design departure, documented on purpose: the reference's share-witness check
needs a pairing-friendly curve. This build replaces it with **Pedersen VSS**
(coefficient commitments Cⱼ = aⱼ·G + bⱼ·H plus a parallel blinding-polynomial
share; check: s·G + t·H == Σ xʲ·Cⱼ), which delivers the same capability —
shares verifiable against a binding, hiding commitment to the polynomial —
on a single fast curve with no pairings. Plain Feldman (aⱼ·G) would leak
low-entropy quantized coefficients to a baby-step/giant-step search; the
blinding term closes that.

The group is the same Edwards25519 used by the VRF; scalars live in Z_q.
Pure-Python backend here (control-plane correctness); `native/` provides a
C++ fast path for the O(d) MSM hot spot, loaded lazily via ctypes.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple

import numpy as np

from biscotti_tpu_torch.crypto import ed25519 as ed

_Q = ed.Q


def _hash_to_point(label: bytes) -> ed.Point:
    """Nothing-up-my-sleeve generator derivation via the shared
    try-and-increment hash-to-curve in ed25519.py. Injects the native
    decompression when loadable (identical semantics); falls back cleanly
    during module import, when decompress_point below is not yet defined
    (the import-time H_POINT derivation takes the pure path)."""
    try:
        dec = decompress_point
    except NameError:  # import-time H_POINT derivation
        dec = None
    return ed.hash_to_point(b"biscotti-gen" + label, decompress=dec)


# Secondary generator for Pedersen blinding; independent of B by construction.
H_POINT = _hash_to_point(b"pedersen-H")


def _scalar(v: int) -> int:
    return v % _Q


def msm(scalars: Sequence[int], points: Sequence[ed.Point]) -> ed.Point:
    """Multi-scalar multiplication Σ sᵢ·Pᵢ (Pippenger bucket method).

    This is the reference's per-update hot spot — an O(d) MSM per round per
    peer (ref: kyber.go:533-562 at d=7,850 dominated its CPU budget,
    SURVEY.md §7.3). The C++ backend in native/ replaces this when built.
    """
    native = _native_mod()
    if native is not None:
        return native.msm(scalars, points)
    return _msm_python(scalars, points)


def _device_mod():
    """The device crypto plane (crypto/kernels) when ARMED
    (`kernels.set_enabled`) — None otherwise. Consulted only at the batched
    seams below: device verdicts are computed from the identical group
    equations, and every REJECTION still routes through the CPU
    recompute/bisection paths, so rejection evidence and stake debits
    stay byte-identical to the CPU configuration."""
    from biscotti_tpu_torch.crypto import kernels

    return kernels.active_module()


def _msm_python(scalars: Sequence[int], points: Sequence[ed.Point]) -> ed.Point:
    if len(scalars) != len(points):
        raise ValueError("scalar/point length mismatch")
    # mirror the native wrapper's top-half-negation EXACTLY: s·P and
    # (q−s)·(−P) differ by q·P, which is NOT the identity for points
    # carrying a small-order (torsion) component — decompression does no
    # subgroup check, so an adversarial torsioned point would otherwise
    # make the two backends disagree on the same inputs (consensus split)
    pairs = []
    for s, p in zip(scalars, points):
        s = _scalar(s)
        if s > _Q // 2:
            s = _Q - s
            p = ed.point_neg(p)
        pairs.append((s, p))
    pairs = [(s, p) for s, p in pairs if s]
    if not pairs:
        return ed.IDENTITY
    c = 8 if len(pairs) >= 32 else 4  # window bits
    maxbits = max(s.bit_length() for s, _ in pairs)
    acc = ed.IDENTITY
    for w in range((maxbits + c - 1) // c - 1, -1, -1):
        if not ed.is_identity(acc):
            for _ in range(c):
                acc = ed.point_double(acc)
        buckets: List[ed.Point] = [ed.IDENTITY] * (1 << c)
        for s, p in pairs:
            idx = (s >> (w * c)) & ((1 << c) - 1)
            if idx:
                buckets[idx] = ed.point_add(buckets[idx], p)
        running = ed.IDENTITY
        window_sum = ed.IDENTITY
        for b in range((1 << c) - 1, 0, -1):
            running = ed.point_add(running, buckets[b])
            window_sum = ed.point_add(window_sum, running)
        acc = ed.point_add(acc, window_sum)
    return acc


# ------------------------------------------------------------- commit key


@dataclass
class CommitKey:
    """d independent generators, one per model parameter — the trusted
    dealer's `commitKey.json` equivalent (ref:
    keyGeneration/generateBootstrapFile.go:26-120, honest.go:760-871).

    Derived transparently from a seed label instead of a dealer's secret
    MSM ladder (ref: publicKey.go:26-61): no trapdoor exists at all, which
    strictly improves on the reference's trusted-dealer assumption."""

    points: List[ed.Point]
    # lazily-built native MSM buffer (128 B/point extended form): built
    # ONCE per key, so per-update commitment recomputes skip the
    # python-point → bytes marshalling that otherwise dominates (measured
    # ~2.4 s/update at d=7,850 — 30× the MSM itself; a keyed miner
    # recomputing its whole intake rode the 90 s round deadline on it)
    _native_buf: Optional[bytes] = None
    # lazily-built device limb buffer ([d, 4, 16] int64 extended limbs)
    # for the --device-crypto MSM path — same build-once rationale
    _device_buf: Optional[object] = None

    # derivation/deserialization memo: the generator ladder is a pure
    # function of (dims, label) and the `_hash_to_point` try-and-increment
    # per generator is the expensive part (a sqrt per candidate). Every
    # in-process peer of an N-node test cluster loads the SAME dealer key,
    # and harnesses regenerate the same transparent key per agent — cache
    # the finished point lists instead of re-deriving N times. Few keys
    # ever exist per process; the cap guards pathological harnesses.
    _CACHE_MAX = 8
    _gen_cache: ClassVar["OrderedDict[Tuple[int, bytes], List[ed.Point]]"] \
        = OrderedDict()
    _deser_cache: ClassVar["OrderedDict[bytes, List[ed.Point]]"] \
        = OrderedDict()

    @classmethod
    def _cache_put(cls, cache: OrderedDict, key, pts) -> None:
        while len(cache) >= cls._CACHE_MAX:
            cache.popitem(last=False)
        cache[key] = pts

    @classmethod
    def generate(cls, dims: int, label: bytes = b"commit-key") -> "CommitKey":
        key = (dims, bytes(label))
        pts = cls._gen_cache.get(key)
        if pts is None:
            pts = [_hash_to_point(label + i.to_bytes(4, "little"))
                   for i in range(dims)]
            cls._cache_put(cls._gen_cache, key, pts)
        else:
            cls._gen_cache.move_to_end(key)
        # the points list is treated as immutable by every consumer;
        # sharing it across CommitKey instances is safe and lets the
        # lazily-built native buffer be the only per-instance state
        return cls(list(pts))

    def serialize(self) -> List[str]:
        return [ed.point_compress(p).hex() for p in self.points]

    @classmethod
    def deserialize(cls, items: Sequence[str]) -> "CommitKey":
        blob = b"".join(bytes.fromhex(s) for s in items)
        ck = hashlib.sha256(blob).digest()
        cached = cls._deser_cache.get(ck)
        if cached is not None:
            cls._deser_cache.move_to_end(ck)
            return cls(list(cached))
        native = _native_mod()
        if native is not None:
            # one native call for the whole key (~10 µs/point vs ~160 µs
            # python): at d=7,850 this is the difference between 0.1 s and
            # ~1.3 s of startup per process
            pts = native.decompress_batch(blob, len(items))
            if pts is None:
                raise ValueError("invalid commit-key point")
            cls._cache_put(cls._deser_cache, ck, pts)
            return cls(list(pts))
        pts = []
        for s in items:
            p = ed.point_decompress(bytes.fromhex(s))
            if p is None:
                raise ValueError("invalid commit-key point")
            pts.append(p)
        cls._cache_put(cls._deser_cache, ck, pts)
        return cls(list(pts))

    def native_buf(self, n: int) -> bytes:
        """First n points as the native 128 B/point MSM buffer."""
        if self._native_buf is None or len(self._native_buf) < 128 * n:
            object.__setattr__(self, "_native_buf", b"".join(
                (x % ed.P).to_bytes(32, "little")
                + (y % ed.P).to_bytes(32, "little")
                + (z % ed.P).to_bytes(32, "little")
                + (t % ed.P).to_bytes(32, "little")
                for x, y, z, t in self.points))
        return self._native_buf[: 128 * n]

    def device_buf(self, n: int):
        """First n points as the device kernel plane's [n, 4, 16] limb
        batch (crypto/kernels); built once per key like native_buf."""
        if self._device_buf is None or len(self._device_buf) < n:
            from biscotti_tpu_torch.crypto.kernels import group as _gp

            object.__setattr__(
                self, "_device_buf",
                _gp.points_to_limbs(self.points).astype("int64"))
        return self._device_buf[:n]


def commit_update(q: np.ndarray, key: CommitKey) -> bytes:
    """C = Σ qᵢ·Gᵢ (ref: kyber.go:533-562). `q` is the int64 quantized
    update; negative entries map to Z_q."""
    if len(q) > len(key.points):
        raise ValueError(f"update dim {len(q)} exceeds commit key {len(key.points)}")
    native = _native_mod()
    if native is not None:
        # zero-marshalling hot path: int64 magnitudes/signs pack in numpy,
        # the key rides its cached native buffer
        flat = np.ascontiguousarray(q, dtype=np.int64)
        n = len(flat)
        mags = np.zeros((n, 32), dtype=np.uint8)
        mags[:, :8] = np.abs(flat).astype("<u8").view(np.uint8).reshape(n, 8)
        signs = (flat < 0).astype(np.uint8)
        pt = native.msm_signed_raw(mags.tobytes(), signs.tobytes(),
                                   key.native_buf(n), n)
        return ed.point_compress(pt)
    return ed.point_compress(msm([int(v) for v in q], key.points[: len(q)]))


def verify_commitment(commitment: bytes, q: np.ndarray, key: CommitKey) -> bool:
    """Recompute-and-compare (ref: kyber.go:564-577)."""
    try:
        return commit_update(q, key) == commitment
    except ValueError:
        return False


def _rlc_gammas(n: int, entropy: Optional[bytes]) -> Optional[List[int]]:
    """n random odd 128-bit RLC weights — from the caller's entropy
    windows (16 B each, determinism for tests) or os.urandom."""
    import os as _os

    if entropy is not None:
        if len(entropy) < 16 * n:
            return None
        raw = entropy[: 16 * n]
    else:
        raw = _os.urandom(16 * n)
    return [int.from_bytes(raw[16 * i: 16 * (i + 1)], "little") | 1
            for i in range(n)]


def _in_subgroup(p: ed.Point) -> bool:
    """ℓ·P == identity — prime-order subgroup membership. Native when
    built (window scalar-mult, the msm wrapper would reduce ℓ to 0)."""
    native = _native_mod()
    if native is not None:
        return ed.is_identity(native.scalarmult_noreduce(_Q, p))
    return ed.is_identity(ed.scalar_mult(_Q, p))


def batch_verify_commitments(items: Sequence[Tuple[bytes, np.ndarray]],
                             key: CommitKey,
                             entropy: Optional[bytes] = None) -> bool:
    """One RLC check for a whole miner intake of plain Pedersen
    commitments: True iff EVERY (commitment, q) pair satisfies
    C = Σ qⱼ·Gⱼ — Σᵢ γᵢ·Cᵢ == Σⱼ (Σᵢ γᵢ·qᵢⱼ)·Gⱼ, ONE d-point MSM with
    ~172-bit combined scalars instead of W d-point MSMs (~10× at the
    35-update mint-trigger intake; the per-update loop this replaces is
    the reference's kyber.go:564-577 recompute run W times).

    Verdict parity with the sequential recompute path is EXACT (failure
    probability 2⁻¹²⁸): every Cᵢ is required to decompress AND to lie in
    the prime-order subgroup (ℓ·C == 0, one cheap scalar-mult each —
    without it two colluders adding the same order-2 torsion point would
    slip past any linear combination whose weight-sum is even, accepted
    here yet rejected by recompute), and valid RFC 8032 encodings are
    bijective to points, so point equality ⟺ bytes equality. On False
    the caller bisects (find_bad_commitments) — rejection evidence is
    always the exact single recompute, never the batch."""
    if not items:
        return True
    n = len(items)
    d = len(items[0][1])
    if d > len(key.points) or any(len(q) != d for _, q in items):
        return False
    # malformed-length commitments return False (the sequential path's
    # byte-compare verdict) instead of tripping the batch decompressor's
    # length check mid-drain
    if any(len(c) != 32 for c, _ in items):
        return False
    gam = _rlc_gammas(n, entropy)
    if gam is None:
        return False
    native = _native_mod()
    c_pts: List[ed.Point] = []
    if native is not None:
        pts = native.decompress_batch(b"".join(c for c, _ in items), n)
        if pts is None:
            return False
        c_pts = pts
    else:
        for c_bytes, _ in items:
            p = ed.point_decompress(c_bytes)
            if p is None:
                return False
            c_pts.append(p)
    if not all(_in_subgroup(p) for p in c_pts):
        return False
    # combined scalars Sⱼ = Σᵢ γᵢ·qᵢⱼ via 8-bit limb decomposition of γ:
    # 16 int64 matmuls keep every partial inside int64 (2⁸·|q|·n — safe
    # for |q| < 2⁵⁵/n, far above any clipped quantized update), with an
    # object-dtype fallback for adversarially huge q values
    qmat = np.stack([np.asarray(q, np.int64) for _, q in items])  # [n, d]
    qmax = int(np.abs(qmat).max()) if qmat.size else 0
    if qmax and qmax * n < (1 << 55):
        limbs = np.zeros((n, 16), np.int64)
        for i, g in enumerate(gam):
            for l in range(16):
                limbs[i, l] = (g >> (8 * l)) & 0xFF
        acc = limbs.T @ qmat  # [16, d] int64, exact
        scalars = [sum(int(acc[l, j]) << (8 * l) for l in range(16))
                   for j in range(d)]
    else:
        accobj = np.zeros(d, dtype=object)
        for g, row in zip(gam, qmat):
            accobj += g * row.astype(object)
        scalars = [int(v) for v in accobj]
    dev = _device_mod()
    if dev is not None:
        # device verdict: same two group equations on the armed device
        # (RLC lhs over the intake's commitments, combined-scalar rhs
        # over the commit key's limb buffer). Integer limb arithmetic is
        # exact, so the computed group elements — and the verdict — are
        # identical to the CPU backends'; a failed batch still bisects
        # through the CPU recompute (find_bad_commitments), so rejection
        # evidence never comes from this path. A device fault raises.
        on = dev.armed_device()
        lhs = dev.msm(gam, c_pts, device=on)
        rhs = dev.msm(scalars, key.device_buf(d), device=on)
        return ed.point_equal(lhs, rhs)
    lhs = msm(gam, c_pts)
    if native is not None:
        rhs = native.msm_raw(scalars, key.native_buf(d), d)
    else:
        rhs = msm(scalars, key.points[:d])
    return ed.point_equal(lhs, rhs)


def find_bad_commitments(items: Sequence[Tuple[bytes, np.ndarray]],
                         key: CommitKey) -> List[int]:
    """Bisection over a failed batch: indices of every (commitment, q)
    pair the sequential recompute rejects. Each leaf verdict IS the
    sequential `verify_commitment`, so acceptance/rejection evidence is
    bit-identical to the per-update path; clean halves are retired with
    one batched check each, costing O(bad·log W) batch calls instead of
    W recomputes."""
    out: List[int] = []

    def walk(lo: int, hi: int, known_bad: bool) -> None:
        if lo >= hi:
            return
        if hi - lo == 1:
            if not verify_commitment(items[lo][0], items[lo][1], key):
                out.append(lo)
            return
        if not known_bad and batch_verify_commitments(items[lo:hi], key):
            return
        mid = (lo + hi) // 2
        walk(lo, mid, False)
        walk(mid, hi, False)

    # the caller reaches here off a failed whole-intake batch — skip
    # re-proving what is already known and split immediately
    walk(0, len(items), True)
    return out


# ------------------------------------------------------------- Schnorr


def _native_mod():
    from biscotti_tpu_torch.crypto import _native

    return _native if _native.available() else None


def base_mult_fast(k: int) -> ed.Point:
    """k·B through the native fixed-base comb tables when built (~50× the
    python double-and-add; the comb for B is shared with the Pedersen
    commitment path since G = B there)."""
    native = _native_mod()
    if native is not None:
        return native.point_from_xy64(
            native.batch_commit_xy([int(k) % _Q], [0]))
    return ed.base_mult(k)


# (secret seed) → (x, prefix, compressed pk): signer identities are
# long-lived, so the per-sign base_mult for the public key amortizes away.
# An LRU bounded at 128, not unbounded: every retained entry pins an
# expanded secret scalar in memory (visible to anything that can read
# process memory or a core dump), so ephemeral harness identities fall
# out instead of accumulating forever. The bound stays ABOVE the largest
# in-process cluster the harnesses run (100 peers signing round-robin in
# one process — eval/scale_test.py — is the LRU worst case; a small
# bound would thrash it into a 100% miss rate). Re-expanding on a miss
# costs one sha512 + fixed-base mult (~0.03 ms native).
_sign_key_cache: "OrderedDict[bytes, tuple]" = OrderedDict()
_SIGN_KEY_CACHE_MAX = 128


def schnorr_sign(seed: bytes, message: bytes) -> bytes:
    """Deterministic Schnorr over Ed25519 (ref: kyber.go:873-896 signs with
    bn256; the curve is an implementation detail of the capability)."""
    cached = _sign_key_cache.get(seed)
    if cached is None:
        x, prefix = ed.secret_expand(seed)
        pk = ed.point_compress(base_mult_fast(x))
        while len(_sign_key_cache) >= _SIGN_KEY_CACHE_MAX:
            _sign_key_cache.popitem(last=False)
        _sign_key_cache[seed] = cached = (x, prefix, pk)
    else:
        _sign_key_cache.move_to_end(seed)
    x, prefix, pk = cached
    k = int.from_bytes(hashlib.sha512(prefix + message).digest(), "little") % _Q
    r_pt = base_mult_fast(k)
    r = ed.point_compress(r_pt)
    c = int.from_bytes(
        hashlib.sha512(r + pk + message).digest(), "little"
    ) % _Q
    s = (k + c * x) % _Q
    return r + s.to_bytes(32, "little")


def batch_schnorr_verify(items: Sequence[Tuple[bytes, bytes, bytes]]) -> bool:
    """Verify MANY (public, message, signature) triples in one shot via a
    random linear combination: Σγᵢ·sᵢ·B == Σγᵢ·Rᵢ + Σγᵢ·cᵢ·Yᵢ, one MSM
    total. With 128-bit random γ a single bad signature survives with
    probability 2⁻¹²⁸; on failure, fall back per-item to identify it.
    This is what makes verifier-quorum checks on whole BLOCKS (and on
    candidate chains during adoption) affordable — one group equation per
    block instead of one per signature."""
    import os as _os

    if not items:
        return True
    for pub, msg, sig in items:
        if len(sig) != 64:
            return False
    # every signature's R nonce is unique (uncacheable) — decompress them
    # all in one native call when the library is built
    native = _native_mod()
    r_pts: Optional[List[ed.Point]] = None
    if native is not None:
        r_pts = native.decompress_batch(
            b"".join(sig[:32] for _, _, sig in items), len(items))
        if r_pts is None:
            return False
    scalars: List[int] = []
    points: List[ed.Point] = []
    s_tot = 0
    for i, (pub, msg, sig) in enumerate(items):
        r_pt = r_pts[i] if r_pts is not None else ed.point_decompress(sig[:32])
        y_pt = _pub_point(pub)  # cofactor-cleared 8Y (see _clear8)
        if r_pt is None or y_pt is None:
            return False
        s = int.from_bytes(sig[32:], "little")
        if s >= _Q:
            return False
        c = int.from_bytes(
            hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % _Q
        g = int.from_bytes(_os.urandom(16), "little") | 1
        # cofactored form: Σγ·8s·B == Σγ·(8R) + Σγc·(8Y) — every point in
        # the MSM is torsion-cleared, matching schnorr_verify exactly
        s_tot += g * 8 * s
        scalars.append(g)
        points.append(_clear8(r_pt))
        scalars.append((g * c) % _Q)
        points.append(y_pt)
    dev = _device_mod()
    if dev is not None:
        # device verdict over the identical cofactored equation; every
        # point in the MSM is already torsion-cleared (8R / 8Y), so the
        # device and CPU backends compute the same group elements. A
        # False verdict still falls back per-item in the caller — the
        # rejection evidence path is untouched. A device fault raises.
        on = dev.armed_device()
        lhs = dev.fixed_base_mult([s_tot % _Q], device=on)[0]
        rhs = dev.msm(scalars, points, device=on)
        return ed.point_equal(lhs, rhs)
    lhs = base_mult_fast(s_tot % _Q)
    rhs = msm(scalars, points)
    return ed.point_equal(lhs, rhs)


# public-key decompression cache: node identities are long-lived and every
# block verification touches the same few committee keys
_pub_cache: dict = {}


def decompress_point(buf: bytes) -> Optional[ed.Point]:
    """RFC 8032 point decompression, native when built — the shared
    dispatch for every caller that decodes a single wire point (VRF
    proofs, public keys). Uncached; long-lived keys go via _pub_point."""
    native = _native_mod()
    if native is not None and len(buf) == 32:
        pts = native.decompress_batch(buf, 1)
        return pts[0] if pts else None
    return ed.point_decompress(buf)


def _clear8(p: ed.Point) -> ed.Point:
    """8·P via three doublings — kills any small-order (torsion) component,
    leaving the prime-order part. Schnorr verification here is COFACTORED
    over cleared points: decompression does no subgroup check, and on a
    torsioned point the exact values of c·Y vs (q−c)·(−Y) differ by a
    torsion element, so cofactorless verification would give different
    verdicts between the single/batch paths (and potentially backends).
    Clearing the points makes every path compute in the prime-order
    subgroup, where all of them agree bit-for-bit."""
    return ed.point_double(ed.point_double(ed.point_double(p)))


def _pub_point(pub: bytes) -> Optional[ed.Point]:
    """Cofactor-CLEARED public point (8·Y) for Schnorr verification —
    see _clear8. Cached: node identities are long-lived."""
    if pub not in _pub_cache:
        p = decompress_point(pub)
        _pub_cache[pub] = _clear8(p) if p is not None else None
    return _pub_cache[pub]


def schnorr_verify(public: bytes, message: bytes, signature: bytes) -> bool:
    """(ref: kyber.go:898-925)."""
    if len(signature) != 64:
        return False
    r_pt = decompress_point(signature[:32])
    y_pt = _pub_point(public)
    if r_pt is None or y_pt is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= _Q:
        return False
    c = int.from_bytes(
        hashlib.sha512(signature[:32] + public + message).digest(), "little"
    ) % _Q
    # cofactored: 8s·B − c·(8Y) == 8R over torsion-cleared points (y_pt
    # from _pub_point is already 8Y) — identical verdicts to the batch
    # path and across backends on ALL inputs, torsioned included
    lhs = msm([(8 * s) % _Q, _Q - c if c else 0], [ed.BASE, y_pt])
    return ed.point_equal(lhs, _clear8(r_pt))


# ------------------------------------------------------- Pedersen VSS


@dataclass
class ChunkVSS:
    """Verifiable sharing of ONE polynomial chunk: coefficient commitments
    plus the blinding polynomial the prover evaluates alongside the real one.
    Plays the role of the reference's per-chunk commitment + KZG witnesses
    (ref: kyber.go:579-673) without pairings."""

    commitments: List[bytes]  # Cⱼ = aⱼ·G + bⱼ·H, j = 0..k−1

    def verify_share(self, x: int, share: int, blind_share: int) -> bool:
        """Check share·G + blind·H == Σ xʲ·Cⱼ — accepts iff (share, blind)
        is a true evaluation of the committed polynomial pair at x."""
        lhs = ed.point_add(
            ed.base_mult(_scalar(share)),
            ed.scalar_mult(_scalar(blind_share), H_POINT),
        )
        rhs = ed.IDENTITY
        xj = 1
        for c_bytes in self.commitments:
            c_pt = ed.point_decompress(c_bytes)
            if c_pt is None:
                return False
            rhs = ed.point_add(rhs, ed.scalar_mult(_scalar(xj), c_pt))
            xj = (xj * x) % _Q
        return ed.point_equal(lhs, rhs)


def vss_commit_chunk(coeffs: Sequence[int], seed: bytes, chunk_index: int,
                     context: bytes = b"") -> Tuple[ChunkVSS, List[int]]:
    """Commit one chunk's coefficients; returns (commitments, blinding
    coefficients). Blinding coefficients are derived deterministically from
    the peer's secret seed AND `context` (pass the round's block hash or
    iteration stamp): reusing blinds across rounds would let an observer
    difference two rounds' commitments, cancel the H term, and brute-force
    the low-entropy quantized coefficient deltas."""
    blinds = [
        int.from_bytes(
            hashlib.sha512(
                seed + b"vss-blind" + context
                + chunk_index.to_bytes(4, "little")
                + j.to_bytes(4, "little")
            ).digest(),
            "little",
        ) % _Q
        for j in range(len(coeffs))
    ]
    comms = [
        ed.point_compress(
            ed.point_add(
                ed.base_mult(_scalar(int(a))),
                ed.scalar_mult(b, H_POINT),
            )
        )
        for a, b in zip(coeffs, blinds)
    ]
    return ChunkVSS(comms), blinds


def eval_poly(coeffs: Sequence[int], x: int) -> int:
    """Exact integer Horner evaluation (shares themselves stay plain ints so
    the int64 aggregation/recovery path is unchanged)."""
    acc = 0
    for a in reversed(list(coeffs)):
        acc = acc * x + int(a)
    return acc


# ------------------------------------------- whole-update VSS (wire format)
#
# The protocol-facing layer: one VSS instance per polynomial chunk of the
# quantized update, flattened to fixed-shape byte tensors so the runtime
# codec can ship them (messages.py allows uint8 arrays). Commitment points
# travel as AFFINE (x, y) pairs (64B), not compressed: loading one costs an
# on-curve check (~7 field mults) instead of a sqrt mod p (~255 squarings),
# and the verifier is the hot side. Subgroup membership is not checked —
# every verification scalar is multiplied by the cofactor 8, which kills
# any small-order component a malicious committer could smuggle in.
#
# A miner verifies ALL (worker, row, chunk) triples of its round intake in
# ONE batched check — a random linear combination collapsing to a single
# MSM (ref: the reference instead runs a bn256 pairing per share,
# kyber.go:650-673). On failure, per-worker fallback identifies the cheat.


# Pedersen blind width in bits. BINDING (what VSS soundness rests on) is
# independent of this; it sets the HIDING level of each coefficient
# commitment. 128-bit blinds give ≥2⁶⁴-operation generic hiding (interval
# kangaroo over [0, 2¹²⁸)) at HALF the comb windows and XOF bytes of full-
# width blinds — and remain categorically stronger than the reference,
# whose commitments carry no blinding at all (C = Σ qᵢ·PKᵢ,
# kyber.go:533-562). Set BISCOTTI_HIDING_BITS=252 for full-width
# (statistically perfect) hiding.
def _hiding_bits_from_env() -> int:
    import os

    raw = os.environ.get("BISCOTTI_HIDING_BITS", "128")
    try:
        v = int(raw)
    except ValueError:
        import sys

        print(f"[commitments] ignoring non-integer BISCOTTI_HIDING_BITS="
              f"{raw!r}; using 128", file=sys.stderr)
        v = 128
    return max(8, min(252, v))


HIDING_BITS = _hiding_bits_from_env()


def vss_blind_bytes(n: int, seed: bytes, context: bytes) -> bytes:
    """n blinding coefficients as packed 32-byte little-endian canonical
    Z_q values, from ONE SHAKE-256 XOF call. At HIDING_BITS=252 each
    value is uniform in [0, 2²⁵²) — statistical distance < 2⁻¹²⁸ from
    uniform mod q (q = 2²⁵² + δ, δ ≈ 2¹²⁴); narrower widths trade
    statistical hiding for computational hiding (see HIDING_BITS) and
    draw proportionally fewer XOF bytes. Zero python bigint traffic."""
    nbytes = (HIDING_BITS + 7) // 8
    raw = bytearray(32 * n)
    xof = hashlib.shake_256(seed + b"vss-blind-xof" + context).digest(
        nbytes * n)
    arr = np.frombuffer(raw, dtype=np.uint8).reshape(n, 32)
    arr[:, :nbytes] = np.frombuffer(xof, dtype=np.uint8).reshape(n, nbytes)
    # mask the top partial byte (252 → 0x0F etc.); value < 2^HIDING_BITS
    # ≤ 2²⁵² < q, so every emitted field is canonical
    arr[:, nbytes - 1] &= (0xFF >> (-HIDING_BITS % 8))
    return bytes(raw)


def vss_commit_chunks_bytes(chunks: np.ndarray, seed: bytes,
                            context: bytes) -> Tuple[np.ndarray, bytes]:
    """Commit every chunk's coefficients — the bytes-native worker path.

    chunks: [C, k] int64 (ss.to_chunks output). Returns (commitments uint8
    [C, k, 64] affine (x,y) LE pairs, blind coefficients as packed C·k
    32-byte LE values). The hot spot is 2·C·k fixed-base mults; the native
    comb path in `native/` takes it when built, fed by numpy-packed
    buffers (no per-value python ints anywhere on this path)."""
    c_chunks, k = chunks.shape
    n = c_chunks * k
    blind_bytes = vss_blind_bytes(n, seed, context)
    flat = np.ascontiguousarray(chunks, dtype=np.int64).reshape(n)
    native = _native_mod()
    if native is not None:
        mags = np.zeros((n, 32), dtype=np.uint8)
        mags[:, :8] = np.abs(flat).astype("<u8").view(np.uint8).reshape(n, 8)
        signs = (flat < 0).astype(np.uint8)
        raw = native.batch_commit_signed_raw(
            mags.tobytes(), signs.tobytes(), blind_bytes, n)
    else:
        flat_b = [int.from_bytes(blind_bytes[32 * i: 32 * (i + 1)], "little")
                  for i in range(n)]
        raw = batch_pedersen_commit_xy([int(v) for v in flat], flat_b)
    out = np.frombuffer(raw, dtype=np.uint8)
    return out.reshape(c_chunks, k, 64).copy(), blind_bytes


def _unpack_blinds(blind_bytes: bytes, c_chunks: int,
                   k: int) -> List[List[int]]:
    """Packed C·k 32-byte LE blinds → [C][k] python ints."""
    return [[int.from_bytes(blind_bytes[32 * (ci * k + j):
                                        32 * (ci * k + j + 1)], "little")
             for j in range(k)] for ci in range(c_chunks)]


def vss_commit_chunks(chunks: np.ndarray, seed: bytes,
                      context: bytes) -> Tuple[np.ndarray, List[List[int]]]:
    """Compatibility wrapper over vss_commit_chunks_bytes returning blind
    coefficients as [C][k] python ints."""
    c_chunks, k = chunks.shape
    comms, blind_bytes = vss_commit_chunks_bytes(chunks, seed, context)
    return comms, _unpack_blinds(blind_bytes, c_chunks, k)


def batch_pedersen_commit_xy(a: Sequence[int], b: Sequence[int]) -> bytes:
    """[aᵢ·G + bᵢ·H] as packed 64B affine pairs, native fast path when
    available."""
    native = _native_mod()
    if native is not None:
        return native.batch_commit_xy(a, b)
    out = bytearray()
    for ai, bi in zip(a, b):
        p = ed.point_add(ed.base_mult(_scalar(int(ai))),
                         ed.scalar_mult(_scalar(int(bi)), H_POINT))
        x, y = ed.to_affine(p)
        out += x.to_bytes(32, "little") + y.to_bytes(32, "little")
    return bytes(out)


def _rlc_coeffs(xs: Sequence[int], gam_bytes: bytes, c_chunks: int,
                k: int) -> List[int]:
    """The python RLC verification-coefficient chain shared by every
    batched-VSS settle path (one-shot fallback, accumulator python
    settle, accumulator device settle): coeff[ci·k + j] = Σ over cells
    (r, ci) of γ_cell·x_rʲ, accumulated over plain signed ints with one
    caller-side mod-q reduction (|x| ≤ S keeps γ·xʲ short). ONE copy —
    the device/CPU verdict-parity contract depends on these chains never
    drifting apart."""
    coeff = [0] * (c_chunks * k)
    cell = 0
    for r, x in enumerate(xs):
        xi = int(x)
        for ci in range(c_chunks):
            xj = int.from_bytes(gam_bytes[16 * cell: 16 * (cell + 1)],
                                "little")
            cell += 1
            base = ci * k
            for j in range(k):
                coeff[base + j] += xj
                xj *= xi
    return coeff


def _xy_to_point(buf: bytes) -> Optional[ed.Point]:
    """Parse + validate one 64B affine pair (python fallback for the native
    batch loader): canonical coords and on-curve, subgroup NOT checked."""
    x = int.from_bytes(buf[:32], "little")
    y = int.from_bytes(buf[32:64], "little")
    if x >= ed.P or y >= ed.P:
        return None
    if (y * y - x * x - 1 - ed.D * x * x * y * y) % ed.P != 0:
        return None
    return (x, y, 1, (x * y) % ed.P)


def vss_digest(comms: np.ndarray) -> bytes:
    """Binding digest over all chunk commitments — used as the update's
    `commitment` field in secure-agg mode, so the verifiers' Schnorr
    signatures cover exactly the object miners verify shares against."""
    return hashlib.sha256(b"vss" + np.ascontiguousarray(comms).tobytes()).digest()


def _blind_rows_python(blinds: List[List[int]],
                       xs: Sequence[int]) -> np.ndarray:
    """Pure-python Horner evaluation of the blind-row tensor (the shared
    fallback body of both vss_blind_rows entry points)."""
    s, c = len(xs), len(blinds)
    out = np.zeros((s, c, 32), dtype=np.uint8)
    for si, x in enumerate(xs):
        xi = int(x)
        for ci, coeffs in enumerate(blinds):
            acc = 0
            for bj in reversed(coeffs):
                acc = acc * xi + bj
            out[si, ci] = np.frombuffer((acc % _Q).to_bytes(32, "little"),
                                        np.uint8)
    return out


def vss_blind_rows_bytes(blind_bytes: bytes, c_chunks: int, k: int,
                         xs: Sequence[int]) -> np.ndarray:
    """vss_blind_rows over the packed 32-byte blind buffer from
    vss_commit_chunks_bytes — native end-to-end, no python ints."""
    native = _native_mod()
    if native is not None and c_chunks and k:
        raw = native.vss_blind_rows_raw(blind_bytes, [int(x) for x in xs],
                                        c_chunks, k)
        if raw is not None:
            return (np.frombuffer(raw, dtype=np.uint8)
                    .reshape(len(xs), c_chunks, 32).copy())
    # straight to python on native failure — re-dispatching through
    # vss_blind_rows would retry the identical native call
    return _blind_rows_python(_unpack_blinds(blind_bytes, c_chunks, k), xs)


def vss_blind_rows(blinds: List[List[int]], xs: Sequence[int]) -> np.ndarray:
    """Evaluate every chunk's blinding polynomial at every share point:
    uint8 [S, C, 32] (little-endian Z_q values), the companion tensor to the
    int64 share matrix.

    The native library evaluates the whole tensor in C (partially-reduced
    256-bit Horner, ~20× the python loop); the python fallback runs Horner
    over the SIGNED small x with one reduction at the end: the share
    points satisfy |x| ≤ S, so the unreduced accumulator stays under
    q·(k·S^k) ≈ 2³⁰⁰ — cheap python-int small-multiplies instead of k
    full-width modmuls per cell."""
    s, c = len(xs), len(blinds)
    k = len(blinds[0]) if blinds else 0
    native = _native_mod()
    if native is not None and c and k and all(len(r) == k for r in blinds):
        # canonicalize mod q before packing: the C kernel requires < q
        # inputs, while this public API (like its python fallback below)
        # accepts arbitrary ints
        buf = b"".join((int(bj) % _Q).to_bytes(32, "little")
                       for row in blinds for bj in row)
        raw = native.vss_blind_rows_raw(buf, [int(x) for x in xs], c, k)
        if raw is not None:
            return (np.frombuffer(raw, dtype=np.uint8)
                    .reshape(s, c, 32).copy())
    return _blind_rows_python(blinds, xs)


def vss_verify_multi(instances: Sequence[Tuple[np.ndarray, Sequence[int],
                                               np.ndarray, np.ndarray]],
                     entropy: Optional[bytes] = None) -> bool:
    """Batched share verification over MANY updates at once, AGGREGATED.

    instances: [(comms [C,k,64], xs, share_rows [S,C], blind_rows
    [S,C,32]), ...]. Instances that share the same evaluation points and
    chunk grid — a miner's whole round intake, since every worker shards
    over the same miner set — are verified as ONE aggregate: Pedersen
    commitments are additively homomorphic, so the per-cell equations
        s^w·G + t^w·H == Σⱼ x_r^j·C^w_cj        (one per worker w)
    sum to
        (Σ_w s^w)·G + (Σ_w t^w)·H == Σⱼ x_r^j·(Σ_w C^w_cj),
    and the verify MSM runs over C·k summed points instead of W·C·k —
    (W−1)·C·k plain point additions replace (W−1)·C·k Pippenger points
    (~8× wall-clock at cifar dims; the reference instead pays a bn256
    pairing per share, kyber.go:650-673).

    Soundness (full argument in docs/NATIVE_CRYPTO.md §aggregated-vss):
    one random odd 128-bit γ per (row, chunk) cell, SHARED by all workers
    in the group, with the cofactor 8 folded into every scalar. Any share
    inconsistent with its own commitments makes the aggregate equation
    fail with probability 1−2⁻¹²⁸ — detection of a lone cheater is NOT
    weakened — unless a coalition corrupts the SAME cell with errors that
    cancel in the group sum. That residual acceptance is harmless ONLY
    for an aggregate covering the whole group (the recovered sum still
    equals the sum of the committed values); an aggregate over a PARTIAL
    group would break the cancellation, so the runtime re-runs this check
    over exactly the aggregation set whenever it does not cover whole
    verified batches (peer.partial_batch_members /
    PeerAgent._ensure_subset_consistent). Callers outside the peer
    runtime must maintain the same invariant: True from this function
    certifies Σ-consistency of THESE instances as one group, not of
    arbitrary sub-multisets. Per-worker identification — call with a
    single instance, which is exact — runs only on failure, costing O(W)
    single checks in the Byzantine case the cheater is evicted and
    debited for."""
    import os as _os

    total_cells = 0
    for comms, xs, rows, blind_rows in instances:
        if comms.ndim != 3 or comms.shape[2] != 64:
            return False
        c_chunks = comms.shape[0]
        if (np.asarray(rows).shape != (len(xs), c_chunks)
                or blind_rows.shape != (len(xs), c_chunks, 32)):
            return False
        total_cells += len(xs) * c_chunks
    if total_cells == 0:
        return True
    # caller-provided entropy keeps the documented per-instance windows
    # (tests drive determinism through it); the default draws one window
    # per GROUP instead — groups only ever consume their first member's
    # window, so the per-instance allocation was W× oversized (46 MB of
    # urandom per mnist_cnn intake, all but 1.3 MB discarded)
    entropy_provided = entropy is not None
    if entropy_provided and len(entropy) < 16 * total_cells:
        return False

    native = _native_mod()

    # Group by (evaluation points, chunk grid); every group member shares
    # one γ vector and one RLC scalar set, and contributes its points to a
    # single summed batch. Entropy windows stay per-instance (16·S·C bytes
    # each, same contract as the ungrouped design); a group consumes its
    # FIRST member's window.
    groups: dict = {}
    off = 0
    for inst in instances:
        comms, xs, _, _ = inst
        key = (tuple(int(x) for x in xs), comms.shape[0], comms.shape[1])
        groups.setdefault(key, []).append((inst, off))
        off += len(xs) * comms.shape[0]

    s_tot = 0
    t_tot = 0
    all_scalars: List[int] = []  # python fallback path
    native_bufs: List[Tuple[bytes, bytes]] = []  # (magnitudes, signs)
    all_pts: List[ed.Point] = []
    sum_bufs: List[bytes] = []  # native: per-group summed point batches
    for (xs_key, c_chunks, k), members in groups.items():
        xs = list(xs_key)
        cells = len(xs) * c_chunks
        # gamma_i = entropy 16-byte window with the low bit forced — as an
        # int for the python s/t accumulation, and verbatim as the packed
        # (lo u64, hi u64) little-endian pair the native RLC consumes
        if entropy_provided:
            g0 = members[0][1]
            gam_bytes = bytearray(entropy[16 * g0: 16 * (g0 + cells)])
        else:
            gam_bytes = bytearray(_os.urandom(16 * cells))
        for i in range(0, len(gam_bytes), 16):
            gam_bytes[i] |= 1
        gam_bytes = bytes(gam_bytes)

        loaded: List = []
        for (comms, _xs, rows, blind_rows), _o in members:
            if native is not None:
                # fused native path, ZERO-COPY: commitment grids, share
                # rows and blind rows pass as numpy storage pointers (at
                # CNN dims the former tobytes()/join staging copied
                # ~0.7 GB per intake). lhs accumulators run per member
                # with the SHARED γ (linearity makes Σ_w γ·s^w ≡
                # γ·Σ_w s^w); zero python bignum traffic either
                loaded.append(np.ascontiguousarray(comms))
                st_acc = native.vss_st_accum(
                    gam_bytes,
                    np.ascontiguousarray(rows, dtype=np.int64),
                    np.ascontiguousarray(blind_rows),
                    len(xs), c_chunks)
                if st_acc is None:
                    return False  # non-canonical blind value
                s_tot += st_acc[0]
                t_tot += st_acc[1]
            else:
                comm_bytes = np.ascontiguousarray(comms).tobytes()
                rows = np.asarray(rows)
                blind_bytes = np.ascontiguousarray(blind_rows).tobytes()
                pts: List[ed.Point] = []
                for i in range(c_chunks * k):
                    p = _xy_to_point(comm_bytes[64 * i: 64 * i + 64])
                    if p is None:
                        return False
                    pts.append(p)
                loaded.append(pts)
                cell = 0
                for r, x in enumerate(xs):
                    for ci in range(c_chunks):
                        g = int.from_bytes(
                            gam_bytes[16 * cell: 16 * (cell + 1)], "little")
                        cell += 1
                        s_tot += g * int(rows[r, ci])
                        boff = 32 * (r * c_chunks + ci)
                        t_val = int.from_bytes(blind_bytes[boff: boff + 32],
                                               "little")
                        if t_val >= _Q:
                            return False
                        t_tot += g * t_val

        # RLC accumulation over plain (signed) integers with one mod-q
        # reduction per accumulator at the end: x is small (|x| ≤ S), so
        # γ·xʲ stays ≲ 2¹⁷² and full-width modmuls are avoided entirely.
        # The cofactor 8 is folded in at reduction time. ONE scalar set
        # per group — the per-cell k-power chain runs once, not per worker.
        if native is not None:
            sb, sgn = native.vss_rlc_scalars(xs, gam_bytes, c_chunks, k)
            native_bufs.append((sb, sgn))
            # ONE fused validate+sum pass over the whole group's affine
            # commitments, handed over as per-member buffer pointers —
            # no intermediate 128B extended batches, no concatenation
            buf = native.load_xy_sum_ptrs(loaded, c_chunks * k)
            if buf is None:
                return False
            sum_bufs.append(buf)
        else:
            coeff = _rlc_coeffs(xs, gam_bytes, c_chunks, k)
            all_scalars.extend((8 * v) % _Q for v in coeff)
            summed = loaded[0]
            for pts in loaded[1:]:
                summed = [ed.point_add(a, b)
                          for a, b in zip(summed, pts)]
            all_pts.extend(summed)

    if native is not None:
        # s·G + t·H in one native fixed-base comb evaluation
        lhs: ed.Point = native.point_from_xy64(
            native.batch_commit_xy([(8 * s_tot) % _Q], [(8 * t_tot) % _Q]))
        sbuf = b"".join(sb for sb, _ in native_bufs)
        signs = b"".join(sgn for _, sgn in native_bufs)
        rhs = native.msm_signed_raw(sbuf, signs, b"".join(sum_bufs),
                                    len(signs))
    else:
        lhs = ed.point_add(ed.base_mult((8 * s_tot) % _Q),
                           ed.scalar_mult((8 * t_tot) % _Q, H_POINT))
        rhs = msm(all_scalars, all_pts)
    return ed.point_equal(lhs, rhs)


# ------------------------------------------------- proactive resharing
#
# Commitment algebra for the distributed resharing round
# (ops/secretshare.reshare_*, docs/MEMBERSHIP.md). Pedersen commitments
# are additively homomorphic in BOTH directions this plane needs:
#
#   * across workers — the commitment grid of an AGGREGATED row slice is
#     the cell-wise point sum of the contributors' grids
#     (sum_commitment_grids), with the aggregated blind the scalar sum
#     of their blind rows (sum_blind_rows);
#   * across coefficients — the commitment to a polynomial's value at x
#     is Σⱼ xʲ·Cⱼ (commitment_eval_xy), with no new commitment needed.
#
# A holder re-dealing its row therefore commits its sub-share polynomial
# with the CONSTANT blinding coefficient pinned to its own blind value
# (reshare_commit_row), and every recipient checks, exactly:
#
#   sub_comms[c][0]  ==  Σⱼ x_oldʲ · orig_comms[c][j]
#
# — the sub-deal's claimed constant IS the original committed row value,
# updated homomorphically, so verification across a resharing epoch
# stays as exact as intake verification was (reshare_verify_deal).


def sum_commitment_grids(grids: Sequence[np.ndarray]) -> Optional[np.ndarray]:
    """Cell-wise point sum of [C, k, 64] affine commitment grids — the
    commitment grid of the SUM of the committed polynomials. Returns
    None if any cell fails to load (off-curve / non-canonical)."""
    if not grids:
        return None
    c_chunks, k = grids[0].shape[0], grids[0].shape[1]
    out = np.zeros((c_chunks, k, 64), np.uint8)
    for ci in range(c_chunks):
        for j in range(k):
            acc = ed.IDENTITY
            for g in grids:
                p = _xy_to_point(bytes(np.ascontiguousarray(g[ci, j])))
                if p is None:
                    return None
                acc = ed.point_add(acc, p)
            x, y = ed.to_affine(acc)
            out[ci, j, :32] = np.frombuffer(x.to_bytes(32, "little"),
                                            np.uint8)
            out[ci, j, 32:] = np.frombuffer(y.to_bytes(32, "little"),
                                            np.uint8)
    return out


def sum_blind_rows(blind_rows: Sequence[np.ndarray]) -> List[List[int]]:
    """Scalar sum (mod q) of [S, C, 32] blind-row tensors → [S][C] python
    ints: the blinding values of an aggregated share slice, the companion
    of sum_commitment_grids on the opening side."""
    s, c = blind_rows[0].shape[0], blind_rows[0].shape[1]
    out = [[0] * c for _ in range(s)]
    for arr in blind_rows:
        buf = np.ascontiguousarray(arr, np.uint8).tobytes()
        for si in range(s):
            for ci in range(c):
                off = 32 * (si * c + ci)
                out[si][ci] = (out[si][ci] + int.from_bytes(
                    buf[off: off + 32], "little")) % _Q
    return out


def sum_blind_row_tensors(blind_rows: Sequence[np.ndarray]) -> np.ndarray:
    """sum_blind_rows, repacked to the wire-tensor form: scalar sum
    (mod q) of [S, C, 32] blind-row tensors returned as the same uint8
    [S, C, 32] layout — the blinding tensor of an aggregated share
    slice, ready to travel in an overlay aggregate frame or feed
    vss_verify_multi directly."""
    sums = sum_blind_rows(blind_rows)
    s = len(sums)
    c = len(sums[0]) if sums else 0
    out = np.zeros((s, c, 32), np.uint8)
    for si in range(s):
        for ci in range(c):
            out[si, ci] = np.frombuffer(
                int(sums[si][ci]).to_bytes(32, "little"), np.uint8)
    return out


def commitment_eval_xy(comms: np.ndarray, x: int) -> Optional[List[ed.Point]]:
    """Homomorphic evaluation of every chunk's committed polynomial at
    share point `x`: [C, k, 64] grid → one point per chunk,
    Σⱼ xʲ·C_cj = commit(f_c(x), b_c(x)). Returns None when a cell fails
    to load."""
    c_chunks, k = comms.shape[0], comms.shape[1]
    buf = np.ascontiguousarray(comms).tobytes()
    scalars = []
    xj = 1
    for _ in range(k):
        scalars.append(xj % _Q)
        xj *= int(x)
    out: List[ed.Point] = []
    for ci in range(c_chunks):
        pts = []
        for j in range(k):
            off = 64 * (ci * k + j)
            p = _xy_to_point(buf[off: off + 64])
            if p is None:
                return None
            pts.append(p)
        out.append(msm(scalars, pts))
    return out


def reshare_commit_row(coeffs_row: np.ndarray, blind0: Sequence[int],
                       seed: bytes,
                       context: bytes) -> Tuple[np.ndarray, List[List[int]]]:
    """Commit one re-dealt row's sub-share polynomials: [C, k] int64
    coefficients (column 0 = the held row values,
    ops/secretshare.reshare_coeffs) with the CONSTANT blinding
    coefficient pinned to the holder's own blind values `blind0` ([C]
    ints) — that pin is what makes the sub-deal homomorphically
    verifiable against the original commitments. Higher blinding
    coefficients come fresh from the XOF exactly like an intake commit.
    Returns (comms uint8 [C, k, 64], blinds [C][k] ints)."""
    coeffs_row = np.asarray(coeffs_row, np.int64)
    c_chunks, k = coeffs_row.shape
    raw = vss_blind_bytes(c_chunks * k, seed, context + b"|reshare")
    blinds = _unpack_blinds(raw, c_chunks, k)
    for ci in range(c_chunks):
        blinds[ci][0] = int(blind0[ci]) % _Q
    flat_a = [int(v) % _Q for v in coeffs_row.reshape(-1)]
    flat_b = [blinds[ci][j] for ci in range(c_chunks) for j in range(k)]
    rawc = batch_pedersen_commit_xy(flat_a, flat_b)
    comms = np.frombuffer(rawc, dtype=np.uint8).reshape(
        c_chunks, k, 64).copy()
    return comms, blinds


def reshare_verify_deal(orig_comms: np.ndarray, x_old: int,
                        sub_comms: np.ndarray, xs_new: Sequence[int],
                        sub_rows: np.ndarray,
                        sub_blind_rows: np.ndarray) -> bool:
    """Verify one holder's re-deal of the row it held at `x_old`:

    1. BINDING — the sub-deal's constant commitments equal the
       homomorphic evaluation of the ORIGINAL grid at x_old (per chunk):
       the re-dealt secret is provably the row the holder was given, not
       a substitute.
    2. CONSISTENCY — every (sub-share, sub-blind) evaluation verifies
       against the sub-deal grid (the standard batched VSS check).

    `orig_comms` is the [C, k, 64] grid of the shared polynomial — for an
    aggregated slice, sum_commitment_grids of the contributors' grids."""
    ev = commitment_eval_xy(orig_comms, x_old)
    if ev is None or sub_comms.shape != orig_comms.shape:
        return False
    buf = np.ascontiguousarray(sub_comms).tobytes()
    k = sub_comms.shape[1]
    for ci, expect in enumerate(ev):
        p = _xy_to_point(buf[64 * ci * k: 64 * ci * k + 64])
        if p is None or not ed.point_equal(p, expect):
            return False
    return vss_verify_multi([(sub_comms, list(xs_new),
                              np.asarray(sub_rows, np.int64),
                              np.asarray(sub_blind_rows, np.uint8))])


class VssIntakeBatch:
    """Incremental round-intake VSS verification — the pipelined miner's
    half of `vss_verify_multi`.

    The one-shot batched check pays its dominant cost (validate + sum W
    commitment grids, O(W·C·k) point work) in one lump at mint time.
    This object spreads that lump over the round: arriving workers'
    grids are folded into a running point accumulator in WAVES as they
    arrive (`add` books the cheap scalar accumulation, `fold` sums the
    pending wave through the vectorized load_xy_sum path and folds the
    wave sum in with one extended-add pass — amortized against the
    network wait for the other contributors), and `verify` at
    mint/serve time settles the WHOLE accumulated set with just the RLC
    scalar chain + ONE C·k-point MSM + the lhs comb — the only crypto
    left on the mint critical path (measured 3.4× below the one-shot
    check at mnist_cnn dims, W=35).

    Soundness is identical to `vss_verify_multi`'s aggregated group
    check: one random odd 128-bit γ per (row, chunk) cell, drawn ONCE at
    construction, shared by every member (Pedersen homomorphism — the
    per-cell equations sum), cofactor 8 folded into the verification
    scalars. γ never leaves the process and every grid a prover could
    choose is fixed before it learns anything about the check, so the
    early draw gives provers no adaptivity. Same residual as the group
    check: a coalition corrupting the SAME cell with cancelling errors
    passes (harmless for whole-group aggregates; partial sets are
    re-proved at the aggregation boundary exactly as before — members()
    hands back the retained instances for those re-checks and for the
    per-worker fallback identification when verify() fails).
    """

    def __init__(self, num_rows: int, c_chunks: int, k: int,
                 entropy: Optional[bytes] = None):
        import os as _os

        self.rows = int(num_rows)
        self.c = int(c_chunks)
        self.k = int(k)
        cells = self.rows * self.c
        raw = bytearray(entropy[: 16 * cells] if entropy is not None
                        else _os.urandom(16 * cells))
        if len(raw) != 16 * cells:
            raise ValueError("entropy shorter than one gamma window")
        arr = np.frombuffer(raw, dtype=np.uint8)
        arr[::16] |= 1  # odd gammas, vectorized (the cell count is S·C)
        self._gam = bytes(raw)
        self._s_tot = 0
        self._t_tot = 0
        self._members: Dict[int, tuple] = {}  # sid -> retained instance
        self._member_st: Dict[int, Tuple[int, int]] = {}  # for un-booking
        self._pending: List[int] = []  # sids booked but not yet folded
        self._acc: Optional[bytearray] = None  # native 128B/pt extended
        self._acc_py: Optional[List[ed.Point]] = None  # python fallback
        # device limb accumulator ([n, 4, 16] int64) — the --device-crypto
        # wave-fold path. The arming switch is sampled per fold, so one
        # accumulator object must live entirely on one side; the runtime
        # arms the plane at construction and never flips it mid-round.
        # A device FAULT raises out of fold/verify (the reference instead
        # rebuilds the CPU accumulator and finishes there).
        self._acc_dev = None

    def __len__(self) -> int:
        return len(self._members)

    def members(self) -> Dict[int, tuple]:
        """sid → (comms, rows, blind_rows) retained references — for the
        aggregation-boundary re-checks and the per-worker fallback."""
        return dict(self._members)

    def add(self, sid: int, comms: np.ndarray, share_rows: np.ndarray,
            blind_rows: np.ndarray) -> bool:
        """Book one worker's grid into the pending wave: shape checks +
        the cheap scalar (Σγ·s, Σγ·t) accumulation. False rejects THIS
        worker only (bad shapes, non-canonical blinds) with the
        accumulator untouched. The point work happens in fold()."""
        comms = np.asarray(comms)
        share_rows = np.asarray(share_rows, dtype=np.int64)
        blind_rows = np.asarray(blind_rows)
        if (sid in self._members
                or comms.shape != (self.c, self.k, 64)
                or share_rows.shape != (self.rows, self.c)
                or blind_rows.shape != (self.rows, self.c, 32)):
            return False
        comms = np.ascontiguousarray(comms)
        share_rows = np.ascontiguousarray(share_rows)
        blind_rows = np.ascontiguousarray(blind_rows)
        native = _native_mod()
        if native is not None:
            st = native.vss_st_accum(self._gam, share_rows, blind_rows,
                                     self.rows, self.c)
            if st is None:
                return False
            s_add, t_add = st
        else:
            blind_bytes = blind_rows.tobytes()
            s_add = t_add = 0
            cell = 0
            for r in range(self.rows):
                for ci in range(self.c):
                    g = int.from_bytes(self._gam[16 * cell: 16 * (cell + 1)],
                                       "little")
                    cell += 1
                    s_add += g * int(share_rows[r, ci])
                    boff = 32 * (r * self.c + ci)
                    t_val = int.from_bytes(blind_bytes[boff: boff + 32],
                                           "little")
                    if t_val >= _Q:
                        return False
                    t_add += g * t_val
        self._s_tot += s_add
        self._t_tot += t_add
        self._member_st[sid] = (s_add, t_add)
        self._members[sid] = (comms, share_rows, blind_rows)
        self._pending.append(sid)
        return True

    def _evict(self, sid: int) -> None:
        s_add, t_add = self._member_st.pop(sid)
        self._s_tot -= s_add
        self._t_tot -= t_add
        self._members.pop(sid, None)

    def fold(self) -> List[int]:
        """Fold the pending wave of grids into the point accumulator:
        one vectorized validate+sum over the wave (load_xy_sum_ptrs,
        the batch-innermost kernel) plus one extended-add pass into the
        running sum. Returns the sids whose grids failed point
        validation (non-canonical / off-curve) — they are evicted here,
        at intake time, instead of poisoning the round batch at mint."""
        if not self._pending:
            return []
        wave, self._pending = self._pending, []
        rejected: List[int] = []
        native = _native_mod()
        n = self.c * self.k
        dev = _device_mod()
        if dev is not None:
            # device wave fold: one all-or-nothing canonicity + on-curve
            # validation over the whole wave (grid_validate_sum, the
            # ed25519_xy_accum equivalent; kernel B2 with
            # BISCOTTI_PALLAS_CRYPTO=1) with a per-grid verdict mask —
            # the same cells the CPU loaders reject, so the evicted sid
            # set is identical — then one pointwise tree sum folded into
            # the limb accumulator. A device FAULT raises.
            on = dev.armed_device()
            grids = [self._members[sid][0] for sid in wave]
            mask, summed = dev.grid_validate_sum(grids, device=on)
            for sid, ok in zip(wave, mask):
                if not ok:
                    self._evict(sid)
                    rejected.append(sid)
            if summed is not None:
                self._acc_dev = (summed if self._acc_dev is None
                                 else dev.ext_add(self._acc_dev, summed,
                                                  device=on))
            return rejected
        if native is not None:
            grids = [self._members[sid][0] for sid in wave]
            if len(wave) == 1 and self._acc is not None:
                # single-grid wave: validate+fold in one in-place pass
                if native.xy_accum(self._acc, grids[0], n) is not None:
                    self._evict(wave[0])
                    return wave
                return []
            summed = native.load_xy_sum_ptrs(grids, n)
            if summed is None:
                # some grid is bad: identify per grid, re-sum the clean
                good = []
                for sid, g in zip(wave, grids):
                    if native.load_xy_batch(g.tobytes(), n) is None:
                        self._evict(sid)
                        rejected.append(sid)
                    else:
                        good.append(g)
                if not good:
                    return rejected
                summed = native.load_xy_sum_ptrs(good, n)
                if summed is None:  # unreachable: every grid validated
                    for sid in wave:
                        if sid not in rejected:
                            self._evict(sid)
                            rejected.append(sid)
                    return rejected
            if self._acc is None:
                self._acc = bytearray(summed)
            else:
                native.ext_accum(self._acc, summed, n)
            return rejected
        for sid in wave:
            comm_bytes = self._members[sid][0].tobytes()
            pts: List[ed.Point] = []
            for i in range(n):
                p = _xy_to_point(comm_bytes[64 * i: 64 * i + 64])
                if p is None:
                    pts = []
                    break
                pts.append(p)
            if not pts:
                self._evict(sid)
                rejected.append(sid)
                continue
            if self._acc_py is None:
                self._acc_py = pts
            else:
                self._acc_py = [ed.point_add(a, b)
                                for a, b in zip(self._acc_py, pts)]
        return rejected

    def verify(self, xs: Sequence[int]) -> bool:
        """Settle the accumulated set against the share points `xs` (the
        miner's row slice, len == num_rows): rlc scalars + one MSM + the
        lhs comb. Folds any still-pending wave first (its rejects count
        as not-members, surfaced by a later members() diff). True
        certifies Σ-consistency of the WHOLE member set as one group
        (the `vss_verify_multi` group contract); on False the caller
        identifies offenders per member. Empty set is True."""
        self.fold()
        if not self._members:
            return True
        if len(xs) != self.rows:
            return False
        native = _native_mod()
        dev = _device_mod()
        if dev is not None and self._acc_dev is not None:
            # device settle: the RLC scalar chain stays host-side (the
            # shared _rlc_coeffs helper), the C·k-point MSM and the
            # s·G + t·H comb run on the armed device over the wave-folded
            # limb accumulator. Identical group equation ⇒ identical
            # verdict; a False here still falls back to the exact
            # per-member CPU checks in the caller. A device FAULT raises.
            on = dev.armed_device()
            coeff = _rlc_coeffs(xs, self._gam, self.c, self.k)
            rhs = dev.msm([(8 * v) % _Q for v in coeff], self._acc_dev,
                          device=on)
            lhs = dev.pedersen_commit_point((8 * self._s_tot) % _Q,
                                            (8 * self._t_tot) % _Q,
                                            device=on)
            return ed.point_equal(lhs, rhs)
        if native is not None and self._acc is not None:
            sb, sgn = native.vss_rlc_scalars(
                [int(x) for x in xs], self._gam, self.c, self.k)
            rhs = native.msm_signed_raw(sb, sgn, self._acc, len(sgn))
            lhs: ed.Point = native.point_from_xy64(native.batch_commit_xy(
                [(8 * self._s_tot) % _Q], [(8 * self._t_tot) % _Q]))
        else:
            coeff = _rlc_coeffs(xs, self._gam, self.c, self.k)
            assert self._acc_py is not None
            rhs = msm([(8 * v) % _Q for v in coeff], self._acc_py)
            lhs = ed.point_add(ed.base_mult((8 * self._s_tot) % _Q),
                               ed.scalar_mult((8 * self._t_tot) % _Q,
                                              H_POINT))
        return ed.point_equal(lhs, rhs)


