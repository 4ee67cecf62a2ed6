"""Pure-Python Edwards25519 group arithmetic (RFC 8032 curve).

The port's own copy of `biscotti_tpu/crypto/ed25519.py`, unchanged: the
python-int oracle that the port's limb plane (`crypto/kernels/`) is held
against.

Control-plane only: the VRF role lottery runs a handful of group operations
per round per peer, far off the hot path (the reference likewise runs its
ed25519 VRF on the host CPU; ref: DistSys/vrf.go:5, vendored coniks-go at
vrf-reference/crypto/vrf/). Extended homogeneous coordinates keep scalar
multiplication inversion-free; a single field inversion happens at encode.

No external dependencies — `hashlib` only.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

P = 2**255 - 19
Q = 2**252 + 27742317777372353535851937790883648493  # group order ℓ
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
COFACTOR = 8

# Base point: y = 4/5, x the even root.
B_Y = (4 * pow(5, P - 2, P)) % P
B_X = 15112221349535400772501151409588531511454012693041857206046113283949847762202

# Extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z.
Point = Tuple[int, int, int, int]

IDENTITY: Point = (0, 1, 1, 0)
BASE: Point = (B_X, B_Y, 1, (B_X * B_Y) % P)


def point_add(p: Point, q: Point) -> Point:
    """Complete addition for a = −1 twisted Edwards (RFC 8032 §5.1.4)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = ((y1 - x1) * (y2 - x2)) % P
    b = ((y1 + x1) * (y2 + x2)) % P
    c = (2 * t1 * D % P) * t2 % P
    dd = (2 * z1 * z2) % P
    e = (b - a) % P
    f = (dd - c) % P
    g = (dd + c) % P
    h = (b + a) % P
    return ((e * f) % P, (g * h) % P, (f * g) % P, (e * h) % P)


def point_double(p: Point) -> Point:
    x1, y1, z1, _ = p
    a = (x1 * x1) % P
    b = (y1 * y1) % P
    c = (2 * z1 * z1) % P
    h = (a + b) % P
    e = (h - (x1 + y1) * (x1 + y1)) % P
    g = (a - b) % P
    f = (c + g) % P
    return ((e * f) % P, (g * h) % P, (f * g) % P, (e * h) % P)


def point_neg(p: Point) -> Point:
    x, y, z, t = p
    return ((-x) % P, y, z, (-t) % P)


def scalar_mult(k: int, p: Point) -> Point:
    """Double-and-add; not constant-time (lottery inputs are public)."""
    acc = IDENTITY
    addend = p
    while k > 0:
        if k & 1:
            acc = point_add(acc, addend)
        addend = point_double(addend)
        k >>= 1
    return acc


def base_mult(k: int) -> Point:
    return scalar_mult(k % Q, BASE)


def point_equal(p: Point, q: Point) -> bool:
    # X1/Z1 == X2/Z2  <=>  X1·Z2 == X2·Z1 (same for Y)
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def is_identity(p: Point) -> bool:
    return point_equal(p, IDENTITY)


def to_affine(p: Point) -> tuple:
    """(x, y) affine coordinates."""
    x, y, z, _ = p
    zinv = pow(z, P - 2, P)
    return (x * zinv) % P, (y * zinv) % P


def point_compress(p: Point) -> bytes:
    xa, ya = to_affine(p)
    return ((ya | ((xa & 1) << 255)).to_bytes(32, "little"))


def point_decompress(s: bytes) -> Optional[Point]:
    if len(s) != 32:
        return None
    val = int.from_bytes(s, "little")
    sign = val >> 255
    y = val & ((1 << 255) - 1)
    if y >= P:
        return None
    # x² = (y² − 1) / (d·y² + 1)
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    # candidate root: (u/v)^((p+3)/8) = u·v³·(u·v⁷)^((p−5)/8)
    x = (u * pow(v, 3, P) % P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    if (v * x * x) % P == u:
        pass
    elif (v * x * x) % P == (-u) % P:
        x = (x * SQRT_M1) % P
    else:
        return None
    if x == 0 and sign == 1:
        return None
    if (x & 1) != sign:
        x = P - x
    return (x, y, 1, (x * y) % P)


def clamp_scalar(h32: bytes) -> int:
    a = bytearray(h32[:32])
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(bytes(a), "little")


def secret_expand(seed: bytes) -> Tuple[int, bytes]:
    """RFC 8032 key expansion: seed → (clamped scalar, 32-byte prefix)."""
    h = hashlib.sha512(seed).digest()
    return clamp_scalar(h[:32]), h[32:]


def public_key(seed: bytes) -> bytes:
    x, _ = secret_expand(seed)
    return point_compress(base_mult(x))


def hash_to_point(prefix: bytes, suffix: bytes = b"",
                  decompress=None) -> Point:
    """Try-and-increment hash-to-curve, cofactor-cleared (the RFC 9381
    §5.4.1.1 TAI construction). Candidate = first 32 bytes of
    SHA-512(prefix ‖ ctr ‖ suffix) for ctr = 0..255. Shared by the VRF's
    encode-to-curve and the commitment-scheme generator derivation —
    security-critical, keep the single copy. `decompress` lets callers
    inject an accelerated (but semantically identical) decompression —
    this module itself stays dependency-free pure python."""
    decompress = decompress or point_decompress
    for ctr in range(256):
        h = hashlib.sha512(prefix + bytes([ctr]) + suffix).digest()[:32]
        pt = decompress(h)
        if pt is None:
            continue
        pt8 = scalar_mult(COFACTOR, pt)
        if not is_identity(pt8):
            return pt8
    raise ValueError("hash_to_point failed for all 256 counters")
