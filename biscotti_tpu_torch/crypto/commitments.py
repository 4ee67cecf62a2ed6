"""The part of `biscotti_tpu/crypto/commitments.py` the device plane needs.

Four pieces, each a copy of the reference's:

  * `_hash_to_point` and `H_POINT`, the Pedersen blinding generator. The
    reference injects its native decompression only after import, and its
    import-time derivation of `H_POINT` takes the pure path, as this copy
    always does (the semantics are identical);
  * `_msm_python`, the python-int MSM oracle that the device `msm` must
    match, with its mod-q, top-half (q − s)·(−P) normalization;
  * `_xy_to_point`, the CPU loader of one 64-byte affine cell, whose
    verdict the device grid validation must reproduce.

The rest of the module (commit keys, VSS, Schnorr, `VssIntakeBatch` and the
native ctypes plane) is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from biscotti_tpu_torch.crypto import ed25519 as ed

_Q = ed.Q


def _hash_to_point(label: bytes) -> ed.Point:
    """Nothing-up-my-sleeve generator derivation via the shared
    try-and-increment hash-to-curve in ed25519.py (pure decompression)."""
    return ed.hash_to_point(b"biscotti-gen" + label)


# Secondary generator for Pedersen blinding; independent of B by construction.
H_POINT = _hash_to_point(b"pedersen-H")


def _scalar(v: int) -> int:
    return v % _Q


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


def _xy_to_point(buf: bytes) -> Optional[ed.Point]:
    """Parse + validate one 64B affine pair: canonical coords and on-curve,
    subgroup NOT checked."""
    x = int.from_bytes(buf[:32], "little")
    y = int.from_bytes(buf[32:64], "little")
    if x >= ed.P or y >= ed.P:
        return None
    if (y * y - x * x - 1 - ed.D * x * x * y * y) % ed.P != 0:
        return None
    return (x, y, 1, (x * y) % ed.P)
