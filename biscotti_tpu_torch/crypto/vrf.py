"""ECVRF over Edwards25519 — verifiable random function for role lotteries.

The port's copy of `biscotti_tpu/crypto/vrf.py`, on the port's
`commitments` dispatchers (native where built): proofs and outputs are
byte-equal to the reference's.

Replaces the reference's vendored coniks-go ed25519 VRF
(ref: DistSys/vrf.go:5-52, vrf-reference/crypto/vrf/vrf.go). Construction
follows the RFC 9381 ECVRF-EDWARDS25519-SHA512-TAI shape (hash-to-curve by
try-and-increment, Chaum-Pedersen style DLEQ proof): prove/verify are
self-consistent and the output is uniformly pseudorandom and *unique* per
(key, input) — the properties the lottery needs. Wire formats are ours, not
coniks'; nothing interoperates with the reference network protocol anyway.

API mirrors the reference surface:
  VRFKey.prove(alpha)  -> (beta, pi)   (vrf.go: Prove -> output, proof)
  verify(pk, alpha, pi) -> beta | None (vrf.go: Verify)
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

from biscotti_tpu_torch.crypto import ed25519 as ed

SUITE = b"\x03"  # edwards25519-SHA512-TAI domain separator
CHALLENGE_LEN = 16
PROOF_LEN = 32 + CHALLENGE_LEN + 32


# role lotteries run one prove plus committee-many verifies per peer per
# round; the shared dispatchers in commitments.py route these through the
# native library when built (the pure-python double-and-add was a measured
# hot spot of whole-cluster runs) and guarantee the two backends compute
# identical group elements on ALL inputs, torsioned included
from biscotti_tpu_torch.crypto.commitments import (  # noqa: E402
    decompress_point as _decompress)
from biscotti_tpu_torch.crypto.commitments import (  # noqa: E402
    msm as _msm_dispatch)


def _msm(scalars, points) -> ed.Point:
    return _msm_dispatch(list(scalars), list(points))


def _encode_to_curve(pk_bytes: bytes, alpha: bytes) -> ed.Point:
    """RFC 9381 §5.4.1.1 TAI preimage layout over the shared hash-to-curve
    (native decompression injected — identical semantics, ~10× faster)."""
    return ed.hash_to_point(SUITE + b"\x01" + pk_bytes + alpha, b"\x00",
                            decompress=_decompress)


def _challenge(*points: ed.Point) -> int:
    buf = SUITE + b"\x02" + b"".join(ed.point_compress(p) for p in points) + b"\x00"
    return int.from_bytes(hashlib.sha512(buf).digest()[:CHALLENGE_LEN], "little")


def _proof_to_hash(gamma: ed.Point) -> bytes:
    g8 = ed.scalar_mult(ed.COFACTOR, gamma)
    return hashlib.sha512(
        SUITE + b"\x03" + ed.point_compress(g8) + b"\x00"
    ).digest()


@dataclass
class VRFKey:
    """One lottery identity. The reference holds two per node — roles and
    noise (ref: DistSys/vrf.go:9-32)."""

    seed: bytes

    def __post_init__(self):
        if len(self.seed) != 32:
            raise ValueError("VRF seed must be 32 bytes")
        self._x, self._prefix = ed.secret_expand(self.seed)
        self._public_pt = ed.base_mult(self._x)
        self.public = ed.point_compress(self._public_pt)

    def prove(self, alpha: bytes) -> Tuple[bytes, bytes]:
        """(beta, pi): 64-byte pseudorandom output + proof anyone can check
        against `self.public`."""
        h_pt = _encode_to_curve(self.public, alpha)
        h_bytes = ed.point_compress(h_pt)
        gamma = _msm([self._x], [h_pt])
        # deterministic nonce, RFC 8032 style: SHA512(prefix ‖ H)
        k = int.from_bytes(
            hashlib.sha512(self._prefix + h_bytes).digest(), "little"
        ) % ed.Q
        u = _msm([k], [ed.BASE])
        v = _msm([k], [h_pt])
        y_pt = self._public_pt
        c = _challenge(y_pt, h_pt, gamma, u, v)
        s = (k + c * self._x) % ed.Q
        pi = (
            ed.point_compress(gamma)
            + c.to_bytes(CHALLENGE_LEN, "little")
            + s.to_bytes(32, "little")
        )
        return _proof_to_hash(gamma), pi


def verify(public: bytes, alpha: bytes, pi: bytes) -> Optional[bytes]:
    """Returns beta iff pi proves that beta = VRF_sk(alpha) for the sk behind
    `public`; None on any failure (never raises on malformed input)."""
    if len(pi) != PROOF_LEN:
        return None
    gamma = _decompress(pi[:32])
    if gamma is None:
        return None
    c = int.from_bytes(pi[32 : 32 + CHALLENGE_LEN], "little")
    s = int.from_bytes(pi[32 + CHALLENGE_LEN :], "little")
    if s >= ed.Q:
        return None
    y_pt = _decompress(public)
    if y_pt is None:
        return None
    try:
        h_pt = _encode_to_curve(public, alpha)
    except ValueError:
        return None
    # U = s·B − c·Y ; V = s·H − c·Γ (each one two-term MSM)
    u = _msm([s, ed.Q - (c % ed.Q)], [ed.BASE, y_pt])
    v = _msm([s, ed.Q - (c % ed.Q)], [h_pt, gamma])
    if _challenge(y_pt, h_pt, gamma, u, v) != c:
        return None
    return _proof_to_hash(gamma)
