"""Affine limb cells for checking the on-curve validator and the plane.

The carry-overflow edge values, cells built from them, random cells and a
valid VSS commitment grid, from numpy and the port's own ed25519 copy only:
the CPU tests, the GPU tests and `chip_smoke.py` share them, and the last
two run where JAX is not installed.
"""

from __future__ import annotations

import numpy as np

from biscotti_tpu_torch.crypto import ed25519 as ed

# the carry-overflow edges of the reference's field tests
EDGE_FIELD = [0, 1, ed.P - 1, ed.P, ed.Q - 1, 2**255 - 1, 2**256 - 1]


def raw_limbs(vals) -> np.ndarray:
    """python ints < 2²⁵⁶ → [len, 16] int64 limbs of their 32-byte LE
    encodings, NOT reduced mod p."""
    blob = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(blob, "<u2").reshape(len(vals), 16).astype(np.int64)


def edge_cells() -> np.ndarray:
    """[N, 2, 16] int64 cells: every pair of edge values, valid points and
    their non-canonical (+p) and bit-flipped twins, the order-2 point
    (0, −1) and the identity (0, 1)."""
    pairs = [(x, y) for x in EDGE_FIELD for y in EDGE_FIELD]
    for k in (1, 2, 9, 12345):
        x, y = ed.to_affine(ed.base_mult(k))
        pairs += [(x, y), (x + ed.P, y), (x, y + ed.P), (x ^ 1, y),
                  (x, y ^ (1 << 200))]
    pairs += [(0, ed.P - 1), (0, 1)]
    return np.stack([raw_limbs(pair) for pair in pairs])


def random_cells(n: int, seed: int) -> np.ndarray:
    """[n, 2, 16] int64 cells of uniform random 16-bit limbs."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 16, (n, 2, 16), dtype=np.int64)


def grid_bytes(a, b, fixed_base_mult, device=None) -> np.ndarray:
    """[n, 64] uint8 affine cells of aᵢ·B + bᵢ·H, the VSS commitment wire
    form, from the given `fixed_base_mult` (the port's primitive)."""
    pa = fixed_base_mult(a, "B", device=device)
    pb = fixed_base_mult(b, "H", device=device)
    out = bytearray()
    for p, q in zip(pa, pb):
        x, y = ed.to_affine(ed.point_add(p, q))
        out += x.to_bytes(32, "little") + y.to_bytes(32, "little")
    return np.frombuffer(bytes(out), np.uint8).reshape(len(a), 64).copy()
