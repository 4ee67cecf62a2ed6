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


def chain_points(n: int, start: int = 1) -> list:
    """[n] extended points start·B, (start + 1)·B, ... by repeated
    addition (cheap beside n scalar multiplications)."""
    pts, p = [], ed.base_mult(start)
    for _ in range(n):
        pts.append(p)
        p = ed.point_add(p, ed.BASE)
    return pts


def point_limbs(pts) -> np.ndarray:
    """[n] extended python-int points → [n, 4, 16] int64 canonical limbs."""
    return raw_limbs([c % ed.P for pt in pts for c in pt]).reshape(
        len(pts), 4, 16)


TORSION2 = (0, ed.P - 1, 1, 0)  # (0, −1): order 2, on the curve


def ladder_lanes(m: int, seed: int):
    """(scalars, [m, 4, 16] int64 points) for the msm ladder: seeded
    scalars uniform in [0, q) (so half in the top half, which the msm
    negates), some 0, 1 on lane 3 and q − 1 on lane 0, whose point is the
    identity (its negation's fsub(Y, X) leaves a −1 limb); points along a
    chain of base multiples, with the order-2 point (0, −1) on lane 1, a
    torsioned point on lane 2, and every fifth point loose (p added
    limb-wise to X and Y, limbs < 2¹⁷)."""
    rng = np.random.default_rng(seed)
    scalars = [int.from_bytes(rng.bytes(32), "little") % ed.Q
               for _ in range(m)]
    for i in range(5, m, 7):
        scalars[i] = 0
    pts = chain_points(m, start=seed % 1000 + 2)
    pts[0] = ed.IDENTITY
    scalars[0] = ed.Q - 1
    if m > 3:
        pts[1] = TORSION2
        pts[2] = ed.point_add(pts[2], TORSION2)
        scalars[3] = 1
    limbs = point_limbs(pts)
    p_limbs = raw_limbs([ed.P])[0]
    limbs[4::5, :2] += p_limbs
    return scalars, limbs


def wire_grids(w: int, n: int, seed: int) -> np.ndarray:
    """[w, n, 2, 16] int64 wire cells of w VSS-shaped grids: each the affine
    cells of a chain of base multiples, rotated by its index; grid 1 with
    one cell off the curve (a flipped bit of x), grid 2 with one
    non-canonical cell (x + p), grid 3 random limbs and, where w > 4, grid
    4 the edge cells, the rest valid."""
    rng = np.random.default_rng(seed)
    base = np.stack([raw_limbs(ed.to_affine(p))
                     for p in chain_points(n, start=seed % 1000 + 2)])
    grids = np.stack([np.roll(base, g, axis=0) for g in range(w)])
    grids[1, n // 3, 0, 0] ^= 1
    x = sum(int(v) << (16 * i) for i, v in enumerate(grids[2, n // 2, 0]))
    grids[2, n // 2, 0] = raw_limbs([x + ed.P])[0]
    grids[3] = rng.integers(0, 1 << 16, (n, 2, 16))
    if w > 4:
        edges = edge_cells()[:n]
        grids[4, :len(edges)] = edges
    return grids
