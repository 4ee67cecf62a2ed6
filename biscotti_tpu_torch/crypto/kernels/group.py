"""Extended-coordinate Edwards25519 group ops over torch limb tensors
(counterpart of `biscotti_tpu/crypto/kernels/group.py`).

A point batch is one int64 tensor [..., 4, 16] — rows X, Y, Z, T of the
extended homogeneous coordinates (x = X/Z, y = Y/Z, T = XY/Z), each a
16-limb field element from `kernels.field`. The complete a = −1 twisted
Edwards addition (RFC 8032 §5.1.4) is formula-for-formula the pure-python
`crypto/ed25519.py` oracle and the reference's limb version, so all three
compute the *same group element* on every input, and the port's limbs
equal the reference's bit for bit.

All ops are shape-polymorphic over leading batch dims (a [4, 16] point
broadcasts against a batch); `select` is the per-lane conditional the
scalar-mult ladders branch with.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from biscotti_tpu_torch.crypto import ed25519 as ed
from biscotti_tpu_torch.crypto.kernels import field as fe

# identity (0, 1, 1, 0) as a [4, 16] limb constant
IDENTITY_LIMBS = np.stack([
    fe.ZERO_LIMBS, fe.ONE_LIMBS, fe.ONE_LIMBS, fe.ZERO_LIMBS,
]).astype(np.int64)


def identity(shape=()) -> np.ndarray:
    """Identity point broadcast to leading batch shape `shape`."""
    out = np.broadcast_to(IDENTITY_LIMBS, tuple(shape) + (4, fe.LIMBS))
    return np.ascontiguousarray(out)


def identity_on(shape, device: torch.device) -> torch.Tensor:
    """`identity(shape)` as an int64 tensor on `device`."""
    return torch.as_tensor(IDENTITY_LIMBS, device=device).expand(
        *shape, 4, fe.LIMBS).contiguous()


def point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete addition — ed25519.point_add, limb-for-limb."""
    x1, y1, z1, t1 = p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]
    x2, y2, z2, t2 = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    a = fe.fmul(fe.fsub(y1, x1), fe.fsub(y2, x2))
    b = fe.fmul(fe.fadd(y1, x1), fe.fadd(y2, x2))
    c = fe.fmul(fe.fmul(t1, fe.const("D2_LIMBS", t1.device)), t2)
    zz = fe.fmul(z1, z2)
    dd = fe.fadd(zz, zz)
    e = fe.fsub(b, a)
    f = fe.fsub(dd, c)
    g = fe.fadd(dd, c)
    h = fe.fadd(b, a)
    return torch.stack([fe.fmul(e, f), fe.fmul(g, h),
                        fe.fmul(f, g), fe.fmul(e, h)], dim=-2)


def point_double(p: torch.Tensor) -> torch.Tensor:
    """ed25519.point_double, limb-for-limb."""
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    a = fe.fmul(x1, x1)
    b = fe.fmul(y1, y1)
    zz = fe.fmul(z1, z1)
    c = fe.fadd(zz, zz)
    h = fe.fadd(a, b)
    xy = fe.fadd(x1, y1)
    e = fe.fsub(h, fe.fmul(xy, xy))
    g = fe.fsub(a, b)
    f = fe.fadd(c, g)
    return torch.stack([fe.fmul(e, f), fe.fmul(g, h),
                        fe.fmul(f, g), fe.fmul(e, h)], dim=-2)


def select(mask: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-lane conditional: mask True → p, else q. mask has the batch
    shape of p/q minus the trailing (4, 16)."""
    return torch.where(mask[..., None, None], p, q)


def on_curve(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """−x² + y² = 1 + d·x²y² over loose limb elements → bool batch."""
    xx = fe.fmul(x, x)
    yy = fe.fmul(y, y)
    lhs = fe.fsub(yy, xx)
    rhs = fe.fadd(fe.const("ONE_LIMBS", x.device),
                  fe.fmul(fe.const("D_LIMBS", x.device), fe.fmul(xx, yy)))
    return fe.eq(lhs, rhs)


def tree_sum(pts: torch.Tensor) -> torch.Tensor:
    """Pointwise batch reduction Σᵢ pts[i] along axis 0 (length must be a
    power of two — pad with identity) via log₂ halving rounds of the
    complete addition."""
    n = pts.shape[0]
    if not n or n & (n - 1):
        raise ValueError(f"tree_sum wants a power-of-two batch, got {n}")
    while n > 1:
        half = n // 2
        pts = point_add(pts[:half], pts[half:n])
        n = half
    return pts[0]


# ----------------------------------------------------- host conversions


def points_to_limbs(points: Sequence[ed.Point]) -> np.ndarray:
    """[n] extended-coordinate python-int points → [n, 4, 16] int32
    limbs (one bytes join per coordinate row)."""
    n = len(points)
    blob = b"".join(
        (c % fe.P).to_bytes(32, "little")
        for pt in points for c in pt)
    return (np.frombuffer(blob, dtype="<u2")
            .reshape(n, 4, fe.LIMBS).astype(np.int32))


def ext_bytes_to_limbs(buf: bytes, n: int) -> np.ndarray:
    """n×128-byte extended buffers (the native plane's wire form:
    x‖y‖z‖t, 32B LE each) → [n, 4, 16] int32 limbs."""
    if len(buf) != 128 * n:
        raise ValueError("extended buffer length mismatch")
    return (np.frombuffer(buf, dtype="<u2")
            .reshape(n, 4, fe.LIMBS).astype(np.int32))


def xy_bytes_to_limbs(buf, n: int) -> np.ndarray:
    """n×64-byte affine (x, y) LE pairs (the VSS commitment wire form) →
    [n, 2, 16] int32 limbs, uninterpreted — validation happens on
    device (`primitives.grid_validate_sum`)."""
    arr = np.frombuffer(bytes(buf), dtype="<u2")
    if arr.size != 32 * n:
        raise ValueError("xy buffer length mismatch")
    return arr.reshape(n, 2, fe.LIMBS).astype(np.int32)


def limbs_to_point(arr) -> ed.Point:
    """[4, 16] limb array (any loose magnitudes) → extended python-int
    point, coordinates reduced mod p."""
    a = np.asarray(arr)
    coords = [fe.limbs_to_int(a[i]) % fe.P for i in range(4)]
    return (coords[0], coords[1], coords[2], coords[3])


__all__: List[str] = [
    "IDENTITY_LIMBS", "identity", "identity_on", "point_add",
    "point_double", "select", "on_curve", "tree_sum", "points_to_limbs",
    "ext_bytes_to_limbs", "xy_bytes_to_limbs", "limbs_to_point",
]
