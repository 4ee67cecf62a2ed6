"""The crypto ladders as hand-written Hopper kernels (counterpart of the
jitted builders at `biscotti_tpu/crypto/kernels/primitives.py:109-179`).

Four kernels of `csrc/ed25519_ladder.cu` (built by `_build.py`; its head
comment gives the design and the bound), each beside its plain PyTorch
version, which is the reference program's own arithmetic written with the
port's `field.py` and `group.py`:

  B3a  msm_ladder(bits, pts)       `_build_msm`'s fori_loop: each lane's
                                   MSB-first double-and-add, [m, 4, 16]
  B3b  fixed_walk(bits, table)     `_build_fixed`: each lane's LSB-first
                                   walk over table[i] = 2^i base
  B3c  grid_validate_points(xy)    `_build_grid`'s cells: (x < p, y < p and
                                   on the curve, the point (x, y, 1, xy))
  B3d  point_add(a, b)             `_build_ext_add`: a[i] + b[i]

and the glue of the reference's programs, which runs through them:
`tree_sum` (gp.tree_sum: one `point_add` a level, the first half the left
operand) and `grid_sum` (`_build_grid` whole: B3c, the grid mask as torch
ops, the tree sum over the waves).

A wrapper given a CPU tensor computes the plain version; given a CUDA
tensor it launches its kernel on the current stream, counts the launch
(`msm_ladder.launches`, ...) and raises on a launch error; any other
device raises. Nothing falls back. Both paths take the same inputs and
refuse the same ones (`ValueError`): int64 points [..., 4, 16] with limbs in
(-2^19, 2^19) for B3a, B3b and B3d (canonical and loose limbs, negated
points and the ladders' own outputs, which can hold small negative limbs:
the range in which the kernel is proven exact), wire cells [..., 2, 16] with
limbs in [0, 2^16) for B3c; the kernel flags a limb outside its range as it
loads it. Bits are packed (`pack_bits`): [m, steps / 32] int32, bit b of
word w being step 32 w + b, for the plain version and the kernel alike.
The contract is bit equality: the kernel's int64 limbs equal the plain
version's, and so the reference's.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from biscotti_tpu_torch import _build
from biscotti_tpu_torch.crypto.kernels import field as fe
from biscotti_tpu_torch.crypto.kernels import group as gp

# B3a, B3b and B3d take limbs in (-LOOSE_BOUND, LOOSE_BOUND); B3c wire limbs
# in [0, WIRE_BOUND)
LOOSE_BOUND = 1 << 19
WIRE_BOUND = 1 << 16
POINT = (4, fe.LIMBS)
CELL = (2, fe.LIMBS)
# co-hosted peers prewarm in threads: the launch counts take a lock
_count_lock = threading.Lock()


# ------------------------------------------------------------------ bits


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[m, steps] 0/1 matrix (steps a multiple of 32) → [m, steps // 32]
    int32, bit b of word w being step 32 w + b."""
    bits = np.asarray(bits)
    m, steps = bits.shape
    if steps % 32:
        raise ValueError(f"pack_bits wants a multiple of 32 steps, got {steps}")
    packed = np.packbits(bits != 0, axis=1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").view(np.int32).reshape(
        m, steps // 32)


def unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[m, words] packed bits → [32 words, m] bool: row s is step s's
    per-lane condition."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    steps = (bits[:, :, None] >> shifts) & 1  # [m, words, 32]
    return (steps.reshape(bits.shape[0], -1) > 0).T.contiguous()


# ------------------------------------------------------------ plain versions


def msm_ladder_plain(bits: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Each lane's MSB-first double-and-add from the identity, as the
    reference's fori_loop body: bits [m, words], pts [m, 4, 16] → [m, 4,
    16]."""
    steps = unpack_bits(bits)
    acc = gp.identity_on((pts.shape[0],), pts.device)
    for i in range(steps.shape[0]):
        acc = gp.point_double(acc)
        acc = gp.select(steps[i], gp.point_add(acc, pts), acc)
    return acc


def fixed_walk_plain(bits: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each lane's walk over table[i] = 2^i base where its bit i is set
    (tables may be concatenated: B‖H walks both in one loop): bits [m,
    words], table [32 words, 4, 16] → [m, 4, 16]."""
    steps = unpack_bits(bits)
    acc = gp.identity_on((bits.shape[0],), table.device)
    for i in range(steps.shape[0]):
        acc = gp.select(steps[i], gp.point_add(acc, table[i]), acc)
    return acc


def grid_points_plain(xy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., 2, 16] wire cells → (ok [...] bool: x < p, y < p and on the
    curve; the extended points (x, y, 1, xy) [..., 4, 16])."""
    x = xy[..., 0, :]
    y = xy[..., 1, :]
    ok = fe.lt_p(x) & fe.lt_p(y) & gp.on_curve(x, y)
    one = fe.const("ONE_LIMBS", xy.device).expand(*x.shape)
    return ok, torch.stack([x, y, one, fe.fmul(x, y)], dim=-2)


point_add_plain = gp.point_add


# ------------------------------------------------------------------ checks


def _check(name: str, t, dtype, tail: Tuple[int, ...],
           lead: Optional[int]) -> None:
    """dtype, shape ([lead dims..., *tail]; lead None: one or more) and
    device of a wrapper's input."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} takes tensors, got {type(t).__name__}")
    k = t.dim() - len(tail) if lead is None else lead
    if t.dtype != dtype or k < 1 or t.dim() != k + len(tail) \
            or tuple(t.shape[k:]) != tail:
        want = "[" + ", ".join(["."] * (lead or 1) + [str(d) for d in tail]) \
            + "]"
        raise ValueError(f"{name} takes a {dtype} {want} tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")


def _in_range(name: str, t: torch.Tensor, lo: int, hi: int) -> None:
    """On the CPU: every limb in [lo, hi), as the kernel checks it."""
    if t.numel() and (int(t.min()) < lo or int(t.max()) >= hi):
        raise ValueError(f"{name} takes limbs in [{lo}, {hi}); got a limb "
                         "outside it")


def _same_device(name: str, *ts: torch.Tensor) -> torch.device:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on {sorted(map(str, devs))}")
    return ts[0].device


def _launch(wrapper, entry: str, args: Sequence, count: int,
            device: torch.device, flag: Optional[torch.Tensor] = None) -> None:
    """Launch `entry` of the library on `device`'s current stream with
    `args`, the out-of-range flag and `count`; raise on a launch error and
    count the launch on `wrapper`. The flag is checked here unless the
    caller passes its own (`tree_sum` reads one flag after its last level)."""
    for t in args:
        if isinstance(t, torch.Tensor) and (not t.is_contiguous()
                                            or t.data_ptr() % 16):
            raise ValueError(f"{wrapper.__name__} takes contiguous, 16-byte "
                             "aligned tensors")
    lib = _build.load("ed25519_ladder")
    own = flag is None
    if own:
        flag = torch.zeros(1, dtype=torch.int32, device=device)
    ptrs = [t.data_ptr() if isinstance(t, torch.Tensor) else t for t in args]
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*ptrs, flag.data_ptr(), count,
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed at {count}: "
                           f"{lib.ed25519_error_string(rc).decode()} ({rc})")
    with _count_lock:
        wrapper.launches += 1
    if own and flag.item():
        raise ValueError(f"{wrapper.__name__}: a limb outside the kernel's "
                         "range")


# ---------------------------------------------------------------- wrappers


def _check_bits(name: str, bits: torch.Tensor, m: Optional[int]) -> None:
    """[m, words] int32 bits, words ≥ 1 (m unchecked when None)."""
    _check(name, bits, torch.int32, (), 2)
    if (m is not None and bits.shape[0] != m) or bits.shape[1] == 0:
        raise ValueError(f"{name}: bits {tuple(bits.shape)} for {m} lanes")


def msm_ladder(bits: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """B3a: bits [m, words] int32 (MSB-first steps), pts [m, 4, 16] int64
    → [m, 4, 16], each lane's double-and-add; on a CUDA tensor the kernel
    (counted in `msm_ladder.launches`)."""
    _check("msm_ladder", pts, torch.int64, POINT, 1)
    _check_bits("msm_ladder", bits, pts.shape[0])
    dev = _same_device("msm_ladder", bits, pts)
    if dev.type == "cpu":
        _in_range("msm_ladder", pts, 1 - LOOSE_BOUND, LOOSE_BOUND)
        return msm_ladder_plain(bits, pts)
    out = torch.empty_like(pts)
    if len(pts):
        _launch(msm_ladder, "ed25519_msm_ladder",
                (bits, bits.shape[1], pts, out), len(pts), dev)
    return out


def fixed_walk(bits: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """B3b: bits [m, words] int32 (LSB-first steps), table [32 words, 4,
    16] int64 → [m, 4, 16]; on a CUDA tensor the kernel (counted in
    `fixed_walk.launches`)."""
    _check("fixed_walk", table, torch.int64, POINT, 1)
    _check_bits("fixed_walk", bits, None)
    if table.shape[0] != 32 * bits.shape[1]:
        raise ValueError(f"fixed_walk: a table of {table.shape[0]} rows for "
                         f"{32 * bits.shape[1]} steps")
    dev = _same_device("fixed_walk", bits, table)
    if dev.type == "cpu":
        _in_range("fixed_walk", table, 1 - LOOSE_BOUND, LOOSE_BOUND)
        return fixed_walk_plain(bits, table)
    out = torch.empty((bits.shape[0],) + POINT, dtype=torch.int64, device=dev)
    if len(out):
        _launch(fixed_walk, "ed25519_fixed_walk",
                (bits, bits.shape[1], table, out), len(out), dev)
    return out


def grid_validate_points(xy: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3c: [w, n, 2, 16] int64 wire cells → (ok [w, n] bool, points [w, n,
    4, 16]); on a CUDA tensor the kernel (counted in
    `grid_validate_points.launches`)."""
    _check("grid_validate_points", xy, torch.int64, CELL, 2)
    if xy.device.type == "cpu":
        _in_range("grid_validate_points", xy, 0, WIRE_BOUND)
        return grid_points_plain(xy)
    ok = torch.empty(xy.shape[:2], dtype=torch.bool, device=xy.device)
    pts = torch.empty(xy.shape[:2] + POINT, dtype=torch.int64,
                      device=xy.device)
    if ok.numel():
        _launch(grid_validate_points, "ed25519_grid_points", (xy, ok, pts),
                ok.numel(), xy.device)
    return ok, pts


def _point_add(a: torch.Tensor, b: torch.Tensor,
               flag: Optional[torch.Tensor]) -> torch.Tensor:
    _check("point_add", a, torch.int64, POINT, None)
    if b.shape != a.shape or b.dtype != a.dtype:
        raise ValueError(f"point_add: {b.dtype} {tuple(b.shape)} against "
                         f"{a.dtype} {tuple(a.shape)}")
    dev = _same_device("point_add", a, b)
    if dev.type == "cpu":
        _in_range("point_add", a, 1 - LOOSE_BOUND, LOOSE_BOUND)
        _in_range("point_add", b, 1 - LOOSE_BOUND, LOOSE_BOUND)
        return point_add_plain(a, b)
    out = torch.empty_like(a)
    count = a.numel() // (4 * fe.LIMBS)
    if count:
        _launch(point_add, "ed25519_point_add", (a, b, out), count, dev, flag)
    return out


def point_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B3d: pointwise a[i] + b[i] of two int64 [..., 4, 16] batches; on a
    CUDA tensor the kernel (counted in `point_add.launches`)."""
    return _point_add(a, b, None)


def tree_sum(pts: torch.Tensor) -> torch.Tensor:
    """Σᵢ pts[i] along axis 0 (a power of two) in log₂ halving levels, each
    one `point_add(pts[:half], pts[half:])`, as gp.tree_sum pairs them. On
    a CUDA tensor each level is one B3d launch, and the range flag is read
    once, after the last."""
    _check("tree_sum", pts, torch.int64, POINT, None)
    n = pts.shape[0]
    if not n or n & (n - 1):
        raise ValueError(f"tree_sum wants a power-of-two batch, got {n}")
    flag = None if pts.device.type == "cpu" else torch.zeros(
        1, dtype=torch.int32, device=pts.device)
    while n > 1:
        half = n // 2
        pts = _point_add(pts[:half], pts[half:n], flag)
        n = half
    if flag is not None and flag.item():
        raise ValueError("tree_sum: a limb outside the kernel's range")
    return pts[0]


def grid_sum(xy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_build_grid` whole: [w, n, 2, 16] int64 wire cells (w a power of
    two) → (grid_ok [w] bool, the [n, 4, 16] sum of the valid grids'
    points). B3c, then the grid mask (torch: a grid is valid iff all its
    cells are; an invalid grid's points become the identity), then
    `tree_sum` over the waves."""
    ok, pts = grid_validate_points(xy)
    grid_ok = ok.all(dim=1)
    pts[~grid_ok] = gp.identity_on((), pts.device)
    return grid_ok, tree_sum(pts)


msm_ladder.launches = 0
fixed_walk.launches = 0
grid_validate_points.launches = 0
point_add.launches = 0

WRAPPERS = (msm_ladder, fixed_walk, grid_validate_points, point_add)


def reset_launches() -> None:
    """Set every B3 wrapper's launch count to 0."""
    for w in WRAPPERS:
        w.launches = 0


def launches() -> dict:
    """{wrapper name: launches} of the four B3 wrappers."""
    return {w.__name__: w.launches for w in WRAPPERS}
