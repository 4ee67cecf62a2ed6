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
       grid_verdicts(xy)           the verdicts alone (`grid_sum`'s B3c)
  B3d  point_add(a, b)             `_build_ext_add`: a[i] + b[i]; and
       column_sum(pts)             the tree sums: gp.tree_sum over axis 0

and the glue of the reference's programs, which runs through them:
`tree_sum` (gp.tree_sum: `column_sum` of one column) and `grid_sum`
(`_build_grid` whole: B3c's verdicts, the grid mask as a torch reduction,
then B3d's tree over the waves, which forms each cell's point as it loads
it). A tree takes at most two B3d launches (`tree_plan`), one when a
block reaches a whole column, as the wave's 64 grids.

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
version's, and so the reference's. On the CPU a tree is the plain column
tree, which gives the card's bits whatever its plan.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

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


def grid_verdicts_plain(xy: torch.Tensor) -> torch.Tensor:
    """[..., 2, 16] wire cells → ok [...] bool: x < p, y < p and on the
    curve."""
    x = xy[..., 0, :]
    y = xy[..., 1, :]
    return fe.lt_p(x) & fe.lt_p(y) & gp.on_curve(x, y)


def grid_points_plain(xy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., 2, 16] wire cells → (ok [...] bool, grid_verdicts_plain's; the
    extended points (x, y, 1, xy) [..., 4, 16])."""
    x = xy[..., 0, :]
    y = xy[..., 1, :]
    one = fe.const("ONE_LIMBS", xy.device).expand(*x.shape)
    return grid_verdicts_plain(xy), torch.stack([x, y, one, fe.fmul(x, y)],
                                                dim=-2)


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


def _call(lib, entry: str, args: Sequence, tail: Tuple[int, ...],
          flag: torch.Tensor, stream) -> None:
    """Call `entry` of the ladder library `lib` with `args` (tensors as
    their pointers, None as a null one), the out-of-range flag, the ints
    `tail` and `stream`; raise on a launch error."""
    ptrs = [t.data_ptr() if isinstance(t, torch.Tensor) else t for t in args]
    rc = getattr(lib, entry)(*ptrs, flag.data_ptr(), *tail, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed at {tail}: "
                           f"{lib.ed25519_error_string(rc).decode()} ({rc})")


def _check_aligned(name: str, args: Sequence) -> None:
    for t in args:
        if isinstance(t, torch.Tensor) and (not t.is_contiguous()
                                            or t.data_ptr() % 16):
            raise ValueError(f"{name} takes contiguous, 16-byte aligned "
                             "tensors")


def _launch(wrapper, entry: str, args: Sequence, tail: Tuple[int, ...],
            device: torch.device, flag: Optional[torch.Tensor] = None) -> None:
    """Launch `entry` of the library on `device`'s current stream (`_call`)
    and count the launch on `wrapper`. The flag is checked here unless the
    caller passes its own (a tree reads one flag after its last launch)."""
    _check_aligned(wrapper.__name__, args)
    own = flag is None
    if own:
        flag = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        _call(_build.load("ed25519_ladder"), entry, args, tail, flag,
              torch.cuda.current_stream().cuda_stream)
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
                (bits, bits.shape[1], pts, out), (len(pts),), dev)
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
                (bits, bits.shape[1], table, out), (len(out),), dev)
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
                (ok.numel(),), xy.device)
    return ok, pts


def grid_verdicts(xy: torch.Tensor,
                  flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B3c's verdicts alone (`grid_sum`'s instance, which writes no
    points): [w, n, 2, 16] int64 wire cells → ok [w, n] bool; on a CUDA
    tensor the kernel (counted in `grid_validate_points.launches`; a
    caller's `flag` is left for it to read)."""
    _check("grid_verdicts", xy, torch.int64, CELL, 2)
    if xy.device.type == "cpu":
        _in_range("grid_verdicts", xy, 0, WIRE_BOUND)
        return grid_verdicts_plain(xy)
    ok = torch.empty(xy.shape[:2], dtype=torch.bool, device=xy.device)
    if ok.numel():
        _launch(grid_validate_points, "ed25519_grid_points", (xy, ok, None),
                (ok.numel(),), xy.device, flag)
    return ok


def point_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B3d: pointwise a[i] + b[i] of two int64 [..., 4, 16] batches; on a
    CUDA tensor the kernel (counted in `point_add.launches`)."""
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
        _launch(point_add, "ed25519_point_add", (a, b, out), (count,), dev)
    return out


def tree_plan(rows: int, cols: int, groups: int) -> List[Tuple[int, int]]:
    """The launches of a tree over the columns of a [rows, cols] batch
    (rows a power of two) by a library of `groups` groups a tree block
    (`ed25519_tree_groups`), each (rows, cols) of the batch as that launch
    views it. Output j of level k of a tree of n members is the sum, in the
    tree's order, of the 2^k members congruent to j mod n / 2^k; so where
    one block does not reach a column (rows > 2 groups), launch 1 sums each
    class of rows / r members, r = 2 groups (the batch viewed as [rows / r,
    r cols]: member j + i r of a column is row i of column j cols + c), and
    launch 2 the r partials of each column ([r, cols])."""
    reach = 2 * groups
    if rows <= reach:
        return [(rows, cols)]
    return [(rows // reach, reach * cols), (reach, cols)]


def column_tree_plain(pts: torch.Tensor) -> torch.Tensor:
    """[rows, cols, 4, 16] → [cols, 4, 16]: each column's sum in
    gp.tree_sum's halving levels, the first half the left operand."""
    n = pts.shape[0]
    while n > 1:
        half = n // 2
        pts = point_add_plain(pts[:half], pts[half:n])
        n = half
    return pts[0]


def _check_rows(name: str, rows: int) -> None:
    if not rows or rows & (rows - 1):
        raise ValueError(f"{name} wants a power-of-two batch, got {rows}")


def column_sum(pts: torch.Tensor) -> torch.Tensor:
    """B3d's tree: [rows, cols, 4, 16] int64 (rows a power of two) →
    [cols, 4, 16], column c the sum of pts[:, c] as gp.tree_sum pairs it.
    On a CUDA tensor at most two B3d launches (`tree_plan`; counted in
    `point_add.launches`), the range flag read once, after the last."""
    _check("column_sum", pts, torch.int64, POINT, 2)
    rows, cols = pts.shape[:2]
    _check_rows("column_sum", rows)
    if pts.device.type == "cpu":
        _in_range("column_sum", pts, 1 - LOOSE_BOUND, LOOSE_BOUND)
        return column_tree_plain(pts)
    if rows == 1 or not cols:
        return pts[0]
    flag = torch.zeros(1, dtype=torch.int32, device=pts.device)
    out = _counted_tree("column_sum", pts, rows, cols, flag)
    if flag.item():
        raise ValueError("column_sum: a limb outside the kernel's range")
    return out


def tree_launches(lib, src: torch.Tensor, rows: int, cols: int,
                  flag: torch.Tensor, stream,
                  grid_ok: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, int]:
    """`tree_plan`'s launches of the ladder library `lib` on `stream` over
    `src` viewed as [rows, cols]: point trees, the first a grid tree from
    the cells where `grid_ok` is given; each writes a fresh tensor (the
    partials, then the [cols, 4, 16] sums). Returns (the sums, the
    launches); counts nothing and leaves `flag` to the caller."""
    plan = tree_plan(rows, cols, lib.ed25519_tree_groups())
    for k, (r, c) in enumerate(plan):
        out = torch.empty((c,) + POINT, dtype=torch.int64, device=src.device)
        if k == 0 and grid_ok is not None:
            _call(lib, "ed25519_grid_tree", (src, grid_ok, out), (r, c, cols),
                  flag, stream)
        else:
            _call(lib, "ed25519_point_tree", (src, out), (r, c), flag,
                  stream)
        src = out
    return src, len(plan)


def _counted_tree(name: str, src: torch.Tensor, rows: int, cols: int,
                  flag: torch.Tensor,
                  grid_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`tree_launches` on the card's library and current stream, counted
    in `point_add.launches`."""
    _check_aligned(name, (src, grid_ok))
    with torch.cuda.device(src.device):
        out, n = tree_launches(_build.load("ed25519_ladder"), src, rows, cols,
                               flag, torch.cuda.current_stream().cuda_stream,
                               grid_ok)
    with _count_lock:
        point_add.launches += n
    return out


def tree_sum(pts: torch.Tensor) -> torch.Tensor:
    """Σᵢ pts[i] along axis 0 (a power of two) as gp.tree_sum pairs them:
    `column_sum` of one column (on a CUDA tensor at most two B3d
    launches)."""
    _check("tree_sum", pts, torch.int64, POINT, 1)
    _check_rows("tree_sum", pts.shape[0])
    return column_sum(pts[:, None])[0]


def grid_sum(xy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_build_grid` whole: [w, n, 2, 16] int64 wire cells (w a power of
    two) → (grid_ok [w] bool, the [n, 4, 16] sum of the valid grids'
    points). A grid is valid iff all its cells are (x < p, y < p, on the
    curve); an invalid grid's points count as the identity. On a CUDA
    tensor: B3c's verdicts alone (`grid_verdicts`), `ok.all(dim=1)`, then
    B3d's tree over the waves (`tree_plan`: one launch up to 2 groups a
    tree block of waves), whose first launch forms each cell's point (x,
    y, 1, x y) as it loads it; one range flag for all, read once. On the
    CPU: the plain points, masked, in the plain column tree."""
    _check("grid_sum", xy, torch.int64, CELL, 2)
    w, n = xy.shape[:2]
    _check_rows("grid_sum", w)
    if xy.device.type == "cpu":
        ok, pts = grid_validate_points(xy)
        grid_ok = ok.all(dim=1)
        pts[~grid_ok] = gp.identity_on((), pts.device)
        return grid_ok, column_tree_plain(pts)
    dev = xy.device
    if not n:
        return torch.ones(w, dtype=torch.bool, device=dev), \
            torch.empty((0,) + POINT, dtype=torch.int64, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    grid_ok = grid_verdicts(xy, flag).all(dim=1)
    out = _counted_tree("grid_sum", xy, w, n, flag, grid_ok)
    if flag.item():
        raise ValueError("grid_sum: a limb outside the kernel's range")
    return grid_ok, out


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
