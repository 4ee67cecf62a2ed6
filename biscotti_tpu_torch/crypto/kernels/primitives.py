"""The four hot device-crypto entry points over torch limb tensors
(counterpart of `biscotti_tpu/crypto/kernels/primitives.py`).

  * `msm`              — multi-scalar mult Σ sᵢ·Pᵢ: per-lane MSB-first
                         double-and-add over the scalars' 256 bits, then a
                         log₂-depth pointwise tree reduction. Every lane
                         runs the identical 256-step ladder, so the batch
                         vectorizes across the intake width.
  * `fixed_base_mult`  — k·B (and k·H) via a precomputed 2ⁱ·base table:
                         256 conditional adds per lane, no doubles.
  * `grid_validate_sum`— whole-intake all-or-nothing canonicity + on-curve
                         validation of affine commitment grids, plus the
                         pointwise sum of the valid grids (the VSS wave
                         fold). `BISCOTTI_PALLAS_CRYPTO=1` also runs the
                         on-curve mask through kernel B2
                         (`cuda_validate.oncurve_mask`) and holds it
                         against the host oracle.
  * `shamir_recover`   — vectorized Shamir interpolation: the Vandermonde
                         pseudoinverse × aggregated shares, a float64
                         `torch.matmul` rounded back to int64.

Scalars are normalized exactly like `commitments._msm_python` — mod-q
reduction, then top-half scalars become (q−s)·(−P) — so the device MSM
agrees with the CPU oracle on EVERY input, torsioned points included (see
`_norm_scalar_point`). Batches pad up to power-of-two lane buckets with the
identity point / zero scalar, which the complete addition absorbs, because
`tree_sum` halves a power of two. Each of the reference's jitted programs
is a hand-written CUDA kernel here, kernel B3 (`cuda_ladder.py`: the msm
ladder, the fixed-base walk, the grid's validate-and-points and the point
add, whose tree sums take at most two launches whatever the width); on the
CPU the wrappers compute their plain versions, the reference's own
formulas as torch ops. Either way the port's limbs equal the reference's
bit for bit.

Every entry point takes `device=None`: the GPU unless the caller asks for
the CPU (`device.resolve_device`). Inputs and results are numpy arrays or
python-int points, as the reference's are; each call copies its result to
the host, so `instrument.timed` charges the device work too.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from biscotti_tpu_torch.crypto import ed25519 as ed
from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
from biscotti_tpu_torch.crypto.kernels import field as fe
from biscotti_tpu_torch.crypto.kernels import group as gp
from biscotti_tpu_torch.crypto.kernels.instrument import timed
from biscotti_tpu_torch.device import resolve_device

Device = Optional[Union[str, torch.device]]

_table_cache: Dict[str, np.ndarray] = {}

# 4p as limb-wise quadrupled P limbs (loose, non-normalized): used for
# host-side point negation −x ≡ 4p − x. 4p rather than 2p because the
# VSS settle negates LOOSE accumulator limbs (< 2¹⁷, which can exceed a
# 2p limb): every 4p limb is ≥ 2¹⁸ − 76, so the result stays
# non-negative at < 2¹⁸ per limb — one bit over the documented loose
# bound, which the fmul analysis absorbs (products < 2³⁶, folded
# < 2⁴⁶, still far inside int64).
_FOURP_LIMBS = 4 * fe.P_LIMBS


def _pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


# lane-count floors of the power-of-two buckets, as in the reference
MSM_MIN_LANES = 32
FIXED_MIN_LANES = 4
GRID_MIN_WAVES = 4


def _on(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a contiguous tensor on `dev`, for a ladder wrapper."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def point_neg_limbs(arr: np.ndarray) -> np.ndarray:
    """Limb-domain point negation (−X, Y, Z, −T) of [..., 4, 16] batches
    with canonical OR loose (< 2¹⁷) coordinate limbs — near-loose
    (< 2¹⁸) output, safe for the ladder's field ops (see _FOURP_LIMBS)."""
    out = np.asarray(arr, dtype=np.int64).copy()
    out[..., 0, :] = _FOURP_LIMBS - out[..., 0, :]
    out[..., 3, :] = _FOURP_LIMBS - out[..., 3, :]
    return out


def _fixed_table(which: str) -> np.ndarray:
    """[256, 4, 16] int64 limb table of 2ⁱ·base for base ∈ {B, H} —
    derived once per process with the python-int oracle (exact)."""
    tab = _table_cache.get(which)
    if tab is None:
        if which == "B":
            pt = ed.BASE
        elif which == "H":
            from biscotti_tpu_torch.crypto.commitments import H_POINT

            pt = H_POINT
        else:
            raise ValueError(f"unknown fixed base {which!r}")
        pts = []
        for _ in range(256):
            pts.append(pt)
            pt = ed.point_double(pt)
        tab = gp.points_to_limbs(pts).astype(np.int64)
        _table_cache[which] = tab
    return tab


# ----------------------------------------------------------- public API


def _norm_scalar_point(scalars, pts_limbs) -> Tuple[np.ndarray, np.ndarray]:
    """Signed/unreduced python-int scalars + [n,4,16] limb points →
    (MSB-first bit matrix, possibly-negated limb points), mirroring
    `commitments._msm_python`'s pair normalization EXACTLY: reduce mod
    q (python semantics cover negatives), then replace top-half scalars
    by (q−s)·(−P). The mirror matters beyond bit-shortness: s·P and
    (q−s)·(−P) differ by q·P, which is NOT the identity for points
    carrying a small-order (torsion) component — commitment-grid cells
    are validated on-curve but NOT subgroup-checked, so without the
    identical fold an adversarial torsioned cell would make the device
    and CPU settles disagree on the same input (consensus split — the
    exact hazard _msm_python's own normalization exists to close).
    Zero scalars ride along (their adds never fire)."""
    mags: List[int] = []
    pts = np.asarray(pts_limbs, dtype=np.int64)
    neg_idx = []
    for i, s in enumerate(scalars):
        s = int(s) % fe.Q
        if s > fe.Q // 2:
            s = fe.Q - s
            neg_idx.append(i)
        mags.append(s)
    if neg_idx:
        pts = pts.copy()
        pts[neg_idx] = point_neg_limbs(pts[neg_idx])
    bits = fe.scalars_to_bits(mags, msb_first=True)
    return bits, pts


def msm_lanes(scalars: Sequence[int], points) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """What `msm` hands kernel B3a: (packed MSB-first bits [m, 8] int32,
    points [m, 4, 16] int64), normalized by `_norm_scalar_point` and
    padded to the power-of-two lane bucket with the identity and zero
    scalars. `points` as for `msm`."""
    n = len(scalars)
    if isinstance(points, np.ndarray):
        pts = np.asarray(points[:n], dtype=np.int64)
    else:
        pts = gp.points_to_limbs(points).astype(np.int64)
    bits, pts = _norm_scalar_point(scalars, pts)
    m = _pow2(n, MSM_MIN_LANES)
    if m != n:
        bits = np.concatenate([bits, np.zeros((m - n, 256), bits.dtype)])
        pts = np.concatenate([pts, gp.identity((m - n,))])
    return cl.pack_bits(bits), pts


def msm(scalars: Sequence[int], points, device: Device = None) -> ed.Point:
    """Σ sᵢ·Pᵢ on `device`. `points` is a sequence of extended python-int
    points or an [n, 4, 16] limb array (e.g. a wave-folded accumulator).
    Returns an extended python-int point — projectively equal (identical
    group element) to the CPU oracle's result on every input. One ladder
    launch (B3a) and at most two tree launches (B3d)."""
    dev = resolve_device(device)
    if len(scalars) == 0:
        return ed.IDENTITY
    with timed("msm"):
        bits, pts = msm_lanes(scalars, points)
        lanes = cl.msm_ladder(_on(bits, dev), _on(pts, dev))
        out = cl.tree_sum(lanes).cpu().numpy()
    return gp.limbs_to_point(out)


def fixed_lanes(scalars: Sequence[int]) -> np.ndarray:
    """What `fixed_base_mult` hands kernel B3b: packed LSB-first bits [m,
    8] int32 of the scalars mod q, padded with zero scalars to the
    power-of-two lane bucket."""
    bits = fe.scalars_to_bits([int(s) % fe.Q for s in scalars],
                              msb_first=False)
    m = _pow2(len(scalars), FIXED_MIN_LANES)
    return cl.pack_bits(np.concatenate(
        [bits, np.zeros((m - len(scalars), 256), bits.dtype)]))


def pedersen_lanes(a: int, b: int) -> np.ndarray:
    """What `pedersen_commit_point` hands kernel B3b: one lane's packed
    bits [1, 16] int32, a's 256 LSB-first bits then b's, against the
    B‖H table."""
    return cl.pack_bits(np.concatenate([
        fe.scalars_to_bits([int(a) % fe.Q], msb_first=False),
        fe.scalars_to_bits([int(b) % fe.Q], msb_first=False)], axis=1))


def fixed_base_mult(scalars: Sequence[int], which: str = "B",
                    device: Device = None) -> List[ed.Point]:
    """[kᵢ·base] for base ∈ {B, H}: 256 conditional table adds per lane,
    vectorized across the batch. Scalars reduce mod q (fixed-base callers
    are group-order scalars by construction)."""
    dev = resolve_device(device)
    n = len(scalars)
    if n == 0:
        return []
    with timed("fixed_base"):
        out = cl.fixed_walk(_on(fixed_lanes(scalars), dev),
                            _on(_fixed_table(which), dev)).cpu().numpy()
    return [gp.limbs_to_point(out[i]) for i in range(n)]


def pedersen_commit_point(a: int, b: int, device: Device = None) -> ed.Point:
    """a·B + b·H in ONE ladder (the concatenated-table walk) — the lhs
    comb of the batched VSS / commitment equations."""
    dev = resolve_device(device)
    with timed("fixed_base"):
        table = np.concatenate([_fixed_table("B"), _fixed_table("H")])
        out = cl.fixed_walk(_on(pedersen_lanes(a, b), dev),
                            _on(table, dev)).cpu().numpy()
    return gp.limbs_to_point(out[0])


def wave_cells(grids: Sequence) -> np.ndarray:
    """What `grid_validate_sum` hands kernel B3c: the W grids' wire limbs
    [wp, n, 2, 16] int32, padded to the power-of-two wave bucket with
    grids of the affine identity (0, 1), which are valid and sum away."""
    bufs = [bytes(g) if isinstance(g, (bytes, bytearray))
            else np.ascontiguousarray(g).tobytes() for g in grids]
    n = len(bufs[0]) // 64
    xy = np.stack([gp.xy_bytes_to_limbs(b, n) for b in bufs])
    w, wp = len(bufs), _pow2(len(bufs), GRID_MIN_WAVES)
    if wp != w:
        pad = np.zeros((wp - w, n, 2, fe.LIMBS), dtype=np.int32)
        pad[..., 1, 0] = 1
        xy = np.concatenate([xy, pad])
    return xy


def grid_validate_sum(grids: Sequence, device: Device = None
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Whole-wave commitment-grid validation + pointwise sum — the
    device `ed25519_xy_accum`. `grids`: W buffers of n packed 64-byte
    affine (x, y) pairs (bytes or uint8 arrays of any shape totalling
    n·64 bytes). Returns (ok mask [W] bool, summed [n, 4, 16] int64 over
    the VALID grids — None when none are valid).

    Verdict parity with the CPU loaders is exact: a grid is ok iff every
    cell has canonical (< p) coordinates AND lies on the curve (subgroup
    NOT checked — callers fold the cofactor 8 into verification scalars,
    exactly like the native plane). With `BISCOTTI_PALLAS_CRYPTO=1` the
    on-curve mask of every padded cell also comes from kernel B2, which
    must agree with the host oracle `_cell_canonical_mask` (a disagreement
    raises); the sum stays on this path either way."""
    dev = resolve_device(device)
    w = len(grids)
    if w == 0:
        return np.zeros(0, dtype=bool), None
    with timed("grid_validate"):
        xy = wave_cells(grids)
        wp, n = xy.shape[:2]
        xy_dev = torch.from_numpy(xy).to(dev).long()
        grid_ok, summed = cl.grid_sum(xy_dev)
        mask = grid_ok.cpu().numpy()[:w]
        if _use_validate_kernel():
            # kernel B2's on-curve mask must agree with the host oracle's
            # verdict; a disagreement is a kernel bug and fails loudly
            # rather than splitting verdicts
            from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv

            km = cv.oncurve_mask(xy_dev.reshape(wp * n, 2, fe.LIMBS))
            km = km.cpu().numpy().reshape(wp, n)[:w]
            canon, full = _cell_canonical_mask(xy[:w])
            if not np.array_equal(km & canon, full):
                raise RuntimeError(
                    "kernel B2's on-curve mask disagrees with the host "
                    "oracle's verdict")
        if not mask.any():
            return mask, None
        summed_np = summed.cpu().numpy()
    return mask, summed_np


def _cell_canonical_mask(xy: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side per-cell (canonicity, canonicity AND on-curve) masks of
    [w, n, 2, 16] wire limbs (each in [0, 2¹⁶)) — the python-int
    cross-check oracle of kernel B2. Each coordinate becomes its int
    through its 32 little-endian bytes."""
    w, n = xy.shape[0], xy.shape[1]
    limbs = np.asarray(xy)
    if limbs.min(initial=0) < 0 or limbs.max(initial=0) > fe.MASK:
        raise ValueError("_cell_canonical_mask takes wire limbs in [0, 2^16)")
    blob = limbs.astype("<u2").tobytes()
    canon = np.zeros(w * n, dtype=bool)
    full = np.zeros(w * n, dtype=bool)
    p, d = fe.P, ed.D
    for c in range(w * n):
        x = int.from_bytes(blob[64 * c: 64 * c + 32], "little")
        y = int.from_bytes(blob[64 * c + 32: 64 * c + 64], "little")
        ok = x < p and y < p
        canon[c] = ok
        full[c] = ok and (y * y - x * x - 1 - d * x * x * y * y) % p == 0
    return canon.reshape(w, n), full.reshape(w, n)


def ext_add(acc: np.ndarray, other: np.ndarray, device: Device = None
            ) -> np.ndarray:
    """Pointwise acc[i] += other[i] over two [n, 4, 16] limb batches —
    the accumulator fold of the incremental VSS intake."""
    dev = resolve_device(device)
    with timed("ext_add"):
        return cl.point_add(_on(np.asarray(acc, np.int64), dev),
                            _on(np.asarray(other, np.int64), dev)
                            ).cpu().numpy()


def shamir_recover(pinv: np.ndarray, agg: np.ndarray, device: Device = None
                   ) -> np.ndarray:
    """[k, S] Vandermonde pseudoinverse × [S, C] aggregated shares on
    `device`, rounded → [C, k] int64 chunk coefficients (the
    `ss.recover_coeffs` tail)."""
    dev = resolve_device(device)
    with timed("shamir_recover"):
        p = torch.from_numpy(np.asarray(pinv, np.float64)).to(dev)
        s = torch.from_numpy(np.asarray(agg, np.int64)).to(dev)
        sol = torch.round(p @ s.to(torch.float64)).to(torch.int64)
        sol = sol.cpu().numpy()
    return np.ascontiguousarray(sol.T)


def prewarm(grid_points: int = 0) -> None:
    """Pay the plane's one-time costs at peer start-up instead of inside
    a round deadline: on the armed device, build kernels B2's and B3's
    libraries (on the GPU), derive the fixed-base tables and run each ladder once at
    the grid width (`grid_points` = C·k), all under
    `instrument.suppressed()` so the warm-up never shows in the round-work
    readouts. A no-op while the plane is disarmed; a failure raises."""
    from biscotti_tpu_torch.crypto import kernels
    from biscotti_tpu_torch.crypto.kernels import instrument

    dev = kernels.armed_device()
    if dev is None:
        return
    with instrument.suppressed():
        if dev.type == "cuda":
            from biscotti_tpu_torch import _build

            _build.load("oncurve")
            _build.load("ed25519_ladder")
        fixed_base_mult([1], device=dev)
        pedersen_commit_point(1, 1, device=dev)
        n = max(1, int(grid_points))
        msm([1] * n, [ed.BASE] * n, device=dev)
        if grid_points:
            ident = np.zeros((n, 64), np.uint8)
            ident[:, 32] = 1  # affine identity (0, 1): on-curve
            grid_validate_sum([ident], device=dev)


def _use_validate_kernel() -> bool:
    """The reference's switch, with its name and meaning:
    BISCOTTI_PALLAS_CRYPTO=1 runs the on-curve mask through kernel B2 as
    well and holds it against the host oracle (off by default)."""
    return os.environ.get("BISCOTTI_PALLAS_CRYPTO", "") == "1"


__all__ = [
    "msm", "fixed_base_mult", "pedersen_commit_point",
    "grid_validate_sum", "ext_add", "shamir_recover", "point_neg_limbs",
    "prewarm",
]
