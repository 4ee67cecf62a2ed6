"""Port the device crypto plane (biscotti_tpu_torch/crypto) against the JAX
reference (biscotti_tpu/crypto/kernels) and the python-int oracles.

The same numpy inputs (seeded 256-bit ints and the carry-overflow edges of
tests/test_crypto_kernels.py:102-103) go through the reference's eager jnp
functions, its jitted entry points, its Pallas kernel in interpret mode, and
the port on the CPU (`device="cpu"`). The tolerance is exact everywhere: the
port follows the reference formula for formula and carry for carry, so loose
limb tensors are equal bit for bit, not just mod p; masks and points are
equal; `shamir_recover` is exact after rounding.

Cost: each jitted reference entry point compiles once per bucket shape (msm
at its 32-lane floor, fixed-base at 8 and 1 lanes, one grid shape), and the
Pallas kernel runs once, on the edge set. Kernel B3's plain versions (the
port's `cuda_ladder.py`, what its CUDA kernels are held to on the card) are
held to those same compiled programs, limb for limb.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from biscotti_tpu.crypto import commitments as rcm
from biscotti_tpu.crypto import ed25519 as red
from biscotti_tpu.crypto.kernels import field as rfe
from biscotti_tpu.crypto.kernels import group as rgp
from biscotti_tpu.crypto.kernels import pallas_validate as rpv
from biscotti_tpu.crypto.kernels import primitives as rprim
from biscotti_tpu.ops import secretshare as ss
from biscotti_tpu_torch.crypto import commitments as cm
from biscotti_tpu_torch.crypto import ed25519 as ed
from biscotti_tpu_torch.crypto import kernels
from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
from biscotti_tpu_torch.crypto.kernels.cells import (EDGE_FIELD, edge_cells,
                                                     ladder_lanes,
                                                     random_cells, raw_limbs,
                                                     wire_grids)
from biscotti_tpu_torch.crypto.kernels import field as fe
from biscotti_tpu_torch.crypto.kernels import group as gp
from biscotti_tpu_torch.crypto.kernels import instrument
from biscotti_tpu_torch.crypto.kernels import primitives as prim

EDGE_SCALARS = [0, 1, ed.Q - 1, 2**256 - 1]  # tests/test_crypto_kernels.py:103
TORSION2 = (0, ed.P - 1, 1, 0)  # (0, −1): order 2, on the curve


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got: torch.Tensor, ref) -> bool:
    ref = np.asarray(ref)
    return got.numpy().dtype.kind == ref.dtype.kind \
        and np.array_equal(got.numpy(), ref)


def _field_inputs():
    """[32, 16] int64: 16 raw 32-byte values (edges + seeded), then 16
    loose elements (limbs < 2¹⁷, uncarried sums of two raw rows)."""
    rng = np.random.default_rng(7)
    vals = EDGE_FIELD + [int.from_bytes(rng.bytes(32), "little")
                         for _ in range(16 - len(EDGE_FIELD))]
    raw = raw_limbs(vals)
    loose = raw + raw[::-1]
    assert loose.max() >= 1 << 16  # really loose
    return np.concatenate([raw, loose])


# ------------------------------------------------------------- field


@pytest.mark.parametrize("op", ["fmul", "fadd", "fsub", "eq"])
def test_field_binary_ops_bit_equal(op):
    x = _field_inputs()
    a, b = x, np.roll(x, 5, axis=0)
    ref = getattr(rfe, op)(jnp.asarray(a), jnp.asarray(b))
    assert _same(getattr(fe, op)(_t(a), _t(b)), ref)


@pytest.mark.parametrize("op", ["carry", "carry_seq", "canonical", "lt_p",
                                "is_zero"])
def test_field_unary_ops_bit_equal(op):
    x = _field_inputs()
    if op in ("carry", "carry_seq"):
        # a post-multiply magnitude and a transiently negative subtraction
        x = np.concatenate([x * 4099 + np.roll(x, 1, axis=0),
                            x - np.roll(x, 2, axis=0)])
    ref = getattr(rfe, op)(jnp.asarray(x))
    assert _same(getattr(fe, op)(_t(x)), ref)


def test_field_ops_match_int_oracle_and_stay_loose():
    x = _field_inputs()[:16]
    ints = [fe.limbs_to_int(r) for r in x]
    a, b = _t(x), _t(np.roll(x, 3, axis=0))
    bi = ints[-3:] + ints[:-3]
    for got, want in ((fe.fmul(a, b), [u * v for u, v in zip(ints, bi)]),
                      (fe.fadd(a, b), [u + v for u, v in zip(ints, bi)]),
                      (fe.fsub(a, b), [u - v for u, v in zip(ints, bi)])):
        assert int(got.max()) < 1 << 17
        can = fe.canonical(got).numpy()
        assert [fe.limbs_to_int(r) for r in can] == [w % ed.P for w in want]
    # deep chain, as the reference's loose-invariant property
    mid = fe.fmul(fe.fsub(fe.fmul(a, b), a), fe.fadd(a, b))
    out = fe.canonical(fe.fmul(mid, mid)).numpy()
    assert int(mid.max()) < 1 << 17
    assert [fe.limbs_to_int(r) for r in out] == [
        pow((u * v - u) * (u + v) % ed.P, 2, ed.P) for u, v in zip(ints, bi)]


@pytest.mark.parametrize("name", ["P_LIMBS", "EIGHT_P", "D_LIMBS", "D2_LIMBS",
                                  "ONE_LIMBS", "ZERO_LIMBS"])
def test_field_constants_equal_reference(name):
    assert np.array_equal(getattr(fe, name), getattr(rfe, name))
    assert _same(fe.const(name, torch.device("cpu")),
                 getattr(rfe, name).astype(np.int64))


def test_field_host_helpers_equal_reference():
    vals = EDGE_FIELD + [12345, ed.D]
    assert np.array_equal(fe.int_to_limbs(ed.P - 1), rfe.int_to_limbs(ed.P - 1))
    assert np.array_equal(fe.ints_to_limbs(vals), rfe.ints_to_limbs(vals))
    arr = np.full(16, 0x1FFFF, np.int64)  # loose magnitudes
    assert fe.limbs_to_int(arr) == rfe.limbs_to_int(arr)
    buf = b"".join(v.to_bytes(32, "little") for v in (0, ed.P, 2**256 - 1))
    assert np.array_equal(fe.bytes_to_limbs(buf, 3), rfe.bytes_to_limbs(buf, 3))
    for msb in (True, False):
        assert np.array_equal(fe.scalars_to_bits(EDGE_SCALARS, msb_first=msb),
                              rfe.scalars_to_bits(EDGE_SCALARS, msb_first=msb))


# ------------------------------------------------------------- group


def _point_inputs():
    """[8, 4, 16] int64 points: subgroup points, the torsion point, the
    identity, a torsioned point, and two loose sums."""
    pts = [ed.base_mult(k) for k in (1, 2, 9, 12345)]
    pts += [TORSION2, ed.IDENTITY, ed.point_add(ed.base_mult(9), TORSION2)]
    limbs = gp.points_to_limbs(pts).astype(np.int64)
    loose = np.asarray(rgp.point_add(jnp.asarray(limbs[:1]),
                                     jnp.asarray(limbs[1:2])))
    return np.concatenate([limbs, loose])


@pytest.mark.parametrize("op", ["point_add", "point_double", "select",
                                "tree_sum"])
def test_group_ops_bit_equal(op):
    p = _point_inputs()
    q = np.roll(p, 3, axis=0)
    mask = np.array([True, False] * 4)
    if op == "point_add":
        got, ref = gp.point_add(_t(p), _t(q)), rgp.point_add(p, q)
    elif op == "point_double":
        got, ref = gp.point_double(_t(p)), rgp.point_double(p)
    elif op == "select":
        got = gp.select(_t(mask), _t(p), _t(q))
        ref = rgp.select(jnp.asarray(mask), p, q)
    else:
        got, ref = gp.tree_sum(_t(p)), rgp.tree_sum(jnp.asarray(p))
        want = red.IDENTITY
        for i in range(len(p)):
            want = red.point_add(want, rgp.limbs_to_point(p[i]))
        assert ed.point_equal(gp.limbs_to_point(got.numpy()), want)
    assert _same(got, ref)


def test_on_curve_bit_equal_and_oracle():
    cells = np.concatenate([edge_cells(), random_cells(64, seed=2)])
    x, y = cells[:, 0], cells[:, 1]
    got = gp.on_curve(_t(x), _t(y))
    assert _same(got, rgp.on_curve(jnp.asarray(x), jnp.asarray(y)))
    want = [(yi * yi - xi * xi - 1 - ed.D * xi * xi * yi * yi) % ed.P == 0
            for xi, yi in ((fe.limbs_to_int(c[0]), fe.limbs_to_int(c[1]))
                           for c in cells)]
    assert got.tolist() == want


def test_group_host_conversions_equal_reference():
    pts = [ed.base_mult(3), TORSION2, ed.IDENTITY]
    assert np.array_equal(gp.points_to_limbs(pts), rgp.points_to_limbs(pts))
    assert np.array_equal(gp.identity((2, 3)), rgp.identity((2, 3)))
    assert np.array_equal(gp.IDENTITY_LIMBS, rgp.IDENTITY_LIMBS)
    assert _same(gp.identity_on((2,), torch.device("cpu")), rgp.identity((2,)))
    ext = gp.points_to_limbs(pts).astype("<u2").tobytes()
    assert np.array_equal(gp.ext_bytes_to_limbs(ext, 3),
                          rgp.ext_bytes_to_limbs(ext, 3))
    xy = rcm.batch_pedersen_commit_xy([1, 2], [3, 4])
    assert np.array_equal(gp.xy_bytes_to_limbs(xy, 2),
                          rgp.xy_bytes_to_limbs(xy, 2))
    loose = _point_inputs()[-1]
    assert gp.limbs_to_point(loose) == rgp.limbs_to_point(loose)


# ------------------------------------------------------- hot entry points


@pytest.mark.parametrize("case", ["edges", "seeded"])
def test_msm_matches_reference_and_oracle(case):
    if case == "edges":
        scalars = EDGE_SCALARS + [-5, 7, 2**128 - 1]
    else:
        rng = np.random.default_rng(11)
        scalars = [int.from_bytes(rng.bytes(32), "little") for _ in range(9)]
    points = [ed.scalar_mult(i + 2, ed.BASE) for i in range(len(scalars))]
    points[-1] = ed.point_add(points[-1], TORSION2)
    got = prim.msm(scalars, points, device="cpu")
    assert got == rprim.msm(scalars, points)  # identical limbs, reduced
    assert ed.point_equal(got, cm._msm_python(scalars, points))
    # the limb-array form of the points (a device accumulator) agrees
    limbs = gp.points_to_limbs(points).astype(np.int64)
    assert prim.msm(scalars, limbs, device="cpu") == got


@pytest.mark.parametrize("s", [ed.Q - 2, ed.Q // 2 + 3, 5, ed.Q - 1])
def test_msm_torsion_parity_with_reference_and_oracle(s):
    """s·P and (q−s)·(−P) differ by q·P ≠ identity on a torsioned point,
    so the port must mirror _msm_python's top-half fold exactly."""
    pt = ed.point_add(ed.base_mult(9), TORSION2)
    got = prim.msm([s], [pt], device="cpu")
    assert got == rprim.msm([s], [pt])
    assert ed.point_equal(got, cm._msm_python([s], [pt]))


def test_msm_empty_and_all_zero():
    assert prim.msm([], [], device="cpu") == ed.IDENTITY == rprim.msm([], [])
    pts = [ed.BASE, ed.point_double(ed.BASE)]
    assert ed.is_identity(prim.msm([0, 0], pts, device="cpu"))


@pytest.mark.parametrize("which", ["B", "H"])
def test_fixed_base_matches_reference_and_oracle(which):
    scalars = EDGE_SCALARS + [12345]
    got = prim.fixed_base_mult(scalars, which, device="cpu")
    assert got == rprim.fixed_base_mult(scalars, which)
    base = ed.BASE if which == "B" else cm.H_POINT
    for k, p in zip(scalars, got):
        assert ed.point_equal(p, ed.scalar_mult(k % ed.Q, base))
    assert np.array_equal(prim._fixed_table(which), rprim._fixed_table(which))


def test_pedersen_commit_point_matches_reference_and_oracle():
    got = prim.pedersen_commit_point(777, ed.Q + 888, device="cpu")
    assert got == rprim.pedersen_commit_point(777, ed.Q + 888)
    assert ed.point_equal(got, ed.point_add(ed.base_mult(777),
                                            ed.scalar_mult(888, cm.H_POINT)))


def test_point_neg_limbs_and_ext_add_equal_reference():
    p = _point_inputs()
    assert np.array_equal(prim.point_neg_limbs(p), rprim.point_neg_limbs(p))
    neg = prim.point_neg_limbs(p)
    for i in range(len(p)):
        assert ed.point_equal(gp.limbs_to_point(neg[i]),
                              ed.point_neg(gp.limbs_to_point(p[i])))
    q = np.roll(p, 1, axis=0)
    got = prim.ext_add(p, q, device="cpu")
    assert got.dtype == np.int64 and np.array_equal(got, rprim.ext_add(p, q))


def _good_grid(seed):
    raw = rcm.batch_pedersen_commit_xy([seed * 7 + i for i in range(3)],
                                       [seed * 11 + i for i in range(3)])
    return np.frombuffer(raw, np.uint8).reshape(3, 64).copy()


def _wave(case):
    g1, g2 = _good_grid(1), _good_grid(2)
    bad = g1.copy()
    bad[1, 0] ^= 1  # off-curve bit flip
    nc = g1.copy()  # non-canonical x + p
    x0 = int.from_bytes(bytes(nc[0, :32]), "little")
    nc[0, :32] = np.frombuffer((x0 + ed.P).to_bytes(32, "little"), np.uint8)
    return {"good": [g1, g2], "off_curve": [bad, g2],
            "non_canonical": [nc, g2, g1], "all_bad": [bad]}[case]


GRID_CASES = ["good", "off_curve", "non_canonical", "all_bad"]


def _check_grid_against_reference(wave, switch_on=None):
    """The port's verdicts and sums equal the reference's (computed with
    the switch off) and the CPU loader's. Given a monkeypatch as
    `switch_on`, the port's call runs with the B2 switch on."""
    rmask, rsummed = rprim.grid_validate_sum(wave)
    if switch_on is not None:
        switch_on.setenv("BISCOTTI_PALLAS_CRYPTO", "1")
    mask, summed = prim.grid_validate_sum(wave, device="cpu")
    assert mask.tolist() == rmask.tolist()
    loader = [all(cm._xy_to_point(bytes(g.reshape(-1, 64)[i])) is not None
                  for i in range(3)) for g in wave]
    assert mask.tolist() == loader
    if rsummed is None:
        assert summed is None
    else:
        assert summed.dtype == np.int64 and np.array_equal(summed, rsummed)
    return mask, summed


@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_validate_sum_matches_reference(case):
    _check_grid_against_reference(_wave(case))


@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_validate_sum_with_validate_kernel_switch(case, monkeypatch):
    """BISCOTTI_PALLAS_CRYPTO=1 consults the B2 wrapper once per call (on
    the CPU it computes the plain version) and holds it against the host
    oracle; the verdicts and sums stay the reference's."""
    consulted = []

    def spy(xy, device=None):
        consulted.append(tuple(xy.shape))
        return real(xy, device)

    real = cv.oncurve_mask
    monkeypatch.setattr(cv, "oncurve_mask", spy)
    _check_grid_against_reference(_wave(case), switch_on=monkeypatch)
    assert consulted == [(4 * 3, 2, 16)]  # every padded cell, once


def test_validate_kernel_disagreement_raises(monkeypatch):
    monkeypatch.setattr(cv, "oncurve_mask",
                        lambda xy, device=None: torch.ones(len(xy), dtype=torch.bool))
    monkeypatch.setenv("BISCOTTI_PALLAS_CRYPTO", "1")
    with pytest.raises(RuntimeError, match="disagrees"):
        prim.grid_validate_sum(_wave("off_curve"), device="cpu")


def test_oncurve_mask_plain_matches_reference_pallas_kernel():
    cells = edge_cells()
    ref = rpv.oncurve_mask(cells)  # interpret mode off the TPU
    assert _same(cv.oncurve_mask_plain(_t(cells)), ref)
    before = cv.oncurve_mask.launches
    got = cv.oncurve_mask(_t(cells))  # a CPU tensor: the plain version
    assert isinstance(got, torch.Tensor) and _same(got, ref)
    np_got = cv.oncurve_mask(cells, device="cpu")
    assert isinstance(np_got, np.ndarray) and np.array_equal(np_got, ref)
    assert cv.oncurve_mask.launches == before
    assert cv.oncurve_mask(cells[:0], device="cpu").shape == (0,)


@pytest.mark.parametrize("limb", [-1, 1 << 17, 1 << 32])
def test_oncurve_mask_rejects_limbs_outside_its_contract(limb):
    cells = edge_cells()
    cells[:, :, 0] = (1 << 17) - 1  # the largest limb in contract passes
    assert cv.oncurve_mask(cells, device="cpu").shape == (len(cells),)
    cells[3, 1, 5] = limb
    with pytest.raises(ValueError, match="limbs in"):
        cv.oncurve_mask(cells, device="cpu")
    with pytest.raises(ValueError, match="limbs in"):
        cv.oncurve_mask(_t(cells))


def test_cell_canonical_mask_equals_reference():
    cells = np.concatenate([edge_cells()[:48], random_cells(12, seed=9)])
    xy = cells.reshape(6, 10, 2, 16)
    got, ref = prim._cell_canonical_mask(xy), rprim._cell_canonical_mask(xy)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    with pytest.raises(ValueError):
        prim._cell_canonical_mask(xy + (1 << 16))


@pytest.mark.parametrize("seed", [0, 1])
def test_shamir_recover_matches_reference(seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-10**6, 10**6, 40).astype(np.int64)
    sh = ss.make_shares(q, 10, 20)
    xs = np.asarray(ss.share_xs(20))
    pinv = ss._vandermonde_pinv(tuple(int(x) for x in xs), 10)
    got = prim.shamir_recover(pinv, sh, device="cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, rprim.shamir_recover(pinv, sh))
    assert np.array_equal(got, ss.recover_coeffs(sh, xs, 10))


# --------------------------------------- kernel B3's plain versions, wrappers


def _ref_program(key, builder):
    """The reference's jitted program at `key`, compiled once per process
    (the entry-point tests above share the same bucket shapes)."""
    return rprim._get(key, builder)


def _msm_case(case):
    """(MSB-first bits [32, 256], points [32, 4, 16]) as msm hands them to
    the ladder: normalized by `_norm_scalar_point`, padded to 32 lanes
    with the identity and zero scalars."""
    if case == "lanes":
        scalars, limbs = ladder_lanes(32, seed=3)
    elif case == "identity_padding":
        scalars, limbs = ladder_lanes(20, seed=4)
    else:  # zero scalars: every add skipped
        scalars, limbs = [0] * 32, ladder_lanes(32, seed=5)[1]
    bits, pts = prim._norm_scalar_point(scalars, limbs)
    pad = 32 - len(bits)
    bits = np.concatenate([bits, np.zeros((pad, 256), bits.dtype)])
    pts = np.concatenate([pts, gp.identity((pad,))])
    return bits, pts


@pytest.mark.parametrize("case", ["lanes", "identity_padding", "zero_scalars"])
def test_plain_msm_ladder_equals_reference_program(case):
    bits, pts = _msm_case(case)
    ref = _ref_program(("msm", 32), lambda: rprim._build_msm(32))
    want = ref(bits.astype(np.int32), pts)
    lanes = cl.msm_ladder(_t(cl.pack_bits(bits)), _t(pts))
    assert _same(cl.tree_sum(lanes), want)
    if case == "lanes":
        # lane 0 is the identity under q − 1, so it is negated, and its
        # fsub(Y, X) reaches the −1 limb that needs signed limbs; fmul
        # carries such a limb on (why the wrappers take negative limbs)
        assert np.array_equal(pts[0], prim.point_neg_limbs(gp.identity((1,)))[0])
        s = fe.fsub(_t(pts[0, 1]), _t(pts[0, 0]))
        assert int(s.min()) == -1 and int(fe.fmul(s, s).min()) == -1
    if case == "zero_scalars":  # doubled identities: loose limbs, identity
        assert all(ed.is_identity(gp.limbs_to_point(p)) for p in lanes.numpy())


@pytest.mark.parametrize("which", ["B", "H", "BH"])
def test_plain_fixed_walk_equals_reference_program(which):
    rng = np.random.default_rng(len(which))
    m = 8 if len(which) == 1 else 1
    scalars = EDGE_SCALARS[:2] + [int.from_bytes(rng.bytes(32), "little")
                                  for _ in range(m * len(which) - 2)]
    bits = np.concatenate(
        [fe.scalars_to_bits([s % ed.Q for s in scalars[i::m]], msb_first=False)
         .reshape(1, -1) for i in range(m)])  # [m, 256 · len(which)]
    table = np.concatenate([prim._fixed_table(w) for w in which])
    ref = _ref_program(("fixed", m), lambda: rprim._build_fixed(m))
    got = cl.fixed_walk(_t(cl.pack_bits(bits)), _t(table))
    assert _same(got, ref(bits.astype(np.int32), table))


def _grid_case(case):
    if case == "wire_grids":
        return wire_grids(4, 3, seed=6)
    xy = np.stack([gp.xy_bytes_to_limbs(bytes(g), 3)
                   for g in _wave(case)]).astype(np.int64)
    pad = np.zeros((4 - len(xy), 3, 2, 16), np.int64)
    pad[..., 1, 0] = 1  # the affine identity, as grid_validate_sum pads
    return np.concatenate([xy, pad])


@pytest.mark.parametrize("case", GRID_CASES + ["wire_grids"])
def test_plain_grid_sum_equals_reference_program(case):
    xy = _grid_case(case)
    ref = _ref_program(("grid", 4, 3), lambda: rprim._build_grid(4, 3))
    want_ok, want_sum = ref(xy)
    grid_ok, summed = cl.grid_sum(_t(xy))
    assert _same(grid_ok, want_ok) and _same(summed, want_sum)
    ok, _ = cl.grid_points_plain(_t(xy))  # each cell against the oracle
    assert np.array_equal(ok.numpy(), prim._cell_canonical_mask(xy)[1])
    assert torch.equal(cl.grid_verdicts(_t(xy)), ok)  # grid_sum's B3c


def test_plain_point_add_equals_reference_program():
    p = _point_inputs()
    q = prim.point_neg_limbs(np.roll(p, 3, axis=0))  # limbs up to 2^18 - 4
    ref = _ref_program(("ext_add",), rprim._build_ext_add)
    for a, b in ((p, q), (q, p), (q, q)):
        assert _same(cl.point_add(_t(a), _t(b)), ref(a, b))
    assert _same(cl.tree_sum(_t(q)), rgp.tree_sum(jnp.asarray(q)))


@pytest.mark.parametrize("w,n", [(4, 3), (8, 5), (64, 3)])
def test_plain_column_tree_equals_reference_grid_program(w, n):
    """B3d's grid tree on the CPU: each column of the masked [w, n, 4, 16]
    points summed over the waves, against the reference's ("grid", w, n)
    program and gp.tree_sum of each column (wire_grids: grids 1-3
    invalid, grid 4 the edge cells where w > 4)."""
    xy = wire_grids(w, n, seed=w + n)
    ref = _ref_program(("grid", w, n), lambda: rprim._build_grid(w, n))
    want_ok, want_sum = ref(xy)
    ok, pts = cl.grid_points_plain(_t(xy))
    grid_ok = ok.all(dim=1)
    pts[~grid_ok] = gp.identity_on((), pts.device)
    assert _same(grid_ok, want_ok)
    got = cl.column_tree_plain(pts)
    assert _same(got, want_sum) and _same(cl.column_sum(pts), want_sum)
    assert _same(cl.grid_sum(_t(xy))[1], want_sum)
    for c in range(n):
        assert _same(got[c], rgp.tree_sum(jnp.asarray(pts[:, c].numpy())))


@pytest.mark.parametrize("m,groups", [(256, 64), (512, 64), (8192, 64),
                                      (64, 2), (32, 4), (16, 8)])
def test_tree_plan_is_gp_tree_sums_pairing(m, groups):
    """Launch 1 of a split tree sums each class of members congruent mod
    the partials' count, launch 2 the partials: the same bits as
    gp.tree_sum, in at most two launches whatever the width."""
    plan = cl.tree_plan(m, 1, groups)
    assert len(plan) == (1 if m <= 2 * groups else 2)
    assert all(r <= 2 * groups for r, _ in plan[1:])
    rng = np.random.default_rng(m + groups)
    pts = _t(rng.integers(-(1 << 18), 1 << 18, (m, 4, 16)))
    src = pts[:, None]
    for r, c in plan:
        src = cl.column_tree_plain(src.reshape(r, c, 4, 16))
    assert torch.equal(src[0], gp.tree_sum(pts))
    if m <= 512:  # the CPU path's plain tree gives the same bits
        assert torch.equal(cl.tree_sum(pts), src[0])


def test_tree_plan_launches():
    from biscotti_tpu_torch.tools.ladder_ab import layout

    groups = layout(_build_source_text())["kTreeGroups"]
    for k in range(0, 21):
        assert len(cl.tree_plan(1 << k, 1, groups)) <= 2
    assert len(cl.tree_plan(8192, 1, groups)) == 2
    assert cl.tree_plan(64, 7850, groups) == [(64, 7850)]  # the wave: one


def _build_source_text():
    from biscotti_tpu_torch import _build

    return _build.source("ed25519_ladder").read_text()


def test_pack_bits_round_trips():
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, (5, 512)).astype(np.uint8)
    packed = cl.pack_bits(bits)
    assert packed.dtype == np.int32 and packed.shape == (5, 16)
    assert np.array_equal(cl.unpack_bits(_t(packed)).numpy().T, bits > 0)
    with pytest.raises(ValueError):
        cl.pack_bits(bits[:, :40])


def _wrapper_call(name, pts, bits, table, xy):
    return {"msm_ladder": lambda: cl.msm_ladder(bits, pts),
            "fixed_walk": lambda: cl.fixed_walk(bits[:2], table),
            "point_add": lambda: cl.point_add(pts, pts.flip(0)),
            "tree_sum": lambda: cl.tree_sum(pts[:4]),
            "grid_validate_points": lambda: cl.grid_validate_points(xy),
            "grid_verdicts": lambda: cl.grid_verdicts(xy)}[name]


@pytest.mark.parametrize("name", ["msm_ladder", "fixed_walk", "point_add",
                                  "tree_sum", "grid_validate_points",
                                  "grid_verdicts"])
def test_ladder_wrappers_refuse_limbs_outside_their_range(name):
    """Points in (−2^19, 2^19), wire cells in [0, 2^16), on the CPU as the
    kernel flags them; the edges just inside are computed."""
    pts = _t(_point_inputs())
    bits = _t(cl.pack_bits(np.ones((8, 32), np.uint8)))
    table = _t(prim._fixed_table("B")[:32].copy())  # not the cache
    xy = _t(wire_grids(4, 3, seed=2))
    grid = name in ("grid_validate_points", "grid_verdicts")
    inside = (0, (1 << 16) - 1) if grid else (-1, (1 << 19) - 1)
    outside = (-1, 1 << 16) if grid else (-(1 << 19), 1 << 19)
    target = xy if grid else (table if name == "fixed_walk" else pts)
    at = (1, 2, 1, 3) if grid else (1, 2, 3)
    for limb in inside:
        target[at] = limb
        _wrapper_call(name, pts, bits, table, xy)()
    for limb in outside:
        target[at] = limb
        with pytest.raises(ValueError, match="limbs in"):
            _wrapper_call(name, pts, bits, table, xy)()


@pytest.mark.parametrize("bad", ["dtype", "shape", "not_pow2", "meta",
                                 "bits", "table_rows", "devices"])
def test_ladder_wrappers_refuse_what_they_do_not_take(bad):
    pts = _t(_point_inputs())
    bits = _t(cl.pack_bits(np.ones((8, 32), np.uint8)))
    table = _t(prim._fixed_table("B")[:32].copy())  # not the cache
    with pytest.raises(ValueError):
        if bad == "dtype":
            cl.msm_ladder(bits, pts.to(torch.int32))
        elif bad == "shape":
            cl.point_add(pts[:, :, :8], pts[:, :, :8])
        elif bad == "not_pow2":
            cl.tree_sum(pts[:3])
        elif bad == "meta":
            cl.grid_validate_points(torch.empty((4, 3, 2, 16),
                                                dtype=torch.int64,
                                                device="meta"))
        elif bad == "bits":
            cl.msm_ladder(bits[:5], pts)
        elif bad == "table_rows":
            cl.fixed_walk(bits, table[:31])
        else:
            cl.point_add(pts, pts.to("meta"))


def test_ladder_library_is_named_and_import_builds_nothing():
    from biscotti_tpu_torch import _build

    assert "ed25519_ladder" in _build.KERNELS
    assert _build.source("ed25519_ladder").is_file()
    assert _build.load.cache_info().currsize == 0  # nothing loaded here
    for entry in ("msm_ladder", "fixed_walk", "grid_validate_points",
                  "point_add"):
        assert getattr(cl, entry).launches == 0  # no CUDA tensor on the CPU


# ------------------------------------------------- oracle modules, switch


def test_oracle_modules_equal_reference():
    assert cm.H_POINT == rcm.H_POINT
    assert (ed.P, ed.Q, ed.D, ed.BASE) == (red.P, red.Q, red.D, red.BASE)
    assert ed.hash_to_point(b"x") == red.hash_to_point(b"x")
    pts = [ed.base_mult(k) for k in (3, 4, 5)] + [TORSION2]
    scalars = [ed.Q - 3, 2**200 + 7, -9, 6]
    assert cm._msm_python(scalars, pts) == rcm._msm_python(scalars, pts)
    for cell in edge_cells()[45:60]:
        buf = cell.astype("<u2").tobytes()
        assert cm._xy_to_point(buf) == rcm._xy_to_point(buf)


def test_instrument_counts_each_call():
    instrument.reset_counters()
    p = _point_inputs()
    prim.ext_add(p, p, device="cpu")
    prim.shamir_recover(np.eye(2), np.ones((2, 3), np.int64), device="cpu")
    assert instrument.device_calls() == {"ext_add": 1, "shamir_recover": 1}
    assert instrument.device_seconds()["ext_add"] > 0
    with instrument.suppressed():
        prim.ext_add(p, p, device="cpu")
    assert instrument.device_calls()["ext_add"] == 1
    assert kernels.device_calls is instrument.device_calls


ENTRY_POINTS = {
    "msm": lambda: prim.msm([1], [ed.BASE]),
    "fixed_base_mult": lambda: prim.fixed_base_mult([1]),
    "pedersen_commit_point": lambda: prim.pedersen_commit_point(1, 2),
    "grid_validate_sum": lambda: prim.grid_validate_sum([_good_grid(1)]),
    "ext_add": lambda: prim.ext_add(gp.identity((1,)), gp.identity((1,))),
    "shamir_recover": lambda: prim.shamir_recover(np.eye(1), np.ones((1, 1))),
    "oncurve_mask": lambda: cv.oncurve_mask(edge_cells()),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_without_gpu_raise(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()


def test_arming_switch(monkeypatch):
    """Arming records the device the seams use; with no GPU, arming for the
    GPU raises instead of leaving the plane quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kernels.set_enabled(True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kernels.set_enabled(True, device="cuda")
        assert not kernels.active() and kernels.active_module() is None
        assert kernels.armed_device() is None
        kernels.set_enabled(True, device="cpu")
        assert kernels.active() and kernels.active_module() is kernels
        assert kernels.armed_device() == torch.device("cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        kernels.set_enabled(True)
        assert kernels.armed_device() == torch.device("cuda")
    finally:
        kernels.set_enabled(False)
    assert not kernels.active() and kernels.armed_device() is None


def test_prewarm_on_the_armed_device(monkeypatch):
    """prewarm is a no-op while disarmed; armed, it runs every ladder at
    the grid width outside the round-work counters, and a failure raises
    (the reference swallows it)."""
    instrument.reset_counters()
    kernels.prewarm(8)  # disarmed
    kernels.set_enabled(True, device="cpu")
    try:
        kernels.prewarm(8)
        assert instrument.device_calls() == {}
        assert set(prim._table_cache) == {"B", "H"}

        def fault(*a, **kw):
            raise RuntimeError("backend fault")

        monkeypatch.setattr(prim, "msm", fault)
        with pytest.raises(RuntimeError, match="backend fault"):
            kernels.prewarm(8)
    finally:
        kernels.set_enabled(False)
