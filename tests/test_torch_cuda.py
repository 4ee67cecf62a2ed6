"""The port's CUDA kernels on the card (marker `cuda`; they skip without one).

Run on a machine with a GPU, where JAX is not installed, without the repo's
conftest (which imports JAX):

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py -q

Tolerance: rtol 1e-4 on Krum scores, as tests/test_krum_pallas.py holds the
TPU kernel (the kernel's fp32 Gram and the plain version's matmul sum in
other orders); integer-valued rows are exact on both, bit for bit. The crypto
plane is exact: on-curve masks equal, limb tensors equal bit for bit; its
seams (the VSS intake's triples, the batch verifiers' verdicts,
`recover_update`) are equal armed on the card, armed on the CPU and disarmed.
"""

import numpy as np
import pytest
import torch

from biscotti_tpu_torch.crypto import ed25519 as ed
from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
from biscotti_tpu_torch.crypto.kernels import field as fe
from biscotti_tpu_torch.crypto.kernels import group as gp
from biscotti_tpu_torch.crypto.kernels.cells import (edge_cells, grid_bytes,
                                                     ladder_lanes,
                                                     random_cells, wire_grids)
from biscotti_tpu_torch.crypto.kernels import primitives as prim
from biscotti_tpu_torch.ops import krum_cuda
from biscotti_tpu_torch.ops.krum import (accept_mask, default_num_adversaries,
                                         krum_accept_mask, same_nonfinite)

pytestmark = pytest.mark.cuda

RTOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel_err(a, b):
    return float(((a - b).abs() / (b.abs() + 1e-6)).max())


@pytest.mark.parametrize("n,d", [(5, 3), (8, 16), (100, 64), (130, 50),
                                 (511, 33), (1056, 70), (2000, 257),
                                 (716, 7850), (4096, 7850)])
def test_kernel_matches_plain(dev, n, d):
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, d, generator=gen, device=dev)
    f = default_num_adversaries(n)
    before = krum_cuda.krum_scores_kernel.launches
    got = krum_cuda.krum_scores_kernel(x, f)
    torch.cuda.synchronize()
    assert krum_cuda.krum_scores_kernel.launches == before + 1
    assert _rel_err(got, krum_cuda.krum_scores_plain(x, f)) < RTOL


def test_kernel_duplicate_ties_and_accept_set(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(96, 32, generator=gen, device=dev)
    x[10:40] = x[10]
    f = default_num_adversaries(96)
    ref = krum_cuda.krum_scores_plain(x, f)
    assert _rel_err(krum_cuda.krum_scores_kernel(x, f), ref) < RTOL
    # integer-valued rows: exact distances, exact ties, index order decides
    xi = torch.randint(-3, 4, (600, 24), generator=gen, device=dev).float()
    xi[[7, 3, 500, 0, 9, 250, 1, 100]] = xi[7].clone()
    f = default_num_adversaries(600)
    got = krum_cuda.krum_scores_kernel(xi, f)
    assert torch.equal(got, krum_cuda.krum_scores_plain(xi, f))
    mask = krum_accept_mask(xi, f)
    assert torch.equal(mask.cpu(), krum_accept_mask(xi.cpu(), f))


@pytest.mark.parametrize("n,d", [(716, 7850), (4096, 7850)])
def test_kernel_is_bit_identical_across_calls(dev, n, d):
    # split-K partials sum in a fixed order, with no float atomics: the
    # verifiers of one cluster compute the same accept set
    gen = torch.Generator(device=dev).manual_seed(n + 1)
    x = torch.randn(n, d, generator=gen, device=dev)
    f = default_num_adversaries(n)
    first = krum_cuda.krum_scores_kernel(x, f)
    assert torch.equal(first, krum_cuda.krum_scores_kernel(x, f))


def test_kernel_on_cancellation_heavy_rows(dev):
    # rows that share one large mean: D = sq_i + sq_j - 2G cancels most of
    # its digits, and a Gram whose sums lose bits in one direction (the
    # tensor cores' truncation, even at 3xTF32) is 100x off. fp32 itself
    # barely resolves this accept boundary (the plain version's own error is
    # about the gap), so the kernel must give the plain accept set and be as
    # exact as the plain version against float64 (10 %: two summation orders)
    gen = torch.Generator(device=dev).manual_seed(3)
    n, d = 716, 7850
    x = 0.05 * torch.randn(n, d, generator=gen, device=dev) \
        + torch.randn(1, d, generator=gen, device=dev)
    f = default_num_adversaries(n)
    got = krum_cuda.krum_scores_kernel(x, f)
    ref = krum_cuda.krum_scores_plain(x, f)
    xd = x.double()
    sq = (xd * xd).sum(-1)
    dist = torch.clamp(sq[:, None] + sq[None, :] - 2 * xd @ xd.T, min=0)
    dist.fill_diagonal_(float("inf"))
    truth = torch.sort(dist, dim=-1).values[:, :n - f - 2].sum(-1)
    assert _rel_err(got, ref) < RTOL
    assert _rel_err(got.double(), truth) <= 1.1 * _rel_err(ref.double(), truth)
    order = lambda v: torch.sort(v, stable=True).indices[:n - f]
    assert set(order(got).tolist()) == set(order(ref).tolist())


def test_pad_kernel_copies_x_and_zero_pads(dev):
    # the Gram reads a 16-byte-aligned copy of x: a row at d = 7850 is
    # 31,400 bytes, not a multiple of 16; the padding must be zero
    from biscotti_tpu_torch import _build

    gen = torch.Generator(device=dev).manual_seed(4)
    for n, d in ((130, 50), (716, 7850)):
        x = torch.randn(n, d, generator=gen, device=dev)
        ws = krum_cuda.workspace(n, d, dev)
        ws["xp"].fill_(float("nan"))
        out = torch.empty(n, device=dev)
        rc = krum_cuda.launch(_build.load("krum_scores"), x, (x * x).sum(-1),
                              out, ws, n - default_num_adversaries(n) - 2)
        torch.cuda.synchronize()
        assert rc == 0
        assert ws["xp"].shape == (ws["n_pad"], ws["d_pad"])
        assert torch.equal(ws["xp"][:n, :d], x)
        assert not ws["xp"][n:].any() and not ws["xp"][:, d:].any()
        assert torch.equal(out, krum_cuda.krum_scores_kernel(
            x, default_num_adversaries(n)))


def test_auto_dispatch_window(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    for n, launched in ((krum_cuda.KERNEL_MIN_N - 1, False),
                        (krum_cuda.KERNEL_MIN_N, True),
                        (krum_cuda.KERNEL_MAX_N, True),
                        (krum_cuda.KERNEL_MAX_N + 1, False)):
        x = torch.randn(n, 8, generator=gen, device=dev)
        before = krum_cuda.krum_scores_kernel.launches
        krum_cuda.krum_scores_auto(x, default_num_adversaries(n))
        assert (krum_cuda.krum_scores_kernel.launches > before) == launched, n


def test_kernel_rejects_what_it_does_not_take(dev):
    x = torch.randn(20, 8, device=dev)
    with pytest.raises(ValueError):
        krum_cuda.krum_scores_kernel(x.double(), 10)
    with pytest.raises(ValueError):
        krum_cuda.krum_scores_kernel(x.t(), 4)
    assert not krum_cuda.krum_scores_kernel(x[:4], 2).any()  # k = 0


@pytest.mark.parametrize("case", ["overflow_2e19", "plus_inf", "minus_inf",
                                  "nan_input"])
def test_kernel_on_nonfinite_rows_matches_plain_on_the_cpu(dev, case):
    """ROADMAP C1 at the main path's n = 716: B1 on the card and the plain
    path on the card against the plain path on the CPU (the oracle the CPU
    tests hold to the reference): the same accept set, the same NaN bits
    and infinities, finite scores within RTOL."""
    x = torch.randn(716, 7850, generator=torch.Generator().manual_seed(6))
    row, value = {"overflow_2e19": (2, 2e19), "plus_inf": (2, float("inf")),
                  "minus_inf": (300, float("-inf")),
                  "nan_input": (9, float("nan"))}[case]
    x[row, 5] = value
    f = default_num_adversaries(716)
    oracle = krum_cuda.krum_scores_plain(x, f)
    want = accept_mask(oracle, 716 - f)
    for got in (krum_cuda.krum_scores_kernel(x.to(dev), f),
                krum_cuda.krum_scores_plain(x.to(dev), f)):
        got = got.cpu()
        assert same_nonfinite(got, oracle)
        fin = torch.isfinite(oracle)
        assert _rel_err(got[fin], oracle[fin]) < RTOL
        assert torch.equal(accept_mask(got, 716 - f), want)
    assert torch.equal(krum_accept_mask(x.to(dev), f).cpu(), want)


@pytest.mark.parametrize("case", ["all_subnormal_products", "mixed_scales"])
def test_kernel_on_subnormal_rows_matches_plain_on_the_cpu(dev, case):
    """ROADMAP C2 at n = 716, d = 7850: x1e-20 rows, whose products are all
    subnormal (the reference flushes them: every distance 0, ties to the
    lower index), alone and beside rows at unit scale and at 1e-30
    (subnormal inputs). B1 and the plain path on the card give the CPU
    plain path's scores and accept set."""
    x = torch.randn(716, 7850, generator=torch.Generator().manual_seed(7)) * 1e-20
    if case == "mixed_scales":
        x[::7] *= 1e20
        x[3::11] *= 1e-10
    f = default_num_adversaries(716)
    oracle = krum_cuda.krum_scores_plain(x, f)
    want = accept_mask(oracle, 716 - f)
    if case == "all_subnormal_products":
        assert not oracle.any()
        assert torch.equal(torch.nonzero(want)[:, 0], torch.arange(716 - f))
    for got in (krum_cuda.krum_scores_kernel(x.to(dev), f),
                krum_cuda.krum_scores_plain(x.to(dev), f)):
        got = got.cpu()
        assert torch.equal(got == 0, oracle == 0)
        assert _rel_err(got, oracle) < RTOL
        assert torch.equal(accept_mask(got, 716 - f), want)
    assert torch.equal(krum_accept_mask(x.to(dev), f).cpu(), want)


# ------------------------------------------------ kernel B2, the crypto plane


def _oncurve_against_plain(cells: np.ndarray, dev) -> np.ndarray:
    xy = torch.from_numpy(cells).to(dev)
    before = cv.oncurve_mask.launches
    got = cv.oncurve_mask(xy)
    torch.cuda.synchronize()
    assert cv.oncurve_mask.launches == before + 1
    assert got.device == xy.device and got.dtype == torch.bool
    assert torch.equal(got, cv.oncurve_mask_plain(xy))
    return got.cpu().numpy()


def test_oncurve_kernel_matches_plain_on_edges(dev):
    cells = edge_cells()
    got = _oncurve_against_plain(cells, dev)
    # the valid points, their +p twins, (0, -1) and (0, 1) lie on the curve
    assert got[49:].tolist() == [True, True, True, False, False] * 4 + [True, True]
    # numpy in, numpy out, on the default device
    assert np.array_equal(cv.oncurve_mask(cells), got)


def test_oncurve_kernel_matches_plain_on_100k_cells(dev):
    cells = random_cells(100_000, seed=3)
    valid = edge_cells()[49:69:5]  # four valid points
    cells[::7] = np.resize(valid, cells[::7].shape)
    got = _oncurve_against_plain(cells, dev)
    assert got[::7].all() and got.sum() == len(cells[::7])


def test_oncurve_kernel_rejects_what_it_does_not_take(dev):
    xy = torch.from_numpy(edge_cells()).to(dev)
    with pytest.raises(ValueError):
        cv.oncurve_mask(xy.to(torch.int32))
    with pytest.raises(ValueError):
        cv.oncurve_mask(xy[:, :, :8])
    with pytest.raises(ValueError):
        cv.oncurve_mask(xy.transpose(1, 2).contiguous().transpose(1, 2))
    assert cv.oncurve_mask(xy[:0]).shape == (0,)
    for limb in (-1, 1 << 17, 1 << 32):  # outside [0, 2^17): flagged
        bad = xy.clone()
        bad[3, 1, 5] = limb
        with pytest.raises(ValueError, match="limbs in"):
            cv.oncurve_mask(bad)
    top = xy.clone()
    top[:, :, 0] = (1 << 17) - 1  # the largest limb in contract
    assert torch.equal(cv.oncurve_mask(top), cv.oncurve_mask_plain(top))


def test_plane_card_matches_cpu_bit_for_bit(dev, monkeypatch):
    rng = np.random.default_rng(4)
    n = 40
    a = [int(v) for v in rng.integers(1, 2**62, n)]
    b = [int(v) for v in rng.integers(1, 2**62, n)]
    grid = grid_bytes(a, b, prim.fixed_base_mult)
    assert grid_bytes(a[:3], b[:3], prim.fixed_base_mult,
                      device="cpu").tobytes() == grid[:3].tobytes()
    bad = grid.copy()
    bad[7, 3] ^= 1
    wave = [grid, bad, grid]
    monkeypatch.setenv("BISCOTTI_PALLAS_CRYPTO", "1")
    before = cv.oncurve_mask.launches
    mask, summed = prim.grid_validate_sum(wave)
    assert cv.oncurve_mask.launches == before + 1
    cmask, csummed = prim.grid_validate_sum(wave, device="cpu")
    assert mask.tolist() == cmask.tolist() == [True, False, True]
    assert np.array_equal(summed, csummed)
    acc = prim.ext_add(summed, summed)
    assert np.array_equal(acc, prim.ext_add(summed, summed, device="cpu"))
    gam = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    rhs = prim.msm(gam, acc)
    assert rhs == prim.msm(gam, acc, device="cpu")
    m = 4  # two valid grids, summed twice
    lhs = prim.pedersen_commit_point(m * sum(g * x for g, x in zip(gam, a)),
                                     m * sum(g * y for g, y in zip(gam, b)))
    assert ed.point_equal(lhs, rhs)
    pinv = np.linalg.pinv(np.vander(np.arange(15) - 10, 10, increasing=True)
                          .astype(np.float64))
    coeffs = rng.integers(-1000, 1000, (785, 10))
    agg = np.vander(np.arange(15) - 10, 10, increasing=True) @ coeffs.T
    assert np.array_equal(prim.shamir_recover(pinv, agg), coeffs)


# ------------------------------------------------ kernel B3, the ladders


def _dev_t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _msm_lanes(m, dev):
    scalars, limbs = ladder_lanes(m, seed=m)
    bits, pts = prim._norm_scalar_point(scalars, limbs)
    assert (pts == prim.point_neg_limbs(gp.identity((1,)))[0]).all(
        axis=(1, 2)).any()  # the negated identity: fsub's -1 limb
    return _dev_t(cl.pack_bits(bits), dev), _dev_t(pts, dev)


# lane counts that leave partial groups, warps and blocks of B3a's layout
@pytest.mark.parametrize("m", [1, 3, 32, 100, 8192])
def test_msm_ladder_kernel_matches_plain(dev, m):
    bits, pts = _msm_lanes(m, dev)
    before = cl.msm_ladder.launches
    got = cl.msm_ladder(bits, pts)
    torch.cuda.synchronize()
    assert cl.msm_ladder.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (m, 4, 16)
    assert torch.equal(got, cl.msm_ladder_plain(bits, pts))
    assert torch.equal(cl.msm_ladder(bits, pts), got)  # two calls, same bits


@pytest.mark.parametrize("pattern", ["clear", "set"])
def test_msm_ladder_kernel_every_bit_clear_or_set(dev, pattern):
    bits, pts = _msm_lanes(100, dev)  # lane 0: the negated identity
    bits = torch.full_like(bits, 0 if pattern == "clear" else -1)
    got = cl.msm_ladder(bits, pts)
    assert torch.equal(got, cl.msm_ladder_plain(bits, pts))
    assert torch.equal(cl.msm_ladder(bits, pts), got)


def _walk_lanes(m, steps):
    """(bits [m, steps] 0/1, table [steps, 4, 16]) of seeded scalars."""
    rng = np.random.default_rng(steps + m)
    scalars = [int.from_bytes(rng.bytes(32), "little") % ed.Q
               for _ in range(m * steps // 256)]
    bits = np.concatenate([fe.scalars_to_bits(scalars[i::m], msb_first=False)
                           for i in range(m)]).reshape(m, steps)
    table = np.concatenate([prim._fixed_table(w) for w in "BH"][:steps // 256])
    return bits, table


@pytest.mark.parametrize("m,steps", [(4, 256), (1, 512), (3, 256), (32, 256)])
def test_fixed_walk_kernel_matches_plain(dev, m, steps):
    bits, table = _walk_lanes(m, steps)
    b, t = _dev_t(cl.pack_bits(bits), dev), _dev_t(table, dev)
    before = cl.fixed_walk.launches
    got = cl.fixed_walk(b, t)
    torch.cuda.synchronize()
    assert cl.fixed_walk.launches == before + 1
    assert torch.equal(got, cl.fixed_walk_plain(b, t))
    assert torch.equal(cl.fixed_walk(b, t), got)  # two calls, same bits


def test_ladders_at_the_loose_limb_edges(dev):
    edge = (1 << 19) - 1  # the largest magnitude inside (-2^19, 2^19)
    bits, pts = _msm_lanes(37, dev)
    pts = pts.clone()
    for lane, row, limb, sign in ((2, 0, 0, 1), (2, 1, 15, -1), (9, 2, 7, 1),
                                  (9, 3, 0, -1), (36, 3, 15, 1)):
        pts[lane, row, limb] = sign * edge
    got = cl.msm_ladder(bits, pts)
    assert torch.equal(got, cl.msm_ladder_plain(bits, pts))
    bits, table = _walk_lanes(3, 256)
    for s, (row, limb) in zip((0, 5, 31, 32, 200, 255),
                              ((0, 0), (1, 15), (2, 3), (3, 15), (0, 9),
                               (2, 0))):
        table[s, row, limb] = edge if s % 2 else -edge
        bits[:, s] = 1  # each such row added on every lane
    b, t = _dev_t(cl.pack_bits(bits), dev), _dev_t(table, dev)
    got = cl.fixed_walk(b, t)
    assert torch.equal(got, cl.fixed_walk_plain(b, t))
    assert torch.equal(cl.fixed_walk(b, t), got)


@pytest.mark.parametrize("w,n", [(4, 64), (64, 7850)])
def test_grid_points_kernel_matches_plain(dev, w, n):
    xy = _dev_t(wire_grids(w, n, seed=n), dev)
    before = cl.grid_validate_points.launches
    ok, pts = cl.grid_validate_points(xy)
    torch.cuda.synchronize()
    assert cl.grid_validate_points.launches == before + 1
    want_ok, want_pts = cl.grid_points_plain(xy)
    assert torch.equal(ok, want_ok) and torch.equal(pts, want_pts)
    grid_ok = ok.all(dim=1).tolist()
    assert grid_ok[:4] == [True, False, False, False]
    before = cl.grid_validate_points.launches
    assert torch.equal(cl.grid_verdicts(xy), want_ok)  # grid_sum's instance
    assert cl.grid_validate_points.launches == before + 1
    grid_ok_sum, summed = cl.grid_sum(xy)
    assert grid_ok_sum.tolist() == grid_ok
    assert torch.equal(summed.cpu(), cl.grid_sum(xy.cpu())[1])


def test_point_add_kernel_and_tree_sum_match_plain(dev):
    _, pts = _msm_lanes(8192, dev)
    before = cl.point_add.launches
    got = cl.point_add(pts[:4096], pts[4096:])
    assert torch.equal(got, cl.point_add_plain(pts[:4096], pts[4096:]))
    assert cl.point_add.launches == before + 1
    lanes = cl.msm_ladder(*_msm_lanes(8192, dev))
    want = lanes
    while len(want) > 1:
        want = cl.point_add_plain(want[:len(want) // 2], want[len(want) // 2:])
    before = cl.point_add.launches
    total = cl.tree_sum(lanes)
    assert cl.point_add.launches <= before + 2  # 13 levels in two launches
    assert torch.equal(total, want[0])
    assert torch.equal(total.cpu(), cl.tree_sum(lanes.cpu()))


# a tree a block reaches (one launch), and ones split in two
@pytest.mark.parametrize("m", [2, 32, 256, 1024, 8192])
def test_tree_sum_kernel_matches_plain_in_at_most_two_launches(dev, m):
    _, pts = _msm_lanes(m, dev)
    before = cl.point_add.launches
    total = cl.tree_sum(pts)
    torch.cuda.synchronize()
    launches = cl.point_add.launches - before
    from biscotti_tpu_torch import _build

    groups = _build.load("ed25519_ladder").ed25519_tree_groups()
    assert launches == len(cl.tree_plan(m, 1, groups)) <= 2
    assert torch.equal(total, gp.tree_sum(pts))
    assert torch.equal(cl.tree_sum(pts), total)  # two calls, same bits


@pytest.mark.parametrize("invalid", ["first", "last", "all"])
def test_grid_sum_kernel_with_invalid_grids(dev, invalid):
    xy = _dev_t(wire_grids(64, 7850, seed=9), dev)  # grids 1-4 invalid
    valid = xy[:1].expand(64, -1, -1, -1)
    if invalid == "first":
        xy = torch.cat([xy[1:2], valid[1:]])
    elif invalid == "last":
        xy = torch.cat([valid[1:], xy[1:2]])
    else:
        xy = xy[1:5].repeat(16, 1, 1, 1)
    xy = xy.contiguous()
    before = (cl.grid_validate_points.launches, cl.point_add.launches)
    grid_ok, summed = cl.grid_sum(xy)
    torch.cuda.synchronize()
    assert (cl.grid_validate_points.launches - before[0],
            cl.point_add.launches - before[1]) == (1, 1)  # B3c, one tree
    want = {"first": [False] + [True] * 63, "last": [True] * 63 + [False],
            "all": [False] * 64}[invalid]
    assert grid_ok.tolist() == want
    want_ok, want_sum = cl.grid_sum(xy.cpu())
    assert torch.equal(grid_ok.cpu(), want_ok)
    assert torch.equal(summed.cpu(), want_sum)


def test_point_add_at_the_loose_limb_edges(dev):
    edge = (1 << 19) - 1
    _, a = _msm_lanes(7850, dev)
    b = a.flip(0).contiguous()
    a = a.clone()
    for lane, row, limb, sign in ((0, 0, 0, 1), (7, 1, 15, -1),
                                  (1000, 2, 7, 1), (7849, 3, 0, -1),
                                  (4096, 0, 15, -1)):
        a[lane, row, limb] = sign * edge
        b[lane, 3 - row, 15 - limb] = -sign * edge
    got = cl.point_add(a, b)
    assert torch.equal(got, cl.point_add_plain(a, b))
    assert torch.equal(cl.point_add(a, b), got)
    pts = torch.cat([a, b])[:8192]
    assert torch.equal(cl.tree_sum(pts), gp.tree_sum(pts))


def test_ladder_kernels_are_deterministic_and_refuse_what_they_do_not_take(dev):
    bits, pts = _msm_lanes(32, dev)
    assert torch.equal(cl.msm_ladder(bits, pts), cl.msm_ladder(bits, pts))
    xy = _dev_t(wire_grids(4, 64, seed=1), dev)
    a, b = cl.grid_validate_points(xy), cl.grid_validate_points(xy)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    table = _dev_t(prim._fixed_table("B"), dev)
    assert torch.equal(cl.fixed_walk(bits[:4], table),
                       cl.fixed_walk(bits[:4], table))
    for limb in (-(1 << 19), 1 << 19, 1 << 40):  # outside (-2^19, 2^19)
        bad = pts.clone()
        bad[5, 2, 7] = limb
        with pytest.raises(ValueError, match="outside"):
            cl.msm_ladder(bits, bad)
        with pytest.raises(ValueError, match="outside"):
            cl.point_add(pts, bad)
        with pytest.raises(ValueError, match="outside"):
            cl.tree_sum(bad)
        bad_table = table.clone()
        bad_table[200, 3, 0] = limb
        with pytest.raises(ValueError, match="outside"):
            cl.fixed_walk(bits[:4], bad_table)
    for limb in (-1, 1 << 16):  # outside [0, 2^16)
        bad = xy.clone()
        bad[2, 9, 1, 4] = limb
        with pytest.raises(ValueError, match="outside"):
            cl.grid_validate_points(bad)
    edge = pts.clone()
    edge[5, 2, 7], edge[6, 0, 0] = (1 << 19) - 1, -1  # inside: computed
    assert torch.equal(cl.point_add(edge, pts), cl.point_add_plain(edge, pts))
    with pytest.raises(ValueError):
        cl.msm_ladder(bits, pts.to(torch.int32))
    with pytest.raises(ValueError):
        cl.point_add(pts.transpose(0, 1).contiguous().transpose(0, 1), pts)
    with pytest.raises(ValueError):
        cl.tree_sum(pts[:3])
    with pytest.raises(ValueError, match="contiguous"):  # every other row
        cl.column_sum(pts[:8].reshape(2, 4, 4, 16).transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        cl.grid_sum(xy[:4].transpose(0, 1))


# --------------------------------- slice 3: CNNs and defenses on the card


def test_cnn_step_card_matches_cpu(dev):
    from biscotti_tpu_torch.models.base import fp32_math
    from biscotti_tpu_torch.models.trainer import local_step_fn
    from biscotti_tpu_torch.models.zoo import MODELS

    for family, dataset in (("mnist_cnn", "mnist"), ("cifar_cnn", "cifar"),
                            ("lfw_cnn", "lfw")):
        model = MODELS[family](dataset)
        w = model.flat_init(torch.Generator().manual_seed(1))
        gen = torch.Generator().manual_seed(2)
        x = torch.randn(4, 10, model.d_in, generator=gen)
        y = torch.randint(0, model.n_classes, (4, 10), generator=gen)
        step = torch.func.vmap(local_step_fn(model, "grad"), in_dims=(None, 0, 0))
        with fp32_math():
            got = step(w.to(dev), x.to(dev), y.to(dev)).cpu()
        ref = step(w, x, y)
        scale = float(ref.abs().max())
        assert torch.allclose(got, ref, rtol=RTOL, atol=RTOL * scale), family


def test_multikrum_runs_b1_in_the_window(dev):
    from biscotti_tpu_torch.ops.robust_agg import multikrum_accept_mask, multikrum_m

    gen = torch.Generator(device=dev).manual_seed(5)
    n, d = 716, 7850
    x = torch.randn(n, d, generator=gen, device=dev)
    x[:200] += 0.3  # a displaced group
    f = default_num_adversaries(n)
    before = krum_cuda.krum_scores_kernel.launches
    mask = multikrum_accept_mask(x, f)
    assert krum_cuda.krum_scores_kernel.launches == before + 1
    plain = krum_cuda.krum_scores_plain(x, f)
    keep = torch.sort(plain, stable=True).indices[:multikrum_m(n, f)]
    want = torch.zeros(n, dtype=torch.bool, device=dev)
    want[keep] = True
    assert torch.equal(mask, want)


def test_foolsgold_and_trimmed_mean_card_match_cpu(dev):
    from biscotti_tpu_torch.ops import robust_agg as ra

    rng = np.random.default_rng(6)
    x = rng.normal(0.0, 1.0, (70, 512)).astype(np.float32)
    x[49:] += rng.normal(0.0, 1.0, (1, 512)).astype(np.float32)  # a cluster
    cpu = torch.from_numpy(x)
    card = cpu.to(dev)
    assert torch.equal(ra.foolsgold_accept_mask(card).cpu(),
                       ra.foolsgold_accept_mask(cpu))
    assert torch.allclose(ra.foolsgold_weights(card).cpu(),
                          ra.foolsgold_weights(cpu), rtol=1e-5, atol=1e-5)
    for t in (0.0, 0.35, 0.49):
        assert torch.allclose(ra.trimmed_mean_aggregate(card, t).cpu(),
                              ra.trimmed_mean_aggregate(cpu, t),
                              rtol=1e-5, atol=1e-4)
    assert torch.allclose(ra.median_aggregate(card).cpu(),
                          ra.median_aggregate(cpu), rtol=1e-6, atol=1e-6)


def test_kernel_at_the_mnist_cnn_width_is_bit_identical(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    n, d = 716, 164_266
    x = torch.randn(n, d, generator=gen, device=dev)
    f = default_num_adversaries(n)
    first = krum_cuda.krum_scores_kernel(x, f)
    assert torch.equal(first, krum_cuda.krum_scores_kernel(x, f))
    assert _rel_err(first, krum_cuda.krum_scores_plain(x, f)) < RTOL


# ---------------------------- slice 4: the seams that call the crypto plane


def _armed_run(device, fn):
    """fn() with the crypto plane armed on `device` (None: disarmed)."""
    from biscotti_tpu_torch.crypto import kernels

    if device is not None:
        kernels.set_enabled(True, device=device)
    try:
        return fn()
    finally:
        kernels.set_enabled(False)


def _vss_instance(seed=7, k=5, c=6, s=4):
    from biscotti_tpu_torch.crypto import commitments as cm

    rng = np.random.default_rng(seed)
    chunks = rng.integers(-200, 200, (c, k)).astype(np.int64)
    comms, blinds = cm.vss_commit_chunks(chunks, b"seed" * 8, b"ctx")
    xs = list(range(1, s + 1))
    rows = np.stack([[cm.eval_poly(chunks[ci], x) for ci in range(c)]
                     for x in xs]).astype(np.int64)
    br = cm.vss_blind_rows(blinds, xs)
    ent = bytes(rng.integers(0, 256, 16 * s * c, dtype=np.uint8))
    return comms, rows, br, xs, ent, (s, c, k)


@pytest.mark.parametrize("case", ["honest", "off_curve", "bad_row", "waves"])
def test_vss_intake_card_matches_cpu(dev, case, monkeypatch):
    """The intake triples (rejected sids a fold, settle, members) armed on
    the card equal those armed on the CPU and disarmed; B2 once a fold."""
    from biscotti_tpu_torch.crypto import commitments as cm

    comms, rows, br, xs, ent, dims = _vss_instance()
    badc = comms.copy()
    badc[0, 0, 0] ^= 1
    rows_bad = rows.copy()
    rows_bad[0, 0] += 1
    good = (comms, rows, br)
    waves, want = {
        "honest": ([{1: good, 2: good}], ([[]], True, [1, 2])),
        "off_curve": ([{1: good, 2: (badc, rows, br)}], ([[2]], True, [1])),
        "bad_row": ([{1: (comms, rows_bad, br)}], ([[]], False, [1])),
        "waves": ([{1: good, 2: good}, {3: (badc, rows, br)}, {4: good}],
                  ([[], [3], []], True, [1, 2, 4]))}[case]

    def run():
        acc = cm.VssIntakeBatch(*dims, entropy=ent)
        rejected = []
        for wave in waves:
            for sid, member in wave.items():
                assert acc.add(sid, *member)
            rejected.append(acc.fold())
        return rejected, acc.verify(xs), sorted(acc.members())

    monkeypatch.setenv("BISCOTTI_PALLAS_CRYPTO", "1")
    before = cv.oncurve_mask.launches
    on_card = _armed_run(dev, run)
    assert cv.oncurve_mask.launches == before + len(waves)
    assert on_card == _armed_run("cpu", run) == _armed_run(None, run) == want


def test_batch_verifiers_card_match_cpu(dev):
    from biscotti_tpu_torch.crypto import commitments as cm

    rng = np.random.default_rng(5)
    key = cm.CommitKey.generate(30, label=b"cryptokernel-test")
    items = [(cm.commit_update(q, key), q) for q in (
        rng.integers(-500, 500, 30).astype(np.int64) for _ in range(4))]
    ent = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    bad = list(items)
    bad[2] = (bad[2][0], bad[2][1] + 1)
    seeds = [bytes([i]) * 32 for i in range(4)]
    trips = [(ed.public_key(s), b"m", cm.schnorr_sign(s, b"m")) for s in seeds]
    tampered = trips[:1] + [(trips[1][0], b"x", trips[1][2])] + trips[2:]

    def run():
        return (cm.batch_verify_commitments(items, key, entropy=ent),
                cm.batch_verify_commitments(bad, key, entropy=ent),
                cm.batch_schnorr_verify(trips),
                cm.batch_schnorr_verify(tampered))

    assert _armed_run(dev, run) == _armed_run(None, run) \
        == (True, False, True, False)


def test_recover_coeffs_card_matches_cpu(dev):
    from biscotti_tpu_torch.ops import secretshare as ss

    rng = np.random.default_rng(11)
    qs = rng.integers(-10**4, 10**4, (35, 7850)).astype(np.int64)
    agg = ss.aggregate_shares(np.stack([ss.make_shares(q, 10, 21)
                                        for q in qs]))
    xs = ss.share_xs(21)

    def run():
        return ss.recover_update(agg, xs, 7850)

    on_card = _armed_run(dev, run)
    assert np.array_equal(on_card, _armed_run("cpu", run))
    assert np.array_equal(on_card, _armed_run(None, run))
    assert np.array_equal(on_card, qs.sum(axis=0) / 10.0 ** 4)


@pytest.mark.parametrize("model", ["", "mnist_cnn"])
def test_hive_stepper_batch_card_matches_cpu(dev, model):
    """One HiveStepper batch on the card equals the CPU port's on the same
    draws (the card's own batch rows and normals), rtol 1e-4; the draws
    are pure in (seed, peer, iteration) on each device."""
    from biscotti_tpu_torch.config import BiscottiConfig
    from biscotti_tpu_torch.runtime.hive import HiveStepper

    cfg = BiscottiConfig(dataset="mnist", model_name=model, num_nodes=12,
                         noising=True, epsilon=1.0, batch_size=10, seed=3)
    ids = range(2, 10)
    card = HiveStepper(cfg, ids, device=dev)
    cpu = HiveStepper(cfg, ids, device="cpu")
    w = torch.from_numpy(np.random.default_rng(0).normal(
        0.0, 0.05, card.num_params).astype(np.float32))
    idx = card.draw_batches(1)
    assert torch.equal(idx, card.draw_batches(1))
    got = card.deltas_from_draws(w, idx).cpu()
    want = cpu.deltas_from_draws(w, idx.cpu())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * float(
        want.abs().max()))
    z = card.draw_noise(1)
    torch.testing.assert_close(card.noise_from_draws(z).cpu(),
                               cpu.noise_from_draws(z.cpu()), rtol=1e-6,
                               atol=0.0)


def test_sharded_paths_on_a_one_rank_nccl_group(dev, tmp_path):
    """The chunk-sharded share pipeline at the mnist_cnn width on the card:
    int64 shares without a matmul, bit-identical to the host path; and
    the sharded round at N = 512 (B1 on the gathered pool, once) equal to
    the single-device round on the same draws."""
    from biscotti_tpu_torch.config import BiscottiConfig
    from biscotti_tpu_torch.ops import secretshare as ss
    from biscotti_tpu_torch.parallel import mesh as pm
    from biscotti_tpu_torch.parallel import sim as psim

    d = 164_266
    q = np.random.default_rng(d).integers(-10 ** 4, 10 ** 4, size=(3, d))
    with pm.open_mesh("chunks", dev, rank=0, world_size=1,
                      init_method=f"file://{tmp_path}/nccl") as mesh:
        make_sh, agg_sh, recover_sh = ss.make_sharded_share_fns(
            mesh, total_shares=20)
        shares = torch.stack([make_sh(ss.to_chunks(qi)) for qi in q])
        agg = agg_sh(shares)
        rec = recover_sh(agg, ss.share_xs(20))
        host = np.stack([ss.make_shares(qi, total_shares=20) for qi in q])
        assert shares.device.type == "cuda"
        assert np.array_equal(shares.cpu().numpy(), host)
        assert np.array_equal(agg.cpu().numpy(), ss.aggregate_shares(host))
        assert np.array_equal(rec.cpu().numpy(), ss.recover_coeffs(
            ss.aggregate_shares(host), ss.share_xs(20)))
        assert np.array_equal(ss.from_chunks(rec.cpu().numpy(), d), q.sum(0))

        sim = psim.Simulator(BiscottiConfig(
            dataset="mnist", num_nodes=512, sample_percent=1.0,
            noising=True, epsilon=1.0, poison_fraction=0.3), device=dev)
        peers = pm.device_mesh("peers", "cuda")
        w = sim.init_state()[0]
        draws = psim.sharded_draws(sim, 1, sim.cfg.seed, range(512))
        before = krum_cuda.krum_scores_kernel.launches
        got = psim.sharded_step_from_draws(sim, peers, sim.x, sim.y, w, *draws)
        assert krum_cuda.krum_scores_kernel.launches == before + 1
        want = sim.round_step_from_draws(w, sim.init_state()[1],
                                         torch.arange(512, device=dev), *draws)
        assert torch.equal(got[1], want[2]) and torch.equal(got[0], want[0])
    assert not torch.distributed.is_initialized()
