"""Kernels B3c and B3d of `csrc/ed25519_ladder.cu` run on the CPU.

`tools.ladder_emulation` compiles the CUDA source with g++ against a header
that runs one std::thread a CUDA thread (barriers and shuffles emulated),
into a library with the card's C interface. Its B3c (verdicts, with and
without the points), B3d's pointwise add and both tree launches (the point
tree and the grid tree that forms each cell's point as it loads it) are
held to the plain versions bit for bit, at small sizes: trees of up to 64
points, a 4 x 8 grid. Two layouts: the source's own, and one with two
groups a tree block and four threads a product, whose block reaches 4
members, so that a 64-point tree takes `tree_plan`'s two launches, its
first with 8 members a group (the stack of partials) and several columns a
block. It checks indices, barriers and shuffles, not what nvcc accepts.
Each library is built under the test's temporary directory (~2 s).
"""

import shutil

import numpy as np
import pytest
import torch

from biscotti_tpu_torch.crypto import ed25519 as ed
from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
from biscotti_tpu_torch.crypto.kernels import group as gp
from biscotti_tpu_torch.crypto.kernels import primitives as prim
from biscotti_tpu_torch.crypto.kernels.cells import ladder_lanes, wire_grids
from biscotti_tpu_torch.tools import ladder_emulation

LAYOUTS = {"source": {}, "small": {"kTreeGroups": 2, "kAddGroup": 4}}
EDGE = (1 << 19) - 1  # the largest limb magnitude B3d takes


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def lib(request, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp(f"ladder_{request.param}")
    return ladder_emulation.load(ladder_emulation.build(
        out, LAYOUTS[request.param]))


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _points(m, seed):
    _, limbs = ladder_lanes(m, seed=seed)
    return torch.from_numpy(prim.point_neg_limbs(limbs).astype(np.int64))


def _column_sum(lib, pts):
    """B3d's tree as the card wrapper launches it (`tree_launches`):
    [rows, cols, 4, 16] → ([cols, 4, 16], launches, flag)."""
    rows, cols = pts.shape[:2]
    bad = torch.zeros(1, dtype=torch.int32)
    out, launches = cl.tree_launches(lib, pts.contiguous(), rows, cols, bad,
                                     None)
    return out, launches, int(bad)


def _grid_sum(lib, xy, points=False):
    """grid_sum as the card wrapper runs it: B3c's verdicts, the grid mask,
    the grid tree (and the point tree where a block does not reach)."""
    w, n = xy.shape[:2]
    bad = torch.zeros(1, dtype=torch.int32)
    ok = torch.empty((w, n), dtype=torch.bool)
    pts = torch.empty((w, n, 4, 16), dtype=torch.int64) if points else None
    assert lib.ed25519_grid_points(xy.data_ptr(), ok.data_ptr(), _ptr(pts),
                                   bad.data_ptr(), w * n, None) == 0
    grid_ok = ok.all(dim=1)
    out, _ = cl.tree_launches(lib, xy, w, n, bad, None, grid_ok)
    return ok, pts, grid_ok, out, int(bad)


def test_point_add_matches_plain_at_the_loose_edges(lib):
    a, b = _points(37, seed=11), _points(37, seed=12).flip(0).contiguous()
    for lane, row, limb, sign in ((0, 0, 0, 1), (5, 1, 15, -1),
                                  (17, 2, 7, 1), (36, 3, 0, -1)):
        a[lane, row, limb] = sign * EDGE
        b[36 - lane, row, 15 - limb] = -sign * EDGE
    out = torch.empty_like(a)
    bad = torch.zeros(1, dtype=torch.int32)
    assert lib.ed25519_point_add(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 bad.data_ptr(), len(a), None) == 0
    assert int(bad) == 0
    assert torch.equal(out, cl.point_add_plain(a, b))


@pytest.mark.parametrize("m", [1, 2, 8, 32, 64])
def test_tree_matches_gp_tree_sum(lib, m):
    pts = _points(m, seed=m)
    got, launches, bad = _column_sum(lib, pts[:, None])
    assert bad == 0 and launches <= 2
    want = gp.tree_sum(pts)
    assert torch.equal(got[0], want)
    assert torch.equal(got[0], cl.tree_sum(pts))  # the CPU path's plan


@pytest.mark.parametrize("rows,cols", [(2, 5), (4, 8), (8, 3), (16, 7)])
def test_column_trees_match_plain(lib, rows, cols):
    pts = _points(rows * cols, seed=rows + cols).reshape(rows, cols, 4, 16)
    got, _, bad = _column_sum(lib, pts)
    assert bad == 0
    assert torch.equal(got, cl.column_tree_plain(pts))


# "mixed": wire_grids' own, grid 0 valid and grids 1-3 invalid
@pytest.mark.parametrize("invalid", ["none", "first", "last", "mixed"])
def test_grid_sum_matches_plain(lib, invalid):
    xy = torch.from_numpy(wire_grids(4, 8, seed=5))
    if invalid == "none":  # every grid valid: copies of grid 0
        xy = xy[:1].repeat(4, 1, 1, 1)
    elif invalid == "first":
        xy = torch.cat([xy[3:], xy[:1].repeat(3, 1, 1, 1)])
    elif invalid == "last":
        xy = torch.cat([xy[:1].repeat(3, 1, 1, 1), xy[3:]])
    xy = xy.contiguous()
    ok, pts, grid_ok, summed, bad = _grid_sum(lib, xy, points=True)
    want_ok, want_pts = cl.grid_points_plain(xy)
    assert bad == 0
    assert torch.equal(ok, want_ok) and torch.equal(pts, want_pts)
    want_grid_ok, want_sum = cl.grid_sum(xy)
    assert grid_ok.tolist() == want_grid_ok.tolist() == {
        "none": [True] * 4, "first": [False] + [True] * 3,
        "last": [True] * 3 + [False],
        "mixed": [True, False, False, False]}[invalid]
    assert torch.equal(summed, want_sum)
    # the verdicts alone (grid_sum's B3c) equal those with the points
    ok2, _, _, summed2, _ = _grid_sum(lib, xy)
    assert torch.equal(ok2, ok) and torch.equal(summed2, summed)


def test_every_grid_invalid_sums_to_the_identity(lib):
    xy = torch.from_numpy(wire_grids(4, 8, seed=6))
    xy[0, 2, 0, 0] ^= 1  # grid 0 off the curve too
    _, _, grid_ok, summed, _ = _grid_sum(lib, xy.contiguous())
    assert not grid_ok.any()
    assert torch.equal(summed, cl.grid_sum(xy)[1])
    # sums of identities: loose limbs, each the identity
    assert all(ed.is_identity(gp.limbs_to_point(p)) for p in summed.numpy())


def test_kernels_flag_limbs_outside_their_range(lib):
    pts = _points(8, seed=3)
    pts[5, 2, 7] = 1 << 19
    assert _column_sum(lib, pts[:, None])[2] == 1
    xy = torch.from_numpy(wire_grids(4, 8, seed=2))
    xy[2, 3, 1, 4] = 1 << 16
    assert _grid_sum(lib, xy.contiguous())[4] == 1
