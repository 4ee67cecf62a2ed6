"""The yardstick of kernels B3a-B3d in `chip_smoke.py`, on the CPU.

Every bound of B3a-B3d counts the work of the field arithmetic, from
field.py's and group.py's operations (`chip_smoke.field_work`: a point add
`POINT_ADD`, a double `POINT_DOUBLE`, a wire cell's verdict `CELL_VERDICT`
and its point `CELL_POINT`), and none reads the SASS of the layout that
computes it: no listing of B3a or B3d moves a bound. The one-thread kernels'
listings on the H100 80GB HBM3 at 700.00 W (git 86a9ec2's B3d and B3a,
git 9f39c34's B3c) are kept here to show how far their instructions exceed
the arithmetic: 1.43x (the add), 1.45x (a double and an add), 2.12x (a
cell) on the FMA pipe, and set the bounds before this count. The occupancy
bounds count the layouts' warps. The helpers are imported; `main` does not
run.
"""

import inspect

import numpy as np
import pytest

import chip_smoke as cs
from biscotti_tpu_torch import _build
from biscotti_tpu_torch.tools.ladder_ab import layout

# cuobjdump's SASS mixes of the one-thread B3d and B3a (git 86a9ec2) on
# the H100: B3d's listing is one add, B3a's one double and one add
B3D_MIX = {
    "IMAD": 1698, "IMAD.WIDE": 1536, "IADD3": 1441, "IMAD.WIDE.U32": 913,
    "LOP3.LUT": 561, "SHF.R.S32.HI": 162, "SHF.R.S64": 144, "SHF.R.U64": 144,
    "MOV": 139, "LEA.HI.SX32": 135, "LEA.HI.X.SX32": 135, "IADD3.X": 131,
    "ISETP.GE.U32.AND": 65, "LDG.E.128.CONSTANT": 64,
    "ISETP.GE.U32.AND.EX": 64, "ISETP.LT.U32.AND": 64,
    "ISETP.LT.U32.AND.EX": 64, "PLOP3.LUT": 32, "STG.E.128": 32,
    "ULDC.64": 21, "SHF.L.U32": 17, "USHF.R.S32.HI": 16, "NOP": 14, "S2R": 2,
    "HFMA2.MMA": 2, "EXIT": 2, "P2R": 2, "ISETP.NE.AND": 2, "LDC": 1,
    "ISETP.GE.AND.EX": 1, "SHF.L.U64.HI": 1, "LDC.64": 1, "STG.E": 1,
    "BRA": 1}
B3A_MIX = {
    "IMAD": 2898, "IMAD.WIDE": 2576, "IADD3": 2352, "IMAD.WIDE.U32": 1571,
    "LOP3.LUT": 785, "MOV": 379, "SHF.R.S64": 306, "SHF.R.S32.HI": 257,
    "LEA.HI.X.SX32": 255, "SHF.R.U64": 238, "LEA.HI.SX32": 225,
    "SHF.L.U32": 92, "STL": 68, "IADD3.X": 64, "LDL": 63, "ULDC.64": 37,
    "ISETP.GE.U32.AND": 33, "LDG.E.128.CONSTANT": 32,
    "ISETP.GE.U32.AND.EX": 32, "ISETP.LT.U32.AND": 32,
    "ISETP.LT.U32.AND.EX": 32, "STG.E.128": 32, "CS2R": 28, "HFMA2.MMA": 19,
    "PLOP3.LUT": 17, "USHF.R.S32.HI": 17, "NOP": 14, "BRA": 5, "LDL.LU": 5,
    "S2R": 4, "LDC": 3, "LEA": 3, "LEA.HI.X": 3, "UMOV": 3, "EXIT": 2,
    "UIADD3": 2, "STL.64": 1, "ISETP.GE.AND.EX": 1, "LDC.64": 1,
    "ISETP.GE.AND": 1, "STG.E": 1, "LDL.64": 1, "LDG.E.CONSTANT": 1,
    "ISETP.LE.AND": 1, "USHF.L.U32": 1, "BSSY": 1, "BSYNC": 1,
    "UISETP.NE.AND": 1}
# cuobjdump's SASS mix of the one-thread B3c (git 9f39c34) on the H100,
# read by tools.ladder_ab --other: one wire cell's verdict and point
B3C_MIX = {
    "IMAD": 2175, "IADD3": 1353, "IMAD.WIDE.U32": 1121, "LOP3.LUT": 353,
    "MOV": 310, "LEA.HI.SX32": 150, "SHF.R.S32.HI": 145, "SHF.R.S64": 82,
    "SHF.R.U64": 78, "LEA.HI.X.SX32": 75, "LEA": 66, "SHF.R.U32.HI": 64,
    "ISETP.EQ.AND": 43, "SEL": 33, "STG.E.128": 32, "SHF.L.U32": 30,
    "ISETP.LT.AND": 30, "ULDC.64": 29, "STL": 22, "LDL.LU": 22,
    "LDG.E.128.CONSTANT": 16, "USHF.R.S32.HI": 16, "PLOP3.LUT": 15, "NOP": 12,
    "ISETP.NE.AND": 10, "HFMA2.MMA": 3, "BRA": 3, "ULDC": 3, "S2R": 2,
    "EXIT": 2, "LEA.HI.X": 2, "ISETP.LT.OR": 2, "BSSY": 2, "BSYNC": 2,
    "LDC": 1, "ISETP.GE.U32.AND": 1, "ISETP.GE.AND.EX": 1, "P2R": 1,
    "CS2R": 1, "LDC.64": 1, "IADD3.X": 1, "STG.E": 1, "STG.E.U8": 1}
# some listing of another layout: more loads and shuffles, fewer products
GROUPED_MIX = {"IMAD.WIDE": 700, "IMAD": 300, "IADD3": 900, "SHFL.IDX": 120,
               "LDS.128": 200, "WARPSYNC": 40, "BAR.SYNC.DEFER_BLOCKING": 6}
LAYOUT = layout(_build.source("ed25519_ladder").read_text())


def _bits(m, words, pop, seed=0):
    """[m, words] packed int32 bits with exactly `pop` set, seeded."""
    flat = np.zeros(m * words * 32, np.uint8)
    flat[np.random.default_rng(seed).choice(flat.size, pop, replace=False)] = 1
    return np.packbits(flat.reshape(m, -1), axis=1, bitorder="little").view(
        "<u4").view(np.int32).reshape(m, words)


def _listing(mix):
    return {k: cs.pipe_counts(mix)[k] for k in cs.PIPES}


def _as_build(monkeypatch, mix):
    """Every listing the build could read is `mix`."""
    monkeypatch.setattr(_build, "sass_mix", lambda lib, kernel: dict(mix))


CELL = cs.summed(cs.CELL_VERDICT, cs.CELL_POINT)


def test_the_field_work_counts_the_limb_products():
    # 9 products of 256 limb products; 4 products and 4 squares of 136;
    # two IMAD.WIDE passes each
    assert cs.POINT_ADD["fma"] == 2 * 9 * 256
    assert cs.POINT_DOUBLE["fma"] == 2 * (4 * 256 + 4 * 136)
    assert cs.CELL_VERDICT["fma"] == 2 * (2 * 256 + 2 * 136)
    assert cs.CELL_POINT["fma"] == 2 * 256
    # the FMA pipe binds every one of them
    for work in (cs.POINT_ADD, cs.POINT_DOUBLE, cs.CELL_VERDICT, CELL):
        assert cs.pipe_clocks(work) == work["fma"] / cs.PIPE_LANES


def test_the_frozen_counts_are_the_one_thread_listings():
    """The one-thread listings issue more than the arithmetic on every
    pipe: 1.43x, 1.45x and 2.12x its FMA passes, and so its time."""
    for mix, work, ratio in (
            (B3D_MIX, cs.POINT_ADD, 6596 / 4608),
            (B3A_MIX, cs.summed(cs.POINT_DOUBLE, cs.POINT_ADD), 11192 / 7744),
            (B3C_MIX, CELL, 4417 / 2080)):
        listing = _listing(mix)
        assert all(listing[k] >= work[k] for k in ("fma", "alu", "issued"))
        assert listing["fma"] / work["fma"] == pytest.approx(ratio,
                                                             rel=1e-12)
        assert cs.pipe_clocks(listing) / cs.pipe_clocks(work) \
            == pytest.approx(ratio, rel=1e-12)


@pytest.mark.parametrize("b3a", [B3A_MIX, GROUPED_MIX, {}])
def test_the_bound_does_not_read_the_b3a_listing(b3a, monkeypatch):
    bits = _bits(8192, 8, 984_858)
    nbytes = bits.nbytes + 2 * 8192 * 4 * 16 * 8
    walk = _bits(4, 8, 518)
    want = (cs.msm_ladder_bound(bits, nbytes, LAYOUT),
            cs.fixed_walk_bound(walk, 1000, LAYOUT))
    _as_build(monkeypatch, b3a)
    assert (cs.msm_ladder_bound(bits, nbytes, LAYOUT),
            cs.fixed_walk_bound(walk, 1000, LAYOUT)) == want


@pytest.mark.parametrize("kind,m,words,pop,nbytes,counts,bound_ms", [
    # the settle's msm: 8,192 lanes, bits and points in, points out
    ("msm", 8192, 8, 984_858, 8192 * 32 + 2 * 8192 * 512,
     {"fma": 16_134_633_960, "alu": 6_397_021_298, "issued": 16_558_773_920},
     0.9645839287764003),
    # fixed_base_mult's 4 lanes over table B, bits and table in, points out
    ("walk", 4, 8, 518, 4 * 32 + 256 * 512 + 4 * 512,
     {"fma": 3_416_728, "alu": 1_639_470, "issued": 3_787_616},
     0.00020426375497398225),
    # the Pedersen comb: 1 lane over B‖H
    ("walk", 1, 16, 253, 64 + 512 * 512 + 512,
     {"fma": 1_668_788, "alu": 800_745, "issued": 1_849_936},
     9.976588804713804e-05)])
def test_the_frozen_counts_give_the_one_thread_ladders_bounds(
        kind, m, words, pop, nbytes, counts, bound_ms, monkeypatch):
    """The one-thread listings' counts in place of the arithmetic's give
    the bounds that those kernels were held to (`counts`, `bound_ms`);
    the arithmetic's operations take 1 / 1.43-1.47 of their time."""
    bits = _bits(m, words, pop)
    fn = cs.msm_ladder_bound if kind == "msm" else cs.fixed_walk_bound
    got = fn(bits, nbytes, LAYOUT)
    add = _listing(B3D_MIX)
    monkeypatch.setattr(cs, "POINT_ADD", add)
    monkeypatch.setattr(cs, "POINT_DOUBLE", {
        k: _listing(B3A_MIX)[k] - add[k] for k in cs.PIPES})
    frozen = fn(bits, nbytes, LAYOUT)
    assert {k: frozen["bound_counts"][k] for k in counts} == counts
    assert frozen["bound_by"] == "operations"
    assert frozen["bound_ms"] == pytest.approx(bound_ms, rel=1e-12)
    assert got["bytes_ms"] == frozen["bytes_ms"]
    ratio = frozen["ops_ms"] / got["ops_ms"]
    assert 6596 / 4608 * (1 - 1e-12) <= ratio <= 4596 / 3136
    assert got["bound_ms"] == max(got["ops_ms"], got["bytes_ms"])


def test_the_frozen_cell_is_the_one_thread_listing():
    """B3c's verdict needs 2 squares and 2 products, its point one more
    product; the one-thread listing of both issues 2.12x their FMA
    passes."""
    assert CELL["fma"] == 2 * (2 * 136 + 3 * 256)
    assert _listing(B3C_MIX)["fma"] / CELL["fma"] == pytest.approx(
        4417 / 2080, rel=1e-12)


def test_the_frozen_cell_gives_the_one_thread_b3c_bound():
    """The wave's 64 x 7,850 cells, each read (32 limbs) and its verdict
    and point written: the one-thread listing gives its 0.133 ms on
    the FMA pipe, the arithmetic 0.0625, below the bytes' 0.115, which
    bind; the verdicts alone (grid_sum's instance) 0.0471 on the FMA
    pipe."""
    cells = 64 * 7850
    nbytes = cells * (2 * 16 * 8 + 1 + 4 * 16 * 8)
    frozen = cs.ladder_bound(cs.scaled(_listing(B3C_MIX), cells), nbytes)
    assert frozen["bound_ms"] == pytest.approx(0.13266548056320784,
                                               rel=1e-12)
    got = cs.grid_cell_bound(cells, points=True)
    assert got["bound_counts"] == cs.scaled(CELL, cells)
    assert got["bytes_ms"] == frozen["bytes_ms"]
    assert frozen["ops_ms"] / got["ops_ms"] == pytest.approx(4417 / 2080,
                                                             rel=1e-12)
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(0.11532704477611941, rel=1e-12)
    assert got["warps_per_scheduler"] == -(-cells // 32 // (4 * 132))
    verdicts = cs.grid_cell_bound(cells, points=False)
    assert verdicts["bound_counts"] == cs.scaled(cs.CELL_VERDICT, cells)
    assert verdicts["bytes_ms"] == pytest.approx(
        1e3 * cells * 257 / cs.PEAK_BYTES_PER_S, rel=1e-12)
    assert verdicts["bound_by"] == "operations"
    assert verdicts["bound_ms"] == pytest.approx(0.04709519436792164,
                                                 rel=1e-12)


@pytest.mark.parametrize("valid,adds", [(64, 63), (62, 61), (1, 0), (0, 0)])
def test_the_grid_sum_bound_counts_what_its_grids_need(valid, adds):
    got = cs.grid_sum_bound(64, 7850, valid)
    assert got["bound_counts"] == cs.summed(
        cs.scaled(cs.CELL_VERDICT, 64 * 7850),
        cs.scaled(cs.CELL_POINT, valid * 7850),
        cs.scaled(cs.POINT_ADD, adds * 7850))


def _bounds():
    """Every bound chip_smoke computes for B3a-B3d."""
    bits = _bits(8192, 8, 984_858)
    return [cs.msm_ladder_bound(bits, 123, LAYOUT),
            cs.fixed_walk_bound(_bits(1, 16, 253), 456, LAYOUT),
            cs.point_add_bound(7850, 789, LAYOUT),
            cs.tree_bound(8192, 1, 1000, LAYOUT),
            cs.tree_bound(64, 7850, 1000, LAYOUT),
            cs.grid_cell_bound(64 * 7850, False),
            cs.grid_cell_bound(64 * 7850, True),
            cs.grid_sum_bound(64, 7850, 62)]


@pytest.mark.parametrize("b3d", [B3D_MIX,
                                 dict(B3D_MIX, IMAD=B3D_MIX["IMAD"] + 1),
                                 GROUPED_MIX, {}])
def test_a_b3d_listing_that_moved_is_refused(b3d, monkeypatch):
    """No listing of B3d, the one-thread one, one that moved, a grouped
    one or none, moves a bound of B3a-B3d: the bounds take no listing."""
    want = _bounds()
    _as_build(monkeypatch, b3d)
    assert _bounds() == want
    # no bound helper takes a listing
    for fn in (cs.msm_ladder_bound, cs.fixed_walk_bound, cs.point_add_bound,
               cs.tree_bound, cs.grid_cell_bound, cs.grid_sum_bound):
        assert not {"mix", "mixes"} & set(inspect.signature(fn).parameters)
    # the add a point_add bound counts is the arithmetic's, pair for pair
    got = cs.point_add_bound(7850, 0, LAYOUT)
    assert got["bound_counts"] == cs.scaled(cs.POINT_ADD, 7850)


@pytest.mark.parametrize("g,pairs,warps,per_sched", [(4, 7850, 982, 2),
                                                     (8, 7850, 1963, 4)])
def test_the_point_add_occupancy_counts_its_groups(g, pairs, warps,
                                                   per_sched):
    got = cs.point_add_bound(pairs, 0, dict(LAYOUT, kAddGroup=g))
    assert got["warps_per_scheduler"] == per_sched \
        == -(-warps // (4 * 132))
    one = cs.ladder_bound(cs.scaled(cs.POINT_ADD, 1 / g), 0,
                          cs.scaled(cs.POINT_ADD, 1 / g), 32)
    assert got["occupancy_bound_ms"] == pytest.approx(
        one["occupancy_bound_ms"] * per_sched, rel=1e-12)


@pytest.mark.parametrize("rows,cols,launches", [(8192, 1, 2), (64, 7850, 1),
                                                (2, 1, 1), (256, 3, 2)])
def test_the_tree_bound_counts_every_add_and_its_launches(rows, cols,
                                                         launches):
    got = cs.tree_bound(rows, cols, 0, LAYOUT)
    assert got["launches"] == launches
    assert got["bound_counts"] == cs.scaled(cs.POINT_ADD,
                                            (rows - 1) * cols)
    assert got["occupancy_bound_ms"] > 0 and got["bound_by"] == "operations"


def test_resident_warps_reads_registers_threads_and_shared_memory():
    assert cs.resident_warps(64, 128, 0) == 8.0  # 65,536 / (64 x 32) warps
    assert cs.resident_warps(255, 64, 0) == 2.0  # git 86a9ec2's B3c
    assert cs.resident_warps(62, 512, 64 * 1344) == 8.0  # two blocks
    assert cs.resident_warps(None, 64, 0) is None


@pytest.mark.parametrize("g,warps,per_sched", [(4, 1024, 2), (8, 2048, 4),
                                               (16, 4096, 8)])
def test_the_occupancy_bound_counts_the_layouts_warps(g, warps, per_sched):
    bits = _bits(8192, 8, 984_858)
    got = cs.msm_ladder_bound(bits, 0, dict(LAYOUT, kMsmGroup=g))
    assert got["warps_per_scheduler"] == per_sched == -(-warps // (4 * 132))
    # the busiest warp of 32 / g lanes takes the add at nearly every step
    steps = cs.warp_set_steps(bits.view(np.uint32), 32 // g)
    assert len(steps) == warps and steps.max() <= 256
    walk = cs.fixed_walk_bound(_bits(1, 16, 253), 0,
                               dict(LAYOUT, kWalkGroup=g))
    assert walk["warps_per_scheduler"] == 1


def test_warp_set_steps_takes_partial_warps():
    bits = np.zeros((5, 1), np.uint32)
    bits[0, 0], bits[1, 0], bits[4, 0] = 0b011, 0b110, 1 << 31
    bits = bits.view(np.int32)
    assert cs.warp_set_steps(bits, 2).tolist() == [3, 0, 1]
    assert cs.warp_set_steps(bits, 32).tolist() == [4]


def test_ptxas_report_reads_registers_and_spills():
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117msm_ladder_kernelILi4ELi128ELb0EEEvPKjiPKlPlPix' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117msm_ladder_kernelILi4ELi128ELb0EEEvPKjiPKlPlPix
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 47232 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116point_add_kernelEPKlS1_PlPix' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116point_add_kernelEPKlS1_PlPix
    288 bytes stack frame, 280 bytes spill stores, 276 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 288 bytes cumulative stack size"""
    report = _build.ptxas_report(log)
    assert list(report.values()) == [
        {"spill_stores": 0, "spill_loads": 0, "registers": 96},
        {"spill_stores": 280, "spill_loads": 276, "registers": 255}]
