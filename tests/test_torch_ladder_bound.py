"""The yardstick of kernels B3a and B3b in `chip_smoke.py`, on the CPU.

B3a's and B3b's bounds count the work of one point double and one add,
frozen from the one-thread-a-lane ladders (`chip_smoke.LADDER_DOUBLE`,
`LADDER_ADD`), not the SASS of the layout that computes them: any B3a
listing gives the same bound, B3d's listing (which still runs that add)
must give the frozen add, and the frozen counts reproduce the bounds that
the one-thread ladders were measured against on the H100 80GB HBM3 at
700.00 W (the settle's 8,192 lanes, the fixed-base walk at 4 x 256 and the
Pedersen comb at 1 x 512). The helpers are imported; `main` does not run.
"""

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


def _mixes(b3a):
    return {"B3a": b3a, "B3b": b3a, "B3d": B3D_MIX}


def test_the_frozen_counts_are_the_one_thread_listings():
    assert {k: cs.pipe_counts(B3D_MIX)[k] for k in cs.PIPES} == cs.LADDER_ADD
    assert cs.summed(cs.LADDER_DOUBLE, cs.LADDER_ADD) == {
        k: cs.pipe_counts(B3A_MIX)[k] for k in cs.PIPES}


@pytest.mark.parametrize("b3a", [B3A_MIX, GROUPED_MIX, {}])
def test_the_bound_does_not_read_the_b3a_listing(b3a):
    bits = _bits(8192, 8, 984_858)
    nbytes = bits.nbytes + 2 * 8192 * 4 * 16 * 8
    want = cs.msm_ladder_bound(_mixes(B3A_MIX), bits, nbytes, LAYOUT)
    got = cs.msm_ladder_bound(_mixes(b3a), bits, nbytes, LAYOUT)
    assert got == want
    walk = _bits(4, 8, 518)
    assert cs.fixed_walk_bound(_mixes(b3a), walk, 1000, LAYOUT) \
        == cs.fixed_walk_bound(_mixes(B3A_MIX), walk, 1000, LAYOUT)


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
        kind, m, words, pop, nbytes, counts, bound_ms):
    bits = _bits(m, words, pop)
    fn = cs.msm_ladder_bound if kind == "msm" else cs.fixed_walk_bound
    got = fn(_mixes(GROUPED_MIX), bits, nbytes, LAYOUT)
    assert {k: got["bound_counts"][k] for k in counts} == counts
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(bound_ms, rel=1e-12)


def test_a_b3d_listing_that_moved_is_refused():
    moved = dict(B3D_MIX, IMAD=B3D_MIX["IMAD"] + 1)
    with pytest.raises(AssertionError, match="frozen add"):
        cs.ladder_step_counts({"B3d": moved})


@pytest.mark.parametrize("g,warps,per_sched", [(4, 1024, 2), (8, 2048, 4),
                                               (16, 4096, 8)])
def test_the_occupancy_bound_counts_the_layouts_warps(g, warps, per_sched):
    bits = _bits(8192, 8, 984_858)
    got = cs.msm_ladder_bound(_mixes(GROUPED_MIX), bits, 0,
                              dict(LAYOUT, kMsmGroup=g))
    assert got["warps_per_scheduler"] == per_sched == -(-warps // (4 * 132))
    # the busiest warp of 32 / g lanes takes the add at nearly every step
    steps = cs.warp_set_steps(bits.view(np.uint32), 32 // g)
    assert len(steps) == warps and steps.max() <= 256
    walk = cs.fixed_walk_bound(_mixes(GROUPED_MIX), _bits(1, 16, 253), 0,
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
