"""Twin of `tests/test_faults.py`'s chaos matrix
(`test_chaos_matrix_chain_equality`, :521) on the port's peer: each fault
kind of `runtime/faults.py`'s FaultPlan alone at an aggressive rate, and a
mixed profile, on a 4-peer live cluster, read by `tools/chaos.py`'s
`chain_oracle` and `tally_faults`.

Each case runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords and seed, and makes the reference test's assertions on
the port's run. The two runs are held to what no timing decides: every
fault an injector applied replays on a fresh plan of either package (the
schedule is pure in the seed), the rejected ids, and in each run the
stake its own chain's records give. Round 0's block is not compared: a
dropped or reset frame is retried after its 4 s timeout, and whether the
retry lands inside the 4 s update window follows the host's load.

The `mixed` case runs in tier-1; the whole matrix, five cases, is `slow`,
as its reference. Ports are 22600-22799, which no other test file
uses."""

import asyncio

import pytest

from torch_twins import PACKAGES, agent, assert_first_block_parity, cfg, twin

pytestmark = pytest.mark.chaos

# the reference file's windows (test_faults.py:33)
CHAOS = dict(update_s=4.0, block_s=12.0, krum_s=3.0, share_s=4.0, rpc_s=4.0)
# test_faults.py:524-531, each on FaultPlan(seed=29)
CASES = {
    "drop20": dict(drop=0.20),
    "delay100": dict(delay=1.0, delay_s=0.08),
    "dup30": dict(duplicate=0.30),
    "reset15": dict(reset=0.15),
    "mixed": dict(drop=0.10, delay=0.50, delay_s=0.05, duplicate=0.10,
                  reset=0.05),
}


def _matrix_case(case):
    plan_kw = dict(seed=29, **CASES[case])

    def scenario(pkg, port, draws):
        n = 4
        plan = pkg.faults.FaultPlan(**plan_kw)

        async def go():
            agents = [agent(pkg, cfg(pkg, i, n, port, CHAOS, fault_plan=plan,
                                     max_iterations=4), draws=draws)
                      for i in range(n)]
            for a in agents:
                a.pool.faults.log = []  # record the applied schedule
            return await asyncio.gather(*(a.run() for a in agents)), agents

        results, agents = asyncio.run(go())
        # the reference's _settled_prefix_equal (test_faults.py:372)
        equal, common, real = pkg.chaos.chain_oracle(results)
        dumps = [r["chain_dump"] for r in results]
        assert common >= 2, f"no progress: {dumps}"
        assert equal, f"chains diverged under chaos:\n{dumps}"
        assert real >= 1, "no real block survived the chaos run"
        assert pkg.chaos.tally_faults(results), "chaos case injected nothing"
        for a in agents:
            for other in PACKAGES:  # the schedule is pure in the seed
                replay = other.faults.FaultPlan(**plan_kw)
                for dst, msg, attempt, seq, kind in a.pool.faults.log:
                    assert replay.action(a.id, dst, msg, attempt,
                                         seq).kind() == kind
        return results, agents

    return scenario


def _twin_case(case, port):
    got = twin(_matrix_case(case), port, stride=10)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0],
                              first_block=False)


def test_chaos_matrix_mixed_case():
    """The matrix's mixed profile: drops, delays, duplicates and resets on
    one plan."""
    _twin_case("mixed", 22600)


@pytest.mark.slow
@pytest.mark.parametrize("port,case", [
    (22620 + 20 * k, case) for k, case in enumerate(CASES)], ids=list(CASES))
def test_chaos_matrix_chain_equality(port, case):
    _twin_case(case, port)
