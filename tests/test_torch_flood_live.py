"""Twin of `tests/test_admission.py`'s mnist flood acceptance
(`test_flood_acceptance_mnist_cluster`, :597) on the port's peer:
`runtime/admission.py`'s plane under one seeded flooder at 50x the honest
frame rate, then the same cluster with admission and no flood, then with
neither.

Each run goes on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords and seed, and the reference test's assertions are made
on the port's runs. The two packages are held to what no timing decides:
the admission caps, sheds on the honest peers under the flood and none
without it, the rejected ids, and round 0's block of each run without
the flood (plain mode, so compared as ROADMAP C10 says); each run's
stake is the one its own chain's records give. Which frames a flood
sheds, and so the flood run's later blocks, follow arrival order.

The clean-against-baseline pair at creditcard runs in tier-1; the whole
acceptance at the mnist width is `slow`, as its reference. Ports are
22800-22999, which no other test file uses."""

import asyncio

import pytest

from torch_twins import (agent, assert_first_block_parity, cfg,
                         tight_admission, twin)

pytestmark = pytest.mark.flood

# the reference file's windows (test_admission.py:36)
FAST = dict(update_s=4.0, block_s=12.0, krum_s=3.0, share_s=4.0, rpc_s=4.0)
FLOOD_NODE = 1


def _run(pkg, port, draws, flood, admission, **kw):
    """The reference's `_flood_cluster_cfgs` cluster of 4, run to the end:
    (results, agents)."""
    n = 4
    plan = pkg.faults.FaultPlan(seed=13)
    flood_plan = pkg.faults.FaultPlan(seed=13, flood=flood)

    async def go():
        agents = [agent(pkg, cfg(
            pkg, i, n, port, FAST, max_iterations=3, admission_plan=admission,
            fault_plan=flood_plan if (flood and i == FLOOD_NODE) else plan,
            **kw), draws=draws) for i in range(n)]
        return await asyncio.gather(*(a.run() for a in agents)), agents

    return asyncio.run(go())


def _flooded(pkg, port, draws, **kw):
    """The flood run and its assertions (test_admission.py:620-641)."""
    results, agents = _run(pkg, port, draws, 50, tight_admission(pkg), **kw)
    equal, common, real = pkg.chaos.chain_oracle(results)
    assert equal and common >= 2 and real >= 1
    snaps = [r["telemetry"] for r in results]
    assert sum(s["admission"]["shed_total"]
               for s in snaps if s["node"] != FLOOD_NODE) > 0
    for s in snaps:
        a = s["admission"]
        assert a["inflight_peak"] <= a["caps"]["global_inflight"]
        assert a["parked_peak"] <= a["caps"]["max_parked"]
    # BusyError feeds no breaker: honest <-> honest links stay pristine
    for s in snaps:
        if s["node"] == FLOOD_NODE:
            continue
        for pid, h in s["health"].items():
            if int(pid) != FLOOD_NODE:
                assert h.get("opens", 0) == 0, (s["node"], pid, h)
    return results, agents


def _clean_and_baseline(pkg, port, draws, **kw):
    """The run with admission and no flood, then the run with neither, and
    their assertions (test_admission.py:642-663)."""
    clean, clean_agents = _run(pkg, port, draws, 0, tight_admission(pkg),
                               **kw)
    equal, _, real = pkg.chaos.chain_oracle(clean)
    assert equal and real >= 1
    for r in clean:
        assert r["telemetry"]["admission"]["shed_total"] == 0
        assert r["telemetry"]["counters"].get("breaker_open", 0) == 0
    base, base_agents = _run(pkg, port + 5, draws, 0,
                             pkg.admission.AdmissionPlan(), **kw)
    equal, _, real = pkg.chaos.chain_oracle(base)
    assert equal and real >= 1
    err_clean, err_base = clean[0]["final_error"], base[0]["final_error"]
    assert abs(err_clean - err_base) < 0.15, (err_clean, err_base)
    return (clean, clean_agents, base_agents,
            [r["telemetry"]["admission"]["caps"] for r in clean])


def _same_runs_without_flood(got):
    ref, port = got["reference"], got["port"]
    assert port[3] == ref[3], "the caps differ"
    for k in (1, 2):  # the clean run's agents, then the baseline's
        assert_first_block_parity(ref[k][0], port[k][0])


def test_admission_clean_against_baseline_creditcard():
    """The acceptance's clean and baseline runs at the reference's tier-1
    width (creditcard)."""
    _same_runs_without_flood(twin(_clean_and_baseline, 22800, stride=10))


def _acceptance(pkg, port, draws):
    flood, flood_agents = _flooded(pkg, port, draws, dataset="mnist")
    rest = _clean_and_baseline(pkg, port + 10, draws, dataset="mnist")
    return (flood, flood_agents) + rest[1:] + (
        [r["telemetry"]["admission"]["caps"] for r in flood],)


@pytest.mark.slow
def test_flood_acceptance_mnist_cluster():
    got = twin(_acceptance, 22820, stride=20)
    ref, port = got["reference"], got["port"]
    assert port[5] == ref[5] and port[4] == ref[4], "the caps differ"
    assert_first_block_parity(ref[1][0], port[1][0], first_block=False)
    for k in (2, 3):  # the clean run's agents, then the baseline's
        assert_first_block_parity(ref[k][0], port[k][0])
