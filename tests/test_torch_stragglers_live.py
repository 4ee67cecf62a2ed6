"""Twins of `tests/test_stragglers.py`'s live clusters on the port's
peer: an honest straggler (4x compute, a service delay) under adaptive
deadlines is never quarantined nor debited, and an adaptive cluster's
round advances well inside the fixed block window after its leader
miner is hard-killed.

Each scenario runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords and makes the reference test's assertions on the port's
run. The slow cluster runs secure aggregation, whose blocks carry
quantized sums, but which workers a round of its waits for follows the
host's timing (a slowed peer, measured deadlines): it is held to the
reference's rejected ids and stake rule. The dead-leader cluster (plain
mode, ROADMAP C10; the kill lands at a moment no run repeats) is held to
the reference's round-0 block too (`torch_twins.assert_first_block_
parity`).

Ports are 19700-19799, which no other test file uses."""

import asyncio
import time

import pytest

from conftest import wait_until
from torch_twins import (agent, assert_first_block_parity, cfg,
                         hard_stop, twin)

pytestmark = pytest.mark.straggler

# the reference file's windows (test_stragglers.py:35)
FAST = dict(update_s=4.0, block_s=12.0, krum_s=3.0, share_s=4.0, rpc_s=4.0)


def _settled_prefix_equal(pkg, results, min_common=1):
    eq, common, real = pkg.chaos.chain_oracle(results)
    assert eq, "settled chain prefixes diverged"
    assert common >= min_common
    return real


def _slow_cluster(pkg, port, draws):
    n, victim = 4, 1
    plan = pkg.faults.FaultPlan(slow_node=victim, slow_factor=4.0,
                                slow_service_s=0.05)

    async def go():
        agents = [agent(pkg, cfg(pkg, i, n, port, FAST, fault_plan=plan,
                                 adaptive_deadlines=True,
                                 deadline_floor_s=1.0, max_iterations=4,
                                 secure_agg=True, verification=True),
                        draws=draws) for i in range(n)]
        return await asyncio.gather(*(a.run() for a in agents)), agents

    results, agents = asyncio.run(go())
    real = _settled_prefix_equal(pkg, results, min_common=2)
    assert real >= 1, "a slow fleet must still mint real blocks"
    for r in results:
        if r["node"] == victim:
            assert r["telemetry"]["stragglers"]["profile"]["slowed"]
            continue
        h = r["telemetry"]["health"].get(str(victim), {})
        assert h.get("opens", 0) == 0, f"honest straggler was quarantined: {h}"
        assert h.get("state", "closed") == "closed"
    stake = agents[0].chain.latest_stake_map()
    assert stake.get(victim, 0) >= agents[0].cfg.default_stake
    merged = pkg.obs.merge_snapshots([r["telemetry"] for r in results])
    assert any(row["node"] == victim
               for row in merged["stragglers"]["slow_peers"])
    return results, agents


def test_slow_cluster_honest_straggler_never_quarantined():
    got = twin(_slow_cluster, 19700)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0],
                              first_block=False)


def _dead_leader(pkg, port, draws):
    n, block_s = 4, 45.0
    slow_t = dict(update_s=10.0, block_s=block_s, krum_s=4.0, share_s=10.0,
                  rpc_s=4.0)

    async def go():
        agents = [agent(pkg, cfg(pkg, i, n, port, slow_t,
                                 adaptive_deadlines=True,
                                 deadline_floor_s=1.5, max_iterations=12),
                        draws=draws) for i in range(n)]
        tasks = [asyncio.ensure_future(a.run()) for a in agents]
        await wait_until(lambda: agents[0].iteration >= 4,
                         what="controller warm-up height")

        def leader_now():
            _, miners, _, _ = agents[0].role_map.committee()
            return max(miners) if miners else 0

        await wait_until(lambda: leader_now() != 0,
                         what="a non-anchor leader round")
        victim = leader_now()
        h_kill = agents[0].iteration
        await hard_stop(agents[victim], tasks[victim])
        t0 = time.monotonic()
        await wait_until(lambda: agents[0].iteration > h_kill,
                         budget=block_s,
                         what="round advance past the dead leader")
        advance_s = time.monotonic() - t0
        survivors = [a for a in agents if a.id != victim]
        results = await asyncio.gather(*(tasks[a.id] for a in survivors))
        return results, agents, advance_s

    results, agents, advance_s = asyncio.run(go())
    assert advance_s < block_s / 3, \
        f"dead-leader round took {advance_s:.1f}s of block_s={block_s}"
    _settled_prefix_equal(pkg, results, min_common=3)
    assert any(r["counters"].get("deadline_adaptive", 0) > 0 for r in results)
    return results, agents  # agent 0, the observer, is never the victim


def test_adaptive_deadline_advances_round_past_dead_leader():
    got = twin(_dead_leader, 19740)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0])
