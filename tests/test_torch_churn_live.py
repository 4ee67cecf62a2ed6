"""Twins of `tests/test_membership.py`'s churn clusters on the port:
`runtime/faults.py::FaultPlan.churn_schedule`,
`runtime/membership.py::ChurnRunner` and the peer's self-kill.

Each scenario runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords and makes the reference test's own assertions on the
port's run. The churn schedule is pure in its seed: the port's must be
the reference's, and each package must apply a prefix of it in order.
Which blocks a churned run mints follows the moments of its kills, so
the runs are held to the reference's rejected ids and the stake rule
(`torch_twins.assert_first_block_parity` without round 0).

Ports are 21100-21299, which no other test file uses."""

import asyncio

import pytest

from torch_twins import agent, assert_first_block_parity, cfg, twin

# the reference file's windows (test_membership.py:39)
FAST = dict(update_s=5.0, block_s=15.0, krum_s=3.0, share_s=5.0, rpc_s=4.0)
CHURN = dict(seed=14, churn=0.25, churn_period=4, churn_down=2)


def _cfg(pkg, i, n, port, **kw):
    return cfg(pkg, i, n, port, FAST, **dict(dict(max_iterations=3), **kw))


def _schedule(pkg, n, rounds):
    return [(e.round, e.node, e.kind)
            for e in pkg.faults.FaultPlan(**CHURN).churn_schedule(n, rounds)]


def _churn(pkg, port, draws):
    n, rounds = 5, 8
    schedule = pkg.faults.FaultPlan(**CHURN).churn_schedule(n, rounds)
    f = pkg.faults
    assert {e.kind for e in schedule} == {f.JOIN, f.KILL, f.RESTART}, \
        schedule
    made = {}

    def make(i):
        made[i] = agent(pkg, _cfg(pkg, i, n, port, max_iterations=rounds,
                                  verification=True,
                                  breaker_cooldown_s=1.0), draws=draws)
        return made[i]

    async def go():
        runner = pkg.membership.ChurnRunner(make, n, schedule)
        return await runner.run(), runner.events_applied

    results, applied = asyncio.run(go())
    assert len(results) == n
    equal, settled, real = pkg.membership.surviving_prefix_oracle(results)
    assert equal, [r["chain_dump"] for r in results]
    assert settled >= 3, f"no progress under churn: settled={settled}"
    assert real >= 1, "no real block survived the churn run"
    # the runner applied a prefix of the schedule, in order
    assert applied, "runner applied nothing"
    assert applied == [(e.round, e.node, e.kind)
                       for e in schedule][:len(applied)]
    joins = sum(r["counters"].get("member_join", 0) for r in results)
    assert joins >= 1, [r["counters"] for r in results]
    assert _schedule(pkg, n, rounds) == [(e.round, e.node, e.kind)
                                         for e in schedule]
    return results, [made[i] for i in range(n)], _schedule(pkg, n, rounds)


@pytest.mark.churn
def test_churn_cluster_seeded_schedule_survives():
    got = twin(_churn, 21100, stride=10)
    assert got["port"][2] == got["reference"][2], "the churn schedules"
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0],
                              first_block=False)


def _self_kill(pkg, port, draws):
    n = 2

    def mk(i):
        return agent(pkg, _cfg(pkg, i, n, port, max_iterations=4,
                               fedsys=True), draws=draws)

    async def go():
        a0, a1 = mk(0), mk(1)
        a1._churn_kills = frozenset({1})  # the schedule seam, directly
        t0 = asyncio.ensure_future(a0.run())
        r1 = await a1.run()
        assert r1.get("churned") is True
        assert r1["iterations"] == 1
        assert r1["counters"].get("churn_self_kill", 0) == 1
        # the port is free at once: a fresh incarnation binds, no retry
        reborn = mk(1)
        r1b_task = asyncio.ensure_future(reborn.run())
        r0 = await t0
        r1b = await r1b_task
        return (r0, r1, r1b), (a0, a1, reborn)

    (r0, r1, r1b), agents = asyncio.run(go())
    assert r0["iterations"] == 4
    assert not r1b.get("churned")
    return (r0, r1b), agents, (r1["iterations"],
                               r1["counters"].get("churn_self_kill"))


def test_churn_self_kill_exits_cleanly_and_port_is_free():
    got = twin(_self_kill, 21130, stride=10)
    assert got["port"][2] == got["reference"][2]
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0],
                              first_block=False)
