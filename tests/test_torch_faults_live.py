"""Twins of `tests/test_faults.py`'s `_call` seams and live chaos
clusters on the port's peer: `PeerAgent._call` on `runtime/faults.py`'s
`FaultInjector` and `HealthLedger`.

Each scenario runs on the reference's agents and on the port's
(`device="cpu"`) from the same config keywords and makes the reference
test's own assertions on the port's run. The `_call` seams are pure in
the mocked transport, so their attempts, counters and breaker ledgers
must equal the reference's. The drop-and-delay cluster's applied fault
schedule must replay on a fresh plan of either package, and its round 0
block must be the reference's (a plain-mode block, ROADMAP C10). The
kill-and-rejoin cluster is timed by the kill: it is held to the breaker's
transitions in both packages and to the reference's rejected ids and
stake rule (`torch_twins.assert_first_block_parity` without round 0).

Ports are 20100-20299, which no other test file uses."""

import asyncio

import pytest

from conftest import wait_until
from torch_twins import (PACKAGES, agent, assert_first_block_parity, cfg,
                         each_package, hard_stop, twin, wait_height)

# the reference file's windows (test_faults.py:33)
CHAOS = dict(update_s=4.0, block_s=12.0, krum_s=3.0, share_s=4.0, rpc_s=4.0)


def _cfg(pkg, i, n, port, **kw):
    return cfg(pkg, i, n, port, CHAOS, **dict(dict(max_iterations=3), **kw))


def _unstarted(pkg, **kw):
    """A never-started agent of `pkg` whose transport the test mocks."""
    return pkg.PeerAgent(_cfg(pkg, 0, 2, 20100, **kw), **pkg.agent_kw)


def _ledger(a):
    """What a `_call` seam decided: the counters and the breaker ledger."""
    snap = a.telemetry_snapshot()
    return {"counters": snap["counters"], "health": snap["health"]}


def test_call_retries_transport_failures_then_succeeds():
    def scenario(pkg):
        a = _unstarted(pkg)
        attempts = []

        async def flaky(host, port, msg_type, meta, arrays, timeout,
                        attempt=0, **kw):
            attempts.append(attempt)
            if len(attempts) < 3:
                raise ConnectionError("synthetic transport failure")
            return {"ok": 1}, {}

        a.pool.call = flaky
        rmeta, _ = asyncio.run(a._call(1, "Echo"))
        assert rmeta["ok"] == 1
        assert attempts == [0, 1, 2], "each retry must carry a fresh attempt"
        assert a.telemetry_snapshot()["counters"].get("rpc_retry", 0) == 2
        assert a.health.state(1) == pkg.faults.CLOSED
        assert 1 in a.alive
        return attempts, _ledger(a)

    each_package(scenario)


def test_call_does_not_retry_protocol_errors():
    def scenario(pkg):
        a = _unstarted(pkg)
        calls = []

        async def reject(host, port, msg_type, meta, arrays, timeout,
                         attempt=0, **kw):
            calls.append(attempt)
            raise pkg.rpc.RPCError("rejected by defense")

        a.pool.call = reject
        with pytest.raises(pkg.rpc.RPCError):
            asyncio.run(a._call(1, "VerifyUpdateKRUM"))
        assert calls == [0], "RPCError is the callee's answer, not a fault"
        assert a.health.state(1) == pkg.faults.CLOSED
        return calls, _ledger(a)

    each_package(scenario)


def test_call_fails_fast_when_breaker_open():
    def scenario(pkg):
        a = _unstarted(pkg, breaker_cooldown_s=60.0)

        async def boom(host, port, msg_type, meta, arrays, timeout,
                       attempt=0, **kw):
            raise ConnectionError("down")

        a.pool.call = boom
        with pytest.raises(ConnectionError):
            asyncio.run(a._call(1, "Echo"))
        assert a.health.state(1) == pkg.faults.OPEN
        assert a.telemetry_snapshot()["counters"].get("breaker_open", 0) == 1

        async def must_not_dial(*a_, **k):
            raise AssertionError("quarantined peer was dialed")

        a.pool.call = must_not_dial
        with pytest.raises(pkg.faults.CircuitOpenError):
            asyncio.run(a._call(1, "Echo"))
        snap = a.telemetry_snapshot()
        assert snap["counters"].get("rpc_fast_fail", 0) == 1
        series = snap["metrics"]["biscotti_breaker_state"]["series"]
        assert series, "breaker gauge missing from the metrics snapshot"
        return _ledger(a), series

    each_package(scenario)


def test_call_releases_probe_slot_on_unexpected_exception():
    def scenario(pkg):
        a = _unstarted(pkg, breaker_threshold=1, breaker_cooldown_s=0.0)
        a.health.record_failure(1)
        assert a.health.state(1) == pkg.faults.OPEN

        async def codec_bug(*a_, **k):
            raise ValueError("unserializable meta")

        a.pool.call = codec_bug
        with pytest.raises(ValueError):
            asyncio.run(a._call(1, "Echo"))  # this call is the probe
        assert a.health.state(1) == pkg.faults.HALF_OPEN
        assert a.health.allow(1), "the probe slot must be reclaimable"
        return _ledger(a)

    each_package(scenario)


def _drop_and_delay(pkg, port, draws):
    n = 4
    plan_kw = dict(seed=11, drop=0.10, delay=0.25, delay_s=0.05)
    plan = pkg.faults.FaultPlan(**plan_kw)

    async def go():
        agents = [agent(pkg, _cfg(pkg, i, n, port, fault_plan=plan),
                        draws=draws) for i in range(n)]
        for a in agents:
            a.pool.faults.log = []  # record the applied schedule
        results = await asyncio.gather(*(a.run() for a in agents))
        return results, agents

    results, agents = asyncio.run(go())
    equal, common, real = pkg.chaos.chain_oracle(results)
    assert common >= 2, [r["chain_dump"] for r in results]
    assert equal, "chains diverged under chaos"
    assert real >= 1, "no real block survived the chaos run"
    fired = pkg.chaos.tally_faults(results)
    assert fired.get("drop", 0) > 0, f"no drops injected: {fired}"
    assert any("delay" in k for k in fired), f"no delays injected: {fired}"
    for a in agents:
        assert a.pool.faults.log, "injector recorded nothing"
        for other in PACKAGES:  # the schedule is pure in the seed
            replay = other.faults.FaultPlan(**plan_kw)
            for dst, msg, attempt, seq, kind in a.pool.faults.log:
                assert replay.action(a.id, dst, msg, attempt, seq).kind() \
                    == kind
    return results, agents


def test_chaos_cluster_drop_and_delay_completes_with_equal_chains():
    got = twin(_drop_and_delay, 20110, stride=10)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0])


def _kill_and_rejoin(pkg, port, draws):
    n, victim, iters = 4, 3, 18
    kw = dict(max_iterations=iters, breaker_threshold=3,
              breaker_cooldown_s=300.0)
    OPEN = pkg.faults.OPEN

    async def go():
        agents = [agent(pkg, _cfg(pkg, i, n, port, **kw), draws=draws)
                  for i in range(n)]
        tasks = [asyncio.ensure_future(a.run()) for a in agents]
        await wait_height(agents[0], 3, budget=90.0)
        await hard_stop(agents[victim], tasks[victim])
        survivors = [a for a in agents if a.id != victim]

        def health():
            return [a.telemetry_snapshot()["health"].get(str(victim), {})
                    for a in survivors]

        def quarantined():
            hs = health()
            return (any(h.get("opens", 0) >= 1 for h in hs)
                    and any(h.get("fast_fails", 0) > 0 for h in hs))

        await wait_until(quarantined, what="breaker to quarantine victim")
        mid_health = health()
        mid_counters = [a.telemetry_snapshot()["counters"] for a in survivors]
        reborn = agent(pkg, _cfg(pkg, victim, n, port, **kw), draws=draws)
        reborn_task = asyncio.ensure_future(reborn.run())

        def readmitted():
            snaps = [a.telemetry_snapshot() for a in survivors]
            return any(s["counters"].get("breaker_close", 0) >= 1
                       and s["health"].get(str(victim), {}).get("state")
                       != OPEN for s in snaps)

        await wait_until(readmitted, what="victim re-admission")
        results = await asyncio.gather(*tasks[:victim], reborn_task)
        return results, survivors + [reborn], mid_health, mid_counters

    results, agents, mid_health, mid_counters = asyncio.run(go())
    equal, common, real = pkg.chaos.chain_oracle(results)
    assert common >= 3 and equal and real >= 1, \
        [r["chain_dump"] for r in results]
    assert [h for h in mid_health if h.get("opens", 0) >= 1], mid_health
    assert any(h.get("fast_fails", 0) > 0 for h in mid_health), mid_health
    assert any(c.get("breaker_open", 0) >= 1 for c in mid_counters)
    end = [r["telemetry"] for r in results[:-1]]
    assert any(s["counters"].get("breaker_close", 0) >= 1 for s in end), \
        [s["counters"] for s in end]
    # the breaker toward the victim opened while it was down and is
    # closed again on a survivor that probed it after the rejoin
    closed = [s["health"][str(victim)] for s in end
              if s["health"].get(str(victim), {}).get("closes", 0) >= 1]
    assert closed and all(h["opens"] >= 1 for h in closed), end
    assert any(h["state"] != OPEN for h in closed), closed
    return results, agents


def test_breaker_quarantines_killed_peer_and_readmits_on_rejoin():
    got = twin(_kill_and_rejoin, 20150, stride=10)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0],
                              first_block=False)
