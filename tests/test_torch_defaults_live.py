"""Twins of the live defaults-off guards and the clean defense run on the
port's peer: `tests/test_stragglers.py`'s cluster with the straggler
plane off (zero straggler counters, every deadline the legacy constant,
no pads), `tests/test_trust.py`'s KRUM cluster that arms no TrustLedger
and emits no trust metric, and its clean ENSEMBLE run, where honest
peers accrue no false rejection.

Each scenario runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords and makes the reference test's assertions on the port's
run. The planes' metric and counter names are the reference's: what the
port's run registered under the straggler, trust and defense families
is what the reference's did. The runs are plain mode, held to round 0's
block, the rejected ids and the stake rule (ROADMAP C10).

Ports are 22200-22399, which no other test file uses."""

import asyncio

import pytest

from torch_twins import (agent, assert_first_block_parity, cfg, run_cluster,
                         twin)

# windows no honest peer misses under a loaded test run (the reference
# files' are 4/12/3/4/4 s, test_stragglers.py:35, and 5/15/3/5/4 s,
# test_trust.py:30); an honest round mints as soon as its workers are
# accounted for, so they cost nothing
WINDOWS = dict(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
               rpc_s=20.0)
FAMILIES = ("biscotti_straggler", "biscotti_slow", "biscotti_deadline",
            "biscotti_trust", "biscotti_defense")


def _plane_names(results) -> tuple:
    """The straggler, trust and defense metric and counter names the run's
    peers registered."""
    metrics = {k for r in results for k in r["telemetry"]["metrics"]
               if k.startswith(FAMILIES)}
    counters = {k for r in results for k in r["counters"]
                if k.startswith(("straggler", "deadline", "trust",
                                 "defense"))}
    return sorted(metrics), sorted(counters)


def _stragglers_off(pkg, port, draws):
    n = 4

    async def go():
        agents = [agent(pkg, cfg(pkg, i, n, port, WINDOWS,
                                 max_iterations=3), draws=draws)
                  for i in range(n)]
        return await asyncio.gather(*(a.run() for a in agents)), agents

    results, agents = asyncio.run(go())
    eq, common, _ = pkg.chaos.chain_oracle(results)
    assert eq, "settled chain prefixes diverged"
    assert common >= 1
    for r in results:
        s = r["telemetry"]["stragglers"]
        assert not s["profile"]["slowed"]
        assert s["excluded"] == {} and s["stalls"] == {}
        assert not s["deadlines"]["enabled"]
        for row in s["deadlines"]["phases"].values():
            assert not row.get("adaptive", False)
        assert r["counters"].get("straggler_excluded", 0) == 0
        assert r["counters"].get("deadline_adaptive", 0) == 0
        mets = r["telemetry"]["metrics"]
        assert pkg.stragglers.EXCLUDED_METRIC not in mets
        fam = mets.get("biscotti_slow_compute_factor", {})
        for row in fam.get("series", []):
            assert row["value"] == 1.0
    return results, agents


@pytest.mark.straggler
def test_defaults_off_cluster_has_zero_straggler_activity():
    got = twin(_stragglers_off, 22200)
    ref, mine = got["reference"], got["port"]
    assert _plane_names(mine[0]) == _plane_names(ref[0])
    assert_first_block_parity(ref[1][0], mine[1][0])


def _trust_cfgs(pkg, n, port, **kw):
    return [cfg(pkg, i, n, port, WINDOWS, verification=True,
                max_iterations=3, **kw) for i in range(n)]


def _ensemble_clean(pkg, port, draws):
    n = 6
    results, agents = run_cluster(
        pkg, _trust_cfgs(pkg, n, port, defense="ENSEMBLE"), draws=draws)
    eq, _, real = pkg.chaos.chain_oracle(results)
    assert eq and real >= 1
    saw_stream = False
    for a, r in zip(agents, results):
        assert a.trust is not None
        tr = r["telemetry"].get("trust")
        assert tr is not None and tr["defense"] == "ENSEMBLE"
        led = tr.get("ledger")
        if led is not None:
            assert led["flagged"] == [] and led["resets"] == {}
            assert not any(v in led["votes"] for v in
                           ("geometry", "similarity", "magnitude",
                            "drift", "hold"))
        for row in tr.get("stream", []):
            saw_stream = True
            assert all(row["accept"]), row
            assert not any(row["votes"]), row
    assert saw_stream
    return results, agents


@pytest.mark.defense
def test_ensemble_clean_run_zero_false_rejections():
    got = twin(_ensemble_clean, 22240)
    ref, mine = got["reference"], got["port"]
    assert _plane_names(mine[0]) == _plane_names(ref[0])
    assert_first_block_parity(ref[1][0], mine[1][0])


def _trust_off(pkg, port, draws):
    n = 4
    results, agents = run_cluster(
        pkg, _trust_cfgs(pkg, n, port, defense="KRUM"), draws=draws)
    eq, _, real = pkg.chaos.chain_oracle(results)
    assert eq and real >= 1
    for a, r in zip(agents, results):
        assert a.trust is None
        snap = r["telemetry"]
        assert pkg.trust.TRUST_METRIC not in snap["metrics"]
        assert not any(k.startswith(pkg.trust.VOTES_METRIC)
                       for k in snap["counters"])
        tr = snap.get("trust")
        if tr is not None:
            assert "ledger" not in tr
            assert tr["defense"] == "KRUM"
    return results, agents


@pytest.mark.defense
def test_defaults_off_guard_no_ledger_no_trust_metrics():
    got = twin(_trust_off, 22280)
    ref, mine = got["reference"], got["port"]
    assert _plane_names(mine[0]) == _plane_names(ref[0])
    assert_first_block_parity(ref[1][0], mine[1][0])
