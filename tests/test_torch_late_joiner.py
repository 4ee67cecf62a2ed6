"""Twin of `tests/test_membership.py::test_snapshot_bootstrap_late_
joiner_skips_history` on the port's peer: a late joiner bootstraps from
a snapshot to the cluster's height without pulling the pre-snapshot
blocks (wire byte accounting).

The scenario runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords, makes the reference test's assertions on the port's
run, and holds it to the reference's round-0 block, rejected ids and
stake rule (`torch_twins.assert_first_block_parity`: the join lands at a
moment no run repeats, and plain-mode hashes part, ROADMAP C10). Each
run rides the update window of the peer that has not joined yet for six
rounds, ~50 s, so the two clusters run side by side in one event loop
and the case has a file of its own.

Ports are 19640-19699, which no other test file uses."""

import asyncio

import pytest

from conftest import wait_until
from torch_twins import PORT, REF, agent, assert_first_block_parity, cfg

pytestmark = pytest.mark.churn

# the reference file's windows (test_membership.py:39)
FAST = dict(update_s=5.0, block_s=15.0, krum_s=3.0, share_s=5.0, rpc_s=4.0)


def _cfg(pkg, i, n, port, **kw):
    return cfg(pkg, i, n, port, FAST, **kw)


async def _late_joiner(pkg, port, draws):
    n, rounds = 4, 9
    agents = [agent(pkg, _cfg(pkg, i, n, port, max_iterations=rounds,
                              verification=True), draws=draws)
              for i in range(3)]
    tasks = [asyncio.ensure_future(a.run()) for a in agents]
    await wait_until(lambda: agents[0].iteration >= 6,
                     what="cluster to build history")
    late = agent(pkg, _cfg(pkg, 3, n, port, max_iterations=rounds,
                           verification=True, snapshot_bootstrap=True,
                           snapshot_tail=3), draws=draws)
    ltask = asyncio.ensure_future(late.run())
    return await asyncio.gather(*tasks, ltask), agents + [late]


def _check(pkg, results):
    late = results[-1]
    assert late["counters"].get("snapshot_adopted", 0) == 1
    assert late["iterations"] == max(r["iterations"] for r in results)
    assert late["telemetry"]["membership"]["pruned_before"] > 0
    assert "pruned heights=" in late["chain_dump"]
    inbound = {}
    fam = late["telemetry"]["metrics"].get("biscotti_wire_bytes_total", {})
    for row in fam.get("series", []):
        labels = row.get("labels", {})
        if labels.get("direction") == "in":
            mt = labels["msg_type"]
            inbound[mt] = inbound.get(mt, 0) + int(row["value"])
    snap_bytes = inbound.get("GetSnapshot.reply", 0)
    assert snap_bytes > 0, inbound
    assert inbound.get("GetBlock.reply", 0) < snap_bytes, inbound
    assert inbound.get("RegisterPeer.reply", 0) < snap_bytes, inbound
    equal, settled, real = pkg.membership.surviving_prefix_oracle(results)
    assert equal and real >= 1


def test_snapshot_bootstrap_late_joiner_skips_history():
    # the two clusters share one event loop: each round waits out the
    # window of the peer that has not joined, so they run side by side;
    # the port's agents take the draws of reference Trainers of the same
    # peers, made before either cluster starts
    draws = {i: REF.PeerAgent(_cfg(REF, i, 4, 19690, max_iterations=9,
                                   verification=True)).trainer
             for i in range(4)}

    async def both():
        return await asyncio.gather(_late_joiner(REF, 19640, None),
                                    _late_joiner(PORT, 19660, draws))

    (ref, ref_agents), (port, port_agents) = asyncio.run(both())
    for pkg, results in ((REF, ref), (PORT, port)):
        _check(pkg, results)
    assert_first_block_parity(ref_agents[0], port_agents[0])
