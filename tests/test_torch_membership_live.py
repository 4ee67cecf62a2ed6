"""Twin of `tests/test_membership.py::test_reshare_round_recovers_after_
miner_loss` on the port's peer: a miner hard-killed after share intake
bumps the membership epoch, and the resharing round still carries the
round to a real block (the late joiner's twin is
`tests/test_torch_late_joiner.py`).

The scenario runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords, makes the reference test's assertions on the port's
run, and holds it to the reference's rejected ids and stake rule
(`torch_twins.assert_first_block_parity` without round 0's block: the
kill lands inside round 0, at a moment no run repeats).

Ports are 19600-19619, which no other test file uses."""

import asyncio

import pytest

from conftest import wait_until
from torch_twins import agent, assert_first_block_parity, cfg, twin

pytestmark = pytest.mark.churn

# the reference file's windows (test_membership.py:39)
FAST = dict(update_s=5.0, block_s=15.0, krum_s=3.0, share_s=5.0, rpc_s=4.0)


def _cfg(pkg, i, n, port, **kw):
    return cfg(pkg, i, n, port, FAST, **dict(dict(max_iterations=3), **kw))


def _miner_loss(pkg, port, draws):
    n = 7

    async def go():
        agents = [agent(pkg, _cfg(pkg, i, n, port, num_miners=3,
                                  secure_agg=True, verification=True,
                                  rpc_retries=0, max_iterations=2),
                        draws=draws) for i in range(n)]
        tasks = [asyncio.ensure_future(a.run()) for a in agents]
        a0 = agents[0]
        await wait_until(lambda: len(a0.role_map.committee()[1]) >= 2,
                         what="round-0 committee election", poll=0)
        miners = sorted(a0.role_map.committee()[1])
        victim = [m for m in miners if m != max(miners)][0]
        await wait_until(
            lambda: agents[victim].counters.get("secret_registered", 0) >= 1,
            what="victim to receive share rows", poll=0)
        t = tasks[victim]
        t.cancel()
        try:
            await t
        except BaseException:
            pass
        survivors = [a for a in agents if a.id != victim]
        results = await asyncio.gather(*(tasks[a.id] for a in survivors))
        return results, agents, survivors

    results, agents, survivors = asyncio.run(go())
    merged = {}
    for r in results:
        for k, v in r["counters"].items():
            merged[k] = merged.get(k, 0) + v
    for key in ("miner_lost", "reshare_round", "reshare_deal_served",
                "reshare_recovered"):
        assert merged.get(key, 0) >= 1, (key, merged)
    assert any(r["telemetry"]["membership"]["epoch"] >= 1 for r in results)
    equal, settled, real = pkg.membership.surviving_prefix_oracle(results)
    assert equal, "chains diverged across the resharing epoch"
    assert real >= 1, results[0]["chain_dump"]
    return results, agents, survivors


def test_reshare_round_recovers_after_miner_loss():
    got = twin(_miner_loss, 19600, stride=10)
    # the victim is round 0's first non-leader miner in both packages
    assert_first_block_parity(got["reference"][2][0], got["port"][2][0],
                              first_block=False)
