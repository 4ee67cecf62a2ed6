"""Twin of `tests/test_fault_injection.py::test_partition_window_heals_
and_chain_matches` on the port's live peer: a minority peer cut off
mid-run rides its block timer, the majority mints on, and after the cut
heals the minority shares the majority's settled prefix.

The scenario runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords, makes the reference test's assertions on the port's
run, and holds it to the reference's round-0 block, rejected ids and
stake rule (`torch_twins.assert_first_block_parity`: the window lands at
a moment no run repeats, and plain-mode hashes part, ROADMAP C10). It
has a file of its own because it holds each run ~20 s.

Ports are 19400-19449, which no other test file uses."""

import asyncio

from torch_twins import (agent, assert_first_block_parity, cfg, twin,
                         wait_height)

FAST = dict(update_s=3.0, block_s=8.0, krum_s=3.0, share_s=3.0, rpc_s=4.0)
CUT = set()  # ids on the minority side, one switch for every agent


def _partitioned(pkg):
    class PartitionedPeer(pkg.PeerAgent):
        """Drops traffic across CUT at the pool, like an iptables window
        (the minted-block broadcast goes through pool.post too)."""

        def __init__(self, c, **kw):
            super().__init__(c, **kw)
            orig_call, orig_post = self.pool.call, self.pool.post

            def blocked(port: int) -> bool:
                return (self.id in CUT) != (port - self.cfg.base_port in CUT)

            async def call(host, port, *a, **k):
                if blocked(port):
                    raise ConnectionError("partitioned")
                return await orig_call(host, port, *a, **k)

            async def post(host, port, *a, **k):
                if blocked(port):
                    raise ConnectionError("partitioned")
                return await orig_post(host, port, *a, **k)

            self.pool.call, self.pool.post = call, post

    return PartitionedPeer


def _partition(pkg, port, draws):
    n, minority = 4, {3}
    cls = _partitioned(pkg)

    async def go():
        agents = [agent(pkg, cfg(pkg, i, n, port, FAST, max_iterations=40),
                        cls, draws) for i in range(n)]
        tasks = [asyncio.ensure_future(a.run()) for a in agents]
        await wait_height(agents[0], 3)
        cut_height = agents[0].iteration
        CUT.update(minority)
        await asyncio.sleep(FAST["block_s"] + 2.0)
        await wait_height(agents[0], cut_height + 3)
        CUT.clear()
        return await asyncio.gather(*tasks), agents

    try:
        results, agents = asyncio.run(go())
    finally:
        CUT.clear()
    majority = [r["chain_dump"] for r, a in zip(results, agents)
                if a.id not in minority]
    assert all(d == majority[0] for d in majority)
    minority_res = next(r for r, a in zip(results, agents)
                        if a.id in minority)
    assert minority_res["counters"].get("block_timeout_empty_fallback", 0) \
        >= 1, "partition never took effect"
    maj = majority[0].splitlines()
    mino = minority_res["chain_dump"].splitlines()
    common = min(len(maj), len(mino)) - 1
    assert common >= 2
    assert maj[:common] == mino[:common], (
        f"fork did not heal:\nmajority={maj}\nminority={mino}")
    return results, agents


def test_partition_window_heals_and_chain_matches():
    got = twin(_partition, 19400)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0])
