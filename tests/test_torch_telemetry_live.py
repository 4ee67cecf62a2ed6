"""Twins of `tests/test_telemetry.py`'s live telemetry on the port's peer:
a dealer-keyed cluster scraped over the `Metrics` RPC in the middle of
its run and merged by `tools.obs`, and the legacy keys of `run()`'s
result beside its `telemetry` snapshot and the recorder's spill.

Each package writes its own key directory (`tools.keygen.generate`, the
dealer's fixed label) from the same stream of node identity seeds (the
OS's in the reference test, a seeded stream here), so the two
directories must be equal file for file, and each cluster boots from its
own. Each scenario runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) and makes the
reference test's assertions on the port's run, with each package's own
`tools.obs`; the reference's `merge_snapshots` on the port's scrape must
give the port's merge. The reference's scrape runs in plain mode, held
to round 0's block, the rejected ids and the stake rule (ROADMAP C10);
the same cluster under secure aggregation, added, mints the reference's
chain bit for bit where the two runs pooled alike
(`torch_twins.assert_same_chain_where_pooled_alike`). The result's keys,
its snapshot's and the spill's are the reference's.

Ports are 22000-22199, which no other test file uses."""

import asyncio
import json
import os
import random
import secrets

import pytest

from torch_twins import (PACKAGES, agent, assert_first_block_parity,
                         assert_same_chain_where_pooled_alike, cfg, twin)

# the reference file's windows (test_telemetry.py:38), which the 2-peer
# run, whose rounds have no worker, rides; the scraped cluster takes
# windows no honest peer misses under a loaded test run (an honest round
# mints as soon as its workers are accounted for)
FAST = dict(update_s=4.0, block_s=20.0, krum_s=4.0, share_s=4.0, rpc_s=6.0)
WINDOWS = dict(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
               rpc_s=20.0)
N = 4
DIMS = 50  # creditcard num_params


@pytest.fixture(scope="module")
def key_dirs(tmp_path_factory):
    dirs = {}
    for pkg in PACKAGES:
        draw = random.Random(1)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(secrets, "token_bytes",
                      lambda n: bytes(draw.getrandbits(8) for _ in range(n)))
            dirs[pkg.name] = out = str(tmp_path_factory.mktemp(pkg.name))
            pkg.keygen.generate(dims=DIMS, nodes=N, out_dir=out)
    for name in ("commit_key.json", "node_keys.json", "peers.txt"):
        texts = [open(os.path.join(d, name)).read() for d in dirs.values()]
        assert texts[0] == texts[1], f"{name} differs across the packages"
    return dirs


def _cfg(pkg, i, port, **kw):
    return cfg(pkg, i, N, port, WINDOWS, max_iterations=6, **kw)


async def _wait_height(agent_, h: int, budget: float = 90.0):
    deadline = asyncio.get_event_loop().time() + budget
    while agent_.iteration < h:
        assert asyncio.get_event_loop().time() < deadline, \
            f"cluster never reached height {h}"
        await asyncio.sleep(0.05)


def _scrape(pkg, port, draws, key_dir, secure):
    ports = [port + i for i in range(N)]

    async def go():
        agents = [agent(pkg, _cfg(pkg, i, port, secure_agg=secure),
                        draws=draws, key_dir=key_dir) for i in range(N)]
        tasks = [asyncio.ensure_future(a.run()) for a in agents]
        await _wait_height(agents[0], 2)
        first = await pkg.obs.scrape("127.0.0.1", ports, tail=5)
        await _wait_height(agents[0], 4)
        second = await pkg.obs.scrape("127.0.0.1", ports)
        rmeta, _ = await pkg.rpc.call("127.0.0.1", port, "Metrics", {})
        results = await asyncio.gather(*tasks)
        return first, second, rmeta, results, agents

    first, second, rmeta, results, agents = asyncio.run(go())
    assert not any(s.get("unreachable") for s in first), first
    m1, m2 = (pkg.obs.merge_snapshots(s) for s in (first, second))
    assert m1["nodes"] == N and m2["nodes"] == N
    assert m1["round_height"]["max"] >= 2
    assert m2["round_height"]["max"] > m1["round_height"]["max"], \
        "round-height gauges must advance between mid-run scrapes"
    assert "sgd" in m2["phases"] and "p99_s" in m2["phases"]["sgd"]
    assert all(s.get("events") for s in first)
    ev = first[0]["events"][-1]
    assert {"seq", "ts", "mono", "event"} <= set(ev)
    page = rmeta["prom"]
    assert "# TYPE biscotti_round_height gauge" in page
    assert "biscotti_phase_seconds_bucket" in page
    assert "biscotti_rpc_frames_total" in page
    table = pkg.obs.format_table(m2)
    assert "cluster: 4 peers" in table and "phase" in table
    out = [r["chain_dump"] for r in results]
    assert all(d == out[0] for d in out)
    return results, agents, (first, second)


@pytest.mark.parametrize("secure,port", [(False, 22000), (True, 22040)],
                         ids=["plain", "secure"])
def test_live_keyed_cluster_scrape_mid_run(key_dirs, secure, port):
    got = twin(lambda pkg, p, d: _scrape(pkg, p, d, key_dirs[pkg.name],
                                         secure), port)
    ref, mine = got["reference"], got["port"]
    # the two packages' obs merge the port's scrapes alike
    ref_obs, port_obs = (pkg.obs for pkg in PACKAGES)
    for snaps in mine[2]:
        assert ref_obs.merge_snapshots(snaps) \
            == port_obs.merge_snapshots(snaps)
    if secure:
        assert_same_chain_where_pooled_alike(ref[:2], mine[:2])
    else:
        assert_first_block_parity(ref[1][0], mine[1][0])


def _legacy(pkg, port, draws, tmp_path):
    logs = [str(tmp_path / f"{pkg.name}-n{i}.jsonl") for i in range(2)]

    async def go():
        agents = [agent(pkg, cfg(pkg, i, 2, port, FAST, max_iterations=2),
                        draws=draws, log_path=logs[i]) for i in range(2)]
        return await asyncio.gather(*(a.run() for a in agents)), agents

    results, agents = asyncio.run(go())
    for r in results:
        for key in ("node", "iterations", "converged", "chain_dump",
                    "final_error", "counters", "phases", "health",
                    "faults", "telemetry"):
            assert key in r, f"run() result lost legacy key {key!r}"
        snap = r["telemetry"]
        assert snap["iter"] == r["iterations"]
        assert snap["phases"] == r["phases"]
        assert "metrics" in snap and "recorder" in snap
    spills = []
    for p in logs:
        lines = [json.loads(x) for x in open(p).read().splitlines()]
        assert lines, "recorder spill is empty"
        assert any(e["event"] == "round_end" for e in lines)
        assert all({"ts", "mono", "seq", "node", "event"} <= set(e)
                   for e in lines)
        spills.append(lines)
    return results, agents, spills


def test_run_result_keeps_legacy_keys(tmp_path):
    got = twin(lambda pkg, p, d: _legacy(pkg, p, d, tmp_path), 22080)
    ref, mine = got["reference"], got["port"]
    for r_ref, r_port in zip(ref[0], mine[0]):
        assert set(r_port) == set(r_ref)
        assert set(r_port["telemetry"]) == set(r_ref["telemetry"])
    # every spilled event carries the reference's stamps, and the round
    # events the reference's own fields
    for s_ref, s_port in zip(ref[2], mine[2]):
        fields = {}
        for e in s_ref:
            fields.setdefault(e["event"], set(e))
        for e in s_port:
            if e["event"] in ("round_start", "round_end"):
                assert set(e) == fields[e["event"]], e
    assert_first_block_parity(ref[1][0], mine[1][0])
