"""Twins of `tests/test_tracing.py`'s live clusters on the port:
`telemetry/tracectx.py`, the `runtime/rpc.py` and `runtime/hive.py`
dispatch seams, the overlay relay and `tools/trace_round.py`.

Each scenario runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords and makes the reference test's own assertions on the
port's run, the span forest read by each package's own `trace_round`.
Every cluster here runs secure aggregation: where seven peers' committees
are disjoint the port's chain must be the reference's bit for bit; where
three peers' committees overlap, the first update to arrive is pooled
(ROADMAP C8), so those runs are held to the rejected ids and the stake
rule. The round trace ids are a pure function of (seed, iteration): the
port's spans must name the reference's.

Ports are 20700-20899, which no other test file uses."""

import asyncio
import re

import pytest

from torch_twins import (PACKAGES, PORT, agent, assert_first_block_parity,
                         assert_same_dumps, cfg, inject_reference_draws,
                         reference_draws, run_cluster, twin, warm)

pytestmark = pytest.mark.trace

# the reference file's windows (test_tracing.py:20)
FAST = dict(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
            rpc_s=10.0)
ROUND_TRACE = re.compile(r"^[0-9a-f]{8}-r\d+$")


def _cfg(pkg, i, n, port, **kw):
    base = dict(num_miners=2, secure_agg=True, verification=True,
                max_iterations=2)
    return cfg(pkg, i, n, port, FAST, **dict(base, **kw))


def _events(agents):
    return [ev for a in agents for ev in a.tele.recorder.tail(100000)]


def _round_traces(agents):
    """The round trace ids that the agents' events name."""
    return sorted({ev["trace"] for ev in _events(agents)
                   if ROUND_TRACE.match(str(ev.get("trace") or ""))})


def _cross_links(spans):
    """Dispatch spans whose parent is a client span on another node."""
    return [s for s in spans.values()
            if s["phase"].startswith("rpc.")
            and (spans.get(s["parent"] or "") or {}).get("phase")
            == "rpc_call" and spans[s["parent"]]["node"] != s["node"]]


def _dumps(results):
    return [r["chain_dump"] for r in results]


def test_round_trace_id_is_pure_in_seed_and_round():
    ref, port = (pkg.tracectx.trace_id_for for pkg in PACKAGES)
    for seed in (0, 3, 2 ** 32 + 5, -1):
        for it in (0, 1, 17):
            assert port(seed, it) == ref(seed, it)


def _traced(pkg, port, draws):
    n = 7
    on, agents_on = run_cluster(pkg, [_cfg(pkg, i, n, port, trace=True)
                                      for i in range(n)], draws=draws)
    off, _ = run_cluster(pkg, [_cfg(pkg, i, n, port + 10) for i in range(n)],
                         draws=draws)
    assert all(d == on[0]["chain_dump"] for d in _dumps(on))
    assert on[0]["chain_dump"] == off[0]["chain_dump"]
    tr = pkg.trace_round
    events = _events(agents_on)
    spans, _ = tr.collect_spans(events)
    assert len(_cross_links(spans)) >= n  # the block broadcast at least
    recon = tr.reconstruct(events, min_nodes=3)
    complete = [r for r in recon["rounds"] if r["complete"]]
    assert complete, recon["rounds"]
    for row in complete:
        cp = row["critical"]
        assert cp["wall_s"] > 0
        assert len({s["node"] for s in cp["chain"]
                    if s["node"] is not None}) >= 2
        assert abs(sum(cp["segments"].values()) - cp["wall_s"]) < 1e-3
    assert all(abs(o) < 0.5 for o in recon["offsets"].values())
    return on, agents_on, _round_traces(agents_on)


def test_traced_cluster_links_spans_and_chains_match_untraced():
    got = twin(_traced, 20700, stride=20)
    assert_same_dumps(_dumps(got["reference"][0]), _dumps(got["port"][0]))
    assert got["port"][2] == got["reference"][2]


def _mixed(pkg, port, draws):
    n = 3
    cfgs = [_cfg(pkg, i, n, port, trace=(i != 2), num_miners=1)
            for i in range(n)]

    async def go():
        agents = [agent(pkg, c, draws=draws) for c in cfgs]
        legacy, seen = agents[2], []
        orig = legacy._handle

        async def spy(msg_type, meta, arrays):
            seen.append((msg_type, pkg.tracectx.KEY in meta))
            return await orig(msg_type, meta, arrays)

        legacy.server.handler = spy
        results = await asyncio.gather(*(a.run() for a in agents))
        return results, agents, seen

    results, agents, seen = asyncio.run(go())
    assert all(d == results[0]["chain_dump"] for d in _dumps(results))
    assert seen, "legacy peer served no RPCs"
    assert not any(stamped for _, stamped in seen), \
        [mt for mt, s in seen if s]
    for ev in agents[2].tele.recorder.tail(100000):
        assert ev.get("event") != "span" or not ev.get("trace")
    assert [ev for a in agents[:2] for ev in a.tele.recorder.tail(100000)
            if ev.get("event") == "span" and ev.get("span")
            and ev.get("parent")]
    return results, agents, _round_traces(agents[:2])


def test_mixed_cluster_legacy_peer_gets_uncontexted_frames():
    """Three peers overlap their committees, so which worker a round
    pools is the first to arrive (ROADMAP C8), in either package: the run
    is held to the reference's rejected ids and the stake rule."""
    got = twin(_mixed, 20740, stride=10)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0],
                              first_block=False)
    assert got["port"][2] == got["reference"][2]


def _hive(pkg, port, draws):
    c = _cfg(pkg, 0, 3, port, trace=True, num_miners=1)
    warm(pkg, c)
    hive = pkg.hive.Hive(c, local_ids=range(3), batch_device=False,
                         **pkg.agent_kw)
    if pkg is PORT:
        for a in hive.agents:
            inject_reference_draws(a, draws[a.id])
    results = asyncio.run(hive.run())
    assert all(d == results[0]["chain_dump"] for d in _dumps(results))
    loopback = sum(
        r["telemetry"]["metrics"].get("biscotti_loopback_rpcs_total",
                                      {}).get("series", []) != []
        for r in results)
    assert loopback >= 1, "cluster never used the loopback fast path"
    spans, _ = pkg.trace_round.collect_spans(_events(hive.agents))
    assert _cross_links(spans), "no cross-peer links over the loopback seam"
    return results, hive.agents, _round_traces(hive.agents)


def test_loopback_hive_dispatch_adopts_context():
    """Three co-hosted peers overlap their committees (ROADMAP C8), as in
    the mixed cluster."""
    ref = _hive(PACKAGES[0], 20760, None)
    port = _hive(PORT, 20770, reference_draws(ref[1]))
    assert_first_block_parity(ref[1][0], port[1][0], first_block=False)
    assert port[2] == ref[2]


def _overlay(pkg, port, draws):
    n = 7
    results, agents = run_cluster(pkg, [
        _cfg(pkg, i, n, port, trace=True, overlay=True, overlay_group=3)
        for i in range(n)], draws=draws)
    assert all(d == results[0]["chain_dump"] for d in _dumps(results))
    spans, _ = pkg.trace_round.collect_spans(_events(agents))
    hops = []
    for s in spans.values():
        # target dispatch <- relay's forward rpc_call <- relay dispatch
        if not s["phase"].startswith("rpc."):
            continue
        fwd = spans.get(s["parent"] or "")
        if fwd is None or fwd["phase"] != "rpc_call":
            continue
        relay = spans.get(fwd["parent"] or "")
        if relay is not None and relay["phase"] in ("rpc.RelayFrames",
                                                    "rpc.OverlayOffer"):
            hops.append((relay["node"], s["node"]))
    offers = [s for s in spans.values()
              if s["phase"] in ("rpc.OverlayOffer", "rpc.RegisterAggregate",
                                "rpc.RelayFrames")]
    assert offers, "overlay run produced no overlay dispatch spans"
    assert hops, "no re-parented relay hop found in the span forest"
    return results, agents, _round_traces(agents)


@pytest.mark.overlay
def test_overlay_relay_reparents_per_hop():
    got = twin(_overlay, 20780, stride=10)
    assert_same_dumps(_dumps(got["reference"][0]), _dumps(got["port"][0]))
    assert got["port"][2] == got["reference"][2]
