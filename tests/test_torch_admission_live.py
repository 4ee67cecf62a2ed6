"""Twins of `tests/test_admission.py`'s client path, transport boundary
and live flood clusters on the port: `runtime/admission.py`,
`runtime/rpc.py` (`FrameStream`'s read deadline, the BusyError status)
and `PeerAgent`'s parking.

Each scenario runs on the reference's package and on the port's
(`device="cpu"` agents) and makes the reference test's own assertions on
the port's run. The client-path and transport cases are pure in their
mocked transport or their fixed frames, so their attempts, counters,
sheds and replies must equal the reference's. The flood clusters are
timed by the storm: each is held to the reference's assertions, to
caps that bound every peak, to no breaker between honest peers, and to
round 0's plain-mode block (ROADMAP C10). A reference server and a port
client (and the other way round) also shed alike over the wire.

Ports are 20300-20499, which no other test file uses."""

import asyncio
import struct

import numpy as np
import pytest

from torch_twins import (PACKAGES, PORT, REF, agent,
                         assert_first_block_parity, cfg, each_package,
                         tight_admission, twin)

# the reference file's windows (test_admission.py:40)
FAST = dict(update_s=4.0, block_s=12.0, krum_s=3.0, share_s=4.0, rpc_s=4.0)


def _cfg(pkg, i, n, port, **kw):
    return cfg(pkg, i, n, port, FAST, **dict(dict(max_iterations=3), **kw))


def _unstarted(pkg, n=2, **kw):
    return pkg.PeerAgent(_cfg(pkg, 0, n, 20300, **kw), **pkg.agent_kw)


# --------------------------------------------------- client path: BusyError


def test_call_retries_busy_with_backoff_breaker_never_advances():
    def scenario(pkg):
        a = _unstarted(pkg)
        attempts = []

        async def busy_then_ok(host, port, msg_type, meta, arrays, timeout,
                               attempt=0, **kw):
            attempts.append(attempt)
            if len(attempts) < 3:
                raise pkg.rpc.BusyError("admission shed: rate")
            return {"ok": 1}, {}

        a.pool.call = busy_then_ok
        rmeta, _ = asyncio.run(a._call(1, "RegisterUpdate"))
        assert rmeta["ok"] == 1
        assert attempts == [0, 1, 2], "busy replies must be retried"
        snap = a.telemetry_snapshot()
        assert snap["counters"].get("rpc_busy_retry", 0) == 2
        assert a.health.state(1) == pkg.faults.CLOSED
        assert snap["health"].get("1", {}).get("total_failures", 0) == 0
        assert snap["health"].get("1", {}).get("opens", 0) == 0
        return attempts, snap["counters"], snap["health"]

    each_package(scenario)


def test_permanently_busy_peer_gives_up_without_quarantine():
    def scenario(pkg):
        a = _unstarted(pkg)
        calls = []

        async def always_busy(host, port, msg_type, meta, arrays, timeout,
                              attempt=0, **kw):
            calls.append(attempt)
            raise pkg.rpc.BusyError("admission shed: peer_inflight")

        a.pool.call = always_busy
        with pytest.raises(pkg.rpc.BusyError):
            asyncio.run(a._call(1, "RegisterUpdate"))
        assert len(calls) == 1 + a.cfg.rpc_retries, "budget fully spent"
        assert 1 in a.alive
        assert a.health.state(1) == pkg.faults.CLOSED
        assert a._peer_busy(1), "peer must be marked busy for the round"
        snap = a.telemetry_snapshot()
        assert snap["counters"].get("rpc_busy_give_up", 0) == 1
        assert snap["counters"].get("breaker_open", 0) == 0
        return calls, snap["counters"], snap["health"]

    each_package(scenario)


def _fanout(a, busy):
    for pid in busy:
        a._busy_peers[pid] = a.iteration
    sent = []

    async def record(pid, msg_type, meta=None, arrays=None, timeout=None,
                     retries=None):
        sent.append(pid)
        return {}, {}

    a._call = record

    async def go():
        a._gossip_block(a._empty_block(), full=False)
        await asyncio.sleep(0.3)  # let the advertise tasks run

    asyncio.run(go())
    return sent


def test_gossip_fanout_deprioritizes_busy_peer():
    def scenario(pkg):
        # 10 peers: fan-out = max(3, log2(9) + 1) = 4, the 8 fresh
        # targets fill the draw, so the busy peer is not advertised to
        a = _unstarted(pkg, n=10)
        sent = _fanout(a, [3])
        assert sent, "no advertise fan-out happened"
        assert 3 not in sent, "busy peer must be deprioritized"
        assert a.counters.get("gossip_deprioritize_busy", 0) == 1
        assert a.health.state(3) == pkg.faults.CLOSED
        # where fresh targets cannot fill the draw, busy peers top it up
        sent2 = _fanout(_unstarted(pkg, n=4), [1, 2, 3])
        assert sorted(sent2) == [1, 2, 3]
        return sorted(sent), sorted(sent2)

    each_package(scenario)


def test_wait_for_iteration_sheds_oldest_as_busy():
    def scenario(pkg):
        a = _unstarted(pkg, admission_plan=pkg.admission.AdmissionPlan(
            enabled=True, max_parked=1))

        async def go():
            first = asyncio.ensure_future(
                a._wait_for_iteration(2, budget=5.0))
            await asyncio.sleep(0.1)  # first is parked
            second = asyncio.ensure_future(
                a._wait_for_iteration(2, budget=5.0))
            with pytest.raises(pkg.rpc.BusyError):
                await first  # evicted by the newer waiter
            second.cancel()
            try:
                await second
            except asyncio.CancelledError:
                pass

        asyncio.run(go())
        snap = a.admission.snapshot()
        assert snap["shed"].get("parked_cap", 0) == 1
        assert snap["parked"] == 0, "a cancelled waiter must unpark"
        assert snap["parked_peak"] <= 1 + 1
        return snap["shed"], snap["parked"]

    each_package(scenario)


# ------------------------------------------------------ transport boundary


def _inflight(server_pkg, client_pkg, port):
    rpc = server_pkg.rpc

    async def go():
        gate = asyncio.Event()

        async def handler(mt, meta, arrays):
            await gate.wait()
            return {"served": 1}, {}

        srv = rpc.RPCServer("127.0.0.1", port, handler)
        srv.admission = server_pkg.admission.AdmissionController(
            server_pkg.admission.AdmissionPlan(
                enabled=True, peer_inflight=2, global_inflight=8,
                update_rate=1e9, bulk_rate=1e9, control_rate=1e9))
        await srv.start()
        pool = client_pkg.rpc.Pool()
        try:
            calls = [asyncio.ensure_future(
                pool.call("127.0.0.1", port, "Metrics", {"source_id": 9},
                          timeout=5.0))
                for _ in range(6)]
            await asyncio.sleep(0.4)  # busy sheds come back at once
            gate.set()
            results = await asyncio.gather(*calls, return_exceptions=True)
        finally:
            pool.close()
            await srv.stop()
        return srv.admission.snapshot(), results

    snap, results = asyncio.run(go())
    ok = [r for r in results if isinstance(r, tuple)]
    busy = [r for r in results if isinstance(r, client_pkg.rpc.BusyError)]
    assert len(ok) == 2 and len(busy) == 4, results
    assert snap["shed"].get("peer_inflight", 0) == 4
    assert snap["inflight_peak"] == 2, "the cap must bound concurrency"
    assert snap["inflight"] == 0, "all tickets released"
    return snap["shed"], sorted((r[0]["served"], r[0]["_wire_codec"])
                                for r in ok)


@pytest.mark.parametrize("server,client,port", [
    (PORT, PORT, 20310), (REF, REF, 20312), (PORT, REF, 20314),
    (REF, PORT, 20316)],
    ids=["port", "reference", "port-server", "port-client"])
def test_server_sheds_over_inflight_cap_with_busy_status(server, client,
                                                         port):
    got = _inflight(server, client, port)
    assert got == ({"peer_inflight": 4}, [(1, "raw64")] * 2), got


def _slow_loris(pkg, port):
    rpc = pkg.rpc

    async def go():
        async def handler(mt, meta, arrays):
            return {"pong": 1}, {}

        srv = rpc.RPCServer("127.0.0.1", port, handler)
        srv.read_deadline = 0.4
        await srv.start()
        try:
            # a frame prefix promising 1000 bytes, then a stall
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(struct.pack(">I", 1000) + b"\x00\x00")
            await writer.drain()
            data = await asyncio.wait_for(reader.read(), 3.0)
            assert data == b"", "server must drop the stalled connection"
            writer.close()
            # an honest frame on a fresh connection is still served
            rmeta, _ = await rpc.call("127.0.0.1", port, "Metrics", {},
                                      timeout=3.0)
            assert rmeta.get("pong") == 1
            return data, rmeta
        finally:
            await srv.stop()

    return asyncio.run(go())


def test_read_deadline_drops_slow_loris_but_not_honest_conns():
    ref, port = (_slow_loris(pkg, 20320 + k)
                 for k, pkg in enumerate(PACKAGES))
    assert port == ref and ref[1]["pong"] == 1, (port, ref)


def _chunked(pkg, port):
    rpc = pkg.rpc

    async def go():
        got = []

        async def handler(mt, meta, arrays):
            got.append({k: v.shape for k, v in arrays.items()})
            return {"pong": 1}, {}

        srv = rpc.RPCServer("127.0.0.1", port, handler)
        srv.read_deadline = 0.6
        await srv.start()
        try:
            # ~160 KB in 64 KiB continuation chunks, one chunk per 0.4 s
            blob = pkg.messages.encode("Metrics", {"rid": 1},
                                       {"x": np.zeros(20000, np.float64)},
                                       chunk_bytes=65536)
            frames, off = [], 0
            while off < len(blob):
                (n,) = struct.unpack(">I", blob[off: off + 4])
                frames.append(blob[off: off + 4 + n])
                off += 4 + n
            assert len(frames) >= 3, "payload did not chunk"
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            for f in frames:
                writer.write(f)
                await writer.drain()
                await asyncio.sleep(0.4)
            reply = await asyncio.wait_for(reader.read(64), 3.0)
            assert reply, "server dropped a legitimate chunked transfer"
            writer.close()
        finally:
            await srv.stop()
        assert got and got[0]["x"] == (20000,)
        return frames, got

    return asyncio.run(go())


def test_read_deadline_chunk_progress_keeps_slow_bulk_transfers_alive():
    ref, port = (_chunked(pkg, 20330 + k) for k, pkg in enumerate(PACKAGES))
    assert port[0] == ref[0], "the port chunks the payload otherwise"
    assert port[1] == ref[1]


def _legacy_patience(pkg, port):
    rpc = pkg.rpc

    async def go():
        async def handler(mt, meta, arrays):
            return {}, {}

        srv = rpc.RPCServer("127.0.0.1", port, handler)  # no deadline
        assert not srv.read_deadline
        await srv.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(struct.pack(">I", 1000))
            await writer.drain()
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(reader.read(), 1.0)
            writer.close()
        finally:
            await srv.stop()

    asyncio.run(go())


def test_read_deadline_zero_keeps_legacy_patience():
    for k, pkg in enumerate(PACKAGES):
        _legacy_patience(pkg, 20340 + k)


# ------------------------------------------------------- live flood cluster


def _flood_cfgs(pkg, n, port, flood, flood_node):
    plan = pkg.faults.FaultPlan(seed=13)
    flood_plan = pkg.faults.FaultPlan(seed=13, flood=flood)
    return [_cfg(pkg, i, n, port,
                 fault_plan=flood_plan if (flood and i == flood_node)
                 else plan, admission_plan=tight_admission(pkg))
            for i in range(n)]


def _flood(pkg, port, draws):
    n, flood_node = 4, 1

    async def go():
        agents = [agent(pkg, c, draws=draws)
                  for c in _flood_cfgs(pkg, n, port, 50, flood_node)]
        return await asyncio.gather(*(a.run() for a in agents)), agents

    results, agents = asyncio.run(go())
    equal, common, real = pkg.chaos.chain_oracle(results)
    assert equal and common >= 2 and real >= 1, \
        "protocol did not hold under flood"
    snaps = [r["telemetry"] for r in results]
    fired = pkg.chaos.tally_faults(results)
    assert fired.get("flood", 0) > 0, f"flood never fired: {fired}"
    honest = [s for s in snaps if s["node"] != flood_node]
    assert sum(s["admission"]["shed_total"] for s in honest) > 0, \
        [s["admission"] for s in snaps]
    assert any(s["metrics"].get("biscotti_shed_total", {}).get("series")
               for s in honest)
    for s in snaps:
        a = s["admission"]
        assert a["inflight_peak"] <= a["caps"]["global_inflight"]
        assert a["parked_peak"] <= max(1, a["caps"]["max_parked"])
    # BusyError feeds no breaker: no honest peer opened one toward
    # another honest peer (opens toward the drowning flooder may accrue)
    for s in honest:
        for pid, h in s["health"].items():
            if int(pid) != flood_node:
                assert h.get("opens", 0) == 0, (s["node"], pid, h)
    return results, agents, [s["admission"]["caps"] for s in snaps]


@pytest.mark.flood
def test_flood_cluster_sheds_and_completes_with_equal_chains():
    got = twin(_flood, 20400, stride=10)
    assert got["port"][2] == got["reference"][2], "the caps differ"
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0])


def _no_flood(pkg, port, draws):
    n = 4

    async def go():
        agents = [agent(pkg, c, draws=draws)
                  for c in _flood_cfgs(pkg, n, port, 0, -1)]
        return await asyncio.gather(*(a.run() for a in agents)), agents

    results, agents = asyncio.run(go())
    equal, _, real = pkg.chaos.chain_oracle(results)
    assert equal and real >= 1
    for r in results:
        a = r["telemetry"]["admission"]
        assert a["shed_total"] == 0, f"honest traffic was shed: {a}"
        assert r["telemetry"]["counters"].get("breaker_open", 0) == 0
    return results, agents


@pytest.mark.flood
def test_admission_without_flood_sheds_nothing():
    got = twin(_no_flood, 20430, stride=10)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0])


def _flooded_call(server_pkg, client_pkg, port, flood, delay):
    """One call of a flooding client (every frame replayed `flood` times)
    to a server with the flood clusters' admission plan whose handler
    takes `delay` s: (what the call returned or raised, the sheds)."""
    async def go():
        async def handler(mt, meta, arrays):
            await asyncio.sleep(delay)
            return {"served": 1}, {}

        srv = server_pkg.rpc.RPCServer("127.0.0.1", port, handler)
        srv.admission = server_pkg.admission.AdmissionController(
            tight_admission(server_pkg))
        await srv.start()
        f = client_pkg.faults
        pool = client_pkg.rpc.Pool()
        pool.faults = f.FaultInjector(f.FaultPlan(seed=13, flood=flood), 1,
                                      lambda host, p: 0)
        try:
            try:
                rmeta, _ = await pool.call("127.0.0.1", port, "GetBlock",
                                           {"source_id": 1}, timeout=5.0)
                got = ("served", rmeta["served"])
            except client_pkg.rpc.BusyError as e:
                got = ("busy", str(e))
        finally:
            pool.close()
            await srv.stop()
        return got, srv.admission.snapshot()["shed"]

    return asyncio.run(go())


@pytest.mark.flood
@pytest.mark.parametrize("server,client,port", [
    (REF, REF, 20450), (PORT, PORT, 20452), (REF, PORT, 20454)],
    ids=["reference", "port", "port-client"])
def test_a_flooders_call_resolves_on_the_first_reply(server, client, port):
    """ROADMAP C12: a flooder's frame and its replays share one request
    id, and the call resolves on the first reply to arrive. Where the
    handler is slower than a shed, a shed replay's busy reply wins, so the
    flooder's own call is refused; where it is fast, the call is served.
    The flood clusters at the live width (a block of 7,850 weights to
    serialize) meet the first case, the creditcard ones the second."""
    assert _flooded_call(server, client, port, 0, 0.2) == \
        (("served", 1), {})
    for delay, want in ((0.0, ("served", 1)),
                        (0.2, ("busy", "admission shed: rate"))):
        got, shed = _flooded_call(server, client, port, 20, delay)
        assert got == want and set(shed) == {"rate"}, (delay, got, shed)
