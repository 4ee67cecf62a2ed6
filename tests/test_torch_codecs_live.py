"""Twins of `tests/test_wire_codecs.py`'s live wire plane on the port:
a request and a reply above the chunk threshold over one loopback
connection, a secure-aggregation cluster with one raw64-only peer among
codec peers, and the mnist cluster's block gossip under f32+zlib against
raw64.

The chunked call runs with every pairing of server and client: the
port's and the reference's, in both directions across the packages. The
clusters run on the reference's agents and on the port's (`device="cpu"`,
trained on the reference run's draws) from the same config keywords and
make the reference test's assertions on the port's run; their blocks
carry quantized sums, so each chain must be the reference's bit for bit
wherever the two runs pooled the same workers (a round with more workers
than samples pools the first to arrive, ROADMAP C8), and so must the
bytes of the block gossip, which the two packages frame alike.

Ports are 21800-21999, which no other test file uses."""

import asyncio

import numpy as np
import pytest

from torch_twins import (PACKAGES, assert_same_chain_where_pooled_alike,
                         outcome, run_cluster, twin)

pytestmark = pytest.mark.codec


@pytest.mark.parametrize("server,client", [(s, c) for s in PACKAGES
                                           for c in PACKAGES],
                         ids=lambda p: p.name)
def test_chunked_rpc_roundtrip_live(server, client):
    """Request and reply above the chunk threshold: the client chunks by
    `chunk_bytes`, the server honours `achunk`."""
    port = 21800 + 2 * (server.name == "port") + (client.name == "port")
    big = np.random.default_rng(9).normal(size=60_000)  # ~480 KB each way

    async def handler(msg_type, meta, arrays):
        return {"ok": 1}, {"echo": arrays["d"]}

    async def go():
        srv = server.rpc.RPCServer("127.0.0.1", port, handler)
        srv.caps = server.codecs.FULL_CAPS
        await srv.start()
        pool = client.rpc.Pool()
        try:
            return await pool.call("127.0.0.1", port, "Big",
                                   {"achunk": 65536}, {"d": big},
                                   timeout=20.0, chunk_bytes=65536)
        finally:
            pool.close()
            await srv.stop()

    rmeta, rarrays = asyncio.run(go())
    assert rmeta["ok"] == 1
    assert np.array_equal(rarrays["echo"], big)


# ------------------------------------------------- live cluster behavior


def _wire_out_by_codec(results, msg_type=None):
    tot = {}
    for r in results:
        fam = r["telemetry"]["metrics"].get("biscotti_wire_bytes_total", {})
        for row in fam.get("series", []):
            lb = row["labels"]
            if lb.get("direction") != "out":
                continue
            if msg_type is not None and lb.get("msg_type") != msg_type:
                continue
            tot[lb.get("codec")] = tot.get(lb.get("codec"), 0) + row["value"]
    return tot


def _cluster(pkg, port, draws, dataset, codecs_by_node, **kw):
    """The reference file's `_cluster` on `pkg`, with windows no honest
    peer misses under a loaded test run (the reference's are 6/30/6/6/8 s;
    an honest round mints as soon as its workers are accounted for)."""
    fast = pkg.config.Timeouts(update_s=20.0, block_s=60.0, krum_s=20.0,
                               share_s=20.0, rpc_s=20.0)
    n = len(codecs_by_node)
    base = dict(num_nodes=n, dataset=dataset, base_port=port,
                num_verifiers=1, num_miners=1, num_noisers=1,
                secure_agg=True, noising=True, verification=True,
                defense=pkg.config.Defense.KRUM, max_iterations=2,
                convergence_error=0.0, sample_percent=1.0, batch_size=8,
                timeouts=fast, seed=3)
    base.update(kw)
    cfgs = [pkg.config.BiscottiConfig(node_id=i,
                                      wire_codec=codecs_by_node[i], **base)
            for i in range(n)]
    return run_cluster(pkg, cfgs, draws=draws)


def _mixed(pkg, port, draws):
    results, agents = _cluster(pkg, port, draws, "creditcard",
                               ["raw64", "f32+zlib", "f32+zlib", "f32+zlib"])
    out = [r["chain_dump"] for r in results]
    assert all(d == out[0] for d in out)
    assert sum(a.counters.get("submission_rejected", 0)
               for a in agents) == 0
    assert sum(a.counters.get("secret_registered", 0) for a in agents) > 0
    # the legacy peer sent only raw64 frames...
    raw_only = _wire_out_by_codec([results[0]])
    assert set(raw_only) == {"raw64"} and raw_only["raw64"] > 0
    # ...the codec peers spoke both dialects
    coded = _wire_out_by_codec(results[1:])
    assert coded.get("f32+zlib", 0) > 0
    assert coded.get("raw64", 0) > 0
    return results, agents


def test_mixed_cluster_interop_raw64_peer_converges():
    got = twin(_mixed, 21820)
    assert_same_chain_where_pooled_alike(got["reference"], got["port"])


def _gossip(pkg, port, draws, codec):
    results, agents = _cluster(pkg, port, draws, "mnist", [codec] * 4,
                               noising=False)
    out = [r["chain_dump"] for r in results]
    assert all(d == out[0] for d in out)
    assert sum(a.counters.get("submission_rejected", 0)
               for a in agents) == 0
    assert sum(a.counters.get("secret_registered", 0) for a in agents) > 0
    assert all(np.isfinite(r["final_error"]) for r in results)
    return results, agents


def test_gossip_compression_vs_raw64_mnist():
    """f32+zlib against raw64 on one mnist config, in each package: the
    block gossip shrinks at least 2x (the mnist_cnn acceptance asks 3x),
    with recovery and commitment checks intact in both runs."""
    raw = twin(lambda pkg, p, d: _gossip(pkg, p, d, "raw64"), 21860)
    cod = twin(lambda pkg, p, d: _gossip(pkg, p, d, "f32+zlib"), 21900)
    gossip = {}
    for pkg in PACKAGES:
        per = []
        for got in (raw, cod):
            results = got[pkg.name][0]
            per.append(sum(_wire_out_by_codec(results,
                                              "RegisterBlock").values())
                       / max(1, max(r["iterations"] for r in results)))
        assert per[0] > 0 and per[1] > 0
        assert per[0] / per[1] >= 2.0, (pkg.name, per)
        gossip[pkg.name] = per
    for got in (raw, cod):
        assert_same_chain_where_pooled_alike(got["reference"], got["port"])
    # one chain, framed alike: where each run's rounds pooled alike, the
    # gossip bytes a round are the reference's under either codec
    if all(outcome(got["reference"][1][0]) == outcome(got["port"][1][0])
           for got in (raw, cod)):
        assert gossip["port"] == gossip["reference"], gossip
