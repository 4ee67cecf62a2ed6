"""Twins of `tests/test_upgrade.py`'s tier-1 cases and of
`tests/test_keyed_cluster.py` on the port's live peer: two v0-pinned
peers among current ones finish with equal chains while both wire
dialects flow and the degradations are traced; the rolling-upgrade drill
through the port's `tools/chaos.py` holds the settled-prefix oracle; the
chaos CLI refuses mislabelled upgrade runs; a v7 pin answers the elastic
fleet's RPCs `unknown method`; and dealer-keyed clusters run Pedersen
commitments and dealer Schnorr keys in live protocol flow.

Each cluster runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws where the test
builds the agents) from the same config keywords, makes the reference
test's assertions on the port's run and compares the runs. The clusters
are held to the reference's round-0 block, rejected ids and stake rule
(`torch_twins.assert_first_block_parity`): a plain-mode block hash parts
in the weights' last bits (ROADMAP C10), and the keyed secure-aggregation
cluster's round 1 pools other workers from one reference run to the
next. The chaos drill's report must carry the reference's waves, applied
upgrades and final versions.

Ports are 19500-19599, which no other test file uses."""

import asyncio
import json

import pytest

from biscotti_tpu.tools import keygen as jkeygen
from torch_twins import (PACKAGES, PORT, REF, assert_first_block_parity,
                         cfg, dumps, run_cluster, twin)

pytestmark = pytest.mark.upgrade

# the reference file's windows (test_upgrade.py:18)
FAST = dict(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
            rpc_s=10.0)


def _matrix(pkg, port, draws):
    n = 5
    full = dict(wire_codec="f32+zlib", trace=True, overlay=True,
                overlay_group=2)
    cfgs = [cfg(pkg, i, n, port, FAST, **full,
                protocol_version=0 if i >= 3 else -1) for i in range(n)]
    results, agents = run_cluster(pkg, cfgs, draws=draws)
    protocol = pkg.protocol
    equal, common, real = pkg.chaos.chain_oracle(results)
    assert equal, "mixed-version chains diverged"
    assert real >= 1, "no real block settled across the version gap"
    merged = pkg.obs.merge_snapshots([r["telemetry"] for r in results])
    codecs_seen = set(merged["wire"]["out_by_codec"])
    assert {"raw64", "f32+zlib"} <= codecs_seen, codecs_seen
    assert merged["counters"].get("feature_degraded", 0) > 0
    degraded = set()
    for r in results[:3]:
        for feats in r["telemetry"]["protocol"]["degraded"].values():
            degraded.update(feats)
    assert {"f32", "zlib", protocol.TRACE, protocol.RELAY} <= degraded, \
        degraded
    for r in results:
        snap = r["telemetry"]["protocol"]
        if r["node"] >= 3:
            assert snap["version"] == 0
            assert snap["advertised"] == ["raw64"]
        else:
            assert snap["version"] == protocol.CURRENT_VERSION
            assert protocol.TRACE in snap["advertised"]
    return results, agents, sorted(degraded), codecs_seen


def test_mixed_version_matrix_interops_with_observable_degradation():
    got = twin(_matrix, 19500, stride=10)
    ref, port = got["reference"], got["port"]
    assert port[2:] == ref[2:]
    assert PORT.protocol.CURRENT_VERSION == REF.protocol.CURRENT_VERSION
    assert_first_block_parity(ref[1][0], port[1][0])


def _drill(pkg, port, capsys):
    extra = ["--device", "cpu"] if pkg is PORT else []
    rc = pkg.chaos.main(["--nodes", "4", "--rounds", "6",
                         "--base-port", str(port), "--rolling-upgrade", "0",
                         "--upgrade-period", "2", "--upgrade-wave", "2",
                         "--codec", "f32+zlib"] + extra)
    report = json.loads(capsys.readouterr().out)
    assert rc == 0, report
    ru = report["rolling_upgrade"]
    assert ru["from_version"] == 0
    assert ru["to_version"] == pkg.protocol.CURRENT_VERSION
    assert ru["waves"] == [[2, [1, 2]], [4, [3]]]
    assert sorted(ru["applied"]) == [[2, 1], [2, 2], [4, 3]]
    assert set(ru["final_versions"].values()) == \
        {pkg.protocol.CURRENT_VERSION}
    assert report["cluster"]["counters"].get("feature_degraded", 0) > 0
    assert report["settled_prefix_equal"] and report["real_blocks"] >= 1
    return ru


def test_rolling_upgrade_zero_settled_divergence(capsys):
    ref = _drill(REF, 19520, capsys)
    port = _drill(PORT, 19530, capsys)
    for key in ("from_version", "to_version", "waves", "final_versions"):
        assert port[key] == ref[key], key
    assert sorted(port["applied"]) == sorted(ref["applied"])


@pytest.mark.parametrize("argv", [
    ["--rolling-upgrade", str(PORT.protocol.CURRENT_VERSION)],
    ["--rolling-upgrade", "0", "--protocol-version", "1"],
    ["--protocol-version", "99"],
    ["--rolling-upgrade", "0", "--rounds", "2"],
])
def test_chaos_refuses_mislabeled_upgrade_runs(argv):
    for pkg in PACKAGES:
        with pytest.raises(SystemExit) as exc:
            pkg.chaos.main(["--nodes", "4"] + argv)
        assert exc.value.code == 2, pkg.name


def _v7_pin(pkg, port):
    protocol, out = pkg.protocol, []
    pinned = pkg.PeerAgent(cfg(pkg, 0, 2, port, FAST, protocol_version=7),
                           **pkg.agent_kw)
    assert protocol.MIGRATE not in pinned.caps
    assert protocol.DKG not in pinned.caps
    for mt in ("GetMigrationTicket", "DkgDeal"):
        assert not protocol.serves(pinned.caps, mt)
        with pytest.raises(pkg.rpc.RPCError,
                           match=f"unknown method {mt}") as e:
            asyncio.run(pinned._handle(mt, {}, {}))
        out.append(str(e.value))
    cur = pkg.PeerAgent(cfg(pkg, 1, 2, port + 5, FAST), **pkg.agent_kw)
    assert {protocol.MIGRATE, protocol.DKG} <= cur.caps
    for mt in ("GetMigrationTicket", "DkgDeal"):
        assert protocol.serves(cur.caps, mt)
    before = cur.counters.get("feature_degraded", 0)
    cur._record_caps(0, sorted(pinned.caps))
    assert {protocol.MIGRATE, protocol.DKG} <= cur._degraded_seen[0]
    assert cur.counters.get("feature_degraded", 0) >= before + 2
    with pytest.raises(pkg.rpc.RPCError,
                       match="migration not authorized") as e:
        asyncio.run(cur._handle("GetMigrationTicket", {}, {}))
    out.append(str(e.value))
    return (out, sorted(pinned.caps), sorted(cur.caps),
            sorted(cur._degraded_seen[0]),
            cur.counters.get("feature_degraded", 0) - before)


def test_v7_pin_answers_elastic_fleet_rpcs_unknown_method():
    assert _v7_pin(PORT, 19560) == _v7_pin(REF, 19570)


# ---------------------------------------------------- dealer-keyed clusters

N = 4
DIMS = 50  # creditcard num_params


@pytest.fixture(scope="module")
def key_dir(tmp_path_factory):
    """The reference's dealer writes the keys; both packages load them
    (the port's keygen writes the same files, tests/test_torch_keygen.py)."""
    out = tmp_path_factory.mktemp("keys")
    jkeygen.generate(dims=DIMS, nodes=N, out_dir=str(out))
    return str(out)


def _keyed(key_dir, **kw):
    def scenario(pkg, port, draws):
        cfgs = [cfg(pkg, i, N, port, dict(update_s=4.0, block_s=20.0,
                                          krum_s=4.0, share_s=4.0,
                                          rpc_s=6.0),
                    verification=True, defense="NONE", **kw)
                for i in range(N)]
        results, agents = run_cluster(pkg, cfgs, draws=draws, key_dir=key_dir)
        chain = dumps(results, agents)
        assert all(d == chain[0] for d in chain)
        accepted = [u for b in agents[0].chain.blocks for u in b.data.deltas
                    if u.accepted]
        assert accepted, "no update made it into a block"
        assert all(a.commit_key is not None for a in agents)
        assert sum(a.counters.get("submission_rejected", 0)
                   for a in agents) == 0
        return results, agents, accepted, chain
    return scenario


def test_keyed_plain_mode_pedersen_commitments(key_dir):
    got = twin(_keyed(key_dir), 19580, stride=5)
    for u in got["port"][2]:
        assert len(u.commitment) == 32
        assert u.signatures and u.signers
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0])


def test_keyed_secureagg_vss_with_dealer_schnorr(key_dir):
    got = twin(_keyed(key_dir, secure_agg=True, noising=True), 19590,
               stride=5)
    results, agents = got["port"][:2]
    assert sum(a.counters.get("secret_registered", 0) for a in agents) > 0
    assert any("|w|=0.000000" not in b.summary()
               for b in agents[0].chain.blocks[1:])
    assert_first_block_parity(got["reference"][1][0], agents[0])
