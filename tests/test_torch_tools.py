"""The port's tools (`biscotti_tpu_torch/tools/`) against the reference's
on the same inputs: `bench_diff`, `obs`, `trace_round`, `profile_round`'s
table and `pod_launch`'s pure functions give the reference's outputs, on
hand-built inputs and on one traced 4-peer port cluster's telemetry; the
entry points that build `PeerAgent` (`chaos`, `soak`, `profile_round`,
`pod_launch` in hive mode) run port clusters on the CPU.

One departure is tested as such: the port's `trace_round` labels a trace
with the round its id names, where the reference takes the first span's
`iter` (ROADMAP Queue C, C4).

Ports are 17450-17499, which no other test file uses."""

import asyncio
import copy
import json

import pytest

from biscotti_tpu.tools import bench_diff as jbd
from biscotti_tpu.tools import obs as jobs
from biscotti_tpu.tools import pod_launch as jpod
from biscotti_tpu.tools import profile_round as jprof
from biscotti_tpu.tools import trace_round as jtr
from biscotti_tpu_torch.config import BiscottiConfig, Timeouts
from biscotti_tpu_torch.runtime.peer import PeerAgent
from biscotti_tpu_torch.tools import bench_diff as bd
from biscotti_tpu_torch.tools import obs
from biscotti_tpu_torch.tools import pod_launch as pod
from biscotti_tpu_torch.tools import profile_round as prof
from biscotti_tpu_torch.tools import trace_round as tr
from test_bench_diff import OLD, SOAK
from test_tracing import _mk_span, _synthetic_round

TRACED = Timeouts(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
                  rpc_s=20.0)


@pytest.fixture(scope="module")
def traced_cluster():
    """A traced 4-peer port cluster on the CPU, 2 rounds: (agents,
    results, every recorder event)."""
    n = 4
    cfgs = [BiscottiConfig(node_id=i, num_nodes=n, dataset="creditcard",
                           base_port=17450, num_verifiers=1, num_miners=1,
                           num_noisers=1, secure_agg=True, noising=True,
                           verification=True, max_iterations=2,
                           convergence_error=0.0, sample_percent=1.0,
                           batch_size=8, seed=3, trace=True, timeouts=TRACED)
            for i in range(n)]

    async def go():
        agents = [PeerAgent(c, device="cpu") for c in cfgs]
        return agents, await asyncio.gather(*(a.run() for a in agents))

    agents, results = asyncio.run(go())
    dumps = {r["chain_dump"] for r in results}
    assert len(dumps) == 1
    events = [ev for a in agents for ev in a.tele.recorder.tail(100000)]
    return agents, results, events


# ----------------------------------------------------------- bench_diff


def test_bench_diff_equals_the_reference(tmp_path, capsys):
    new = copy.deepcopy(OLD)
    new["mnist"]["round_total_s"] = 1.3
    new["mnist"]["miner_crypto_s"] = 0.37
    new["extra"] = {"new_key_s": 5.0, "points_per_s": 3.0}
    worse_soak = copy.deepcopy(SOAK)
    worse_soak["slos"]["shed_rate"] *= 3
    for a, b in ((OLD, new), (SOAK, worse_soak), ({"a_s": 0.0}, {"a_s": 2.0})):
        fa, fb = bd.flatten(a), bd.flatten(b)
        assert fa == jbd.flatten(a) and fb == jbd.flatten(b)
        for thr in (0.1, 0.5):
            d = bd.diff(fa, fb, threshold=thr)
            assert d == jbd.diff(fa, fb, threshold=thr)
            assert bd.format_diff(d) == jbd.format_diff(d)
            assert bd.format_diff(d, min_pct=50.0) == \
                jbd.format_diff(d, min_pct=50.0)
    assert bd.DEFAULT_REGRESS == jbd.DEFAULT_REGRESS
    old_p, new_p = tmp_path / "old.json", tmp_path / "new.json"
    old_p.write_text(json.dumps({"tail": json.dumps(OLD)}))
    new_p.write_text(json.dumps(new))
    for args in ([str(old_p), str(new_p)],
                 [str(old_p), str(new_p), "--threshold", "1.5"],
                 [str(old_p), str(old_p)]):
        rc = bd.main(args)
        out = capsys.readouterr().out
        assert rc == jbd.main(args) and out == capsys.readouterr().out


# ------------------------------------------------------------------ obs


def _hive_snaps():
    def snap(hid, peers, rss, lag, drift=0):
        return {"hive": {"id": hid, "peers": peers, "rss_bytes": rss,
                         "rss_peak_bytes": rss, "loop_lag_s": lag,
                         "rss_drift_bytes": drift,
                         "loop_lag_drift_s": lag / 10}}

    snaps = [snap("h0", 2, 100 << 20, 0.01, drift=1 << 20),
             snap("h0", 2, 120 << 20, 0.5), snap("h1", 3, 90 << 20, 0.02),
             {"other": True}]
    snaps[0]["metrics"] = {"biscotti_wire_bytes_total": {
        "type": "counter", "series": [
            {"labels": {"msg_type": "RegisterBlock", "direction": "loopback",
                        "codec": "raw64"}, "value": 4096}]}}
    return snaps


def test_obs_merges_equal_the_reference(traced_cluster):
    _, results, _ = traced_cluster
    cluster = [r["telemetry"] for r in results]
    for snaps in (_hive_snaps(), cluster):
        merged = obs.merge_snapshots(copy.deepcopy(snaps))
        assert merged == jobs.merge_snapshots(copy.deepcopy(snaps))
        assert obs.format_table(merged) == jobs.format_table(merged)
        for fn in ("merge_wire", "merge_admission", "merge_stragglers",
                   "merge_hives", "merge_overlay", "merge_trust",
                   "merge_phase_histograms"):
            assert getattr(obs, fn)(copy.deepcopy(snaps)) == \
                getattr(jobs, fn)(copy.deepcopy(snaps)), fn
    merged = obs.merge_snapshots(cluster)
    assert merged["wire"]["cross_host_bytes"] > 0
    assert "loopback 4.0KB avoided" in obs.format_table(
        obs.merge_snapshots(_hive_snaps()))


# ---------------------------------------------------------- trace_round


def _comparable(recon, labels=True):
    """A reconstruction with its sets sorted; without the round labels
    where `labels` is False (a live cluster's, which can hold C4's case)."""
    drop = set() if labels else {"round"}
    return {"offsets": recon["offsets"],
            "rounds": [{k: v for k, v in r.items() if k not in drop}
                       for r in recon["rounds"]],
            "traces": {k: {kk: (sorted(vv, key=str) if kk == "nodes" else vv)
                           for kk, vv in v.items() if kk not in drop}
                       for k, v in recon["traces"].items()}}


def test_trace_round_equals_the_reference(traced_cluster):
    _, _, events = traced_cluster
    T, synth = _synthetic_round()
    skewed = [_mk_span(0, "rpc_call", 1.0, 0.2, "0.9"),
              _mk_span(1, "rpc.Ping", 1.55, 0.1, "1.9", parent="0.9"),
              _mk_span(2, "rpc.Ping", 0.7, 0.05, "2.9", parent="0.9")]
    for evs, min_nodes in ((events, 4), (synth, 3), (skewed, 1)):
        got, want = tr.reconstruct(evs, min_nodes), jtr.reconstruct(evs,
                                                                   min_nodes)
        labels = evs is synth
        assert _comparable(got, labels) == _comparable(want, labels)
        assert tr.chrome_trace(got["traces"]) == jtr.chrome_trace(
            want["traces"])
        tr.validate_chrome(tr.chrome_trace(got["traces"]))
        for row in got["rounds"]:
            if row.get("critical"):
                assert tr.format_critical_table(row["critical"], 1) \
                    == jtr.format_critical_table(row["critical"], 1)
    recon = tr.reconstruct(events, min_nodes=4)
    rounds = [r for r in recon["rounds"] if r["round"] in (0, 1)]
    assert [r["round"] for r in rounds] == [0, 1]
    assert all(r["complete"] and r["critical"] for r in rounds)
    for phase in ("sgd", "crypto_commit", "rpc_call", "mint", "x"):
        assert tr.segment_of(phase) == jtr.segment_of(phase)


def test_trace_round_labels_a_trace_by_its_id():
    """ROADMAP C4, two cases. (1) Miner 2 verifies, at iteration 0, an
    update whose frame carried no trace context (the capability not yet
    negotiated): its spans open a `detached-2` trace. (2) Peer 3, still in
    round 0, serves a round-1 frame: its dispatch span carries trace r1
    with its own iter 0 and is the first r1 span in the stream. The
    reference labels both traces round 0 (three traces of round 0); the
    port labels each by its id: no round for the detached one."""
    r0, r1 = "00000003-r0", "00000003-r1"
    events = [
        _mk_span(2, "miner_verify", 0.2, 0.01, "2.d", trace="detached-2",
                 it=0),
        _mk_span(3, "rpc.RegisterUpdate", 1.2, 0.01, "3.5", parent="0.7",
                 trace=r1, it=0),
        _mk_span(0, "sgd", 0.5, 0.5, "0.1", trace=r0, it=0),
        _mk_span(1, "sgd", 0.5, 0.5, "1.1", trace=r0, it=0),
        _mk_span(0, "sgd", 1.1, 0.5, "0.6", trace=r1, it=1),
        _mk_span(0, "rpc_call", 1.2, 0.05, "0.7", parent="0.6", trace=r1,
                 it=1),
    ]
    assert [r["round"] for r in jtr.reconstruct(events, 1)["rounds"]] == \
        [0, 0, 0]
    got = tr.reconstruct(events, 1)["rounds"]
    assert [(r["trace"], r["round"]) for r in got] == [
        (r0, 0), (r1, 1), ("detached-2", None)]
    assert tr.trace_round_of(r1) == 1 and tr.trace_round_of("x-r2") is None
    assert tr.trace_round_of("cafe0003-r-1") == -1


# -------------------------------------------------------- profile_round


def test_profile_round_table_equals_the_reference(traced_cluster):
    agents, _, _ = traced_cluster
    got = prof.collect_round_table(agents)
    assert got == jprof.collect_round_table(agents)
    assert [r["iter"] for r in got["rounds"]][:2] == [0, 1]
    assert got["rounds"][0]["trace"] == "00000003-r0"


def test_profile_round_cli_runs_a_port_cluster(tmp_path, capsys, monkeypatch):
    from biscotti_tpu_torch import config

    # the CLI's 20 s windows, which its 70 % sampling waits out, cut to 3 s
    monkeypatch.setattr(config, "Timeouts", lambda **kw: Timeouts(
        update_s=3.0, block_s=20.0, krum_s=3.0, share_s=3.0, rpc_s=6.0))
    out = tmp_path / "prof.json"
    rc = prof.main(["--nodes", "4", "--iterations", "1", "--base-port",
                    "17460", "--device", "cpu", "--json", str(out),
                    "--chrome-out", str(tmp_path / "round.trace.json")])
    table = json.loads(out.read_text())
    assert rc == 0 and table["chains_equal"] and table["rounds"]
    assert "chrome trace" in capsys.readouterr().out


# ------------------------------------------------------------ pod_launch


def test_pod_launch_pure_functions_equal_the_reference(tmp_path):
    hosts = ["localhost", "localhost", "vm-a"]
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    pod.write_peers_file(hosts, 2, 9000, str(a))
    jpod.write_peers_file(hosts, 2, 9000, str(b))
    assert a.read_text() == b.read_text()
    for req, total in ((3, 4), (3, 1000), (1, 2), (5, 9)):
        assert pod.committee_size(req, total) == jpod.committee_size(req,
                                                                      total)
    args = type("A", (), dict(dataset="mnist", base_port=14350, secure_agg=0,
                              noising=0, verification=1, num_miners=3,
                              num_verifiers=3, num_noisers=2, iterations=2,
                              seed=3, overlay=1, key_dir="k",
                              peers_per_host=0, nodes_per_host=2,
                              platform="cpu"))()
    got = pod.hive_cmd(args, 4, 4, 12, "p.txt", "hive1", "0.0.0.0",
                       overlay_group=4)
    want = jpod.hive_cmd(args, 4, 4, 12, "p.txt", "hive1", "0.0.0.0",
                         overlay_group=4)
    assert got[2] == "biscotti_tpu_torch.runtime.hive"
    assert [x for x in got[3:] if x not in ("--platform", "cpu")] == want[3:]
    got = pod.peer_cmd(args, 5, 12, "p.txt", "0.0.0.0")
    want = jpod.peer_cmd(args, 5, 12, "p.txt", "0.0.0.0")
    assert got[2] == "biscotti_tpu_torch.runtime.peer"
    assert [x for x in got[3:] if x not in ("--platform", "cpu")] == want[3:]
    ok = {"chains_equal_local": True, "chain_digest": "ab"}
    texts = ["noise\n" + json.dumps(ok), "{broken\n", "", json.dumps(ok) + "\n{"]
    for t in texts:
        assert pod.hive_summary(t) == jpod.hive_summary(t)
    for sums in ([ok, ok], [ok, dict(ok, chain_digest="cd")],
                 [ok, None], [], [dict(ok, chains_equal_local=False)]):
        assert pod.cross_hive_equal(sums) == jpod.cross_hive_equal(sums)


def test_pod_launch_dry_run_plans_the_port_processes(tmp_path, capsys):
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("localhost\nvm-a\n")
    argv = ["--hosts", str(hosts), "--peers-per-host", "2", "--dataset",
            "creditcard", "--iterations", "1",
            "--peers-file", str(tmp_path / "peers.txt"), "--dry-run"]
    assert pod.main(argv + ["--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "biscotti_tpu_torch.runtime.hive" in out and "--platform cpu" in out
    assert "JAX_PLATFORMS" not in out and "[scp]" in out and "[ssh]" in out
    assert json.loads(out.splitlines()[-1])["hive_mode"] is True
    # per-peer processes run the port's peer CLI on the same platform
    assert pod.main(argv[:2] + argv[4:] + ["--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "biscotti_tpu_torch.runtime.peer" in out and "--platform cpu" in out


def test_pod_launch_runs_two_port_hives_on_the_cpu(tmp_path, capsys):
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("localhost\nlocalhost\n")
    rc = pod.main(["--hosts", str(hosts), "--peers-per-host", "2",
                   "--dataset", "creditcard", "--iterations", "1",
                   "--base-port", "17470", "--platform", "cpu",
                   "--num-miners", "1", "--num-verifiers", "1",
                   "--num-noisers", "1", "--timeout", "240",
                   "--peers-file", str(tmp_path / "peers.txt")])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["chains_equal"] and summary["blocks"] == 1
    assert [h["device"] for h in summary["hives"]] == ["cpu", "cpu"]


# ------------------------------------------------------ chaos and soak


def test_chaos_cli_runs_a_port_cluster(capsys):
    from biscotti_tpu_torch.tools import chaos

    rc = chaos.main(["--nodes", "3", "--rounds", "2", "--base-port", "17480",
                     "--fault-seed", "11", "--fault-drop", "0.05",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{\n"):])
    assert rc == 0 and report["settled_prefix_equal"]
    assert report["real_blocks"] >= 1


def test_soak_cli_runs_one_port_cycle(tmp_path, capsys):
    from biscotti_tpu_torch.tools import soak

    out = tmp_path / "soak.json"
    soak.main(["--minutes", "0", "--nodes", "3", "--rounds", "3",
               "--base-port", "17485", "--churn", "0", "--slow", "0",
               "--campaign-flood", "0", "--fault-drop", "0", "--device",
               "cpu", "--out", str(out)])
    art = json.loads(out.read_text())
    assert art["cycles_run"] == 1 and art["prefix_held"]
    assert art["settled_rounds"] >= 1 and art["schema"] == "soak-v1"
