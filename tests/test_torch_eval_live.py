"""The port's live-peer drivers (`biscotti_tpu_torch/eval/`: scale_test,
eval_cost_breakdown, eval_ft, eval_attack_matrix, local_test,
eval_os_faults, eval_committee_scale, eval_fedsys_compare,
eval_pod_launch, parse_logs) against the reference's `eval/` scripts, on
the CPU at a small size (`--platform cpu`).

Exact against the reference where nothing is drawn at random: the scale
harness's configs, the attack matrix's plans, configs, replay commands
and table, the chain extraction and log parsing, and the cells and
scenarios the sweep drivers hand to their harness. The live clusters
themselves run the port's `PeerAgent`, which earlier tests hold to the
reference; here their artifacts are held to the reference's keys and to
the oracle bits (chains equal, real blocks). The peer CLI runs on the CPU
through its `--platform`. Ports are 17500-17699."""

import argparse
import importlib.util
import json
import os

import pytest

from biscotti_tpu_torch.eval import (eval_attack_matrix, eval_committee_scale,
                                     eval_cost_breakdown, eval_fedsys_compare,
                                     eval_ft, eval_os_faults, eval_pod_launch,
                                     local_test, parse_logs, scale_test)
from biscotti_tpu_torch.runtime import peer
from biscotti_tpu_torch.tools import keygen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_script(name):
    """A reference script of eval/ as a module (their top levels import the
    standard library only)."""
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "eval", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(text):
    return json.loads([l for l in text.splitlines() if l.startswith("{")][-1])


# ------------------------------------------------------------ scale_test

SCALE_KEYS = {
    "mode", "nodes", "dataset", "model", "defense", "num_verifiers",
    "num_miners", "num_noisers", "host_cores", "secure_agg", "noising",
    "verification", "keyed", "batched_stepper", "geo_regions", "geo_rtt_ms",
    "iterations_run", "nonempty_blocks", "chains_equal", "wall_s",
    "raw_wall_s", "launch_ramp_s", "s_per_iter", "final_error", "data_note",
    "phases_node0", "phases_max"}


@pytest.mark.parametrize("argv", [
    [], ["--nodes", "12", "--num-verifiers", "5", "--share-redundancy", "auto",
         "--secure-agg", "1", "--defense", "MULTIKRUM", "--poison", "0.2"],
    ["--nodes", "30", "--num-miners", "10", "--num-verifiers", "10",
     "--share-redundancy", "auto", "--fedsys"],
    ["--share-redundancy", "2.0", "--dataset", "mnist", "--model", "svm"]])
def test_scale_build_cfgs_equal_the_reference(argv):
    ref = _ref_script("scale_test")
    ap = argparse.ArgumentParser()
    scale_test.add_args(ap)
    ns = ap.parse_args(argv)
    got = scale_test.build_cfgs(ns)
    want = ref.build_cfgs(ns)
    assert [repr(c) for c in got] == [repr(c) for c in want]


def test_scale_test_cli_runs_a_port_cluster(tmp_path, capsys):
    rc = scale_test.main(["--nodes", "4", "--iterations", "2",
                          "--num-miners", "1", "--num-verifiers", "1",
                          "--num-noisers", "1", "--base-port", "17500",
                          "--platform", "cpu", "--out", str(tmp_path)])
    summary = _last_json(capsys.readouterr().out)
    assert rc == 0 and set(summary) == SCALE_KEYS | {"device", "nvidia_smi"}
    assert summary["chains_equal"] and summary["nonempty_blocks"] >= 1
    assert summary["device"] == "cpu" and summary["batched_stepper"]
    tag = "biscotti_creditcard_4"
    assert json.loads((tmp_path / f"scale_{tag}.json").read_text()) == summary
    rows = (tmp_path / f"scale_{tag}.csv").read_text().splitlines()
    assert len(rows) == 2 and all(len(r.split(",")) == 3 for r in rows)


def _recorded_agents(monkeypatch, driver) -> list:
    """Every PeerAgent `driver` builds while the test runs, in order."""
    agents = []

    class Recorded(peer.PeerAgent):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            agents.append(self)

    monkeypatch.setattr(driver, "PeerAgent", Recorded)
    return agents


# ---------------------------------------------------- eval_cost_breakdown


def test_cost_breakdown_cli_with_a_device_trace(tmp_path, capsys,
                                                monkeypatch):
    """The cost-breakdown CLI's artifact on a 4-peer cluster. Its sgd
    calls are the steps the rounds' workers took: each round's committees,
    elected from the chain's head, can seat all 4 peers (3 verifiers and 3
    miners overlap), and which round does follows the block hash's bits,
    so the count is held to the workers the run's own chain elects and to
    the records its blocks carry, not to a fixed number."""
    from biscotti_tpu_torch.parallel import roles

    agents = _recorded_agents(monkeypatch, eval_cost_breakdown)
    trace = tmp_path / "trace"
    rc = eval_cost_breakdown.main([
        "--nodes", "4", "--iterations", "2", "--base-port", "17520",
        "--trace-dir", str(trace), "--platform", "cpu",
        "--out", str(tmp_path)])
    summary = _last_json(capsys.readouterr().out)
    assert rc == 0 and summary["chains_equal"]
    assert set(summary) == {
        "experiment", "device", "nvidia_smi", "dataset", "nodes",
        "iterations", "secure_agg", "pipeline", "chains_equal", "phases",
        "miner_crypto_components", "phase_quantiles", "wire", "device_trace"}
    assert set(summary["miner_crypto_components"]) == {
        "commitment_verify_s", "signature_check_s", "share_interpolation_s"}
    c, chain = agents[0].cfg, agents[0].chain
    workers = 0
    for head in chain.blocks[:-1]:  # the committees each round elected
        v, m = roles.elect_committees(dict(head.stake_map), head.hash,
                                      c.num_verifiers, c.num_miners,
                                      c.num_nodes)
        workers += c.num_nodes - len(set(v) | set(m))
    accepted = sum(u.accepted for b in chain.blocks for u in b.data.deltas)
    assert 1 <= accepted <= summary["phases"]["sgd"]["calls"] <= workers
    assert (trace / "trace.json").exists()
    csv = (tmp_path / "cost_breakdown.csv").read_text().splitlines()
    assert csv[0] == "phase,total_s,calls,s_per_call"
    assert "metric,value" in csv and csv[-1].startswith("wire_bytes_per_round,")


# ---------------------------------------------------------------- eval_ft


def test_ft_cli_kills_and_restarts_a_peer(tmp_path, capsys):
    rc = eval_ft.main(["--nodes", "8", "--iterations", "8", "--churn-every",
                       "3", "--base-port", "17540", "--platform", "cpu",
                       "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    summary, verdict = json.loads(lines[-2]), json.loads(lines[-1])
    assert rc == 0 and verdict == {"summary": "churn_tolerated", "ok": True}
    assert [(e["event"], e["node"]) for e in summary["events"]] == [
        ("kill", 7), ("restart", 7)]
    assert summary["settled_chains_equal"] and summary["nonempty_blocks"] >= 4
    assert set(summary) == {
        "experiment", "device", "nvidia_smi", "dataset", "nodes",
        "iterations", "events", "settled_chains_equal", "common_height",
        "nonempty_blocks", "final_error"}
    assert (tmp_path / "ft.csv").read_text().count("\n") == 8


# ---------------------------------------------------- eval_attack_matrix


def _matrix_ns(**kw):
    base = dict(nodes=10, verifiers=3, rounds=8, seed=11, poison=0.3,
                flood=30, dataset="mnist@dir0.3")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("ns", [_matrix_ns(), _matrix_ns(
    nodes=8, rounds=5, poison=0.375, dataset="digits", flood=12)])
def test_attack_matrix_cells_equal_the_reference(ns):
    """_cell_plan, _cell_cfg and _replay_cmd for every campaign, defense and
    secure-agg setting: equal to the reference's, the replay command up to
    the package it names."""
    from biscotti_tpu.config import Defense as JDefense
    from biscotti_tpu_torch.config import Defense

    ref = _ref_script("eval_attack_matrix")
    assert eval_attack_matrix.CAMPAIGN_CELLS == ref.CAMPAIGN_CELLS
    for camp in ref.CAMPAIGN_CELLS:
        assert repr(eval_attack_matrix._cell_plan(camp, ns)) == \
            repr(ref._cell_plan(camp, ns))
        for d in Defense:
            for sa in (True, False):
                jd = JDefense(d.value)
                if d == Defense.TRIMMED_MEAN and sa:  # refused alike
                    with pytest.raises(ValueError, match="incompatible"):
                        eval_attack_matrix._cell_cfg(3, camp, d, sa, 14400, ns)
                    with pytest.raises(ValueError, match="incompatible"):
                        ref._cell_cfg(3, camp, jd, sa, 14400, ns)
                else:
                    assert repr(eval_attack_matrix._cell_cfg(
                        3, camp, d, sa, 14400, ns)) == \
                        repr(ref._cell_cfg(3, camp, jd, sa, 14400, ns))
                got = eval_attack_matrix._replay_cmd(camp, d, sa, 14400, ns)
                want = ref._replay_cmd(camp, jd, sa, 14400, ns)
                assert got == want.replace("biscotti_tpu.tools.chaos",
                                           "biscotti_tpu_torch.tools.chaos")


def test_attack_matrix_table_equals_the_reference():
    ref = _ref_script("eval_attack_matrix")
    rows = [
        {"campaign": "hug", "defense": "KRUM", "secure_agg": True,
         "survived": True, "final_error": 0.4125, "accepted_poisoned_n": 0},
        {"campaign": "static", "defense": "NONE", "secure_agg": False,
         "survived": False, "final_error": 0.9, "accepted_poisoned_n": 3},
        {"campaign": "static", "defense": "KRUM", "secure_agg": True,
         "error": "RuntimeError: x"},
        {"campaign": "none", "defense": "FOOLSGOLD", "secure_agg": True,
         "survived": True, "final_error": 0.1, "accepted_poisoned_n": 0}]
    assert eval_attack_matrix.format_matrix(rows) == ref.format_matrix(rows)


def test_attack_matrix_cli_runs_one_live_cell(tmp_path, capsys, monkeypatch):
    """One live cell through the CLI. The cell's windows are the
    reference's (6 s updates), which a cold first `sgd` under a loaded
    test run can miss, leaving every block empty; the test gives its cell
    windows under which no peer misses a round (the cells' configs are held
    to the reference's above).

    At 5 peers with 3 verifiers and 1 miner a round samples one worker
    (`num_samples`) while two train, every verifier pools the first update
    to arrive and refuses the other, and the leader mints once one worker
    is accounted for: the refused worker's signed decline can reach it
    before the approved worker's shares, and that round's block is empty
    (ROADMAP C13, the reference's rule). The settled prefix of a 2-round
    run is round 0 alone, so `real_blocks` reads that race; the test holds
    the run to a real block on every peer's whole chain instead, and each
    empty block to a round whose refused worker declined."""
    from biscotti_tpu_torch.config import Timeouts

    monkeypatch.setattr(eval_attack_matrix, "Timeouts", lambda **kw: Timeouts(
        update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0, rpc_s=20.0))
    agents = _recorded_agents(monkeypatch, eval_attack_matrix)
    rc = eval_attack_matrix.main([
        "--nodes", "5", "--rounds", "2", "--quick", "--campaigns", "hug",
        "--defenses", "KRUM", "--base-port", "17560", "--platform", "cpu",
        "--out", str(tmp_path)])
    assert rc == 0
    art = json.loads((tmp_path / "attack_matrix.json").read_text())
    (row,) = art["rows"]
    assert (row["campaign"], row["defense"], row["secure_agg"]) == \
        ("hug", "KRUM", True)
    assert row["chains_equal"]
    # every peer ran both rounds and holds the same whole chain
    assert len(agents) == 5 and all(a.iteration == 2 for a in agents)
    assert len({a.chain.dump() for a in agents}) == 1
    blocks = agents[0].chain.blocks[1:]
    assert any(not b.is_empty() for b in blocks)
    declined = {e["iter"] for a in agents for e in a.tele.recorder.tail(4096)
                if e["event"] == "update_rejected"}
    for b in blocks:
        assert not b.is_empty() or b.data.iteration in declined, \
            f"round {b.data.iteration}'s block is empty and no worker declined"
    assert row["real_blocks"] == sum(not b.is_empty() for b in blocks[:1])
    assert row["failed"] == (0 if row["survived"] else 1)
    assert row["replay"].startswith("python -m biscotti_tpu_torch.tools.chaos")
    assert {"experiment", "device", "nvidia_smi", "dataset", "nodes",
            "rounds", "seed", "poison", "flood", "noising",
            "operating_point_note", "defenses", "campaigns", "rows",
            "hug_vs_static", "table"} == set(art)
    assert (tmp_path / "attack_matrix.csv").read_text().splitlines()[0] == (
        "campaign,defense,secure_agg,final_error,chains_equal,settled,"
        "real_blocks,survived,accepted_poisoned_n")
    assert capsys.readouterr().out.rstrip().endswith(art["table"])


# ------------------------------------------- local_test and eval_os_faults


def test_local_test_runs_port_peer_processes_on_the_cpu(capsys):
    rc = local_test.main(["--nodes", "3", "--max-iterations", "2",
                          "--convergence-error", "0", "--base-port", "17580",
                          "--timeout", "240", "--platform", "cpu"])
    summary = _last_json(capsys.readouterr().out)
    assert rc == 0 and summary["chains_equal"] and summary["blocks"] >= 2
    assert summary["device"] == "cpu" and summary["oracle_peers"] == 3


def test_extract_chain_equals_the_reference():
    ref = _ref_script("local_test")
    texts = ["noise\n=== CHAIN DUMP ===\niter=0 a\niter=1 b\n=== LOGS ===\n"
             "0,0.5,1.0\n", "=== CHAIN DUMP ===\n=== LOGS ===\n", "no dump",
             "=== LOGS ===\n=== CHAIN DUMP ===\nx\n"]
    for t in texts:
        assert local_test.extract_chain(t) == ref.extract_chain(t)


def test_os_faults_scenarios_equal_the_reference(tmp_path, monkeypatch):
    """The three scenarios eval_os_faults hands to the local harness (names,
    fault flags, ports) are the reference's; the artifact keeps its keys."""
    ref = _ref_script("eval_os_faults")
    seen = {"port": [], "ref": []}

    def fake(side):
        def run_scenario(name, extra, nodes, dataset, iters, port, timeout,
                         platform="cuda"):
            seen[side].append((name, extra, nodes, dataset, iters, port,
                               timeout))
            return {"scenario": name, "chains_equal": True, "blocks": 2}
        return run_scenario

    monkeypatch.setattr(eval_os_faults, "run_scenario", fake("port"))
    monkeypatch.setattr(ref, "run_scenario", fake("ref"))
    argv = ["--nodes", "3", "--iterations", "4", "--out"]
    assert eval_os_faults.main(argv + [str(tmp_path), "--platform", "cpu"]) == 0
    assert ref.main(argv + [str(tmp_path / "ref")]) == 0
    assert seen["port"] == seen["ref"] and len(seen["port"]) == 3
    art = json.loads((tmp_path / "os_faults.json").read_text())
    assert set(art) == {"experiment", "device", "nvidia_smi", "injection",
                        "nodes", "dataset", "iterations", "rows", "ok"}


def test_os_faults_baseline_scenario_through_the_peer_cli():
    row = eval_os_faults.run_scenario("baseline", [], 3, "creditcard", 2,
                                      17600, 240.0, platform="cpu")
    assert row["rc"] == 0 and row["chains_equal"] and row["blocks"] > 0
    assert row["scenario"] == "baseline" and row["device"] == "cpu"


# ------------------------------- eval_committee_scale, eval_fedsys_compare


def test_committee_and_fedsys_cells_equal_the_reference(tmp_path, monkeypatch):
    """The cells each sweep hands to the scale harness (committees, sizes,
    modes, ports, key dir) are the reference's; the port's last argument is
    its platform."""
    import biscotti_tpu.tools.keygen as jkeygen

    for mod in (keygen, jkeygen):
        monkeypatch.setattr(mod, "make_ephemeral_dir", lambda *a, **k: "keys")
    for name, port_mod, argv in (
            ("eval_committee_scale", eval_committee_scale, []),
            ("eval_fedsys_compare", eval_fedsys_compare, ["--sizes", "4,6"])):
        ref = _ref_script(name)
        seen = {"port": [], "ref": []}

        def fake(side, _seen=seen):
            def run_cell(*args):
                _seen[side].append(args[:-1] if side == "port" else args)
                return {"s_per_iter": 1.0, "chains_equal": True,
                        "mode": "fedsys" if args[2] is True else "biscotti",
                        "final_error": 0.5}
            return run_cell

        monkeypatch.setattr(port_mod, "run_cell", fake("port"))
        monkeypatch.setattr(ref, "run_cell", fake("ref"))
        argv = argv + ["--out", str(tmp_path)]
        assert port_mod.main(argv + ["--platform", "cpu"]) == 0
        assert ref.main(argv) == 0
        assert seen["port"] == seen["ref"] and seen["port"]


def test_committee_cell_runs_the_port_scale_harness():
    cell = eval_committee_scale.run_cell(4, "creditcard", 1, 1, 1, 2, 17620,
                                         platform="cpu")
    assert cell["chains_equal"] and cell["nonempty_blocks"] >= 1
    assert cell["device"] == "cpu" and cell["secure_agg"] and cell["noising"]


def test_fedsys_cell_runs_the_port_scale_harness():
    cell = eval_fedsys_compare.run_cell(4, "creditcard", True, 2, 17640,
                                        platform="cpu")
    assert cell["mode"] == "fedsys" and cell["chains_equal"]


# ------------------------------------------------------- eval_pod_launch


def test_pod_launch_eval_runs_a_two_host_fleet(tmp_path, capsys):
    rc = eval_pod_launch.main(["--nodes-per-host", "2", "--iterations", "1",
                               "--base-port", "17660", "--platform", "cpu",
                               "--out", str(tmp_path)])
    art = json.loads((tmp_path / "pod_launch.json").read_text())
    assert rc == 0 and art["chains_equal"] and art["total_nodes"] == 4
    assert art["hosts"] == 2 and art["device"] == "cpu" and art["keyed"]
    assert _last_json(capsys.readouterr().out) == art


# ------------------------------------------------------------ parse_logs

STDOUT = """=== CHAIN DUMP ===
iter=0 ndeltas=3
=== LOGS ===
0,0.812000,1700000000.000000
1,0.401000,1700000002.500000
junk,line
2,0.350000,1700000004.000000
"""
EVENTS = "\n".join(json.dumps(e) for e in (
    {"event": "round_start", "iter": 1, "ts": 5.0},
    {"event": "round_end", "iter": 1, "error": 0.7, "ts": 6.0},
    {"event": "round_end", "iter": 2, "error": 0.5, "ts": 8.5},
    {"event": "round_end", "iter": 3, "error": 0.6, "ts": 9.0})) + "\n{broken\n"


def test_parse_logs_equals_the_reference(tmp_path, capsys):
    ref = _ref_script("parse_logs")
    for text in (STDOUT, "0,0.5,1.0\n", ""):
        assert parse_logs.rows_from_stdout(text) == ref.rows_from_stdout(text)
        rows = parse_logs.rows_from_stdout(text)
        assert json.dumps(parse_logs.summarize(rows)) == \
            json.dumps(ref.summarize(rows))
    assert parse_logs.rows_from_events(EVENTS) == ref.rows_from_events(EVENTS)
    assert parse_logs.summarize(parse_logs.rows_from_events(EVENTS)) == \
        ref.summarize(ref.rows_from_events(EVENTS))
    for name, text, flags in (("out.txt", STDOUT, []),
                              ("events.jsonl", EVENTS, ["--events"])):
        path = tmp_path / name
        path.write_text(text)
        outs = []
        for mod in (parse_logs, ref):
            assert mod.main([str(path)] + flags) == 0
            outs.append(capsys.readouterr())
        assert outs[0].out == outs[1].out and outs[0].err == outs[1].err


# --------------------------------------------------------- the peer CLI


def test_peer_cli_runs_one_peer_on_the_cpu(capsys, monkeypatch):
    """`--platform cpu`: the port's peer CLI runs a one-peer cluster on the
    CPU and prints its chain dump and logs (the GPU default raises without a
    card: tests/test_torch_import.py). A lone peer has no worker to wait
    for, so its round lasts its windows: the test gives it short ones."""
    from biscotti_tpu_torch.config import Timeouts

    monkeypatch.setattr(Timeouts, "scaled", lambda self, *a, **k: Timeouts(
        update_s=1.0, block_s=2.0, krum_s=1.0, share_s=1.0, rpc_s=3.0))
    rc = peer.main(["--platform", "cpu", "-i", "0", "-t", "1", "-d",
                    "creditcard", "-p", "17680", "-na", "1", "-nv", "1",
                    "-nn", "1", "--max-iterations", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "=== CHAIN DUMP ===" in out and "=== LOGS ===" in out
    assert len(local_test.extract_chain(out).splitlines()) == 2
