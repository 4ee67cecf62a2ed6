"""The reference bench's four other entries in the port's bench
(`biscotti_tpu_torch/bench.py`: crypto_kernel, straggler, attack_matrix,
migration), on the CPU at a small size.

Held to the reference exactly where no random draw is involved: the
crypto entry's points at widths 2 and 3 (the port's device plane armed on
the CPU against the reference's `cm.msm`) and the straggler entry's seed
scan (the reference nests `plan_for` in its entry, bench.py:593-605, so the
test repeats that scan over the reference's `FaultPlan.slow_table`). The
live entries' rows are held to the reference's keys and oracle bits.
Ports are 17700-17799."""

import json

import pytest
import torch

from biscotti_tpu.crypto import commitments as jcm
from biscotti_tpu.crypto import ed25519 as jed
from biscotti_tpu.runtime.faults import FaultPlan as JFaultPlan
from biscotti_tpu_torch import bench
from biscotti_tpu_torch.config import Defense
from biscotti_tpu_torch.crypto import commitments as cm
from biscotti_tpu_torch.crypto import ed25519 as ed
from biscotti_tpu_torch.crypto import kernels

MSM_KEYS = {"cpu_msm_s", "device_msm_s", "cpu_msm_points_per_s",
            "device_msm_points_per_s", "results_equal"}


def test_crypto_kernel_entry_equals_the_reference_msm():
    """Widths 2 and 3: the entry's two paths agree, and the port's device
    plane on the CPU gives the reference's `cm.msm` point exactly, from the
    same commit key and scalars."""
    out = bench.bench_crypto_kernel((2, 3), device="cpu")
    assert list(out) == ["w2", "w3"]
    assert all(set(r) == MSM_KEYS and r["results_equal"] for r in out.values())
    key = cm.CommitKey.generate(3, label=b"bench-msm")
    jkey = jcm.CommitKey.generate(3, label=b"bench-msm")
    for w in (2, 3):
        scalars = bench.msm_scalars(w)
        assert scalars == [((i + 3) * 0x9E3779B97F4A7C15F39CC0605CEDC835) | 1
                           for i in range(w)]
        assert [ed.point_compress(p) for p in key.points[:w]] == \
            [jed.point_compress(p) for p in jkey.points[:w]]
        got = kernels.msm(scalars, key.points[:w], device="cpu")
        assert ed.point_compress(got) == jed.point_compress(jcm.msm(scalars, jkey.points[:w]))


def _ref_plan_for(frac, n):
    """bench.py:593-605 over the reference's FaultPlan."""
    want = int(round(frac * n))
    if want == 0:
        return JFaultPlan(), 0
    for seed in range(500):
        p = JFaultPlan(seed=seed, slow=frac, slow_factor=4.0)
        if len(p.slow_table(n)) == want:
            return p, seed
    return JFaultPlan(slow_node=1, slow_factor=4.0), -1


@pytest.mark.parametrize("n", [10, 4, 3])
def test_straggler_plan_for_equals_the_reference_scan(n):
    for frac in (0.0, 0.10, 0.20):
        plan, seed = bench.plan_for(frac, n)
        ref, ref_seed = _ref_plan_for(frac, n)
        assert seed == ref_seed
        assert repr(plan) == repr(ref)
        assert sorted(plan.slow_table(n)) == sorted(ref.slow_table(n))


def test_straggler_entry_rows():
    """The whole entry at n = 4, 2 rounds: a warm-up, then six rows under
    the reference's names with its columns; every cluster's chains equal
    with a real block; the 20 % rows carry vs_homogeneous."""
    out = bench.bench_straggler_degradation(n=4, rounds=2, base_port=17700,
                                            device="cpu")
    names = [f"slow{p}_{m}" for p in (0, 10, 20) for m in ("fixed", "adaptive")]
    assert list(out) == names
    for name in names:
        row = out[name]
        assert {"mean_round_s", "chains_equal", "real_blocks",
                "straggler_excluded", "slowed_peers", "slow_seed",
                "slow_factor"} <= set(row), row
        assert row["chains_equal"] and row["real_blocks"] >= 1, row
    assert out["slow20_adaptive"]["slowed_peers"] == \
        len(bench.plan_for(0.2, 4)[0].slow_table(4))
    assert "vs_homogeneous" in out["slow20_fixed"]


def test_attack_matrix_entry_rows(monkeypatch):
    """One guard cell (hug × KRUM) through the port's eval driver, the
    operating point cut to 5 nodes and 2 rounds: the reference's
    regression-gated columns and anchor_error; a budget that covers no cell
    gives error rows."""
    monkeypatch.setattr(bench, "ATTACK_POINT",
                        dict(bench.ATTACK_POINT, nodes=5, rounds=2))
    out = bench.bench_attack_matrix(base_port=17750, device="cpu",
                                    cells=(("hug", Defense.KRUM),))
    row = out["hug_krum"]
    assert set(out) == {"complete", "hug_krum"} and out["complete"]
    assert set(row) == {"chains_equal", "survived", "failed",
                        "accepted_poisoned_n", "anchor_error"}
    assert row["chains_equal"] and row["failed"] == (0 if row["survived"]
                                                     else 1)
    out = bench.bench_attack_matrix(budget_s=0.0, device="cpu")
    assert out["complete"] is False
    assert [k for k in out if k != "complete"] == [
        "static_krum", "hug_krum", "static_foolsgold", "hug_foolsgold",
        "hug_ensemble"]
    assert all(v == {"error": "attack-matrix budget exhausted"}
               for k, v in out.items() if k != "complete")


def test_migration_entry_moves_peers_and_keeps_chains():
    out = bench.bench_migration(n=6, iterations=2, base_port=17770,
                                device="cpu")
    assert out["moves"] >= 1 and out["chains_equal"] and out["real_blocks"] >= 1
    assert {"peers", "iterations", "moves", "chains_equal", "settled_height",
            "real_blocks", "migration_downtime_s", "downtime_max_s",
            "migration_bytes", "ticket_bytes_max"} == set(out)
    assert out["migration_bytes"] > 0


@pytest.mark.parametrize("switch,entry", [
    ("BISCOTTI_BENCH_CRYPTO_KERNEL", bench.bench_crypto_kernel),
    ("BISCOTTI_BENCH_STRAGGLER", bench.bench_straggler_degradation),
    ("BISCOTTI_BENCH_ATTACK", bench.bench_attack_matrix),
    ("BISCOTTI_BENCH_MIGRATION", bench.bench_migration)])
def test_entries_keep_the_reference_skip_switches(monkeypatch, switch, entry):
    monkeypatch.setenv(switch, "0")
    assert entry(device="cpu") == {"skipped": f"{switch}=0"}


def test_bench_cli_runs_the_asked_entries(monkeypatch, capsys):
    """`--entries` runs each named entry on the bench's device and puts its
    rows under the reference's key in the one JSON line."""
    seen = []

    def fake(key):
        def entry(device=None):
            seen.append((key, device))
            return {"ran": key}
        return entry

    monkeypatch.setattr(bench, "run", lambda names, rounds, device:
                        {"device": "cpu", "rows": {}})
    monkeypatch.setattr(bench, "ENTRIES", {
        name: (key, fake(key)) for name, (key, _) in bench.ENTRIES.items()})
    assert bench.main(["--device", "cpu", "--entries",
                       "migration,crypto_kernel,straggler,attack_matrix"]) == 0
    out = json.loads(capsys.readouterr().out)
    for key in ("migration", "crypto_kernel", "straggler_degradation",
                "attack_matrix"):
        assert out[key] == {"ran": key}
    assert all(d == torch.device("cpu") for _, d in seen) and len(seen) == 4
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--entries", "nope"])
