"""The port's crypto-inclusive bench (`python -m biscotti_tpu_torch.bench`)
on the CPU with two-config lists: one JSON line with the stated keys, the
crypto half's keys (the device ones where C·k ≤ 2048, from the plane armed
on the bench's device), an exact share round-trip, the reference's
headline, the configs built from the reference bench's keywords, and the
six byte columns equal to the reference bench's (`bench.py:73-190`,
`:396-417`) on every BASELINE config for the same vector and count."""

import importlib.util
import json
import os

import numpy as np
import pytest

from biscotti_tpu.config import BiscottiConfig as JConfig
from biscotti_tpu_torch import bench
from biscotti_tpu_torch.models.zoo import model_for_dataset

CRYPTO_KEYS = {"worker_crypto_s", "miner_intake", "miner_fold_s",
               "miner_crypto_s", "miner_crypto_oneshot_s", "recovery_s",
               "share_pipeline_roundtrip_ok", "round_total_s",
               "round_total_pipelined_s"}
DEVICE_KEYS = {"miner_crypto_device_s", "msm_points_per_s"}
WIRE_KEYS = {"wire_bytes_per_round", "wire_bytes_per_round_f32_zlib",
             "wire_compression_x", "cross_host_bytes_per_round",
             "cross_host_bytes_per_round_overlay",
             "overlay_cross_host_saving_x"}
ROW_KEYS = {"dataset", "model", "nodes", "params", "defense", "secure_agg",
            "noising", "poison", "timed_rounds", "device_round_s",
            "accepted_per_round", "final_error"} | CRYPTO_KEYS | WIRE_KEYS
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_bench():
    """The repo's root `bench.py` (the reference's bench) as a module."""
    spec = importlib.util.spec_from_file_location(
        "reference_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_prints_one_json_line(capsys):
    names = ["creditcard_10", "svm_mnist_100_krum_secagg"]
    assert bench.main(["--configs", ",".join(names), "--rounds", "2",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["device"] == "cpu" and out["nvidia_smi"] is None
    assert out["native_ec_plane"] is True
    assert out["warm_rounds"] == 2 and list(out["rows"]) == names
    assert "headline" not in out  # mnist_100_dp_eps1 did not run
    for name, row in out["rows"].items():
        device_keys = DEVICE_KEYS if name == "creditcard_10" else set()
        assert set(row) == ROW_KEYS | device_keys, name
        assert row["timed_rounds"] == 2 and row["device_round_s"] > 0
        assert 0.0 <= row["final_error"] <= 1.0
    assert out["rows"]["creditcard_10"]["params"] == 25
    assert out["rows"]["svm_mnist_100_krum_secagg"]["model"] == "svm"


def test_bench_configs_are_the_reference_rows():
    assert [n for n, _ in bench.CONFIGS] == [
        "creditcard_10", "mnist_100_clean", "mnist_100_poison30_krum",
        "mnist_100_dp_eps1", "cifar_lenet_100_krum_secagg",
        "mnist_cnn_100_krum_secagg", "lfw_cnn_100_krum_secagg",
        "svm_mnist_100_krum_secagg"]
    for name, kw in bench.CONFIGS:
        cfg = bench.config(name)
        ref = JConfig(defense=cfg.defense.value, **kw, **bench.BASE)
        assert cfg.num_samples == ref.num_samples, name
        assert bench.timed_rounds(cfg) == (4 if kw.get("model_name") else 10)


def test_bench_rejects_unknown_configs():
    with pytest.raises(SystemExit):
        bench.main(["--configs", "nope", "--device", "cpu"])


def test_bench_on_the_card_refuses_the_python_int_fallback(monkeypatch):
    """On the GPU the host crypto half must run on the native plane: a
    bench whose library did not load raises before any row."""
    import torch

    from biscotti_tpu_torch.crypto import _native

    monkeypatch.setattr(bench, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(_native, "available", lambda: False)
    monkeypatch.setattr(_native, "load_error", lambda: "g++ not found")
    monkeypatch.setattr(bench, "bench_config", pytest.fail)
    with pytest.raises(RuntimeError, match="native EC plane did not load: "
                                           "g\\+\\+ not found"):
        bench.run(["creditcard_10"])


def test_bench_crypto_half_and_headline():
    """One round of creditcard_10 (C·k = 30: the device settle runs, on the
    plane armed on the CPU) and of mnist_100_dp_eps1 (C·k = 7,850: host
    only), with the reference's headline."""
    out = bench.run(["creditcard_10", "mnist_100_dp_eps1"], rounds=1,
                    device="cpu")
    cc, mn = out["rows"]["creditcard_10"], out["rows"]["mnist_100_dp_eps1"]
    assert DEVICE_KEYS <= set(cc) and not DEVICE_KEYS & set(mn)
    for row in (cc, mn):
        assert CRYPTO_KEYS <= set(row)
        assert row["share_pipeline_roundtrip_ok"] is True
        assert all(row[k] > 0 for k in CRYPTO_KEYS
                   if k not in ("share_pipeline_roundtrip_ok", "miner_intake"))
        assert row["round_total_s"] == pytest.approx(
            row["device_round_s"] + row["worker_crypto_s"]
            + row["miner_crypto_oneshot_s"] + row["recovery_s"])
        assert row["round_total_pipelined_s"] == pytest.approx(
            max(row["device_round_s"], row["worker_crypto_s"],
                row["miner_fold_s"]) + row["miner_crypto_s"]
            + row["recovery_s"])
    assert (cc["miner_intake"], mn["miner_intake"]) == (2, 35)
    assert cc["msm_points_per_s"] > 0
    head = out["headline"]
    assert head["metric"].startswith("crypto-inclusive s/iter")
    assert head["value"] == mn["round_total_pipelined_s"]
    assert head["serial_s_per_iter"] == mn["round_total_s"]


@pytest.mark.parametrize("name", [n for n, _ in bench.CONFIGS])
def test_byte_columns_equal_reference(name):
    """The six byte columns for one seeded model-width vector (float32
    values as float64, as the bench takes the final weights off the card)
    and one accepted count, through both packages' frame encoders."""
    ref_bench = _reference_bench()
    cfg = bench.config(name)
    ref_cfg = JConfig(defense=cfg.defense.value, **dict(bench.CONFIGS)[name],
                      **bench.BASE)
    d = model_for_dataset(cfg.dataset, cfg.model_name).num_params
    w = np.random.default_rng(len(name)).normal(0.0, 0.05, d).astype(
        np.float32).astype(np.float64)
    accepted = cfg.num_samples // 2
    raw = ref_bench.wire_round_bytes(ref_cfg, w, accepted, codec="raw64")
    f32z = ref_bench.wire_round_bytes(ref_cfg, w, accepted, codec="f32+zlib")
    flat = ref_bench.cross_host_round_bytes(ref_cfg, w, accepted, hosts=2,
                                            overlay=False)
    tree = ref_bench.cross_host_round_bytes(ref_cfg, w, accepted, hosts=2,
                                            overlay=True)
    want = {"wire_bytes_per_round": raw,
            "wire_bytes_per_round_f32_zlib": f32z,
            "wire_compression_x": round(raw / max(1, f32z), 2),
            "cross_host_bytes_per_round": flat,
            "cross_host_bytes_per_round_overlay": tree,
            "overlay_cross_host_saving_x": round(flat / max(1, tree), 2)}
    assert bench.byte_columns(cfg, w, accepted) == want
    assert set(want) == WIRE_KEYS and f32z < raw
    for codec in ("raw64", "f32+zlib", "topk+f32+zlib"):
        assert bench._round_frame_bytes(cfg, w, accepted, codec) \
            == ref_bench._round_frame_bytes(ref_cfg, w, accepted, codec)


def test_peer_density_parses_summaries_and_keeps_error_rows(monkeypatch):
    """`bench_peer_density` runs one process of the port's hive CLI a
    size (the reference's command, bench.py:478-481, on the asked-for
    device), parses its summary line with pod_launch's `hive_summary`
    into the reference's columns, and turns a process that printed no
    summary, one that raised, and a size the budget no longer covers into
    error rows."""
    import subprocess
    import types

    summary = {"peers": 100, "blocks": 2, "chains_equal_local": True,
               "s_per_iter": 1.5, "rss_peak_bytes": 3 * 2**30,
               "rss_per_peer_bytes": 3 * 2**30 // 100, "loop_lag_s": 0.01,
               "sgd_batches": 2, "rss_peak_source": "VmHWM",
               "rss_sampled_max_bytes": 2 * 2**30}
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        n = int(cmd[cmd.index("-t") + 1])
        if n == 100:
            return types.SimpleNamespace(
                stdout="log line\n" + json.dumps(summary) + "\n",
                stderr="", returncode=0)
        if n == 400:
            return types.SimpleNamespace(stdout="", stderr="x" * 900 + "Killed",
                                         returncode=-9)
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    out = bench.bench_peer_density(platform="cpu")
    assert calls[0][2:] == ["biscotti_tpu_torch.runtime.hive", "-t", "100",
                            "-d", "mnist", "--iterations", "2", "-sa", "0",
                            "-np", "0", "-vp", "1", "--seed", "3",
                            "--platform", "cpu"]
    assert out["n100"] == {"peers": 100, "blocks": 2, "chains_equal": True,
                           "s_per_iter": 1.5, "rss_peak_mb": 3072.0,
                           "rss_per_peer_mb": 30.72, "loop_lag_s": 0.01,
                           "sgd_batches": 2, "rss_peak_source": "VmHWM",
                           "rss_sampled_max_per_peer_mb": 20.48}
    assert out["n400"]["error"] == "no summary (rc=-9)"
    assert out["n400"]["stderr_tail"].endswith("Killed")
    assert len(out["n400"]["stderr_tail"]) == 800
    assert out["n1000"]["error"].startswith("TimeoutExpired")
    out = bench.bench_peer_density(sizes=(100,), budget_s=10.0)
    assert out == {"n100": {"error": "density budget exhausted"}}
