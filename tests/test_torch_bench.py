"""The port's device-round bench (`python -m biscotti_tpu_torch.bench`) on
the CPU with a two-config list: one JSON line with the stated keys, and the
configs built from the reference bench's keywords."""

import json

import pytest

from biscotti_tpu.config import BiscottiConfig as JConfig
from biscotti_tpu_torch import bench

ROW_KEYS = {"dataset", "model", "nodes", "params", "defense", "secure_agg",
            "noising", "poison", "timed_rounds", "device_round_s",
            "accepted_per_round", "final_error"}


def test_bench_prints_one_json_line(capsys):
    names = ["creditcard_10", "svm_mnist_100_krum_secagg"]
    assert bench.main(["--configs", ",".join(names), "--rounds", "2",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["device"] == "cpu" and out["nvidia_smi"] is None
    assert out["warm_rounds"] == 2 and list(out["rows"]) == names
    for name, row in out["rows"].items():
        assert set(row) == ROW_KEYS, name
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
