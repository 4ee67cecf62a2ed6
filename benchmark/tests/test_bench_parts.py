"""The benchmark's yardstick on the CPU: counts, the TF32 rounding, the
reference's data and draws against the program's, the no-JAX check, and
the data files that make cells and metrics."""

import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import cells  # noqa: E402
from benchmark.counts import foolsgold_gram, krum_b1, lfw_cnn, mnist_cnn  # noqa: E402
from benchmark.reference import shards  # noqa: E402
from benchmark.reference.draws import round_draws  # noqa: E402
from benchmark.reference.nets import FP64, leaf_slices, tf32_round  # noqa: E402
from benchmark.reference.round import local_deltas, model  # noqa: E402
from benchmark.run import foreign_modules, metric_names  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_model_counts_by_hand():
    # mnist_cnn: conv 2·16·25·1024, fc 2·16384·10; the step adds the conv's
    # weight gradient and both of the fc's
    assert mnist_cnn.forward_flops() == 819_200 + 327_680
    assert mnist_cnn.step_flops() == 2 * 819_200 + 3 * 327_680
    # lfw_cnn: c1 2·6·75·2494, c2 2·16·150·425, f1 2·1536·84, f3 2·84·12
    assert lfw_cnn.forward_flops() == 2_244_600 + 2_040_000 + 258_048 + 2_016
    assert lfw_cnn.step_flops() == 2 * 2_244_600 + 3 * (2_040_000 + 258_048
                                                        + 2_016)


def test_kernel_counts_by_hand():
    n, d = 716, 164_266
    assert krum_b1.flops(n, d) == 716 * 717 * 164_266  # 84.3 GFLOP
    assert krum_b1.bytes_moved(n, d) == (716 * 164_266 + 716) * 4
    assert foolsgold_gram.flops(n, d) == 2 * 716 * 716 * 164_266
    assert foolsgold_gram.bytes_moved(n, d) == (716 * 164_266 + 716 * 716) * 4


@pytest.mark.parametrize("name,counts", [("mnist_cnn", mnist_cnn),
                                         ("lfw_cnn", lfw_cnn)])
def test_model_counts_match_the_reference_products(name, counts):
    """torch's own count of the reference's matrix products for one
    sample's forward, and for its step, equals the count module's."""
    m = model(name, 1)
    d_in = importlib.import_module(f"benchmark.reference.{name}").D_IN
    w = torch.randn(m.d, dtype=torch.float64) * 0.01
    x, y = torch.randn(1, 1, d_in), torch.zeros(1, 1, dtype=torch.long)
    p = {n: w[sl].reshape((1,) + shape)
         for (n, sl), (_, shape, _) in zip(leaf_slices(m.leaves), m.leaves)}
    with FlopCounterMode(display=False) as fc:
        m.logits(FP64, p, x.double())
    assert fc.get_total_flops() == counts.forward_flops()
    with FlopCounterMode(display=False) as fc:
        local_deltas(m, FP64, w, x, y)
    assert fc.get_total_flops() == counts.step_flops()


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159265,
                      1e-3, 12345.678], dtype=torch.float32)
    r = tf32_round(x)
    # ten mantissa bits kept: ties to even, then the nearest
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 4 * 2 ** -11
    bits = r.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())
    assert bool(((r - x).abs() <= x.abs() * 2 ** -11).all())


@pytest.mark.parametrize("dataset", ["mnist", "lfw"])
def test_reference_shards_equal_the_programs(dataset):
    from biscotti_tpu_torch.data import datasets as ds

    n, p = 10, 0.3
    rows = shards.peer_rows(dataset, n, p, range(n), threads=2)
    bad = shards.poisoned(n, p)
    assert bad == {i for i in range(n) if i > math.ceil(n * (1 - p))}
    for peer in (0, 9):
        want = ds.load_shard(dataset, ds.shard_name(dataset, peer, peer in bad))
        np.testing.assert_array_equal(rows[peer][0], want["x_train"])
        np.testing.assert_array_equal(rows[peer][1], want["y_train"])
    x, y = shards.test_split(dataset, shards.class_means(dataset))
    want = ds.load_shard(dataset, f"{dataset}_test")
    np.testing.assert_array_equal(x, want["x_test"])
    np.testing.assert_array_equal(y, want["y_test"])


@pytest.mark.parametrize("workload", ["mnist_cnn_n1024.krum_dp",
                                      "lfw_cnn_n1024.krum"])
def test_reference_draws_equal_the_programs(workload):
    from benchmark.harness import build

    cell = cells.load(workload, num_nodes=12)
    sim = build(cell, 7, "cpu")
    seed = 2 ** 31 + 11
    for it in (0, 5):
        cidx, bidx, noise, keep = sim.draw_round(sim.gen, it, seed)
        c2, b2, normals = round_draws("cpu", seed, it, 12, cell.num_samples,
                                      sim.rows, cell.settings["batch_size"],
                                      sim.num_params, cell.settings["noising"])
        assert torch.equal(cidx, c2) and torch.equal(bidx, b2)
        assert bool(keep.all())
        if normals is None:
            assert not bool(noise.any())
        else:
            b = cell.settings["batch_size"]
            sigma = math.sqrt(2 * math.log(1.25 / cell.settings["delta"]))
            want = normals * (sigma * math.sqrt(b) * (-1.0 / b))
            torch.testing.assert_close(noise, want, rtol=1e-6, atol=0)


def test_foreign_modules_compares_whole_top_level_names():
    assert foreign_modules(["biscotti_tpu_torch", "biscotti_tpu_torch.ops.krum",
                            "jaxtyping", "flaxen", "numpy"]) == []
    assert foreign_modules(["biscotti_tpu.ops.krum", "jax.numpy", "jaxlib",
                            "flax.linen", "torch"]) == [
        "biscotti_tpu", "flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax():
    """Every module a run imports, the program's included, loads none of
    JAX or of the JAX package."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.harness, benchmark.check, "
            "benchmark.tracing, benchmark.calibrate\n"
            "import biscotti_tpu_torch.parallel.sim, "
            "biscotti_tpu_torch.ops.krum_cuda, biscotti_tpu_torch.utils.profiling\n"
            "import pkgutil, importlib, benchmark.metrics as m\n"
            "for i in pkgutil.iter_modules(m.__path__): "
            "importlib.import_module('benchmark.metrics.' + i.name)\n"
            "print(benchmark.run.foreign_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_benchmark_json_matches_the_files():
    for w in SPEC["workloads"]:
        cell = cells.load(w["name"])
        assert cell.config["name"] == w["config"] and cell.chips == w["chips"]
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert {"first_update_gap", "change_gap", "window_update_gap",
                "mask_gap", "stake_gap", "wrong_rows_gap"} <= set(cell.limits)
        assert cell.limits["stake_gap"] == 0
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        m = model(cfg["simulator"]["model_name"], 1)
        assert cfg["num_params"] == m.d
        assert cfg["leaves"] == {n: list(s) for n, s, _ in m.leaves}
    for kind in ("end_to_end", "per_layer"):
        for e in SPEC[kind]:
            mod = importlib.import_module(
                f"benchmark.metrics.{e['name'].split('.')[0]}")
            assert mod.UNIT == e["unit"]
            if kind == "per_layer":
                suffix = e["name"][len(e["name"].split(".")[0]):]
                assert (mod.LAYER, mod.MOVES + suffix) == (e["layer"], e["moves"])


def _data_copy(tmp_path):
    for kind in ("configs", "traffic", "workloads"):
        (tmp_path / kind).mkdir()
        for f in (ROOT / "benchmark" / kind).glob("*.json"):
            (tmp_path / kind / f.name).write_text(f.read_text())
    return json.loads((tmp_path / "workloads"
                       / "mnist_cnn_n1024.krum_dp.json").read_text())


def test_a_new_workload_file_is_a_cell(tmp_path, monkeypatch):
    """A cell is found by its file's name: a copy of the data directories
    with one more traffic mix and workload file, and nothing else
    changed, runs it; the program's settings and the reference's rule
    are found by the traffic's names."""
    from benchmark import harness

    base = _data_copy(tmp_path)
    traffic = json.loads((tmp_path / "traffic" / "krum_dp.json").read_text())
    traffic["simulator"]["defense"] = "NONE"
    traffic["simulator"]["stake_unit"] = 5
    (tmp_path / "traffic" / "none_dp.json").write_text(json.dumps(
        {**traffic, "defense_counts": None}))
    (tmp_path / "workloads" / "mnist_cnn_n1024.none_dp.json").write_text(
        json.dumps({**base, "traffic": "none_dp"}))
    monkeypatch.setattr(cells, "HERE", tmp_path)
    cell = cells.load("mnist_cnn_n1024.none_dp", num_nodes=12,
                      reference_block=8)
    assert cell.settings["defense"] == "NONE"
    assert harness.sim_config(cell, 5).stake_unit == 5
    out = harness.run(cell, 3_000_000_019, 0.05, False, "cpu", 0.0,
                      metric_names({"end_to_end": [{"name": "round_ms"}]},
                                   "end_to_end", cell.name),
                      log=lambda m: None)
    assert out["correct"], out["numbers"]
    assert set(out["values"]) == {"round_ms"}


@pytest.mark.parametrize("bad", [{"simulator": {"no_such_setting": 1}},
                                 {"simulator": {"seed": 1}},
                                 {"simulator": {"num_nodes": 12}}])
def test_a_setting_the_program_does_not_take_is_refused(tmp_path, monkeypatch,
                                                        bad):
    """A traffic key that names no field of the program's configuration,
    the seed (the run's own), or a key the configuration already sets
    stops the run before it starts."""
    from benchmark import harness

    base = _data_copy(tmp_path)
    traffic = json.loads((tmp_path / "traffic" / "krum_dp.json").read_text())
    traffic["simulator"].update(bad["simulator"])
    (tmp_path / "traffic" / "odd.json").write_text(json.dumps(traffic))
    (tmp_path / "workloads" / "mnist_cnn_n1024.odd.json").write_text(
        json.dumps({**base, "traffic": "odd"}))
    monkeypatch.setattr(cells, "HERE", tmp_path)
    cell = cells.load("mnist_cnn_n1024.odd")
    with pytest.raises(KeyError):
        harness.sim_config(cell, 5)


def test_each_defense_has_its_reference_rule():
    """Every defense a traffic mix names has `reference/defense_<name>.py`
    with a decision and an aggregate."""
    from benchmark.reference import defense

    names = {json.loads(f.read_text())["simulator"]["defense"]
             for f in (ROOT / "benchmark" / "traffic").glob("*.json")}
    for name in names | {"NONE"}:
        mod = defense.rule(name)
        assert callable(mod.decide) and callable(mod.aggregate)


def test_round_readers_take_the_window_not_the_traced_stretch():
    """round_mfu and idle_share divide by the measured window's round,
    which no profiler slows; a traced stretch twice as slow changes
    neither, and a busy time over the window's round reads as no idle."""
    from types import SimpleNamespace

    from benchmark.metrics import idle_share, round_mfu
    from benchmark.peaks import TF32_FLOPS

    cell = cells.load("mnist_cnn_n1024.krum_dp")
    flops = round_mfu.round_flops(cell)
    assert flops == (716 * 10 * mnist_cnn.step_flops()
                     + 2000 * mnist_cnn.forward_flops()
                     + krum_b1.flops(716, 164_266))
    for stretch_s in (0.4, 0.8):
        run = SimpleNamespace(cell=cell, rounds=1000, window_s=20.0,
                              trace={"rounds": 20, "window_s": stretch_s,
                                     "busy_s": 0.3})
        assert math.isclose(round_mfu.read(run),
                            100 * flops / 0.02 / TF32_FLOPS)
        assert math.isclose(idle_share.read(run), 100 * (1 - 0.015 / 0.02))
    run.trace["busy_s"] = 0.41
    assert idle_share.read(run) == 0.0
