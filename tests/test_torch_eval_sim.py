"""The port's simulator drivers (`biscotti_tpu_torch/eval/`: eval_sim_scale,
eval_krum_kernel, eval_poison, eval_privacy_utility, eval_inversion)
against the reference's `eval/` scripts, on the CPU at a small size.

Where the reference's driver computes a number from given inputs (the
Krum scores of its numpy-made x, eval_poison's gate over per-cell
aggregates, the inversion objective and Adam steps), both packages get the
same inputs and the test states the tolerance. Where the reference draws
from `jax.random`, the test runs the port's driver and holds its artifact
to the reference's keys, CSV header and cell grid."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from biscotti_tpu import config as jc
from biscotti_tpu.models.zoo import model_for_dataset as jmodel_for_dataset
from biscotti_tpu.ops.krum import krum_scores as jkrum_scores
from biscotti_tpu_torch.eval import (eval_inversion, eval_krum_kernel,
                                     eval_poison, eval_privacy_utility,
                                     eval_sim_scale)
from biscotti_tpu_torch.models.zoo import model_for_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_script(name):
    """A reference script of eval/ as a module (their top levels import the
    standard library only)."""
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "eval", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _csv_header(path):
    with open(path) as f:
        return f.readline().strip()


# ---------------------------------------------------------- eval_sim_scale


def test_sim_scale_driver_keeps_the_reference_artifact(tmp_path, capsys):
    rc = eval_sim_scale.main(["--sizes", "10,20", "--rounds", "2",
                              "--platform", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    art = json.loads((tmp_path / "sim_scale.json").read_text())
    assert set(art) == {"experiment", "platform", "device", "nvidia_smi",
                        "dataset", "timing_note", "reference", "rows"}
    assert art["device"] == "cpu" and art["nvidia_smi"] is None
    ref_keys = {"nodes", "contributors_per_round", "rounds", "s_per_iter",
                "device_ms_per_iter", "wall_s", "compile_s", "final_error",
                "mean_accepted", "krum_path"}
    added = {"scan_event_ms_per_iter", "device_idle_share",
             "kernels_per_iter", "krum_launches"}
    for n, row in zip((10, 20), art["rows"]):
        assert set(row) == ref_keys | added
        assert row["nodes"] == n and row["rounds"] == 2
        # S from the reference's own config at the same size
        assert row["contributors_per_round"] == jc.BiscottiConfig(
            num_nodes=n, sample_percent=0.70).num_samples
        assert row["krum_path"] == "plain" and row["krum_launches"] == 0
        assert row["device_ms_per_iter"] is None  # not measured on the CPU
        assert 0.0 <= row["final_error"] <= 1.0
    assert _csv_header(tmp_path / "sim_scale.csv") == (
        "nodes,contributors,rounds,s_per_iter,device_ms_per_iter,"
        "final_error,krum_path")
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "experiment": "sim_scale", "max_nodes": 20,
        "s_per_iter_at_max": art["rows"][-1]["s_per_iter"]}


def test_sim_scale_driver_needs_a_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_sim_scale.main(["--sizes", "10", "--rounds", "1"])


# -------------------------------------------------------- eval_krum_kernel


@pytest.mark.parametrize("n,d", [(16, 32), (40, 24)])
def test_krum_kernel_driver_scores_the_reference_inputs(n, d):
    """The driver's x is the reference's (`default_rng(n).normal`, float32,
    f = n // 2); the port's plain scores on it equal the reference's
    `krum_scores` within rtol 1e-5, and the row agrees with itself."""
    row = eval_krum_kernel.size_row(n, d, torch.device("cpu"))
    x = np.random.default_rng(n).normal(size=(n, d)).astype(np.float32)
    ref = np.asarray(jkrum_scores(jnp.asarray(x), n // 2))
    got = eval_krum_kernel.krum_cuda.krum_scores_plain(torch.from_numpy(x),
                                                      n // 2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert row["agree"] and row["accept_set_equal"] and row["n"] == n
    assert row["kernel_ms"] is None and row["plain_ms"] is None


def test_krum_kernel_driver_cli_and_bound(tmp_path, capsys):
    assert eval_krum_kernel.main(["--sizes", "8,20", "--d", "16", "--platform",
                                  "cpu", "--out", str(tmp_path)]) == 0
    art = json.loads((tmp_path / "krum_kernel.json").read_text())
    assert [r["n"] for r in art["rows"]] == [8, 20]
    assert {"n", "d", "plain_ms", "kernel_ms", "speedup", "max_rel_err",
            "agree"} <= set(art["rows"][0])
    assert art["window"] == [512, 4096] and art["device"] == "cpu"
    assert _csv_header(tmp_path / "krum_kernel.csv") == \
        "n,d,plain_ms,kernel_ms,speedup,max_rel_err"
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["all_agree"]
    # the bound chip_smoke.py reports at the main path's shape: the
    # n(n-1)/2 off-diagonal dot products on the fp32 FMA pipe
    ms, by = eval_krum_kernel.krum_bound(716, 7850)
    assert by == "operations" and ms == pytest.approx(
        1e3 * 716 * 715 * 7850 / 67e12, rel=1e-12)


# ------------------------------------------------------------- eval_poison


def test_poison_gate_equals_the_reference_artifact(tmp_path):
    """The reference's gate is inline in its main: run its driver at a tiny
    size on the CPU, give its per-cell aggregates to the port's `gate`, and
    compare with the gate in its artifact, exactly."""
    out = tmp_path / "ref"
    proc = subprocess.run(
        [sys.executable, "eval/eval_poison.py", "--nodes", "10", "--rounds",
         "1", "--seeds", "2", "--out", str(out), "--platform", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    ref = json.loads((out / "poison.json").read_text())
    got, ok = eval_poison.gate(ref["rows"], ref["defenses"], "", False,
                               ref["nodes"], ref["seeds"])
    assert got == ref["gate"]
    assert proc.returncode == (0 if ok else 1)
    # the waived and the control-less gates, from the same aggregates
    got, ok = eval_poison.gate(ref["rows"], ref["defenses"], "", True, 10, 2)
    assert ok and got["gate_waived"].startswith("--no-gate")
    assert got["separates"] == ref["gate"]["separates"]
    got, ok = eval_poison.gate(ref["rows"], ["KRUM"], "", False, 10, 2)
    assert ok and got == {"summary": "defense_reduces_attack_rate",
                          "gate_defense": "KRUM",
                          "gate_waived": "no defense/control pair in "
                                         "--defenses"}


def test_poison_driver_keeps_the_reference_artifact(tmp_path, capsys):
    rc = eval_poison.main(["--nodes", "10", "--rounds", "1", "--seeds", "2",
                           "--no-gate", "--platform", "cpu",
                           "--out", str(tmp_path)])
    assert rc == 0
    art = json.loads((tmp_path / "poison.json").read_text())
    assert set(art) == {"experiment", "device", "nvidia_smi", "dataset",
                        "nodes", "rounds", "seeds", "noising", "epsilon",
                        "defenses", "trim_fraction", "rows", "data_note",
                        "seeds_note", "gate"}
    grid = [(p, d) for p in eval_poison.POISON_FRACTIONS
            for d in ("KRUM", "NONE")]
    assert [(r["poison"], r["defense"]) for r in art["rows"]] == grid
    assert eval_poison.POISON_FRACTIONS == \
        _ref_script("eval_poison").POISON_FRACTIONS
    assert set(art["rows"][0]) == {
        "poison", "defense", "seeds", "final_error", "final_error_std",
        "attack_rate", "attack_rate_std", "attack_success_rate",
        "attack_success_rate_std", "mean_accepted", "mean_accepted_std"}
    assert _csv_header(tmp_path / "poison.csv") == (
        "poison,defense,seed,final_error,attack_rate,attack_success_rate,"
        "mean_accepted")
    assert art["gate"]["gate_waived"].startswith("--no-gate")
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == art["gate"]


# --------------------------------------------------- eval_privacy_utility


def test_privacy_utility_driver_keeps_the_reference_grid(tmp_path):
    eval_privacy_utility.main(["--nodes", "10", "--rounds", "2", "--platform",
                               "cpu", "--out", str(tmp_path)])
    art = json.loads((tmp_path / "privacy_utility.json").read_text())
    eps = _ref_script("eval_privacy_utility").EPSILONS
    assert eval_privacy_utility.EPSILONS == eps
    label = ["inf" if e == float("inf") else e for e in eps]
    grid = [(m, None, e) for m in ("model", "committee") for e in label] + \
        [("model", "gaussian", 1.0), ("model", "mcmc13", 1.0)]
    assert [(r["mode"], r.get("mechanism"), r["epsilon"])
            for r in art["rows"]] == grid
    assert "mcmc_accept_rate" in art["rows"][-1]
    assert art["rows"][5] == dict(art["rows"][11], mode="model")  # ε = ∞
    assert set(art) == {"experiment", "device", "nvidia_smi", "dataset",
                        "nodes", "rounds", "rows", "data_note"}
    assert _csv_header(tmp_path / "privacy_utility.csv") == (
        "mode,mechanism,epsilon,final_error,best_error,attack_rate,"
        "mean_accepted")


# ---------------------------------------------------------- eval_inversion


def test_inversion_objective_and_adam_steps_equal_the_reference():
    """The gradient-matching objective and 4 Adam steps (lr 0.1) from one
    x0 and one observed gradient, port against the reference's jax/optax
    formulation (eval/eval_inversion.py:60-84), within rtol 1e-4."""
    rng = np.random.default_rng(3)
    batch, steps = 2, 4
    jm, pm = jmodel_for_dataset("mnist"), model_for_dataset("mnist")
    x0 = (0.01 * rng.normal(size=(batch, jm.d_in))).astype(np.float32)
    y = np.array([1, 7], np.int32)
    w = (0.01 * rng.normal(size=jm.num_params)).astype(np.float32)
    observed = (0.1 * rng.normal(size=jm.num_params)).astype(np.float32)

    jw, jy, jobs = jnp.asarray(w), jnp.asarray(y), jnp.asarray(observed)
    grad_fn = jax.grad(jm.loss_flat)

    def match_loss(x):
        diff = grad_fn(jw, x, jy) - jobs
        return jnp.sum(diff * diff)

    opt = optax.adam(0.1)
    x, state, losses = jnp.asarray(x0), None, []
    state = opt.init(x)
    for _ in range(steps):
        loss, g = jax.value_and_grad(match_loss)(x)
        up, state = opt.update(g, state)
        x = optax.apply_updates(x, up)
        losses.append(float(loss))

    tw, ty = torch.from_numpy(w), torch.from_numpy(y.astype(np.int64))
    tobs = torch.from_numpy(observed)
    got0 = float(eval_inversion.match_loss(pm, tw, ty, tobs,
                                           torch.from_numpy(x0)))
    assert got0 == pytest.approx(losses[0], rel=1e-4)
    recon, last = eval_inversion.reconstruct(pm, tw, ty, tobs,
                                             torch.from_numpy(x0), steps)
    assert last == pytest.approx(losses[-1], rel=1e-4)
    np.testing.assert_allclose(recon, np.asarray(x), rtol=1e-4, atol=1e-7)


def test_inversion_driver_keeps_the_reference_artifact(tmp_path, capsys):
    eval_inversion.main(["--steps", "3", "--batch", "2", "--platform", "cpu",
                         "--out", str(tmp_path)])
    art = json.loads((tmp_path / "inversion.json").read_text())
    assert [r["epsilon"] for r in art["rows"]] == ["inf", "1.0", "0.1"]
    assert set(art["rows"][0]) == {"epsilon", "cosine_similarity",
                                   "match_loss"}
    assert set(art) == {"experiment", "device", "nvidia_smi", "dataset",
                        "batch", "steps", "rows", "data_note"}
    assert _csv_header(tmp_path / "inversion.csv") == \
        "epsilon,cosine_similarity"
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["summary"] == "dp_degrades_inversion"
    # best_cosine of an input against itself is 1
    x = np.random.default_rng(0).normal(size=(3, 8))
    assert eval_inversion.best_cosine(x, x) == pytest.approx(1.0)
