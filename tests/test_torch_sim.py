"""The slice as a whole: the port's simulator round against the JAX
`Simulator`, on the reference's own draws, for every defense, both DP
mechanisms and a CNN family.

The reference draws from `jax.random` under sim.py:240-253's keys; the test
takes those draws (contributors, minibatch rows, DP noise, dropped frames)
from the JAX `Simulator`'s own `_contributors`, `sample_batch` and
`_peer_noise`, and feeds them to the port's `round_step_from_draws`. Both
sides then run 3 rounds from the same non-zero weights.

Tolerances: masks and stakes exact; w within rtol 1e-5, atol 1e-5 (float32
sums in another order; rtol 1e-4, atol 1e-4 for the mnist CNN, whose
convolution gradients sum in another order too); the test error within one
test sample (1/test_size).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biscotti_tpu.config import BiscottiConfig as JConfig
from biscotti_tpu.config import Defense as JDefense
from biscotti_tpu.models.trainer import sample_batch as jsample_batch
from biscotti_tpu.parallel.sim import Simulator as JSimulator
from biscotti_tpu.runtime.faults import FaultPlan as JFaultPlan
from biscotti_tpu_torch.config import BiscottiConfig, Defense, FaultPlan
from biscotti_tpu_torch.ops.krum import default_num_adversaries, krum_scores
from biscotti_tpu_torch.ops.robust_agg import multikrum_m
from biscotti_tpu_torch.ops.roni import roni_scores
from biscotti_tpu_torch.parallel import sim as psim
from biscotti_tpu_torch.parallel.sim import Simulator
from biscotti_tpu_torch.weights import params_from_jax, params_to_jax

CPU = "cpu"
ROUNDS = 3

MNIST20 = dict(dataset="mnist", num_nodes=20, poison_fraction=0.3,
               noising=True, verification=True)
CASES = {
    "mnist20_krum_poison": dict(MNIST20, seed=0),
    "creditcard10_logreg": dict(dataset="creditcard", num_nodes=10,
                                noising=True, verification=True, seed=2),
    "mnist20_drop": dict(MNIST20, seed=1),
    "mnist20_multikrum": dict(MNIST20, seed=3, defense="MULTIKRUM"),
    "mnist20_foolsgold": dict(MNIST20, seed=4, defense="FOOLSGOLD"),
    "mnist20_roni": dict(MNIST20, seed=5, defense="RONI"),
    "mnist20_trimmed_mean": dict(MNIST20, seed=6, defense="TRIMMED_MEAN",
                                 secure_agg=False),
    "mnist20_none": dict(MNIST20, seed=7, defense="NONE"),
    "mnist20_ensemble": dict(MNIST20, seed=8, defense="ENSEMBLE"),
    "mnist20_mcmc13": dict(MNIST20, seed=11, dp_mechanism="mcmc13"),
    "mnist10_cnn": dict(dataset="mnist", model_name="mnist_cnn", num_nodes=10,
                        poison_fraction=0.3, noising=True, verification=True,
                        seed=10),
}
DROP = {"mnist20_drop": dict(drop=0.2, seed=5)}
TOL = {"mnist10_cnn": 1e-4}


def _pair(case):
    kw = dict(CASES[case])
    defense = kw.pop("defense", "KRUM")
    drop = DROP.get(case, {})
    jcfg = JConfig(defense=JDefense(defense), fault_plan=JFaultPlan(**drop), **kw)
    pcfg = BiscottiConfig(defense=Defense(defense), fault_plan=FaultPlan(**drop),
                          **kw)
    return JSimulator(jcfg), Simulator(pcfg, device=CPU)


def _jax_draws(jsim, it):
    """Round `it`'s draws exactly as the reference's jitted step makes them
    (biscotti_tpu/parallel/sim.py:240-266)."""
    cfg = jsim.cfg
    seed = jnp.asarray(cfg.seed, jnp.int32)
    rkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), seed), it)
    ckey, bkey, nkey = jax.random.split(rkey, 3)
    cidx = jsim._contributors(ckey)
    s = cidx.shape[0]
    bidx = jax.vmap(lambda i: jsample_batch(jax.random.fold_in(bkey, i),
                                            jsim.rows, cfg.batch_size))(cidx)
    if cfg.noising or cfg.dp_in_model:
        noise = jax.vmap(jsim._peer_noise)(
            jax.vmap(lambda i: jax.random.fold_in(nkey, i))(cidx))
    else:
        noise = jnp.zeros((s, jsim.num_params), jnp.float32)
    if cfg.fault_plan.enabled:
        dkey = jax.random.fold_in(jax.random.PRNGKey(cfg.fault_plan.seed), it)
        keep = jax.random.uniform(dkey, (s,)) >= cfg.fault_plan.drop
    else:
        keep = jnp.ones((s,), bool)
    return (torch.from_numpy(np.array(cidx, np.int64)),
            torch.from_numpy(np.array(bidx, np.int64)),
            torch.from_numpy(np.array(noise, np.float32)),
            torch.from_numpy(np.array(keep, bool)))


def _assert_decisions_clear(psim_, w, draws):
    """No accept decision sits on a float near-tie: the Krum and Multi-Krum
    boundaries are exact ties (both sides break them by index) or gaps far
    above the float noise, and no RONI score lies within one validation
    sample of the threshold, so a mask flip cannot hide behind rounding."""
    cidx, bidx, noise, _ = draws
    _, noised = psim_.local_updates(w, cidx, bidx, noise)
    s = cidx.shape[0]
    f = default_num_adversaries(s)
    keep = {Defense.KRUM: s - f,
            Defense.MULTIKRUM: multikrum_m(s, f)}.get(psim_.defense)
    if keep is not None and keep < s:
        scores = torch.sort(krum_scores(noised, f)).values
        lo, hi = float(scores[keep - 1]), float(scores[keep])
        gap = (hi - lo) / max(abs(hi), 1e-30)
        assert gap == 0.0 or gap > 1e-4, (
            f"near-tie at the Krum accept boundary: {lo} vs {hi}")
    if psim_.defense == Defense.RONI:
        scores = roni_scores(psim_.model, w, noised, psim_.x_val, psim_.y_val)
        n_val = psim_.x_val.shape[0]
        assert (scores - psim_.cfg.roni_threshold).abs().min() > 1.0 / n_val


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_matches_reference_on_reference_draws(case):
    jsim, sim = _pair(case)
    assert sim.rows == jsim.rows and sim.num_params == jsim.num_params
    assert np.array_equal(sim.x.numpy(), np.asarray(jsim.x))
    test_size = sim.x_val.shape[0]

    # the same non-zero weights on both sides, through the flat layout
    key = jax.random.PRNGKey(1)
    if jsim.model.name == "logreg":  # its init is all zeros
        params = 0.01 * jax.random.normal(key, (jsim.num_params,), jnp.float32)
    else:
        params = jsim.model.init(key)
    jw = jsim.model.flatten(params) if isinstance(params, dict) else params
    w = params_from_jax(params, device=CPU)
    assert np.array_equal(params_to_jax(w), np.asarray(jw))
    jstake = jnp.full((jsim.cfg.num_nodes,), jsim.cfg.default_stake, jnp.int32)
    stake = torch.from_numpy(np.array(jstake))

    dropped, accepted = 0, []
    tol = TOL.get(case, 1e-5)
    for it in range(ROUNDS):
        draws = _jax_draws(jsim, it)
        _assert_decisions_clear(sim, w, draws)
        jw, jstake, jmask, jerr = jsim.round_step(jnp.array(jw),
                                                  jnp.array(jstake), it)
        w, stake, mask, err = sim.round_step_from_draws(w, stake, *draws)
        assert np.array_equal(mask.numpy(), np.asarray(jmask)), f"round {it}"
        assert np.array_equal(stake.numpy(), np.asarray(jstake)), f"round {it}"
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=tol, atol=tol)
        assert abs(float(err) - float(jerr)) <= 1.0 / test_size + 1e-7
        dropped += int((~draws[3]).sum())
        accepted.append(int(mask.sum()))
    assert float(torch.linalg.vector_norm(w)) > 0
    s = sim.cfg.num_samples
    if sim.defense in (Defense.NONE, Defense.ENSEMBLE, Defense.TRIMMED_MEAN):
        assert accepted == [s] * ROUNDS  # accept-all, as sim.py:63-84
    if case in DROP:
        assert dropped > 0  # the fault plan really dropped frames


def test_draw_round_is_pure_and_well_formed():
    cfg = BiscottiConfig(dataset="mnist", num_nodes=20, poison_fraction=0.3,
                         fault_plan=FaultPlan(drop=0.5, seed=3))
    sim = Simulator(cfg, device=CPU)
    a = sim.draw_round(sim.gen, 4)
    sim.draw_round(sim.gen, 5)
    b = sim.draw_round(sim.gen, 4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    cidx, bidx, noise, keep = a
    s = cfg.num_samples
    assert cidx.shape == (s,) and len(set(cidx.tolist())) == s
    assert bidx.shape == (s, cfg.batch_size)
    assert all(len(set(r.tolist())) == cfg.batch_size for r in bidx)
    assert noise.shape == (s, sim.num_params) and keep.shape == (s,)
    assert 0 < int(keep.sum()) < s
    c = sim.draw_round(sim.gen, 6)
    assert not torch.equal(c[0], a[0]) or not torch.equal(c[1], a[1])


def test_run_and_metrics_on_cpu():
    cfg = BiscottiConfig(dataset="mnist", num_nodes=20, poison_fraction=0.3,
                         convergence_error=0.0)
    sim = Simulator(cfg, device=CPU)
    w, stake, logs = sim.run(3)
    assert [l.iteration for l in logs] == [0, 1, 2]
    s = cfg.num_samples
    assert all(l.accepted == s - default_num_adversaries(s) for l in logs)
    assert 0.0 <= sim.test_error(w) <= 1.0
    assert 0.0 <= sim.attack_rate(w) <= 1.0
    assert 0.0 <= sim.attack_success_rate(w) <= 1.0
    # each round moves S stakes by ±stake_unit: the total moves by
    # (accepted − rejected)·unit
    moved = int(stake.sum()) - cfg.num_nodes * cfg.default_stake
    per_round = (2 * (s - default_num_adversaries(s)) - s) * cfg.stake_unit
    assert moved == 3 * per_round


@pytest.mark.parametrize("defense", list(Defense))
def test_defense_mask_takes_every_defense(defense):
    # the reference's arguments, every member; TRIMMED_MEAN, NONE and
    # ENSEMBLE accept all (sim.py:63-84)
    sim = Simulator(BiscottiConfig(dataset="creditcard", num_nodes=10),
                    device=CPU)
    w, _ = sim.init_state()
    noised = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (9, sim.num_params)).astype(np.float32))
    mask = psim.defense_mask(defense, sim.model, w, noised, sim.x_val,
                             sim.y_val, 0.02, default_num_adversaries(9))
    assert mask.dtype == torch.bool and mask.shape == (9,)
    if defense in (Defense.NONE, Defense.ENSEMBLE, Defense.TRIMMED_MEAN):
        assert mask.all()


def test_trimmed_mean_config_and_drop_errors():
    with pytest.raises(ValueError, match="secure_agg"):
        BiscottiConfig(defense=Defense.TRIMMED_MEAN)  # secure_agg defaults on
    with pytest.raises(ValueError, match="trim_fraction"):
        BiscottiConfig(defense=Defense.TRIMMED_MEAN, secure_agg=False,
                       trim_fraction=0.5)
    BiscottiConfig(defense=Defense.KRUM, trim_fraction=0.9)  # unread: no check
    cfg = BiscottiConfig(dataset="creditcard", defense=Defense.TRIMMED_MEAN,
                         secure_agg=False, fault_plan=FaultPlan(drop=0.1))
    with pytest.raises(ValueError, match="TRIMMED_MEAN"):
        Simulator(cfg, device=CPU)
    with pytest.raises(ValueError, match="dp_mechanism"):
        Simulator(BiscottiConfig(dataset="creditcard", dp_mechanism="laplace"),
                  device=CPU)


def test_run_scan_equals_run_round_by_round():
    cfg = BiscottiConfig(dataset="mnist", num_nodes=20, poison_fraction=0.3,
                         convergence_error=0.0, seed=4)
    sim = Simulator(cfg, device=CPU)
    w, stake, logs = sim.run(4)
    sw, sstake, errs, accepted = sim.run_scan(4)
    assert isinstance(errs, np.ndarray) and isinstance(accepted, np.ndarray)
    assert errs.shape == accepted.shape == (4,)
    assert torch.equal(sw, w) and torch.equal(sstake, stake)
    assert errs.tolist() == [l.error for l in logs]
    assert accepted.tolist() == [l.accepted for l in logs]
    # a seed override changes the stream without a rebuild; the config's
    # own seed gives the default stream back
    ow, _, oerrs, _ = sim.run_scan(4, seed=99)
    assert not torch.equal(ow, w)
    again = sim.run_scan(4, seed=4)
    assert torch.equal(again[0], w) and np.array_equal(again[2], errs)
    assert sim.run_scan(0)[2].shape == (0,)


def test_run_feeds_the_metrics_families():
    from biscotti_tpu_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    cfg = BiscottiConfig(dataset="creditcard", num_nodes=10,
                         convergence_error=0.0)
    _, _, logs = Simulator(cfg, device=CPU, metrics=reg).run(3)
    page = reg.render()
    assert "biscotti_sim_round_seconds_count 3" in page
    assert "biscotti_sim_round_height 3" in page
    assert f"biscotti_sim_error {logs[-1].error}" in page
    snap = reg.snapshot()
    assert {"biscotti_sim_round_seconds", "biscotti_sim_round_height",
            "biscotti_sim_error"} <= set(snap)


def test_round_log_csv():
    log = psim.RoundLog(3, 0.25, 12.5, 7)
    assert log.csv() == "3,0.250000,12.500000"


def test_cli_main_on_cpu(capsys):
    import json

    rc = psim.main(["-d", "creditcard", "-t", "10", "--rounds", "2",
                    "--device", "cpu", "--fault-drop", "0.2",
                    "--convergence-error", "0"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["rounds_run"] == 2
    assert 0.0 <= out["test_error"] <= 1.0


def test_cli_scan_csv_and_metrics_out(capsys, tmp_path):
    import json

    csv = tmp_path / "rounds.csv"
    prom = tmp_path / "sim.prom"
    base = ["-d", "creditcard", "-t", "10", "--rounds", "3", "--device", "cpu",
            "--convergence-error", "0"]
    assert psim.main(base + ["--scan", "--csv", str(csv)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["rounds_run"] == 3
    rows = csv.read_text().strip().splitlines()
    assert [r.split(",")[0] for r in rows] == ["0", "1", "2"]
    assert float(rows[-1].split(",")[1]) == pytest.approx(out["final_error"],
                                                          abs=1e-6)
    assert psim.main(base + ["--metrics-out", str(prom), "--defense", "MULTIKRUM",
                             "--dp-mechanism", "mcmc13", "-sa", "0"]) == 0
    assert "biscotti_sim_round_height 3" in prom.read_text()
    with pytest.raises(SystemExit):
        psim.main(base + ["--scan", "--metrics-out", str(prom)])
    assert "--metrics-out requires a non-scan run" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        psim.main(base + ["--defense", "BOGUS"])
