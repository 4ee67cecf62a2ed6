"""The slice as a whole: the port's simulator round against the JAX
`Simulator`, on the reference's own draws.

The reference draws from `jax.random` under sim.py:240-253's keys; the test
takes those draws (contributors, minibatch rows, DP noise, dropped frames)
from the JAX `Simulator`'s own `_contributors`, `sample_batch` and
`_peer_noise`, and feeds them to the port's `round_step_from_draws`. Both
sides then run 3 rounds from the same non-zero weights.

Tolerances: masks and stakes exact; w within rtol 1e-5, atol 1e-5 (float32
sums in another order); the test error within one test sample
(1/test_size).
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
from biscotti_tpu_torch.parallel import sim as psim
from biscotti_tpu_torch.parallel.sim import Simulator
from biscotti_tpu_torch.weights import params_from_jax, params_to_jax

CPU = "cpu"
ROUNDS = 3

CASES = {
    "mnist20_krum_poison": dict(dataset="mnist", num_nodes=20,
                                poison_fraction=0.3, noising=True,
                                verification=True, seed=0),
    "creditcard10_logreg": dict(dataset="creditcard", num_nodes=10,
                                noising=True, verification=True, seed=2),
    "mnist20_drop": dict(dataset="mnist", num_nodes=20, poison_fraction=0.3,
                         noising=True, verification=True, seed=1),
}
DROP = {"mnist20_drop": dict(drop=0.2, seed=5)}


def _pair(case):
    kw = CASES[case]
    drop = DROP.get(case, {})
    jcfg = JConfig(defense=JDefense.KRUM, fault_plan=JFaultPlan(**drop), **kw)
    pcfg = BiscottiConfig(defense=Defense.KRUM, fault_plan=FaultPlan(**drop), **kw)
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


def _assert_boundary_gap(psim_, w, draws):
    """The Krum accept boundary is not a near-tie: either an exact tie
    (both sides break it by index) or a relative gap far above the float
    noise, so a mask flip cannot hide behind rounding."""
    cidx, bidx, noise, _ = draws
    _, noised = psim_.local_updates(w, cidx, bidx, noise)
    s = cidx.shape[0]
    keep = s - default_num_adversaries(s)
    scores = torch.sort(krum_scores(noised, default_num_adversaries(s))).values
    if keep < s:
        lo, hi = float(scores[keep - 1]), float(scores[keep])
        gap = (hi - lo) / max(abs(hi), 1e-30)
        assert gap == 0.0 or gap > 1e-4, (
            f"near-tie at the Krum accept boundary: {lo} vs {hi}")


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

    dropped = 0
    for it in range(ROUNDS):
        draws = _jax_draws(jsim, it)
        _assert_boundary_gap(sim, w, draws)
        jw, jstake, jmask, jerr = jsim.round_step(jnp.array(jw),
                                                  jnp.array(jstake), it)
        w, stake, mask, err = sim.round_step_from_draws(w, stake, *draws)
        assert np.array_equal(mask.numpy(), np.asarray(jmask)), f"round {it}"
        assert np.array_equal(stake.numpy(), np.asarray(jstake)), f"round {it}"
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
        assert abs(float(err) - float(jerr)) <= 1.0 / test_size + 1e-7
        dropped += int((~draws[3]).sum())
    assert float(torch.linalg.vector_norm(w)) > 0
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


def test_defenses_not_ported_raise():
    for d in (Defense.RONI, Defense.MULTIKRUM, Defense.FOOLSGOLD,
              Defense.TRIMMED_MEAN, Defense.ENSEMBLE):
        with pytest.raises(NotImplementedError, match="not ported"):
            Simulator(BiscottiConfig(dataset="creditcard", defense=d), device=CPU)
    with pytest.raises(NotImplementedError, match="mcmc13"):
        Simulator(BiscottiConfig(dataset="creditcard", dp_mechanism="mcmc13"),
                  device=CPU)
    x = torch.ones(3, 4)
    assert psim.defense_mask(Defense.NONE, x, 1).all()


def test_cli_main_on_cpu(capsys):
    import json

    rc = psim.main(["-d", "creditcard", "-t", "10", "--rounds", "2",
                    "--device", "cpu", "--fault-drop", "0.2",
                    "--convergence-error", "0"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["rounds_run"] == 2
    assert 0.0 <= out["test_error"] <= 1.0
