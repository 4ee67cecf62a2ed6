"""The port's sharded round step (`biscotti_tpu_torch/parallel/sim.py::
make_sharded_round_step`) on gloo meshes of 1 (in this process), 2 and 4
CPU ranks, against the reference's `make_sharded_round_step` on the
suite's 8-device virtual CPU mesh.

The reference draws each peer's minibatch rows and noise from
`fold_in(bkey, gid)` and `fold_in(nkey, gid)` (sim.py:409-426) and the
fault plane's drops from `fold_in(PRNGKey(fault seed), it)`; the test takes
those draws and feeds them to the port's pure
`sharded_step_from_draws`, each rank its own peers' rows, for 3 rounds,
each round from the reference's weights after the round before (the
first from the same non-zero weights), so every world size steps from the
same w. Tolerances: accept masks exact; w and the test error at rtol 1e-5
against the reference (float32 sums in another order); across world sizes
the masks and the gathered [N, d] pool bit for bit and w at rtol 1e-6 of
its largest entry (the psum adds the ranks' partial sums in another order,
and an entry that cancels keeps the rounding of its larger terms).

JAX is imported inside the reference-side helpers only: the spawned ranks
import this module and stay JAX-free."""

import numpy as np
import pytest
import torch

from biscotti_tpu_torch.config import BiscottiConfig, Defense, FaultPlan
from biscotti_tpu_torch.parallel import mesh as pm
from biscotti_tpu_torch.parallel import sim as psim

ROUNDS = 3
RTOL = 1e-5
TIMEOUT_S = 120.0

# (dataset, N, defense, fault-plan drop): every Defense, a drop rate and
# TRIMMED_MEAN's dp_in_model branch, each dataset at both N. One case a
# branch: the reference compiles its sharded step for each (~5 s here).
CASES = {
    "creditcard8_krum": ("creditcard", 8, "KRUM", 0.0),
    "mnist16_krum_drop": ("mnist", 16, "KRUM", 0.3),
    "creditcard16_multikrum": ("creditcard", 16, "MULTIKRUM", 0.0),
    "mnist8_foolsgold": ("mnist", 8, "FOOLSGOLD", 0.0),
    "mnist8_roni": ("mnist", 8, "RONI", 0.0),
    "creditcard16_trimmed_mean": ("creditcard", 16, "TRIMMED_MEAN", 0.0),
    "mnist16_trimmed_mean_dp_in_model": ("mnist", 16, "TRIMMED_MEAN", 0.0),
    "mnist16_none": ("mnist", 16, "NONE", 0.0),
    "creditcard8_ensemble": ("creditcard", 8, "ENSEMBLE", 0.0),
}
WORLDS = (1, 2, 4)


def _kw(case):
    dataset, n, defense, drop = CASES[case]
    kw = dict(dataset=dataset, num_nodes=n, batch_size=10, epsilon=1.0,
              noising=True, verification=True, sample_percent=1.0,
              poison_fraction=0.3, secure_agg=False, num_verifiers=0,
              num_miners=0, seed=sorted(CASES).index(case))
    if case.endswith("dp_in_model"):
        kw["dp_in_model"] = True
    return kw, defense, dict(drop=drop, seed=5) if drop else {}


def _port_sim(case, peers=None):
    kw, defense, drop = _kw(case)
    return psim.Simulator(BiscottiConfig(defense=Defense(defense),
                                         fault_plan=FaultPlan(**drop), **kw),
                          device="cpu", peers=peers)


def _rank_sim(mesh, case):
    """`case`'s Simulator holding this rank's peers only."""
    return _port_sim(case, peers=pm.local_slice(mesh, CASES[case][1]))


# ----------------------------------------------------------- the reference


def _reference(case):
    """The reference's rounds and its own per-gid draws: (the weights each
    round starts from, draws a round as (batch_idx[N, B], noise[N, d],
    keep[N]), (w, mask, err) a round), numpy."""
    import jax
    import jax.numpy as jnp

    from biscotti_tpu.config import BiscottiConfig as JConfig
    from biscotti_tpu.config import Defense as JDefense
    from biscotti_tpu.models.trainer import sample_batch as jsample_batch
    from biscotti_tpu.parallel.sim import Simulator as JSimulator
    from biscotti_tpu.parallel.sim import make_sharded_round_step as jstep
    from biscotti_tpu.runtime.faults import FaultPlan as JFaultPlan

    kw, defense, drop = _kw(case)
    jsim = JSimulator(JConfig(defense=JDefense(defense),
                              fault_plan=JFaultPlan(**drop), **kw))
    cfg, n = jsim.cfg, jsim.cfg.num_nodes
    step = jstep(jsim, jax.sharding.Mesh(np.array(jax.devices()[:8]),
                                         ("peers",)))
    w0 = (0.01 * np.random.default_rng(1).normal(size=jsim.num_params)
          ).astype(np.float32)
    w, draws, out = jnp.asarray(w0), [], []
    for it in range(ROUNDS):
        rkey = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(0), jnp.asarray(cfg.seed, jnp.int32)), it)
        bkey, nkey = jax.random.split(rkey)
        bidx = np.stack([np.asarray(jsample_batch(
            jax.random.fold_in(bkey, g), jsim.rows, cfg.batch_size))
            for g in range(n)]).astype(np.int64)
        noise = np.stack([np.asarray(jsim._peer_noise(
            jax.random.fold_in(nkey, g))) for g in range(n)]).astype(np.float32)
        keep = np.ones(n, bool)
        if drop:
            keep = np.asarray(jax.random.uniform(jax.random.fold_in(
                jax.random.PRNGKey(cfg.fault_plan.seed), it), (n,))
                >= cfg.fault_plan.drop)
        draws.append((bidx, noise, keep))
        w, mask, err = step(w, it)
        out.append((np.array(w), np.array(mask), float(err)))
    return [w0] + [w for w, _, _ in out[:-1]], draws, out


# ------------------------------------------------------------ the port ranks


def _port_rounds(mesh, case, ws, draws):
    """This rank's rounds of `case` from the weights `ws` on the
    reference's draws: (w, mask, err, the gathered pool) a round, numpy."""
    sim = _rank_sim(mesh, case)
    mine = pm.local_slice(mesh, sim.cfg.num_nodes)
    pools, out = [], []
    real = psim.defense_mask

    def spy(defense, model, w, noised, *rest):
        pools.append(noised.numpy().copy())
        return real(defense, model, w, noised, *rest)

    psim.defense_mask = spy
    try:
        for w, (bidx, noise, keep) in zip(ws, draws):
            w, mask, err = psim.sharded_step_from_draws(
                sim, mesh, sim.x, sim.y, torch.from_numpy(w),
                torch.from_numpy(bidx[mine]), torch.from_numpy(noise[mine]),
                torch.from_numpy(keep.copy()))
            out.append((w.numpy().copy(), mask.numpy().copy(), float(err),
                        pools[-1]))
    finally:
        psim.defense_mask = real
    return out


def _seed_override(mesh):
    """make_sharded_round_step's seed argument, as the reference's
    test_sharded_seed_override_takes_effect checks it."""
    sim = _rank_sim(mesh, "creditcard8_krum")
    step = psim.make_sharded_round_step(sim, mesh)
    w = torch.zeros(sim.num_params)
    a, a2, b = (step(w, 0, seed=s)[0] for s in (1, 1, 2))
    d, c = step(w, 0)[0], step(w, 0, seed=sim.cfg.seed)[0]
    return (torch.equal(a, a2), not torch.allclose(a, b), torch.equal(d, c),
            sim.cfg.seed)


def _world(mesh, inputs):
    """One world's runs of every case, with the seed override and the
    divisibility rule."""
    runs = {case: _port_rounds(mesh, case, ws, draws)
            for case, (ws, draws) in inputs.items()}
    try:
        psim.make_sharded_round_step(
            psim.Simulator(BiscottiConfig(dataset="creditcard",
                                          num_nodes=2 * mesh.size() + 1),
                           device="cpu"), mesh)
        odd = "no error"
    except ValueError as e:
        odd = str(e)
    return runs, _seed_override(mesh), odd


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ref = {case: _reference(case) for case in sorted(CASES)}
    inputs = {case: (ws, draws) for case, (ws, draws, _) in ref.items()}
    init = "file://" + str(tmp_path_factory.mktemp("mesh1") / "rendezvous")
    # one intra-op thread, as every spawned rank runs: a multi-threaded CPU
    # matmul splits its sums by the batch's size
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pm.open_mesh("peers", "cpu", rank=0, world_size=1,
                          init_method=init, timeout_s=TIMEOUT_S) as mesh:
            worlds = {1: [_world(mesh, inputs)]}
    finally:
        torch.set_num_threads(threads)
    assert not torch.distributed.is_initialized()
    for k in WORLDS[1:]:
        worlds[k] = pm.spawn(_world, k, "cpu", args=(inputs,),
                             timeout_s=TIMEOUT_S)
    return ref, worlds


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_reference_on_its_draws(results, case):
    ref, worlds = results
    _, _, want = ref[case]
    sim_n = CASES[case][1]
    for k in WORLDS:
        got = worlds[k][0][0][case]
        for it, ((w, mask, err, pool), (jw, jmask, jerr)) in enumerate(
                zip(got, want)):
            assert np.array_equal(mask, jmask), f"world {k} round {it}"
            np.testing.assert_allclose(w, jw, rtol=RTOL, atol=RTOL)
            assert err == pytest.approx(jerr, rel=RTOL, abs=1e-7)
            assert pool.shape == (sim_n, w.shape[0])
    defense = CASES[case][2]
    if defense in ("NONE", "ENSEMBLE", "TRIMMED_MEAN"):
        assert all(m.all() for _, m, _ in want)
    if defense == "KRUM" and not CASES[case][3]:
        assert all(m.sum() == sim_n - sim_n // 2 for _, m, _ in want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_does_not_depend_on_the_world_size(results, case):
    _, worlds = results
    one = worlds[1][0][0][case]
    for k in WORLDS[1:]:
        for rank in range(k):
            for (w, mask, err, pool), (w1, mask1, err1, pool1) in zip(
                    worlds[k][rank][0][case], one):
                assert np.array_equal(mask, mask1)
                assert np.array_equal(pool, pool1)
                np.testing.assert_allclose(w, w1, rtol=1e-6,
                                           atol=1e-6 * np.abs(w1).max())
                assert err == pytest.approx(err1, rel=1e-6)


@pytest.mark.parametrize("world", WORLDS[1:])
def test_every_rank_holds_the_same_masks_and_weights(results, world):
    _, worlds = results
    ranks = [r[0] for r in worlds[world]]
    for case in CASES:
        for rank in ranks[1:]:
            for (w, mask, err, _), (w0, mask0, err0, _) in zip(rank[case],
                                                               ranks[0][case]):
                assert np.array_equal(mask, mask0)
                assert np.array_equal(w, w0) and err == err0


@pytest.mark.parametrize("world", WORLDS)
def test_seed_override_takes_effect(results, world):
    _, worlds = results
    for _, (same, differs, default, seed) in [r[:2] for r in worlds[world]]:
        assert same and differs and default
        assert seed == sorted(CASES).index("creditcard8_krum")


@pytest.mark.parametrize("world", WORLDS[1:])
def test_peers_must_divide_over_the_mesh(results, world):
    _, worlds = results
    for _, _, odd in worlds[world]:
        assert f"length {2 * world + 1} does not divide over a {world}-rank" \
            in odd


def test_sharded_draws_do_not_depend_on_the_rank_split():
    sim = _port_sim("mnist16_krum_drop")
    whole = psim.sharded_draws(sim, 2, 7, range(16))
    halves = [psim.sharded_draws(sim, 2, 7, range(lo, lo + 8))
              for lo in (0, 8)]
    assert torch.equal(whole[0], torch.cat([h[0] for h in halves]))
    assert torch.equal(whole[1], torch.cat([h[1] for h in halves]))
    assert all(torch.equal(whole[2], h[2]) for h in halves)
    assert 0 < int(whole[2].sum()) < 16  # the fault plane dropped frames
    assert not torch.equal(whole[1], psim.sharded_draws(sim, 3, 7, range(16))[1])


def test_sharded_step_equals_the_single_device_round_on_the_same_draws(tmp_path):
    sim = _port_sim("creditcard16_multikrum")
    n = sim.cfg.num_nodes
    w = 0.01 * torch.randn(sim.num_params, generator=torch.Generator().manual_seed(3))
    stake = sim.init_state()[1]
    draws = psim.sharded_draws(sim, 0, sim.cfg.seed, range(n))
    with pm.open_mesh("peers", "cpu", rank=0, world_size=1,
                      init_method=f"file://{tmp_path}/rendezvous") as mesh:
        got = psim.sharded_step_from_draws(sim, mesh, sim.x, sim.y, w, *draws)
        run = psim.make_sharded_round_step(sim, mesh)(w, 0)
    want = sim.round_step_from_draws(w, stake, torch.arange(n), *draws)
    assert torch.equal(got[1], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-7)
    assert float(got[2]) == float(want[3])
    assert all(torch.equal(a, b) for a, b in zip(got, run))


# ------------------------------------------- a rank holds only its own peers


def test_a_slice_simulator_holds_the_full_ones_rows_bit_for_bit():
    full = _port_sim("mnist16_krum_drop")
    for peers in (slice(0, 4), slice(4, 8), slice(12, None), slice(8, 16)):
        part = _port_sim("mnist16_krum_drop", peers=peers)
        lo, hi = peers.start, peers.stop or 16
        assert torch.equal(part.x, full.x[lo:hi])
        assert torch.equal(part.y, full.y[lo:hi])
        assert part.rows == full.rows
        assert part.x.shape[0] == len(part.peers) == hi - lo
    whole = _port_sim("mnist16_krum_drop", peers=slice(0, 16))
    assert torch.equal(whole.x, full.x) and whole.peers == full.peers
    for bad in (slice(4, 4), slice(0, 17), slice(0, 16, 2), range(0, 4)):
        with pytest.raises(ValueError, match="peers"):
            _port_sim("mnist16_krum_drop", peers=bad)


def test_a_slice_simulator_refuses_the_single_device_round():
    sim = _port_sim("creditcard8_krum", peers=slice(4, 8))
    w, stake = sim.init_state()
    draws = psim.sharded_draws(sim, 0, sim.cfg.seed, range(8))
    calls = {
        "draw_round": lambda: sim.draw_round(sim.gen, 0),
        "local_updates": lambda: sim.local_updates(
            w, torch.arange(8), draws[0], draws[1]),
        "round_step_from_draws": lambda: sim.round_step_from_draws(
            w, stake, torch.arange(8), draws[0], draws[1], draws[2]),
        "round_step": lambda: sim.round_step(w, stake, 0),
        "run": lambda: sim.run(1),
        "run_scan": lambda: sim.run_scan(1)}
    for name, call in calls.items():
        with pytest.raises(ValueError, match=rf"^{name} needs every peer's "
                                             r"shard.*peers 4\.\.7 of 8"):
            call()


def test_the_sharded_step_refuses_a_slice_that_is_not_the_ranks(tmp_path):
    with pm.open_mesh("peers", "cpu", rank=0, world_size=1,
                      init_method=f"file://{tmp_path}/rendezvous") as mesh:
        for peers in (slice(0, 4), slice(4, 8)):
            with pytest.raises(ValueError, match="this rank's slice is 0..7"):
                psim.make_sharded_round_step(
                    _port_sim("creditcard8_krum", peers=peers), mesh)


def _held(mesh):
    """What this rank's Simulator holds, and its sharded step's first
    round, for the world-size test below."""
    sim = _rank_sim(mesh, "mnist16_krum_drop")
    w, mask, _ = psim.make_sharded_round_step(sim, mesh)(
        sim.init_state()[0], 0)
    return (mesh.size(), sim.x.shape[0], sim.y.shape[0],
            (sim.peers.start, sim.peers.stop), w.numpy(), mask.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_n_over_k_peers(world, tmp_path):
    n = CASES["mnist16_krum_drop"][1]
    if world == 1:
        with pm.open_mesh("peers", "cpu", rank=0, world_size=1,
                          init_method=f"file://{tmp_path}/rendezvous") as mesh:
            got = [_held(mesh)]
    else:
        got = pm.spawn(_held, world, "cpu", timeout_s=TIMEOUT_S)
    assert len(got) == world
    for rank, (k, x_rows, y_rows, peers, w, mask) in enumerate(got):
        assert k == world and x_rows == y_rows == n // world
        assert peers == (rank * n // world, (rank + 1) * n // world)
        assert np.array_equal(mask, got[0][5]) and np.array_equal(w, got[0][4])


def test_a_cuda_mesh_needs_a_gpu_a_rank(monkeypatch):
    """No quiet fallback: a cuda mesh with more ranks than GPUs, or with no
    GPU, raises before any rank starts; only an explicit gloo backend
    shares one GPU between ranks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pm.rank_device("cuda", 0, 1) == torch.device("cuda", 0)
    assert pm.rank_device(None, 0, 1) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="needs a GPU a rank; this host has 1"):
        pm.rank_device("cuda", 1, 2)
    with pytest.raises(RuntimeError, match="needs a GPU a rank"):
        pm.spawn(_world, 2, "cuda")
    assert pm.rank_device("cuda", 1, 2, backend="gloo") == torch.device("cuda", 0)
    assert pm.rank_device("cpu", 3, 4) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.spawn(_world, 1)
