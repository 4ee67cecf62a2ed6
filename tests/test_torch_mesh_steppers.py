"""The batched steppers' mesh branches on a 2-rank gloo mesh on the CPU
(`biscotti_tpu_torch/runtime/device_cluster.py::BatchStepper`,
`runtime/hive.py::HiveStepper`, `parallel/mesh.py::Controller`), and the
port's multi-device dry run (`biscotti_tpu_torch/multichip.py`).

  * `BatchStepper` on the mesh: round `it`'s gathered [N, d] batch equals
    the one-device stepper's (rtol 1e-6, both on one intra-op thread);
    a cluster of 8 mnist peers over the mesh, 3 iterations, KRUM: chains
    equal, every block non-empty, one mesh batch a round;
  * `HiveStepper` on the mesh: H = 4 sharded over the 2 ranks, H = 3 on
    the single-client path; every peer's delta is its standalone port
    Trainer's (rtol 1e-5, atol 1e-6, as tests/test_torch_hive.py);
  * `Hive` built on every rank: rank 0 runs the agents, the follower
    serves their batches and returns [];
  * the controller's keep-alive: a follower outlasts a batch gap longer
    than the controller group's timeout; dispatch and close refuse to
    run off rank 0, serve on it;
  * rank 0 raising mid-run releases the follower at once;
  * `dryrun_multichip(2, device="cpu")`, its block check on chains that
    agree with the trained rounds and chains that cannot, and
    `mesh_rounds`' sharded rounds at 1 and 2 ranks held to each other.

Ports are 17800-17899, which no other test file uses."""

import asyncio
import time

import numpy as np
import pytest
import torch

from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts
from biscotti_tpu_torch.data import datasets as ds
from biscotti_tpu_torch.models.trainer import Trainer
from biscotti_tpu_torch.parallel import mesh as pm
from biscotti_tpu_torch.runtime.device_cluster import BatchStepper, run_cluster
from biscotti_tpu_torch.runtime.hive import Hive, HiveStepper

TIMEOUT_S = 120.0
KEEPALIVE_TIMEOUT_S, KEEPALIVE_GAP_S = 3.0, 7.0
ITS = (0, 2)
FAST = Timeouts(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
                rpc_s=20.0)


def _cfg(n, port, **extra):
    kw = dict(num_nodes=n, dataset="mnist", base_port=port, num_verifiers=1,
              num_miners=1, num_noisers=1, secure_agg=False, noising=False,
              verification=True, defense=Defense.KRUM, convergence_error=0.0,
              sample_percent=1.0, batch_size=8, seed=3, timeouts=FAST)
    kw.update(extra)
    return BiscottiConfig(**kw)


def _w(d):
    return np.random.default_rng(1).normal(0.0, 0.05, d)


async def _hive_steps(stepper, w, it):
    return await asyncio.gather(*(stepper.step(pid, w, it)
                                  for pid in stepper.local_ids))


def _refused(*calls):
    """The message of each call's RuntimeError (None where it ran)."""
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except RuntimeError as e:
            out.append(str(e))
    return out


def _world(mesh):
    """Rank 0 drives, rank 1 follows: the controller across a gap longer
    than its group's timeout, the BatchStepper's batches, a mesh cluster,
    the HiveStepper at H = 4 and H = 3, then a Hive on both ranks."""
    lead = mesh.get_local_rank() == 0
    out = {}
    ctl = pm.Controller(mesh, 3, lambda it, w: (w + it)[None],
                        timeout_s=KEEPALIVE_TIMEOUT_S)
    if lead:
        got = [ctl.dispatch(0, torch.zeros(3))]
        time.sleep(KEEPALIVE_GAP_S)
        got.append(ctl.dispatch(1, torch.ones(3)))
        refused = _refused(ctl.serve)
        ctl.close()
        out["keepalive"] = ([g.numpy() for g in got], refused)
    else:
        refused = _refused(lambda: ctl.dispatch(0, torch.zeros(3)), ctl.close)
        out["keepalive"] = (ctl.serve(), refused)
    stepper = BatchStepper(_cfg(8, 17800), mesh, device="cpu")
    w = _w(stepper.num_params)
    if lead:
        out["batches"] = [stepper.deltas(it, w).numpy() for it in ITS]
        stepper.close()
    else:
        out["served"] = stepper.serve()
    out["gids"] = list(stepper.gids)

    cs, _, results = asyncio.run(run_cluster(_cfg(8, 17800), mesh, 3))
    out["cluster"] = ([r["chain_dump"] for r in results], cs.batches,
                      str(cs.device))

    for h in (4, 3):
        hs = HiveStepper(_cfg(h, 17810, noising=True, epsilon=1.0),
                         range(h), mesh)
        if lead:
            out[h] = (hs.sharded, hs.mine,
                      asyncio.run(_hive_steps(hs, w, 4)), hs.batches)
            hs.close()
        else:
            out[h] = (hs.sharded, hs.mine, hs.serve())

    hive = Hive(_cfg(4, 17830, max_iterations=2), range(4), mesh, device="cpu")
    results = asyncio.run(hive.run())
    out["hive"] = ([r["chain_dump"] for r in results], len(hive.agents),
                   hive.stepper.mine, hive.stepper.batches)
    return out


@pytest.fixture(scope="module")
def world():
    return pm.spawn(_world, 2, "cpu", timeout_s=TIMEOUT_S)


def test_batch_stepper_mesh_gathers_the_one_device_batch(world):
    lead, follower = world
    one = BatchStepper(_cfg(8, 17800), device="cpu")
    w = _w(one.num_params)
    assert (lead["gids"], follower["gids"]) == ([0, 1, 2, 3], [4, 5, 6, 7])
    assert follower["served"] == len(ITS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: a threaded matmul splits its sums
    try:
        want = [one.deltas(it, w).numpy() for it in ITS]
    finally:
        torch.set_num_threads(threads)
    for got, ref in zip(lead["batches"], want):
        assert got.shape == (8, one.num_params)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert not np.allclose(lead["batches"][0], lead["batches"][1])


def test_batch_stepper_mesh_cluster_mints_equal_chains(world):
    lead, follower = world
    dumps, batches, device = lead["cluster"]
    assert len(dumps) == 8 and all(d == dumps[0] for d in dumps), dumps[0]
    lines = dumps[0].splitlines()
    assert len(lines) == 4 and not any("ndeltas=0" in l for l in lines[1:]), \
        dumps[0]
    assert batches == 3 and device == "cpu"
    assert follower["cluster"] == ([], 0, "cpu")


def test_hive_stepper_mesh_deltas_are_the_trainers(world):
    lead, follower = world
    assert lead[4][:2] == (True, [0, 1]) and follower[4] == (True, [2, 3], 1)
    assert lead[3][:2] == (False, [0, 1, 2]) and follower[3] == (False, [0, 1, 2], 0)
    for h in (4, 3):
        cfg = _cfg(h, 17810, noising=True, epsilon=1.0)
        deltas, batches = lead[h][2], lead[h][3]
        assert batches == 1
        for pid in range(h):
            t = Trainer(cfg.dataset, ds.shard_name(cfg.dataset, pid, False),
                        cfg=cfg, seed=pid, device="cpu")
            np.testing.assert_allclose(deltas[pid], t.private_fun(
                _w(t.model.num_params), 4), rtol=1e-5, atol=1e-6)


def test_controller_keeps_a_follower_past_its_group_timeout(world):
    lead, follower = world
    got, lead_refused = lead["keepalive"]
    served, follower_refused = follower["keepalive"]
    np.testing.assert_array_equal(got[0], np.zeros((2, 3)))
    np.testing.assert_array_equal(got[1], np.full((2, 3), 2.0))
    assert served == 2
    assert lead_refused == ["rank 0 dispatches; serve() is the followers'"]
    assert all("runs on the mesh's rank 0; rank 1 serves" in m
               for m in follower_refused) and len(follower_refused) == 2


def test_hive_on_every_rank_hosts_its_agents_on_rank_0(world):
    lead, follower = world
    dumps, agents, mine, batches = lead["hive"]
    assert agents == 4 and mine == [0, 1] and batches == 2
    assert all(d == dumps[0] for d in dumps), dumps[0]
    lines = dumps[0].splitlines()
    assert len(lines) == 3 and not any("ndeltas=0" in l for l in lines[1:]), \
        dumps[0]
    assert follower["hive"] == ([], 0, [2, 3], 0)


def _raising_world(mesh):
    """Rank 0's agents raise once the first batch is served; the follower
    reports how many batches it served and how long it waited."""
    from biscotti_tpu_torch.runtime import peer

    async def run(self):
        await self.stepper.step(self.id, np.zeros(self.stepper.num_params), 0)
        raise RuntimeError("agent failed mid-run")

    t0 = time.monotonic()
    if mesh.get_local_rank() == 0:
        peer.PeerAgent.run = run
        try:
            asyncio.run(run_cluster(_cfg(4, 17820), mesh, 3))
        except RuntimeError as e:
            return str(e)
        return "no error"
    stepper, agents, results = asyncio.run(run_cluster(_cfg(4, 17820), mesh, 3))
    return stepper.batches, agents, time.monotonic() - t0


def test_rank0_failing_releases_the_followers():
    lead, follower = pm.spawn(_raising_world, 2, "cpu", timeout_s=60.0)
    assert lead == "agent failed mid-run"
    batches, agents, waited = follower
    assert batches == 0 and agents == [] and waited < 30.0


def test_dryrun_multichip_on_two_cpu_ranks():
    from biscotti_tpu_torch.multichip import dryrun_multichip

    line = dryrun_multichip(2, device="cpu", base_port=17840)
    assert line.startswith("dryrun_multichip(2): ok — mask 2/4")
    assert "sharded secure-agg ok at d=7850/164266" in line
    assert "8 peers, 2v/2m committee" in line


def _dump(ndeltas):
    return "\n".join(["iter=-1 ndeltas=0 hash=0 prev=0 |w|=0"] + [
        f"iter={it} ndeltas={n} hash={it} prev=0 |w|=1"
        for it, n in enumerate(ndeltas)])


# a one-rank dry run on the CPU: round 4 trained two workers, the
# verifiers refused one, and its decline closed the leader's intake first
_TRAINED = {0: 2, 1: 1, 2: 1, 3: 1, 4: 2, 5: 1, 6: 1, 7: 2}


@pytest.mark.parametrize("ndeltas, trained, refused, minted", [
    ([1, 1, 1, 1, 0, 1, 1, 1], _TRAINED, 3, 7),
    ([1, 1, 1, 1, 1, 1, 1, 1], _TRAINED, 3, 8),
    ([1, 0, 1, 1, 0, 1, 0, 0], {0: 1, 2: 1, 3: 1, 5: 2}, 1, 4),
    ([1, 1, 1, 1, 0, 1, 1, 1], _TRAINED, 0, None),  # no refusal
    ([1, 0, 1, 1, 1, 1, 1, 1], _TRAINED, 3, None),  # one worker, empty
    ([1, 1, 1, 1, 1, 1, 1, 1], {i: 1 for i in range(7)}, 0, None),
    ([0] * 8, {}, 0, None),  # nothing minted
], ids=["refused-first", "all-real", "untrained-empty", "no-refusal",
        "lone-worker-empty", "untrained-real", "none"])
def test_cluster_blocks_agree_with_the_trained_rounds(ndeltas, trained,
                                                      refused, minted):
    from biscotti_tpu_torch.multichip import check_cluster_blocks

    if minted is None:
        with pytest.raises(AssertionError, match="device cluster"):
            check_cluster_blocks(_dump(ndeltas), trained, refused)
    else:
        assert check_cluster_blocks(_dump(ndeltas), trained,
                                    refused) == minted


def test_mesh_rounds_agree_across_mesh_sizes():
    from biscotti_tpu_torch.multichip import mesh_rounds

    rows = mesh_rounds((1, 2), n=8, rounds=2, device="cpu")
    assert [r["ranks"] for r in rows] == [1, 2]
    assert all(r["masks_equal_first"] and r["w_close_first"]
               and r["err_close_first"] for r in rows)
    assert rows[1]["devices"] == ["cpu", "cpu"]
    assert rows[1]["accepted"] == [4, 4]  # N − N // 2, as KRUM keeps
    assert all(len(ms) == 2 for ms in rows[1]["round_ms"])
