"""Twins of `tests/test_runtime.py`'s live clusters on the port's peer:
FedSys mode, a plain-mode cluster with two miners, the verifiers'
privacy invariant (only the noised copy reaches them), a late joiner
that adopts the running chain, a cifar_cnn cluster through the full
secure-aggregation protocol, and the trimmed-mean miner aggregation.

Each scenario runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords and makes the reference test's own assertions on the
port's run. The CNN cluster's blocks carry quantized sums, so its chain
must be the reference's bit for bit. The plain-mode runs (FedSys, the
two miners, the trimmed mean) are held to round 0's block, the rejected
ids and the stake rule (ROADMAP C10); the late join lands at a moment
no run repeats, so that run is held to the rejected ids and the stake
rule, and so are the two miners' and the trimmed mean's where their
verifier pooled other updates in round 0 than the reference's (a round
with more workers than samples pools the first to arrive, ROADMAP C8).

Ports are 21300-21599, which no other test file uses."""

import asyncio

import jax.numpy as jnp
import numpy as np
import torch

from biscotti_tpu.ops.robust_agg import \
    trimmed_mean_aggregate as ref_trimmed_mean
from biscotti_tpu_torch.ops.robust_agg import trimmed_mean_aggregate
from torch_twins import (agent, assert_first_block_parity,
                         assert_same_dumps, cfg, dumps, round_pools,
                         run_cluster, twin, wait_height)

# the reference file's windows (test_runtime.py:17), which the late joiner
# rides; the other clusters take windows no honest peer misses under a
# loaded test run (an honest round mints as soon as its workers are
# accounted for, so they cost nothing)
FAST = dict(update_s=4.0, block_s=20.0, krum_s=4.0, share_s=4.0, rpc_s=6.0)
WINDOWS = dict(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
               rpc_s=20.0)


def _cfg(pkg, i, n, port, t=WINDOWS, **kw):
    return cfg(pkg, i, n, port, t, **kw)


def _chains_equal(results, lines):
    out = [r["chain_dump"] for r in results]
    assert all(d == out[0] for d in out)
    assert len(out[0].splitlines()) == lines
    return out[0].splitlines()


# ------------------------------------------------------ fedsys, two miners


def _fedsys(pkg, port, draws):
    n = 4
    results, agents = run_cluster(
        pkg, [_cfg(pkg, i, n, port, fedsys=True) for i in range(n)],
        draws=draws)
    _chains_equal(results, 3)
    return results, agents


def test_cluster_fedsys_mode():
    got = twin(_fedsys, 21300)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0])


def _two_miners(pkg, port, draws):
    n = 6
    results, agents = run_cluster(
        pkg, [_cfg(pkg, i, n, port, num_miners=2, num_verifiers=1,
                   verification=True, defense="KRUM") for i in range(n)],
        draws=draws)
    lines = _chains_equal(results, 3)
    assert "ndeltas=0" not in lines[1], lines
    return results, agents


def test_cluster_plain_mode_multiple_miners():
    got = twin(_two_miners, 21340)
    ref, port = got["reference"], got["port"]
    # the genesis committee seats node 0 as verifier and miner, so four
    # workers race for three samples and the verifier pools the first
    # three to arrive (ROADMAP C8): round 0's block is held to the
    # reference's where both verifiers pooled the same updates
    assert_first_block_parity(
        ref[1][0], port[1][0],
        first_block=round_pools(ref[0]) == round_pools(port[0]))


# ------------------------------------------- the verifiers' privacy rule


def _verifier_bound(monkeypatch, pkg, port, draws):
    """Every update the workers pack, seen through the package's own
    `wire.pack_update` as the peer module calls it."""
    seen = []
    orig = pkg.wire.pack_update

    def spy(u, prefix="u"):
        seen.append(u)
        return orig(u, prefix)

    monkeypatch.setattr(pkg.peer.wire, "pack_update", spy)
    n = 4
    results, agents = run_cluster(
        pkg, [_cfg(pkg, i, n, port, noising=True, verification=True,
                   defense="KRUM", num_verifiers=1, max_iterations=1)
              for i in range(n)], draws=draws)
    bound = [u for u in seen if u.noised_delta is not None
             and u.delta.size == 0]
    assert bound, "no redacted verifier-bound updates observed"
    for u in bound:
        assert u.delta.size == 0 and u.noised_delta is not None
    return results, agents, {u.source_id: np.asarray(u.noised_delta)
                             for u in bound}


def test_verifier_bound_updates_carry_no_raw_delta(monkeypatch):
    got = twin(lambda pkg, p, d: _verifier_bound(monkeypatch, pkg, p, d),
               21380)
    ref, port = got["reference"][2], got["port"][2]
    # round 0's workers are fixed by the genesis committee draw: the same
    # workers redact, and their noised copies are the reference's within
    # the step's tolerance (the port trains on the reference's rows and
    # noise)
    assert sorted(port) == sorted(ref)
    for sid in ref:
        np.testing.assert_allclose(port[sid], ref[sid], rtol=1e-5,
                                   atol=1e-6)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0])


# ------------------------------------------------------------ late joiner


def _late_joiner(pkg, port, draws):
    n = 3

    async def go():
        early = [agent(pkg, _cfg(pkg, i, n, port, FAST), draws=draws)
                 for i in range(2)]
        early_task = asyncio.gather(*(a.run() for a in early))
        # both rounds without node 2 (the reference sleeps 6 s, which its
        # own run's rounds fill); node 2 joins while the early peers still
        # serve, in the linger after their last round
        await wait_height(early[0], 2)
        late = agent(pkg, _cfg(pkg, 2, n, port, FAST), draws=draws)
        late_res = await late.run()
        return await early_task, late_res, early + [late]

    early_res, late_res, agents = asyncio.run(go())
    e0 = early_res[0]["chain_dump"].splitlines()
    lj = late_res["chain_dump"].splitlines()
    assert lj[0] == e0[0]
    assert len(lj) >= 2
    # it adopted the running network's chain, all of it
    assert lj == e0
    return early_res + [late_res], agents


def test_late_joiner_adopts_longest_chain():
    got = twin(_late_joiner, 21420)
    ref, port = got["reference"], got["port"]
    # the two packages' genesis blocks are one block
    assert port[0][0]["chain_dump"].splitlines()[0] \
        == ref[0][0]["chain_dump"].splitlines()[0]
    assert_first_block_parity(ref[1][0], port[1][0], first_block=False)


# ------------------------------------------------ CNN, secure aggregation


def _cnn_secure_agg(pkg, port, draws):
    n = 4
    slow = dict(update_s=25.0, block_s=90.0, krum_s=15.0, share_s=25.0,
                rpc_s=20.0)
    results, agents = run_cluster(
        pkg, [_cfg(pkg, i, n, port, slow, dataset="cifar",
                   model_name="cifar_cnn", secure_agg=True,
                   verification=True, defense="NONE", max_iterations=1,
                   batch_size=4) for i in range(n)], draws=draws)
    lines = _chains_equal(results, 2)
    assert "ndeltas=0" not in lines[1], lines
    assert agents[0].trainer.num_params == 62006
    return results, agents


def test_cluster_cnn_model_secure_agg():
    got = twin(_cnn_secure_agg, 21460)
    assert_same_dumps(dumps(*got["reference"]), dumps(*got["port"]))


# ------------------------------------------------------------ trimmed mean


def _trimmed_mean(pkg, port, draws):
    n = 5
    results, agents = run_cluster(
        pkg, [_cfg(pkg, i, n, port, verification=True,
                   defense="TRIMMED_MEAN", max_iterations=1)
              for i in range(n)], draws=draws)
    _chains_equal(results, 2)
    blk = agents[0].chain.blocks[1]
    carried = [u.delta for u in blk.data.deltas
               if u.accepted and u.delta is not None and len(u.delta)]
    assert len(carried) >= 3
    frac = agents[0].cfg.trim_fraction
    # the reference's kernel on the carried deltas, in either package
    expect = np.asarray(ref_trimmed_mean(
        jnp.asarray(np.stack(carried), jnp.float32), frac), np.float64)
    got = blk.data.global_w - agents[0].chain.blocks[0].data.global_w
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)
    assert not np.allclose(got, np.stack(carried).sum(axis=0))
    return results, agents


def test_trimmed_mean_miner_aggregation_is_trimmed():
    got = twin(_trimmed_mean, 21500)
    ref_a, port_a = got["reference"][1][0], got["port"][1][0]
    # round 0's block is held to the reference's where both verifiers
    # pooled the same updates (a round with more workers than samples
    # pools the first to arrive, ROADMAP C8), and each run to the
    # trimmed-mean rule above in any case
    assert_first_block_parity(
        ref_a, port_a, first_block=round_pools(got["reference"][0])
        == round_pools(got["port"][0]))
    # as many deltas carried (a pool of num_samples), and the port's own
    # kernel on the reference's carried deltas is the reference's aggregate
    blocks = [got[k][1][0].chain.blocks[1] for k in ("reference", "port")]
    ref_d, port_d = ([u.delta for u in b.data.deltas if u.accepted]
                     for b in blocks)
    assert len(ref_d) == len(port_d)
    frac = got["port"][1][0].cfg.trim_fraction
    ours = trimmed_mean_aggregate(
        torch.as_tensor(np.stack(ref_d), dtype=torch.float32), frac)
    theirs = ref_trimmed_mean(jnp.asarray(np.stack(ref_d), jnp.float32),
                              frac)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6,
                               atol=1e-7)
