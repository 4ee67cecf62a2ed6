"""Twins of `tests/test_pipeline.py`'s live cases on the port's peer, and
the shared-generator fault (ROADMAP C9) that only the pipelined path
shows.

The pipelined round engine (`pipeline`, `speculation`, `batch_intake`)
must leave chains as the serial engine does, under seeded chaos too; a
fork on the speculated height must discard the speculative step; and the
miner's batched plain-mode intake must give the sequential path's exact
verdicts. Each live case runs on the reference's agents and on the
port's (`device="cpu"`, trained on the reference run's draws) from the
same config keywords, makes the reference test's assertions on the
port's run and compares the two runs.

C9: the speculative step and the serial step of one round run
`Trainer.private_fun` in two worker threads. Until the repair the
Trainer seeded one shared generator and then drew from it, so a thread
that seeded between another's seed and draw took the continuation of
the stream: a minibatch that is not the round's. `Interleave` forces
that order (both threads seeded, then the first drawing, then the
second); on the shared generator the second step's delta is another
minibatch's. A second case forces it on a live agent across a fork and
holds the serial step's delta to the reference's step on the round's
rows.

Ports are 19200-19299, which no other test file uses."""

import asyncio
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biscotti_tpu.models import trainer as jtrainer
from biscotti_tpu_torch.config import BiscottiConfig
from biscotti_tpu_torch.models import base as pbase
from biscotti_tpu_torch.models import trainer as ptrainer
from torch_twins import (PACKAGES, PORT, REF, assert_same_dumps,
                         assert_same_outcome, cfg, dumps, honest_outcome,
                         reference_draws, run_cluster)

pytestmark = pytest.mark.pipeline

# the reference file's windows (test_pipeline.py:34)
FAST = dict(update_s=4.0, block_s=14.0, krum_s=3.0, share_s=4.0, rpc_s=6.0)


def _cfg(pkg, i, n, port, **kw):
    return cfg(pkg, i, n, port, FAST, **dict(dict(defense="KRUM",
                                                  max_iterations=3), **kw))


# ------------------------------------------------ C9: the shared generator

class Interleave:
    """Holds the first two `sample_batch` calls between their seed and
    their draw until both are seeded, then lets the first draw and, once
    it has drawn, the second: with one generator shared by the two
    threads, the second draws the continuation of the stream."""

    def __init__(self, monkeypatch):
        self._orig = ptrainer.sample_batch
        self._lock = threading.Lock()
        self._calls = 0
        self.seeded = [threading.Event(), threading.Event()]
        self._go = [threading.Event(), threading.Event()]
        self._drawn = [threading.Event(), threading.Event()]
        monkeypatch.setattr(ptrainer, "sample_batch", self._sample_batch)
        threading.Thread(target=self._conduct, daemon=True).start()

    def _sample_batch(self, gen, n, batch_size, count):
        with self._lock:
            k, self._calls = self._calls, self._calls + 1
        if k < 2:
            self.seeded[k].set()
            assert self._go[k].wait(60), "interleaving never released"
        out = self._orig(gen, n, batch_size, count)
        if k < 2:
            self._drawn[k].set()
        return out

    def _conduct(self):
        for e in self.seeded:
            e.wait(60)
        self._go[0].set()
        self._drawn[0].wait(60)
        self._go[1].set()


def _creditcard_trainer():
    return ptrainer.Trainer("creditcard", "creditcard2",
                            cfg=BiscottiConfig(dataset="creditcard", seed=3),
                            device="cpu")


def test_two_threads_of_one_round_step_on_the_rounds_rows(monkeypatch):
    """C9: the speculative and the serial step of round 7 in two threads,
    the second seeded before the first draws: both train on round 7's
    rows and give the serial delta."""
    t = _creditcard_trainer()
    w = np.random.default_rng(0).normal(0, 0.1, t.num_params)
    rows = t.batch_indices(7)
    want = t.private_fun_from_batch(w, rows)
    seen = []
    step = t.private_fun_from_batch

    def recording(flat_w, idx):
        seen.append(idx.clone())
        return step(flat_w, idx)

    t.private_fun_from_batch = recording
    Interleave(monkeypatch)
    out = [None, None]

    def run(k):
        out[k] = t.private_fun(w, 7)

    threads = [threading.Thread(target=run, args=(k,)) for k in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert len(seen) == 2
    for idx in seen:
        assert torch.equal(idx, rows), f"a step drew {idx.tolist()}, " \
            f"not round 7's {rows.tolist()}"
    for d in out:
        np.testing.assert_array_equal(d, want)


def test_batch_rows_are_the_stream_of_before_the_repair():
    """The repair keeps the stream: one generator a call gives the rows
    that the one shared generator gave, (seed, peer, iteration) by
    (seed, peer, iteration)."""
    pinned = {  # Trainer.batch_indices on the tree before the repair
        ("creditcard", "creditcard2", 3): {
            0: [73, 312, 160, 224, 77, 8, 127, 3, 118, 43],
            1: [89, 140, 279, 129, 1, 275, 286, 149, 315, 223],
            7: [270, 87, 114, 147, 275, 314, 39, 243, 226, 196]},
        ("mnist", "mnist3", 0): {
            0: [473, 423, 198, 20, 203, 379, 291, 14, 8, 389],
            1: [180, 289, 31, 394, 227, 201, 17, 25, 292, 446],
            7: [412, 452, 389, 462, 311, 193, 468, 360, 423, 368]}}
    for (dataset, shard, seed), rows in pinned.items():
        t = ptrainer.Trainer(dataset, shard,
                             cfg=BiscottiConfig(dataset=dataset, seed=seed),
                             device="cpu")
        shared = torch.Generator()
        n = int(t.x_train.shape[0])
        for it in (0, 1, 7, 3, 0, 250):
            shared.manual_seed(ptrainer.stream_seed(
                "trainer", seed, t.seed, "batch", it))
            old = ptrainer.sample_batch(shared, n, min(t.batch_size, n), 1)[0]
            assert torch.equal(t.batch_indices(it), old)
            if it in rows:
                assert t.batch_indices(it).tolist() == rows[it]


def test_fp32_math_holds_until_the_last_thread_leaves():
    """fp32_math's flags are process-wide: a thread still inside must
    keep TF32 off after another thread has left, and the flags come back
    once both have left."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    first_in, second_in, first_out = (threading.Event(), threading.Event(),
                                      threading.Event())
    seen = []

    def first():
        with pbase.fp32_math():
            first_in.set()
            second_in.wait(30)
        first_out.set()

    def second():
        first_in.wait(30)
        with pbase.fp32_math():
            second_in.set()
            first_out.wait(30)
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        threads = [threading.Thread(target=f) for f in (first, second)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert seen == [(False, False)], seen
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_steps_and_flags_hold_under_many_threads():
    """A stress of C9's two repairs: 16 threads (more than the cores)
    switching every microsecond draw rounds 0-2 inside fp32_math; each
    draw is its round's rows, TF32 stays off inside, and the flags come
    back once every thread has left."""
    t = _creditcard_trainer()
    want = {it: t.batch_indices(it) for it in range(3)}
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, sys.getswitchinterval())
    bad = []

    def work(k):
        for i in range(40):
            it = (k + i) % 3
            with pbase.fp32_math():
                rows = t.batch_indices(it)
                if (torch.backends.cuda.matmul.allow_tf32
                        or torch.backends.cudnn.allow_tf32):
                    bad.append(("tf32", k, i))
            if not torch.equal(rows, want[it]):
                bad.append(("rows", k, i))

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads)
        assert not bad, bad[:5]
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        sys.setswitchinterval(saved[2])


# --------------------------------------------- chains equal under chaos

def test_pipelined_chaos_chains_equal_to_unpipelined():
    """4 peers, pipelining + speculation + batched intake on, seeded
    chaos (drop + delay): the settled prefix equals the unpipelined
    run's, the speculation ledger is in telemetry_snapshot(), and the
    port's pipelined run settles the reference's chain."""
    n = 4

    def go(pkg, port, pipe, draws=None):
        plan = pkg.faults.FaultPlan(seed=11, drop=0.10, delay=0.25,
                                    delay_s=0.05)
        cfgs = [_cfg(pkg, i, n, port, secure_agg=True, verification=True,
                     fault_plan=plan, pipeline=pipe, speculation=pipe,
                     batch_intake=pipe) for i in range(n)]
        return run_cluster(pkg, cfgs, draws=draws)

    ref_on, ref_agents = go(REF, 19200, True)
    on, agents_on = go(PORT, 19210, True, reference_draws(ref_agents))
    off, _ = go(PORT, 19220, False, reference_draws(ref_agents))
    for results in (ref_on, on, off):
        equal, common, _ = PORT.chaos.chain_oracle(results)
        assert equal and common >= 1, "cluster diverged under chaos"
    equal, common, real = PORT.chaos.chain_oracle(on + off)
    assert equal, "pipelined run diverged from the unpipelined chains"
    assert common >= 1 and real >= 1
    snaps = [a.telemetry_snapshot() for a in agents_on]
    ready = sum(s["counters"].get("speculation_ready", 0) for s in snaps)
    assert ready > 0, "no speculative step ever completed"
    assert any("biscotti_speculation_hits" in s["metrics"] for s in snaps)
    table = PORT.profile_round.collect_round_table(agents_on)
    assert table["rounds"], "no rounds in the overlap table"
    assert any(r.get("wall_s") is not None for r in table["rounds"])
    assert table["crypto_batch_sizes"], "no batched settles recorded"
    # parity: on one settled prefix with the reference's pipelined run,
    # and no update refused in either
    equal, common, real = PORT.chaos.chain_oracle(ref_on + on)
    assert equal and common >= 1, "port chain parted from the reference's"
    assert_same_outcome(honest_outcome(ref_agents), honest_outcome(agents_on),
                        ("rejected",))


# -------------------------------------------------- speculation rollback

def _pinned_worker(pkg, port):
    a = pkg.PeerAgent(_cfg(pkg, 0, 5, port, pipeline=True, speculation=True),
                      **pkg.agent_kw)
    # the speculation plane only precomputes for workers
    a._elect_role_map = lambda: pkg.roles.RoleMap.build(
        5, verifiers=[1], miners=[2])
    return a


def _fork_block(pkg, a, blk1, it0):
    u = pkg.block.Update(source_id=3, iteration=it0,
                         delta=np.zeros(0, np.float64),
                         commitment=b"\xcd" * 32, accepted=True)
    stake = dict(blk1.stake_map)
    stake[3] = stake.get(3, 0) + a.cfg.stake_unit
    return pkg.block.Block(
        data=pkg.block.BlockData(iteration=it0,
                                 global_w=a.chain.latest_gradient(),
                                 deltas=[u]),
        prev_hash=blk1.prev_hash, stake_map=stake).seal()


def _fork_scenario(pkg, port):
    a = _pinned_worker(pkg, port)

    async def go():
        it0 = a.iteration
        blk1 = a._empty_block()
        a._accept_block(blk1, gossip=False, minted=True)
        assert a._spec_task is not None, "speculation never kicked"
        await a._spec_task
        assert a._spec is not None and a._spec["base"] == blk1.hash
        blk2 = _fork_block(pkg, a, blk1, it0)
        a._accept_block(blk2, gossip=False, minted=True)
        assert a.chain.latest_hash() == blk2.hash, "fork not adopted"
        assert a.counters.get("speculation_discard", 0) >= 1
        snap = a.telemetry_snapshot()
        assert snap["counters"]["speculation_discard"] >= 1
        series = snap["metrics"]["biscotti_speculation_discards"]["series"]
        assert series[0]["value"] >= 1
        claim = await a._claim_spec(a.iteration)
        assert claim is None or a._spec is None
        return (blk1.hash, blk2.hash, a.iteration,
                a.counters.get("speculation_discard", 0),
                a.counters.get("speculation_ready", 0), claim is None)

    return asyncio.run(go())


def test_fork_discards_speculative_step_and_counts_it():
    ref = _fork_scenario(REF, 19230)
    port = _fork_scenario(PORT, 19231)
    assert port == ref


def test_claim_spec_mismatch_counts_discard():
    got = []
    for k, pkg in enumerate(PACKAGES):
        a = pkg.PeerAgent(_cfg(pkg, 0, 5, 19232 + k, pipeline=True,
                               speculation=True), **pkg.agent_kw)
        a._spec = {"it": a.iteration, "base": b"\x00" * 32,
                   "delta": np.zeros(a.trainer.num_params)}
        assert asyncio.run(a._claim_spec(a.iteration)) is None
        assert a.counters.get("speculation_discard", 0) == 1
        assert a._spec is None
        got.append(dict(a.counters))
    assert got[1] == got[0]


def test_fork_serial_step_is_the_reference_step_on_the_rounds_rows(
        monkeypatch):
    """The fork case with C9's interleaving forced: the speculative step
    (off the superseded head) is seeded and held, the serial step of the
    same round seeds after it and draws after it. The serial delta must
    be the reference's step on the round's rows at the fork's weights."""
    a = _pinned_worker(PORT, 19234)
    ref_trainer = REF.PeerAgent(_cfg(REF, 0, 5, 19235)).trainer
    order = Interleave(monkeypatch)

    async def go():
        it0 = a.iteration
        blk1 = a._empty_block()
        a._accept_block(blk1, gossip=False, minted=True)
        spec = a._spec_task
        assert spec is not None, "speculation never kicked"
        while not order.seeded[0].is_set():
            await asyncio.sleep(0.01)
        a._accept_block(_fork_block(PORT, a, blk1, it0), gossip=False,
                        minted=True)
        it = a.iteration
        # the retargeted speculation is not awaited: the serial step runs
        assert await a._claim_spec(it) is None
        w = a.chain.latest_gradient()
        delta = await asyncio.to_thread(a.trainer.private_fun, w, it)
        await spec
        return it, w, delta

    it, w, delta = asyncio.run(go())
    rows = np.asarray(a.trainer.batch_indices(it))  # one thread: the round's
    step = jtrainer.local_step_fn(ref_trainer.model, ref_trainer.mode,
                                  clip=ref_trainer.cfg.grad_clip,
                                  alpha=ref_trainer.cfg.logreg_alpha)
    want = np.asarray(step(jnp.asarray(w, jnp.float32),
                           ref_trainer.x_train[rows],
                           ref_trainer.y_train[rows]), np.float64)
    np.testing.assert_allclose(delta, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------- batched plain-mode intake

def _mk_plain_updates(pkg, agent_, it, count, bad_sid):
    rng = np.random.default_rng(7)
    d = agent_.trainer.num_params
    out = []
    for sid in range(count):
        delta = rng.normal(size=d)
        q = agent_._quantize_np(delta)
        commitment = pkg.cm.commit_update(q + 3 if sid == bad_sid else q,
                                          agent_.commit_key)
        out.append(pkg.block.Update(source_id=sid, iteration=it, delta=delta,
                                    commitment=commitment))
    return out


def _run_plain_intake(pkg, batch_on: bool, port: int):
    a = pkg.PeerAgent(_cfg(pkg, 0, 40, port, batch_intake=batch_on),
                      **pkg.agent_kw)
    a.commit_key = pkg.cm.CommitKey.generate(a.trainer.num_params)
    a.role_map = pkg.roles.RoleMap.build(40, verifiers=[1], miners=[0])
    it = a.iteration

    async def go():
        fut = asyncio.get_running_loop().create_future()
        fut.set_result(set())
        a.round = pkg.peer.RoundState(iteration=it, krum_decision=fut,
                                      block_done=asyncio.Event())
        updates = _mk_plain_updates(pkg, a, it, 35, bad_sid=17)

        async def submit(u):
            meta, arrays = pkg.wire.pack_update(u)
            meta["iteration"] = it
            try:
                await a._h_register_update(meta, arrays)
                return None
            except pkg.rpc.RPCError as e:
                return str(e)

        return await asyncio.gather(*(submit(u) for u in updates))

    return a, asyncio.run(go())


def test_batched_intake_bisection_matches_sequential():
    """One poisoned commitment in a 35-update intake is found by the
    bisection and rejected exactly as the sequential path does, in both
    packages, with the same answers to every submitter."""
    runs = {}
    for k, pkg in enumerate(PACKAGES):
        runs[pkg.name] = (_run_plain_intake(pkg, True, 19240 + 2 * k),
                          _run_plain_intake(pkg, False, 19241 + 2 * k))
    for (agent_b, out_b), (agent_s, out_s) in runs.values():
        for a, outcomes in ((agent_b, out_b), (agent_s, out_s)):
            st = a.round
            assert sorted(st.miner_updates) == [i for i in range(35)
                                                if i != 17]
            assert sorted(st.miner_rejected) == [17]
            assert sum(o is not None for o in outcomes) == 1
        assert out_b == out_s
        assert agent_b.counters.get("plain_batch_verified", 0) >= 1
        assert "plain_batch_verified" not in agent_s.counters
    (rb, rout), _ = runs["reference"]
    (pb, pout), _ = runs["port"]
    assert pout == rout
    assert pb.counters.get("plain_batch_verified") == \
        rb.counters.get("plain_batch_verified")


def test_disabled_knobs_reproduce_seed_schedule():
    """Knobs off: no pipeline-plane counter or phase, depth gauge 0, and
    the port's chain is the reference's (secure aggregation)."""
    n, port = 4, 19250
    got, chains, draws = {}, {}, None
    for k, pkg in enumerate(PACKAGES):
        cfgs = [_cfg(pkg, i, n, port + 10 * k, secure_agg=True,
                     verification=True, max_iterations=2) for i in range(n)]
        results, agents = run_cluster(pkg, cfgs, draws=draws)
        draws = reference_draws(agents)
        equal, common, _ = pkg.chaos.chain_oracle(results)
        assert equal and common >= 1
        for r in results:
            for forbidden in ("speculation_hit", "speculation_discard",
                              "speculation_ready", "intake_preverified",
                              "plain_batch_verified"):
                assert forbidden not in r["counters"]
            for phase in ("intake_fold", "spec_sgd", "spec_commit"):
                assert phase not in r["phases"]
            assert r["telemetry"]["metrics"]["biscotti_pipeline_depth"][
                "series"][0]["value"] == 0
        got[pkg.name] = honest_outcome(agents)
        chains[pkg.name] = dumps(results, agents)
    assert_same_outcome(got["reference"], got["port"],
                        ("accepted", "rejected", "stake", "blocks"))
    assert_same_dumps(chains["reference"], chains["port"])
