"""Twins of `tests/test_byzantine.py` on the port's live peer: a Byzantine
peer in a loopback cluster (corrupted share rows, a commitment forged
over other data, a fabricated noiser lottery, a bogus plain-mode
commitment, two colluders and a lying miner) must be refused at intake,
recorded as rejected and debited by the honest majority, with the
chain-equality oracle intact.

Each scenario runs on the reference's agents (the reference test's own
Byzantine classes) and on the port's (the same classes written again on
the port's `PeerAgent`, below), from the same config keywords and seed.
The port's agents train on the reference run's batch rows and noise
(`torch_twins.inject_reference_draws`). The port's run must pass the
reference test's assertions and match the reference's run on the
accepted and rejected source ids, the final stake map and each block's
members; a secure-aggregation run's chain dump must equal the
reference's (each such reference run gave one dump in repeated runs).
The reduced-redundancy cluster pools 2 of its workers in arrival order
(ROADMAP C8) and is held to the rejected ids, the accepted count and the
stake rule. The agent-level cases (intake shape, signature replay,
forged chains, the leader-signed share release, the quorum memo) give
both packages the same inputs and compare what they answer. One more
case mixes the packages: a port `CorruptSharePeer` among reference
peers, and a reference one among port peers.

Ports are 19000-19199, which no other test file uses."""

import asyncio
import hashlib

import numpy as np
import pytest

import test_byzantine as jb
from torch_twins import (PACKAGES, PORT, REF, agent,
                         assert_first_block_parity, assert_same_dumps,
                         assert_same_outcome, cfg, dumps, honest_outcome,
                         outcome, reference_draws, round0_vanilla,
                         run_cluster)

# the reference file's windows (test_byzantine.py:27)
FAST = dict(update_s=12.0, block_s=40.0, krum_s=12.0, share_s=12.0,
            rpc_s=15.0)


# ------------------------------------------ the Byzantine peers, on the port

class CorruptSharePeer(PORT.PeerAgent):
    """Commits honestly, then ships garbage share rows."""

    def _secret_arrays(self, shares, blind_rows, comms, sl):
        arrays = super()._secret_arrays(shares, blind_rows, comms, sl)
        arrays["share_rows"] = arrays["share_rows"] + 12345
        return arrays


class ForgedCommitmentPeer(PORT.PeerAgent):
    """Gets signatures over a commitment to zeros, shares its real update."""

    def _vss_build(self, q, it, *args):
        return super()._vss_build(np.zeros_like(q), it, *args)


class FakeLotteryPeer(PORT.PeerAgent):
    """Claims a noiser set its VRF never drew."""

    def _noiser_draw(self):
        draw = super()._noiser_draw()
        fake = [i for i in range(self.cfg.num_nodes)
                if i != self.id and i not in draw.noisers]
        picked = (fake or draw.noisers)[: len(draw.noisers)]
        return PORT.roles.NoiserDraw(noisers=picked, output=draw.output,
                                     proof=draw.proof)


class BadCommitPeer(PORT.PeerAgent):
    """Plain mode: a commitment unrelated to its delta."""

    def _commit(self, q):
        return b"\xde\xad" * 16


class PlusSharePeer(PORT.PeerAgent):
    """Colluder A: +OFFSET on every share row cell."""

    OFFSET = 12345

    def _secret_arrays(self, shares, blind_rows, comms, sl):
        arrays = super()._secret_arrays(shares, blind_rows, comms, sl)
        arrays["share_rows"] = arrays["share_rows"] + self.OFFSET
        return arrays


class MinusSharePeer(PlusSharePeer):
    """Colluder B: -OFFSET, cancelling A inside any batch holding both."""

    OFFSET = -12345


class LyingListMiner(PORT.PeerAgent):
    """A colluding miner that lies one colluder out of its update list."""

    OMIT = -1

    async def _h_get_update_list(self, meta, arrays):
        rmeta, arrs = await super()._h_get_update_list(meta, arrays)
        rmeta["sources"] = [s for s in rmeta["sources"] if s != self.OMIT]
        return rmeta, arrs


BYZANTINE = {  # name: (reference class, port class)
    "corrupt_share": (jb.CorruptSharePeer, CorruptSharePeer),
    "forged_commitment": (jb.ForgedCommitmentPeer, ForgedCommitmentPeer),
    "fake_lottery": (jb.FakeLotteryPeer, FakeLotteryPeer),
    "bad_commit": (jb.BadCommitPeer, BadCommitPeer),
}


def _cls(pkg, name):
    return BYZANTINE[name][pkg is PORT]


# ------------------------------------------------------------------ helpers

def _assert_detected_and_debited(results, agents, byz_id):
    """The reference's `_assert_detected_and_debited`, on either package."""
    honest = [r for r, a in zip(results, agents) if a.id != byz_id]
    dumps = [r["chain_dump"] for r in honest]
    assert all(d == dumps[0] for d in dumps), "chain-equality oracle violated"
    got = honest_outcome(agents, skip={byz_id})
    assert byz_id not in got["accepted"], "Byzantine update entered a block"
    assert byz_id in got["rejected"], \
        "Byzantine update was not recorded as rejected"
    assert got["accepted"], "no honest update made it into any block"
    assert got["stake"][byz_id] < agents[0].cfg.default_stake, (
        f"Byzantine stake was not debited: {got['stake'][byz_id]}")
    assert any(a.counters.get("submission_rejected", 0) > 0 for a in agents
               if a.id != byz_id)
    return got


def _detected_twin(name, port, n=5, **kw):
    """One Byzantine worker of round 0 (class `name`) in an n-peer
    cluster, on each package; both detect and debit it, alike."""
    byz = round0_vanilla(REF, n)
    assert round0_vanilla(PORT, n) == byz
    got, chains, draws = {}, {}, None
    for off, pkg in enumerate(PACKAGES):
        cfgs = [cfg(pkg, i, n, port + 10 * off, FAST, max_iterations=1, **kw)
                for i in range(n)]
        results, agents = run_cluster(pkg, cfgs, {byz: _cls(pkg, name)},
                                      draws)
        draws = reference_draws(agents)
        got[pkg.name] = _assert_detected_and_debited(results, agents, byz)
        chains[pkg.name] = dumps(results, agents, {byz})
    assert_same_outcome(got["reference"], got["port"],
                        ("accepted", "rejected", "stake", "blocks"))
    if kw.get("secure_agg"):
        assert_same_dumps(chains["reference"], chains["port"])


# ----------------------------------------------------------- live clusters

def test_corrupt_shares_detected_and_debited():
    _detected_twin("corrupt_share", 19000, secure_agg=True,
                   verification=True, defense="NONE")


def test_forged_commitment_detected_and_debited():
    _detected_twin("forged_commitment", 19020, secure_agg=True,
                   verification=True, defense="NONE")


def test_plain_mode_bad_commitment_detected_and_debited():
    _detected_twin("bad_commit", 19040)


def test_fake_noiser_lottery_refused():
    n, port = 5, 19060
    byz = round0_vanilla(REF, n)
    got, draws = {}, None
    for off, pkg in enumerate(PACKAGES):
        cfgs = [cfg(pkg, i, n, port + 10 * off, FAST, noising=True,
                    max_iterations=1) for i in range(n)]
        results, agents = run_cluster(pkg, cfgs,
                                      {byz: _cls(pkg, "fake_lottery")}, draws)
        draws = reference_draws(agents)
        chain = dumps(results, agents, {byz})
        assert all(d == chain[0] for d in chain)
        assert any(a.counters.get("noise_draw_rejected", 0) > 0
                   for a in agents if a.id != byz), \
            "no noiser rejected the fake lottery"
        assert "ndeltas=0" not in chain[0].splitlines()[1]
        got[pkg.name] = honest_outcome(agents, skip={byz})
    assert_same_outcome(got["reference"], got["port"],
                        ("accepted", "rejected", "stake", "blocks"))


def _colluders(pkg, n):
    chain = pkg.chain.Blockchain(50, n, 10)
    verifiers, miners = pkg.roles.elect_committees(
        chain.latest_stake_map(), chain.latest_hash(), 1, 2, n)
    busy = set(verifiers) | set(miners)
    workers = sorted(i for i in range(n) if i not in busy)
    return workers, min(miners), max(miners)


def test_colluding_cancellation_caught_at_aggregation_boundary():
    """Workers B (+e) and C (-e) cancel inside every miner's intake
    batch, the non-leader miner lies C out of the agreed set: the
    leader's partial-batch re-proof isolates B and debits it."""
    n, port = 7, 19080
    workers, liar_id, leader_id = _colluders(REF, n)
    assert _colluders(PORT, n) == (workers, liar_id, leader_id)
    assert len(workers) >= 3 and liar_id != leader_id
    plus_id, minus_id = workers[0], workers[1]
    byz = {plus_id, minus_id, liar_id}
    got, chains, draws = {}, {}, None
    for off, pkg in enumerate(PACKAGES):
        plus, minus, liar = ((jb.PlusSharePeer, jb.MinusSharePeer,
                              jb.LyingListMiner) if pkg is REF else
                             (PlusSharePeer, MinusSharePeer, LyingListMiner))
        liar.OMIT = minus_id
        cfgs = [cfg(pkg, i, n, port + 10 * off, FAST, secure_agg=True,
                    verification=True, defense="NONE", max_iterations=1,
                    num_miners=2) for i in range(n)]
        results, agents = run_cluster(
            pkg, cfgs, {plus_id: plus, minus_id: minus, liar_id: liar}, draws)
        draws = reference_draws(agents)
        chains[pkg.name] = dumps(results, agents, byz)
        assert all(d == chains[pkg.name][0] for d in chains[pkg.name]), \
            "chain-equality oracle violated"
        out = honest_outcome(agents, skip=byz)
        assert plus_id in out["rejected"], \
            "remaining colluder was not caught by the boundary re-check"
        assert plus_id not in out["accepted"]
        assert minus_id not in out["accepted"], \
            "lied-out colluder entered the block"
        assert any(w in out["accepted"] for w in workers[2:]), \
            "no honest update made it into the block"
        assert out["stake"][plus_id] < cfgs[0].default_stake, \
            "colluder stake was not debited"
        got[pkg.name] = out
    assert_same_outcome(got["reference"], got["port"],
                        ("accepted", "rejected", "stake", "blocks"))
    assert_same_dumps(chains["reference"], chains["port"])


def test_honest_secureagg_cluster_still_accepts_everyone():
    n, port = 5, 19100
    got, chains, draws = {}, {}, None
    for off, pkg in enumerate(PACKAGES):
        cfgs = [cfg(pkg, i, n, port + 10 * off, FAST, secure_agg=True,
                    verification=True, noising=True, defense="KRUM",
                    max_iterations=2) for i in range(n)]
        results, agents = run_cluster(pkg, cfgs, draws=draws)
        draws = reference_draws(agents)
        chains[pkg.name] = dumps(results, agents)
        out = honest_outcome(agents)
        assert not out["rejected"]
        assert all(v >= agents[0].cfg.default_stake
                   for v in out["stake"].values())
        assert sum(a.counters.get("submission_rejected", 0)
                   for a in agents) == 0
        got[pkg.name] = out
    assert_same_outcome(got["reference"], got["port"],
                        ("accepted", "rejected", "stake", "blocks"))
    assert_same_dumps(chains["reference"], chains["port"])


def test_reduced_redundancy_closes_differencing_and_still_converges():
    """share_redundancy 1.5 with 3 miners: rows a miner times half the
    miners stay under poly_size, and the round still recovers. The round
    pools 2 of its workers' updates in arrival order (ROADMAP C8), so
    which two follows the host's timing: the port's run is held to the
    reference's rejected ids, accepted count and stake rule."""
    n, port = 6, 19120
    got, draws = {}, None
    for off, pkg in enumerate(PACKAGES):
        cfgs = [cfg(pkg, i, n, port + 10 * off, FAST, secure_agg=True,
                    verification=True, num_miners=3, defense="NONE",
                    max_iterations=1, share_redundancy=1.5)
                for i in range(n)]
        assert cfgs[0].total_shares == 15
        assert cfgs[0].shares_per_miner * (cfgs[0].num_miners // 2) \
            < cfgs[0].poly_size
        results, agents = run_cluster(pkg, cfgs, draws=draws)
        draws = reference_draws(agents)
        chain = dumps(results, agents)
        assert all(d == chain[0] for d in chain)
        assert any("ndeltas=" in ln and "ndeltas=0" not in ln
                   for ln in chain[0].splitlines()[1:]), chain[0]
        got[pkg.name] = agents[0]
    assert_first_block_parity(got["reference"], got["port"],
                              first_block=False)
    assert len(outcome(got["port"])["accepted"]) == \
        len(outcome(got["reference"])["accepted"])


@pytest.mark.parametrize("byz_pkg", ["port", "reference"])
def test_mixed_packages_corrupt_sharer_rejected_and_debited(byz_pkg):
    """A port CorruptSharePeer among reference peers, and a reference one
    among port peers: the honest majority of the other package rejects
    and debits it, as an all-reference cluster does."""
    n = 5
    port = 19140 if byz_pkg == "port" else 19150
    byz = round0_vanilla(REF, n)
    honest_pkg, byz_pkg_ = (REF, PORT) if byz_pkg == "port" else (PORT, REF)

    async def go():
        agents = []
        for i in range(n):
            pkg = byz_pkg_ if i == byz else honest_pkg
            c = cfg(pkg, i, n, port, FAST, secure_agg=True, verification=True,
                    defense="NONE", max_iterations=1)
            agents.append(agent(pkg, c, _cls(pkg, "corrupt_share")
                                if i == byz else None))
        return await asyncio.gather(*(a.run() for a in agents)), agents

    results, agents = asyncio.run(go())
    got = _assert_detected_and_debited(results, agents, byz)
    assert got["rejected"] == [byz]


# ------------------------------------------------------ agent-level cases

def _high_degree(pkg, port):
    cm, ss = pkg.cm, pkg.ss
    c_ = cfg(pkg, 0, 3, port, FAST, secure_agg=True)
    a = pkg.PeerAgent(c_, **pkg.agent_kw)
    a.role_map = pkg.roles.RoleMap.build(3, verifiers=[1], miners=[0])
    c = ss.num_chunks(a.trainer.num_params, c_.poly_size)
    comms = np.zeros((c, 2 * c_.poly_size, 64), dtype=np.uint8)
    rows = np.zeros((c_.shares_per_miner, c), dtype=np.int64)
    blind = np.zeros((c_.shares_per_miner, c, 32), dtype=np.uint8)
    return a._check_secret_intake(
        cm.vss_digest(comms), {"iteration": 0, "source_id": 2},
        {"comms": comms, "blind_rows": blind, "share_rows": rows})


def test_high_degree_commitment_rejected():
    ref, port = _high_degree(REF, 19160), _high_degree(PORT, 19161)
    assert not port[0] and "shape" in port[1]
    assert port == ref


def _replay(pkg, port):
    c_ = cfg(pkg, 0, 3, port, FAST)
    a = pkg.PeerAgent(c_, **pkg.agent_kw)
    a.role_map = pkg.roles.RoleMap.build(3, verifiers=[1], miners=[0])
    seed = hashlib.sha256(f"schnorr-{c_.seed}-1".encode()).digest()
    commitment = b"\xab" * 32
    sig = pkg.cm.schnorr_sign(seed, a._sig_message(commitment, 0, 2))
    return sig, [a._verify_sig_quorum(commitment, it, sid, [1], [sig])
                 for it, sid in ((0, 2), (1, 2), (0, 1))]


def test_signature_replay_across_rounds_fails():
    ref, port = _replay(REF, 19162), _replay(PORT, 19163)
    assert port[1] == [True, False, False]
    assert port == ref


def _forged_chain(pkg, port):
    a = pkg.PeerAgent(cfg(pkg, 0, 4, port, FAST, verification=True),
                      **pkg.agent_kw)
    blocks = [a.chain.blocks[0]]
    for i in range(3):
        prev = blocks[-1]
        forged = pkg.block.Update(source_id=1, iteration=i,
                                  delta=np.zeros(0, np.float64),
                                  commitment=b"\x11" * 32, accepted=True)
        blocks.append(pkg.block.Block(
            data=pkg.block.BlockData(iteration=i,
                                     global_w=np.ones(a.trainer.num_params),
                                     deltas=[forged]),
            prev_hash=prev.hash, stake_map=dict(prev.stake_map)).seal())
    other = pkg.chain.Blockchain.__new__(pkg.chain.Blockchain)
    other.blocks = blocks
    other.verify()
    quorums = a._chain_quorums_ok(blocks)
    a._accept_block(blocks[1], gossip=False)
    return ([b.hash for b in blocks], quorums, a.chain.get_block(0) is None,
            a.counters.get("block_quorum_rejected", 0))


def test_forged_heavy_chain_refused_without_quorums():
    ref, port = _forged_chain(REF, 19164), _forged_chain(PORT, 19165)
    assert port[1:] == (False, True, 1)
    assert port == ref


def _share_release(pkg, port):
    c_ = cfg(pkg, 0, 4, port, FAST, secure_agg=True, verification=True)
    a = pkg.PeerAgent(c_, **pkg.agent_kw)
    a.role_map = pkg.roles.RoleMap.build(4, verifiers=[1], miners=[a.id, 3])

    async def attempt(meta):
        a.round.krum_decision = asyncio.get_running_loop().create_future()
        try:
            await a._h_get_miner_part(meta, {})
            return None
        except pkg.rpc.RPCError as e:
            return str(e)

    async def go():
        r1 = await attempt({"iteration": a.iteration, "nodes": [0, 1],
                            "source_id": 2, "sig": "00" * 64})
        r2 = await attempt({"iteration": a.iteration, "nodes": [0, 1],
                            "source_id": 3, "sig": "00" * 64})
        seed = hashlib.sha256(f"schnorr-{c_.seed}-3".encode()).digest()
        sig = pkg.cm.schnorr_sign(seed, a._part_message(
            "miner-part", a.iteration, [0, 2]))
        r3 = await attempt({"iteration": a.iteration, "nodes": [0, 1],
                            "source_id": 3, "sig": sig.hex()})
        return r1, r2, r3

    return asyncio.run(go())


def test_share_release_requires_leader_signature():
    ref, port = _share_release(REF, 19166), _share_release(PORT, 19167)
    r1, r2, r3 = port
    assert r1 and "leader" in r1
    assert r2 and "signature" in r2
    assert r3 and "signature" in r3
    assert port == ref


def _quorum_memo(pkg, port):
    c_ = cfg(pkg, 0, 4, port, FAST, verification=True)
    a = pkg.PeerAgent(c_, **pkg.agent_kw)
    genesis = a.chain.blocks[0]
    vset = a._committee_for(genesis.stake_map, genesis.hash)
    cm = pkg.cm

    def make_block(source_id, signed):
        u = pkg.block.Update(source_id=source_id, iteration=0,
                             delta=np.zeros(0, np.float64),
                             commitment=bytes([source_id]) * 32,
                             accepted=True)
        if signed:
            msg = a._sig_message(u.commitment, 0, source_id)
            for vid in vset:
                seed = hashlib.sha256(
                    f"schnorr-{c_.seed}-{vid}".encode()).digest()
                u.signers.append(vid)
                u.signatures.append(cm.schnorr_sign(seed, msg))
        return pkg.block.Block(
            data=pkg.block.BlockData(iteration=0,
                                     global_w=np.ones(a.trainer.num_params),
                                     deltas=[u]),
            prev_hash=genesis.hash, stake_map=dict(genesis.stake_map)).seal()

    sid = max(i for i in range(4) if i not in vset)
    genuine = make_block(sid, signed=True)
    forged = make_block((sid + 1) % 4 if (sid + 1) % 4 not in vset else sid,
                        signed=False)
    assert forged.hash == forged.compute_hash()
    cold = a._block_quorums_ok(forged, genesis.stake_map, genesis.hash)
    relabeled = make_block(sid, signed=True)
    relabeled.hash = forged.hash
    relabeled_ok = a._block_quorums_ok(relabeled, genesis.stake_map,
                                       genesis.hash)
    poisoned = forged.hash in a._quorum_ok_hashes
    forged_after = a._block_quorums_ok(forged, genesis.stake_map,
                                       genesis.hash)
    genuine_ok = a._block_quorums_ok(genuine, genesis.stake_map,
                                     genesis.hash)
    return (sorted(vset), genuine.hash, forged.hash, cold, relabeled_ok,
            poisoned, forged_after, genuine_ok,
            genuine.hash in a._quorum_ok_hashes)


def test_quorum_memo_cannot_be_poisoned_by_relabeled_block():
    ref, port = _quorum_memo(REF, 19168), _quorum_memo(PORT, 19169)
    assert port[3:] == (False, True, False, False, True, True)
    assert port == ref
