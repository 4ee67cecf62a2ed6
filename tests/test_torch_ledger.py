"""The port's ledger (`biscotti_tpu_torch/ledger/`, `utils/checkpoint.py`)
against the JAX package's (`biscotti_tpu/ledger/`, `utils/checkpoint.py`).

Each chain scenario of tests/test_ledger.py and tests/test_chain_security.py
runs once on each package's modules; every observation (hashes, dumps,
`consider_block` and `maybe_adopt` decisions, `ChainInvariantError`
messages) must be equal. Canonical bytes and hashes must be equal bit for
bit for seeded updates (with and without noise, signatures and signers)
and block data holding float32, float64 and torch vectors. Checkpoints
cross packages both ways. Tolerance: exact everywhere."""

import json
import os
import types

import numpy as np
import pytest
import torch

from biscotti_tpu.ledger import block as rblock
from biscotti_tpu.ledger import chain as rchain
from biscotti_tpu.utils import checkpoint as rckpt
from biscotti_tpu_torch.ledger import block as pblock
from biscotti_tpu_torch.ledger import chain as pchain
from biscotti_tpu_torch.utils import checkpoint as pckpt

REF = types.SimpleNamespace(Block=rblock.Block, BlockData=rblock.BlockData,
                            Update=rblock.Update, genesis=rblock.genesis_block,
                            Chain=rchain.Blockchain,
                            Error=rchain.ChainInvariantError, ckpt=rckpt)
PORT = types.SimpleNamespace(Block=pblock.Block, BlockData=pblock.BlockData,
                             Update=pblock.Update, genesis=pblock.genesis_block,
                             Chain=pchain.Blockchain,
                             Error=pchain.ChainInvariantError, ckpt=pckpt)


def _try(fn):
    """fn()'s value, or ("raise", the exception's type name, message)."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the observation is the point
        return ("raise", type(e).__name__, str(e))


def _mk(L, chain, d=8, ndeltas=2, tag=1.0):
    it = chain.next_iteration
    deltas = [L.Update(source_id=s, iteration=it,
                       delta=np.full(d, tag + s, dtype=np.float64))
              for s in range(ndeltas)]
    return L.Block(data=L.BlockData(iteration=it,
                                    global_w=chain.latest_gradient() + tag,
                                    deltas=deltas),
                   prev_hash=chain.latest_hash(),
                   stake_map=chain.latest_stake_map()).seal()


def _at(L, chain, prev_hash):
    it = chain.latest.iteration
    return L.Block(data=L.BlockData(
        iteration=it, global_w=chain.latest_gradient() + 1,
        deltas=[L.Update(source_id=0, iteration=it, delta=np.ones(8))]),
        prev_hash=prev_hash, stake_map=chain.latest_stake_map()).seal()


def _empty(L, chain):
    return L.Block(data=L.BlockData(iteration=chain.next_iteration,
                                    global_w=chain.latest_gradient()),
                   prev_hash=chain.latest_hash(),
                   stake_map=chain.latest_stake_map()).seal()


# ------------------------------------------------------------ scenarios


def sc_genesis(L):
    a, b = L.genesis(16, 4, 10), L.genesis(16, 4, 10)
    return [a.hash, b.hash, a.iteration, a.stake_map, a.summary()]


def sc_hash_covers_contents(L):
    g = L.genesis(8, 2, 10)
    out = [g.compute_hash()]
    g.data.global_w[0] = 5.0
    out.append(g.compute_hash())
    g.data.global_w[0] = 0.0
    g.stake_map[0] = 11
    out.append(g.compute_hash())
    return out


def sc_append_and_invariants(L):
    c = L.Chain(num_params=8, num_nodes=4)
    for _ in range(5):
        c.add_block(_mk(L, c))
    return [len(c), c.next_iteration, _try(c.verify), c.dump(),
            c.adoption_key(), c.get_block(2).hash, c.get_block(9)]


def sc_append_rejects_bad_iteration_and_hash(L):
    c = L.Chain(num_params=8, num_nodes=4)
    blk = _mk(L, c)
    blk.data.iteration += 1
    blk.seal()
    out = [_try(lambda: c.add_block(blk))]
    blk2 = _mk(L, c)
    blk2.hash = b"\x00" * 32
    out.append(_try(lambda: c.add_block(blk2)))
    blk3 = _mk(L, c)
    blk3.prev_hash = b"\x01" * 32
    blk3.seal()
    out.append(_try(lambda: c.add_block(blk3)))
    return out + [len(c)]


def sc_same_height_quality(L):
    c = L.Chain(num_params=8, num_nodes=4)
    prev = c.latest_hash()
    empty = _empty(L, c)
    out = [c.consider_block(empty), c.latest.is_empty()]
    full = _at(L, c, prev)
    out += [c.consider_block(full), c.latest.is_empty(),
            c.consider_block(empty), _try(c.verify), c.dump()]
    return out


def sc_wrong_prev_hash(L):
    c = L.Chain(num_params=8, num_nodes=4)
    blk = _mk(L, c)
    blk.prev_hash = b"\xff" * 32
    blk.seal()
    return [c.consider_block(blk), len(c),
            L.Chain.block_quality(blk, c.latest_hash())]


def sc_longest_chain_adoption(L):
    a, b = L.Chain(num_params=8, num_nodes=4), L.Chain(num_params=8, num_nodes=4)
    for _ in range(3):
        a.add_block(_mk(L, a))
    return [b.maybe_adopt(a), b.dump() == a.dump(), a.maybe_adopt(b), b.dump()]


def sc_adoption_with_losing_fork_tip(L):
    a, b = L.Chain(num_params=8, num_nodes=4), L.Chain(num_params=8, num_nodes=4)
    shared = _mk(L, a)
    a.add_block(shared)
    b.add_block(shared)
    b.add_block(_mk(L, b, tag=9.0))
    a.add_block(_mk(L, a, tag=2.0))
    a.add_block(_mk(L, a, tag=3.0))
    return [b.maybe_adopt(a), b.dump()]


def sc_tampered_next_height(L):
    c = L.Chain(num_params=4, num_nodes=2)
    blk = _mk(L, c, d=4, ndeltas=1)
    blk.hash = b"\xab" * 32
    return [c.consider_block(blk), len(c)]


def sc_tampered_same_height(L):
    c = L.Chain(num_params=4, num_nodes=2)
    c.consider_block(_empty(L, c))
    forged = L.Block(data=L.BlockData(iteration=0, global_w=np.ones(4),
                                      deltas=[L.Update(0, 0, np.ones(4))]),
                     prev_hash=c.blocks[-2].hash,
                     stake_map=c.latest_stake_map()).seal()
    forged.data.global_w = np.full(4, 666.0)  # mutated after the seal
    return [c.consider_block(forged), _try(c.verify), c.dump()]


def sc_empty_padded_chain_not_adopted(L):
    honest = L.Chain(num_params=4, num_nodes=2)
    for _ in range(2):
        honest.add_block(_mk(L, honest, d=4, ndeltas=1))
    evil = L.Chain(num_params=4, num_nodes=2)
    evil.add_block(_mk(L, evil, d=4, ndeltas=1, tag=5.0))
    for _ in range(4):
        evil.add_block(_mk(L, evil, d=4, ndeltas=0))
    return [_try(evil.verify), honest.maybe_adopt(evil),
            honest.maybe_adopt(honest), evil.adoption_key(),
            honest.adoption_key()]


def sc_heavier_chain_adopted(L):
    minority = L.Chain(num_params=4, num_nodes=2)
    minority.add_block(_mk(L, minority, d=4, ndeltas=1, tag=7.0))
    majority = L.Chain(num_params=4, num_nodes=2)
    for _ in range(3):
        majority.add_block(_mk(L, majority, d=4, ndeltas=2))
    adopted = minority.maybe_adopt(majority)
    majority.blocks[1].data.global_w[:] = 666.0  # isolated copies
    return [adopted, minority.dump(), _try(minority.verify)]


def sc_forged_genesis(L):
    fresh = L.Chain(num_params=4, num_nodes=2)
    evil = L.Chain(num_params=4, num_nodes=2, default_stake=10**6)
    for _ in range(2):
        evil.add_block(_mk(L, evil, d=4, ndeltas=1))
    return [_try(evil.verify), fresh.maybe_adopt(evil), len(fresh)]


def sc_forged_longer_chain(L):
    honest = L.Chain(num_params=4, num_nodes=2)
    evil = L.Chain(num_params=4, num_nodes=2)
    for _ in range(3):
        evil.add_block(_mk(L, evil, d=4, ndeltas=1))
    evil.blocks[2].stake_map = {0: 10**9, 1: 0}
    out = [_try(evil.verify), honest.maybe_adopt(evil), len(honest)]
    good = L.Chain(num_params=4, num_nodes=2)
    for _ in range(3):
        good.add_block(_mk(L, good, d=4, ndeltas=1))
    return out + [honest.maybe_adopt(good), honest.dump()]


def sc_verify_errors(L):
    out = []
    for fault in ("iteration", "hash", "prev"):
        c = L.Chain(num_params=4, num_nodes=3)
        for _ in range(4):
            c.add_block(_mk(L, c, d=4))
        blk = c.blocks[2]
        if fault == "iteration":
            blk.data.iteration = 7
        elif fault == "hash":
            blk.data.global_w = blk.data.global_w + 1.0
        else:
            blk.prev_hash = b"\x07" * 32
            blk.seal()
        out.append(_try(c.verify))
    return out


def sc_pruned_suffix(L):
    full = L.Chain(num_params=4, num_nodes=3)
    for _ in range(6):
        full.add_block(_mk(L, full, d=4, ndeltas=1))
    snap = L.Chain(num_params=4, num_nodes=3)
    snap.blocks = [snap.blocks[0]] + full.blocks[4:]
    snap.pruned_before, snap.pruned_weight = 3, 3
    fresh = L.Chain(num_params=4, num_nodes=3)
    return [_try(snap.verify), snap.dump(), snap.adoption_key(),
            snap.get_block(-1).hash, snap.get_block(1), snap.get_block(4).hash,
            fresh.maybe_adopt(snap), fresh.dump(), full.maybe_adopt(snap)]


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_genesis, sc_hash_covers_contents, sc_append_and_invariants,
    sc_append_rejects_bad_iteration_and_hash, sc_same_height_quality,
    sc_wrong_prev_hash, sc_longest_chain_adoption,
    sc_adoption_with_losing_fork_tip, sc_tampered_next_height,
    sc_tampered_same_height, sc_empty_padded_chain_not_adopted,
    sc_heavier_chain_adopted, sc_forged_genesis, sc_forged_longer_chain,
    sc_verify_errors, sc_pruned_suffix)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_chain_scenario_equals_reference(name):
    ref, port = SCENARIOS[name](REF), SCENARIOS[name](PORT)
    assert port == ref


def test_scenarios_raise_chain_invariant_errors():
    # the raising cases are the reference's ChainInvariantError, not noise
    for name in ("append_rejects_bad_iteration_and_hash", "verify_errors"):
        for obs in SCENARIOS[name](PORT)[:3]:
            assert obs[:2] == ("raise", "ChainInvariantError"), obs


# ----------------------------------------------- canonical bytes, hashes


def _updates(L, seed):
    """Seeded updates: bare, with noise and its noised copy, with
    signatures and signers, accepted or not."""
    rng = np.random.default_rng(seed)
    d = 13
    out = []
    for j in range(4):
        delta = rng.normal(size=d)
        kw = {}
        if j % 2:
            noise = rng.normal(size=d)
            kw.update(noise=noise, noised_delta=delta + noise)
        if j >= 2:
            kw.update(signatures=[rng.bytes(64) for _ in range(j)],
                      signers=[int(s) for s in rng.integers(0, 50, j)])
        out.append(L.Update(source_id=int(rng.integers(100)), iteration=j,
                            delta=delta, commitment=rng.bytes(32),
                            accepted=bool(j % 3), **kw))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_canonical_bytes_equal_reference(seed):
    for r, p in zip(_updates(REF, seed), _updates(PORT, seed)):
        assert p.canonical_bytes() == r.canonical_bytes()


@pytest.mark.parametrize("kind", ["float64", "float32", "torch32", "torch64"])
def test_block_bytes_and_hash_equal_reference(kind):
    """The port's block takes a float32 or float64 array or a torch tensor
    (as a model comes off the card) and hashes it as the reference hashes
    the float64 view of the same values."""
    w32 = np.random.default_rng(5).normal(size=33).astype(np.float32)
    w = {"float64": w32.astype(np.float64), "float32": w32,
         "torch32": torch.from_numpy(w32),
         "torch64": torch.from_numpy(w32.astype(np.float64))}[kind]
    rdata = REF.BlockData(iteration=4, global_w=w32.astype(np.float64),
                          deltas=_updates(REF, 3))
    pdata = PORT.BlockData(iteration=4, global_w=w, deltas=_updates(PORT, 3))
    assert pdata.canonical_bytes() == rdata.canonical_bytes()
    stake = {i: 10 + i for i in (3, 0, 2, 1)}
    rb = REF.Block(data=rdata, prev_hash=b"\x11" * 32, stake_map=stake).seal()
    pb = PORT.Block(data=pdata, prev_hash=b"\x11" * 32, stake_map=stake).seal()
    assert pb.hash == rb.hash and pb.summary() == rb.summary()


def test_torch_model_chain_dumps_like_reference():
    """A chain whose blocks carry torch models dumps and verifies like the
    reference chain of their float64 values."""
    rng = np.random.default_rng(9)
    rc, pc = REF.Chain(num_params=6, num_nodes=3), PORT.Chain(num_params=6,
                                                              num_nodes=3)
    for it in range(3):
        w32 = rng.normal(size=6).astype(np.float32)
        for L, c, w in ((REF, rc, w32.astype(np.float64)),
                        (PORT, pc, torch.from_numpy(w32))):
            c.consider_block(L.Block(
                data=L.BlockData(iteration=it, global_w=w),
                prev_hash=c.latest_hash(), stake_map={0: it}).seal())
    pc.verify()
    assert pc.dump() == rc.dump() and len(pc) == 4


# ----------------------------------------------------------- checkpoints


def _chain(L, n_blocks=4, pruned=False):
    c = L.Chain(num_params=5, num_nodes=3)
    rng = np.random.default_rng(11)
    for it in range(n_blocks):
        ups = _updates(L, it)
        for u in ups:
            u.delta = rng.normal(size=5)
            if u.noise is not None:
                u.noise = rng.normal(size=5)
                u.noised_delta = u.delta + u.noise
        c.add_block(L.Block(data=L.BlockData(
            iteration=it, global_w=c.latest_gradient() + rng.normal(size=5),
            deltas=ups), prev_hash=c.latest_hash(),
            stake_map={i: 10 + it for i in range(3)}).seal())
    if pruned:
        c.blocks = [c.blocks[0]] + c.blocks[3:]
        c.pruned_before, c.pruned_weight = 2, 2
    return c


@pytest.mark.parametrize("pruned", [False, True])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_checkpoint_crosses_packages(tmp_path, direction, pruned):
    save_l, load_l = (REF, PORT) if direction == "ref_to_port" else (PORT, REF)
    chain = _chain(save_l, pruned=pruned)
    other = _chain(load_l, pruned=pruned)
    path = save_l.ckpt.save(chain, str(tmp_path / "a"))
    twin = load_l.ckpt.save(other, str(tmp_path / "b"))
    with open(os.path.join(path, "manifest.json"), "rb") as f, \
            open(os.path.join(twin, "manifest.json"), "rb") as g:
        assert f.read() == g.read()
    with np.load(os.path.join(path, "blocks.npz")) as a, \
            np.load(os.path.join(twin, "blocks.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    loaded = load_l.ckpt.load(str(tmp_path / "a"))
    assert isinstance(loaded, load_l.Chain)
    assert loaded.dump() == chain.dump() == other.dump()
    assert [b.hash for b in loaded.blocks] == [b.hash for b in chain.blocks]
    assert (loaded.pruned_before, loaded.pruned_weight) == \
        (chain.pruned_before, chain.pruned_weight)


def test_checkpoint_steps_prune_and_corrupt_snapshots_equal_reference(tmp_path):
    out = {}
    for tag, L in (("ref", REF), ("port", PORT)):
        d = str(tmp_path / tag)
        c = L.Chain(num_params=5, num_nodes=3)
        for it in range(5):
            c.add_block(_mk(L, c, d=5, ndeltas=1))
            L.ckpt.save(c, d)
        steps = L.ckpt.list_steps(d)
        with open(os.path.join(d, "step_4", "manifest.json")) as f:
            m = json.load(f)
        m["blocks"][2]["hash"] = "00" * 32  # a tampered snapshot
        with open(os.path.join(d, "step_4", "manifest.json"), "w") as f:
            json.dump(m, f)
        report = []
        newest = L.ckpt.load(d, report=report)
        strict = _try(lambda: L.ckpt.load(d, step=4))
        L.ckpt.prune(d, keep=2)
        out[tag] = [steps, report, newest.dump(), strict,
                    L.ckpt.list_steps(d), _try(lambda: L.ckpt.load(
                        str(tmp_path / "none")))]
    out["ref"][-1] = out["ref"][-1][:2]  # the messages name each directory
    out["port"][-1] = out["port"][-1][:2]
    assert out["port"] == out["ref"]
    assert out["port"][0] == [0, 1, 2, 3, 4] and out["port"][4] == [3, 4]
