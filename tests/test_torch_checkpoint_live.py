"""Twins of `tests/test_checkpoint.py`'s torn snapshots on the port's
peer: an agent whose newest snapshot is torn and whose next one holds a
model of other dims restores the older intact one, and an agent pointed
at snapshots torn three ways starts from genesis instead of crashing.

Each package writes the snapshots with its own `utils.checkpoint` and
ledger, and its agent restores them; the port's agent also restores the
reference's snapshot directory, since the two write the same files. The
restored chains are the same chain in both packages. The one-peer FedSys
run that follows the torn snapshots is plain mode, held to its round-0
block, the rejected ids and the stake rule (ROADMAP C10).

Ports are 21700-21799, which no other test file uses."""

import asyncio
import json
import os

import numpy as np

from torch_twins import (PACKAGES, PORT, REF, agent,
                         assert_first_block_parity)

# the reference file's windows (test_checkpoint.py:105)
FAST = dict(update_s=2.0, block_s=8.0, krum_s=2.0, share_s=2.0, rpc_s=3.0)


def _chain_with_block(pkg, n_blocks, dims):
    """The reference file's `_chain_with_block` on `pkg`'s ledger."""
    chain = pkg.chain.Blockchain(dims, num_nodes=3, default_stake=10)
    rng = np.random.default_rng(0)
    for it in range(n_blocks):
        delta = rng.normal(size=dims)
        u = pkg.block.Update(source_id=1, iteration=it, delta=delta,
                             commitment=b"\x01" * 32, accepted=True,
                             signatures=[b"\x02" * 64])
        chain.add_block(pkg.block.Block(
            data=pkg.block.BlockData(iteration=it,
                                     global_w=chain.latest_gradient() + delta,
                                     deltas=[u]),
            prev_hash=chain.latest_hash(),
            stake_map={0: 10, 1: 15, 2: 10}).seal())
    return chain


def _agent(pkg, port, cdir, draws=None, **kw):
    c = pkg.config.BiscottiConfig(timeouts=pkg.config.Timeouts(**FAST),
                                  dataset="creditcard", node_id=0,
                                  secure_agg=False, noising=False,
                                  verification=False, fedsys=True,
                                  base_port=port, **kw)
    return agent(pkg, c, draws=draws, ckpt_dir=str(cdir))


def _torn_newest(pkg, cdir, dims):
    """A valid snapshot at step 1, a torn one at step 9 and a valid one
    of other model dims at step 5, written by `pkg`."""
    pkg.checkpoint.save(_chain_with_block(pkg, 2, dims), str(cdir))
    os.makedirs(cdir / "step_9")
    (cdir / "step_9" / "manifest.json").write_text("torn")
    pkg.checkpoint.save(_chain_with_block(pkg, 4, 3), str(cdir), step=5)


def _restore_only(a):
    async def go():
        # run the restore logic only: converged at once, no rounds
        a.converged = True
        return await a.run()

    asyncio.run(go())


def test_corrupt_newest_falls_back_to_older_snapshot(tmp_path):
    dumps = {}
    for k, (writer, reader) in enumerate(((REF, REF), (PORT, PORT),
                                          (REF, PORT))):
        cdir = tmp_path / f"{writer.name}-{reader.name}" / "node_0"
        a = _agent(reader, 21700 + 10 * k, cdir, num_nodes=3,
                   max_iterations=2)
        _torn_newest(writer, cdir, a.trainer.num_params)
        assert len(a.chain.blocks) == 1
        _restore_only(a)
        # from step_1, not genesis or step_5
        assert a.chain.latest.iteration == 1
        dumps[(writer.name, reader.name)] = a.chain.dump()
    assert len(set(dumps.values())) == 1, dumps
    # the two packages' snapshot manifests are the same file
    texts = {open(tmp_path / f"{p.name}-{p.name}" / "node_0" / "step_1"
                  / "manifest.json").read() for p in PACKAGES}
    assert len(texts) == 1


def _torn_three_ways(cdir):
    """The reference test's snapshots: garbage npz, garbage manifest,
    valid JSON of the wrong structure (no package writes these)."""
    os.makedirs(cdir / "step_0")
    with open(cdir / "step_0" / "manifest.json", "w") as f:
        json.dump({"version": 1, "num_blocks": 0, "blocks": []}, f)
    np.savez(cdir / "step_0" / "blocks.npz")  # loads fine, empty chain
    os.makedirs(cdir / "step_1")
    with open(cdir / "step_1" / "manifest.json", "w") as f:
        json.dump({"version": 1, "num_blocks": 1, "blocks": None}, f)
    os.makedirs(cdir / "step_2")
    with open(cdir / "step_2" / "manifest.json", "w") as f:
        f.write("{not json")
    os.makedirs(cdir / "step_3")
    with open(cdir / "step_3" / "manifest.json", "w") as f:
        json.dump({"version": 1, "num_blocks": 1,
                   "blocks": [{"iteration": -1, "prev_hash": "00",
                               "hash": "00", "deltas": []}]}, f)
    with open(cdir / "step_3" / "blocks.npz", "wb") as f:
        f.write(b"this is not a zip archive")


def test_peer_survives_corrupt_checkpoint(tmp_path):
    agents, draws = {}, None
    for k, pkg in enumerate(PACKAGES):
        cdir = tmp_path / pkg.name / "node_0"
        _torn_three_ways(cdir)
        a = _agent(pkg, 21740 + 10 * k, cdir, draws, num_nodes=1,
                   max_iterations=1)
        result = asyncio.run(a.run())
        assert result["iterations"] >= 1  # ran from genesis, no crash
        agents[pkg.name] = a
        draws = {0: a.trainer}
    assert_first_block_parity(agents["reference"], agents["port"])
