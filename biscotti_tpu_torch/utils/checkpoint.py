"""The port's copy of `biscotti_tpu/utils/checkpoint.py`: the same on-disk
format, so a chain saved by either package loads in the other.

Chain + model checkpointing.

The reference's only checkpoint is the blockchain itself — every block
carries the full model, resume = fetch the chain from any peer
(ref: SURVEY.md §5.4; DistSys/blockData.go:10-14, main.go:431-433,
blockchain.go:31-37). It keeps nothing on disk, so a full-network restart
loses all progress.

This module adds what the reference lacks: periodic on-disk snapshots of the
whole chain (and therefore the model), so a cold-started network resumes
from the last sealed height instead of genesis. Format is
orbax-checkpoint-compatible in spirit (a directory per step, atomic rename
commit) but self-contained: one .npz per block plus a JSON manifest — no
dependency on orbax's async machinery for host-side control-plane state.
Snapshots are verified on load (`Blockchain.verify`) so a tampered or
torn checkpoint is refused, never adopted.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np

from biscotti_tpu_torch.ledger.block import Block, BlockData, Update
from biscotti_tpu_torch.ledger.chain import Blockchain, ChainInvariantError


def _block_to_npz_dict(blk: Block, idx: int) -> Dict[str, np.ndarray]:
    # Every field covered by Block.compute_hash must round-trip, or the
    # reloaded chain fails its own hash verification: noise/noised_delta are
    # hashed via Update.canonical_bytes, so they are persisted too (None is
    # encoded by key absence).
    out = {f"b{idx}.global_w": blk.data.global_w}
    for j, u in enumerate(blk.data.deltas):
        out[f"b{idx}.d{j}.delta"] = u.delta
        if u.noise is not None:
            out[f"b{idx}.d{j}.noise"] = u.noise
        if u.noised_delta is not None:
            out[f"b{idx}.d{j}.noised_delta"] = u.noised_delta
    return out


def _block_meta(blk: Block) -> Dict:
    return {
        "iteration": blk.data.iteration,
        "prev_hash": blk.prev_hash.hex(),
        "hash": blk.hash.hex(),
        "timestamp": blk.timestamp,
        "stake_map": {str(k): v for k, v in blk.stake_map.items()},
        "deltas": [
            {
                "source_id": u.source_id,
                "iteration": u.iteration,
                "commitment": u.commitment.hex(),
                "accepted": u.accepted,
                "signatures": [s.hex() for s in u.signatures],
                "signers": list(u.signers),
            }
            for u in blk.data.deltas
        ],
    }


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platforms that refuse O_RDONLY on dirs: rename is still atomic
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(chain: Blockchain, directory: str, step: Optional[int] = None) -> str:
    """Durably + atomically write a snapshot of the full chain; returns the
    snapshot path. Layout: <dir>/step_<height>/{manifest.json, blocks.npz}.

    Write protocol: everything lands in a temp dir first, every file is
    fsync'd, then ONE rename commits the step and the parent directory is
    fsync'd. A peer killed at ANY instant — mid-.npz write, mid-rename,
    before the dir entry is durable — therefore leaves either the complete
    committed step or no step at all; it can never leave a truncated
    blocks.npz under the committed name that poisons its own rejoin
    (docs/MEMBERSHIP.md §rejoin)."""
    step = chain.latest.iteration if step is None else step
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory)
    try:
        arrays: Dict[str, np.ndarray] = {}
        metas: List[Dict] = []
        for i, blk in enumerate(chain.blocks):
            arrays.update(_block_to_npz_dict(blk, i))
            metas.append(_block_meta(blk))
        np.savez_compressed(os.path.join(tmp, "blocks.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            # pruned-chain state must round-trip: a snapshot-bootstrapped
            # peer's chain has a deliberate gap below pruned_before, and a
            # checkpoint that dropped it would fail its own verify() on
            # reload (poisoning every rejoin-from-checkpoint). Absent keys
            # default to 0 — old checkpoints stay loadable.
            json.dump({"version": 1, "num_blocks": len(chain.blocks),
                       "pruned_before": chain.pruned_before,
                       "pruned_weight": chain.pruned_weight,
                       "blocks": metas}, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_file(os.path.join(tmp, "blocks.npz"))
        _fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit (same filesystem)
        _fsync_dir(directory)  # make the committed name itself durable
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                continue
    return sorted(out)


def load(directory: str, step: Optional[int] = None,
         report: Optional[List] = None) -> Blockchain:
    """Load and VERIFY a snapshot; raises FileNotFoundError when no
    snapshot exists.

    step=None: walk steps NEWEST first, SKIP any corrupt one — bad zip,
    bad JSON, structurally wrong manifest, failed chain verify — and
    return the newest intact snapshot; each skip is recorded in `report`
    (a caller-supplied list receiving (step, \"reason\") tuples) so a
    caller can trace what was refused instead of crashing on it. Only
    when EVERY step is corrupt does the last error propagate (a dir
    holding nothing but garbage still fails loudly). Note PeerAgent.run's
    rejoin walks steps itself (via list_steps + explicit-step loads)
    because it interleaves per-step quorum/adoption checks this module
    cannot know about — this walk is for every OTHER consumer (tools,
    tests, offline inspection) so the skip policy lives in one place.

    An explicit `step` stays STRICT — tampering with a named snapshot
    raises (ChainInvariantError etc.), it is never silently skipped."""
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    if step is None:
        last_err: Optional[BaseException] = None
        for s in reversed(steps):
            try:
                return _load_step(directory, s)
            except Exception as e:
                last_err = e
                if report is not None:
                    report.append((s, f"{type(e).__name__}: {e}"))
        assert last_err is not None
        raise last_err
    return _load_step(directory, step)


def _load_step(directory: str, step: int) -> Blockchain:
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = np.load(os.path.join(path, "blocks.npz"))
    blocks: List[Block] = []
    for i, meta in enumerate(manifest["blocks"]):
        deltas = []
        for j, d in enumerate(meta["deltas"]):
            key = f"b{i}.d{j}.delta"
            nkey = f"b{i}.d{j}.noise"
            ndkey = f"b{i}.d{j}.noised_delta"
            deltas.append(Update(
                source_id=int(d["source_id"]),
                iteration=int(d["iteration"]),
                delta=np.asarray(arrays[key], np.float64)
                if key in arrays else np.zeros(0, np.float64),
                commitment=bytes.fromhex(d.get("commitment", "")),
                noise=np.asarray(arrays[nkey], np.float64)
                if nkey in arrays else None,
                noised_delta=np.asarray(arrays[ndkey], np.float64)
                if ndkey in arrays else None,
                accepted=bool(d.get("accepted", False)),
                signatures=[bytes.fromhex(s) for s in d.get("signatures", [])],
                signers=[int(s) for s in d.get("signers", [])],
            ))
        blk = Block(
            data=BlockData(iteration=int(meta["iteration"]),
                           global_w=np.asarray(arrays[f"b{i}.global_w"],
                                               np.float64),
                           deltas=deltas),
            prev_hash=bytes.fromhex(meta["prev_hash"]),
            stake_map={int(k): int(v)
                       for k, v in meta.get("stake_map", {}).items()},
            timestamp=int(meta.get("timestamp", 0)),
        )
        blk.hash = bytes.fromhex(meta["hash"])
        blocks.append(blk)
    chain = Blockchain.__new__(Blockchain)
    chain.blocks = blocks
    chain.pruned_before = int(manifest.get("pruned_before", 0))
    chain.pruned_weight = int(manifest.get("pruned_weight", 0))
    chain.verify()  # refuse tampered/torn snapshots
    return chain


def prune(directory: str, keep: int = 3) -> None:
    """Drop all but the newest `keep` snapshots."""
    steps = list_steps(directory)
    for s in steps[:-keep] if keep > 0 else steps:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)
