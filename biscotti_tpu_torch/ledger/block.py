"""The port's copy of `biscotti_tpu/ledger/block.py`: the same canonical
bytes and hashes, and `_pack_f64` also takes a torch tensor on any device.

Ledger data model: Update, BlockData, Block.

Capability parity with the reference's in-memory chain records
(ref: DistSys/update.go:13-22, DistSys/blockData.go, DistSys/block.go).
The reference hashes gob-encoded structs (ref: DistSys/block.go:23-28);
gob is Go-specific, so we define our own *canonical byte serialization*
(little-endian lengths + raw float64 buffers) and SHA-256 over that. The
serialization is deterministic across processes, which is what the
chain-equality oracle (ref: DistSys/localTest.sh:40-96) requires.

Weights live here as float64 numpy arrays: the ledger is host-side control
plane; device math gets views of these buffers and never mutates them.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


def _f64(vec) -> np.ndarray:
    """A contiguous float64 numpy copy or view of `vec`; a torch tensor on
    any device is taken off it first, so a float32 model from the card
    hashes like the reference's float64 view of the same values."""
    if isinstance(vec, torch.Tensor):
        vec = vec.detach().to("cpu", torch.float64).numpy()
    return np.ascontiguousarray(np.asarray(vec, dtype=np.float64))


def _pack_f64(vec) -> bytes:
    if vec is None:
        return struct.pack("<q", -1)
    a = _f64(vec)
    return struct.pack("<q", a.size) + a.tobytes()


def _pack_bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack("<q", -1)
    return struct.pack("<q", len(b)) + b


@dataclass
class Update:
    """The wire unit of learning (ref: DistSys/update.go:13-22)."""

    source_id: int
    iteration: int
    delta: np.ndarray  # raw local gradient delta, float64[d]
    commitment: bytes = b""  # Pedersen commitment to quantized delta
    noise: Optional[np.ndarray] = None  # committee-averaged DP noise
    noised_delta: Optional[np.ndarray] = None  # delta + noise, sent to verifiers
    accepted: bool = False
    signatures: List[bytes] = field(default_factory=list)  # verifier Schnorr sigs
    # which verifier produced each signature — receivers verify each sig
    # against the claimed signer's public key (the reference ships bare
    # signature lists, update.go:21, and its miner-side check was disabled;
    # here the quorum check is enforced, so the binding must travel)
    signers: List[int] = field(default_factory=list)

    def canonical_bytes(self) -> bytes:
        out = [struct.pack("<qq?", self.source_id, self.iteration, self.accepted)]
        out.append(_pack_f64(self.delta))
        out.append(_pack_bytes(self.commitment))
        out.append(_pack_f64(self.noise))
        out.append(_pack_f64(self.noised_delta))
        out.append(struct.pack("<q", len(self.signatures)))
        out.extend(_pack_bytes(s) for s in self.signatures)
        out.append(struct.pack("<q", len(self.signers)))
        out.extend(struct.pack("<q", s) for s in self.signers)
        return b"".join(out)


@dataclass
class BlockData:
    """Per-iteration payload (ref: DistSys/blockData.go:10-14).

    Carries the *full* global model: the blockchain doubles as the
    checkpoint store (ref: SURVEY.md §5.4).
    """

    iteration: int
    global_w: np.ndarray  # float64[d], the model after this round's aggregation
    deltas: List[Update] = field(default_factory=list)

    def canonical_bytes(self) -> bytes:
        out = [struct.pack("<q", self.iteration), _pack_f64(self.global_w)]
        out.append(struct.pack("<q", len(self.deltas)))
        out.extend(u.canonical_bytes() for u in self.deltas)
        return b"".join(out)


@dataclass
class Block:
    """Hash-chained block (ref: DistSys/block.go:13-28) carrying the stake
    map adopted by all peers on append (ref: DistSys/main.go:1346-1349)."""

    data: BlockData
    prev_hash: bytes
    stake_map: Dict[int, int] = field(default_factory=dict)
    timestamp: int = 0  # fixed at 0 by default: hashes must be equal across peers
    hash: bytes = b""

    def compute_hash(self) -> bytes:
        h = hashlib.sha256()
        h.update(struct.pack("<q", self.timestamp))
        h.update(self.data.canonical_bytes())
        h.update(_pack_bytes(self.prev_hash))
        for k in sorted(self.stake_map):
            h.update(struct.pack("<qq", k, self.stake_map[k]))
        return h.digest()

    def seal(self) -> "Block":
        self.hash = self.compute_hash()
        return self

    @property
    def iteration(self) -> int:
        return self.data.iteration

    def is_empty(self) -> bool:
        """Empty blocks advance the round when a committee times out
        (ref: DistSys/main.go:2099-2143)."""
        return len(self.data.deltas) == 0

    def summary(self) -> str:
        """One-line digest used by the chain-equality oracle."""
        return (
            f"iter={self.iteration} ndeltas={len(self.data.deltas)} "
            f"hash={self.hash.hex()[:16]} prev={self.prev_hash.hex()[:16]} "
            f"|w|={float(np.linalg.norm(_f64(self.data.global_w))):.6f}"
        )


def genesis_block(num_params: int, num_nodes: int, default_stake: int) -> Block:
    """Genesis with zero weights (ref: DistSys/block.go:46-52) and the
    initial uniform stake map (ref: DistSys/main.go:39,714)."""
    data = BlockData(iteration=-1, global_w=np.zeros(num_params, dtype=np.float64))
    blk = Block(data=data, prev_hash=b"\x00" * 32,
                stake_map={i: default_stake for i in range(num_nodes)})
    return blk.seal()
