"""The port's copy of `biscotti_tpu/runtime/wire.py`.

Block/Update <-> wire conversion for the runtime codec.

The reference gob-encodes its structs directly (ref: DistSys/main.go:609-610);
our codec separates JSON metadata from raw array payloads, so blocks and
updates need explicit packers. All byte fields travel as hex in metadata.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from biscotti_tpu_torch.ledger.block import Block, BlockData, Update


def _as_f64(a: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """float64 view of a decoded payload, ZERO-COPY when the wire already
    delivered float64 (the common case: messages.decode hands back
    read-only views into the frame buffer, and an `asarray(..., f64)`
    on a differently-typed array is the only thing that should ever
    copy). Codec-decoded arrays (runtime/codecs.py) arrive as float64
    already, so coded frames stay on the no-copy path too."""
    if a is None:
        return None
    a = np.asarray(a)
    return a if a.dtype == np.float64 else a.astype(np.float64)


def pack_update(u: Update, prefix: str = "u") -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    meta = {
        "source_id": u.source_id,
        "iteration": u.iteration,
        "commitment": u.commitment.hex(),
        "accepted": u.accepted,
        "signatures": [s.hex() for s in u.signatures],
        "signers": list(u.signers),
        "has_noise": u.noise is not None,
        "has_noised": u.noised_delta is not None,
    }
    arrays = {f"{prefix}.delta": u.delta}
    if u.noise is not None:
        arrays[f"{prefix}.noise"] = u.noise
    if u.noised_delta is not None:
        arrays[f"{prefix}.noised"] = u.noised_delta
    return meta, arrays


def unpack_update(meta: Dict[str, Any], arrays: Dict[str, np.ndarray],
                  prefix: str = "u") -> Update:
    return Update(
        source_id=int(meta["source_id"]),
        iteration=int(meta["iteration"]),
        delta=_as_f64(arrays[f"{prefix}.delta"]),
        commitment=bytes.fromhex(meta.get("commitment", "")),
        noise=_as_f64(arrays[f"{prefix}.noise"])
        if meta.get("has_noise") else None,
        noised_delta=_as_f64(arrays[f"{prefix}.noised"])
        if meta.get("has_noised") else None,
        accepted=bool(meta.get("accepted", False)),
        signatures=[bytes.fromhex(s) for s in meta.get("signatures", [])],
        signers=[int(s) for s in meta.get("signers", [])],
    )


def pack_block(blk: Block) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    metas: List[Dict[str, Any]] = []
    arrays: Dict[str, np.ndarray] = {"global_w": blk.data.global_w}
    for i, u in enumerate(blk.data.deltas):
        m, a = pack_update(u, prefix=f"d{i}")
        metas.append(m)
        arrays.update(a)
    meta = {
        "iteration": blk.data.iteration,
        "prev_hash": blk.prev_hash.hex(),
        "hash": blk.hash.hex(),
        "timestamp": blk.timestamp,
        "stake_map": {str(k): v for k, v in blk.stake_map.items()},
        "deltas": metas,
    }
    return meta, arrays


def unpack_block(meta: Dict[str, Any], arrays: Dict[str, np.ndarray]) -> Block:
    deltas = [
        unpack_update(m, arrays, prefix=f"d{i}")
        for i, m in enumerate(meta.get("deltas", []))
    ]
    blk = Block(
        data=BlockData(
            iteration=int(meta["iteration"]),
            global_w=_as_f64(arrays["global_w"]),
            deltas=deltas,
        ),
        prev_hash=bytes.fromhex(meta["prev_hash"]),
        stake_map={int(k): int(v) for k, v in meta.get("stake_map", {}).items()},
        timestamp=int(meta.get("timestamp", 0)),
    )
    blk.hash = bytes.fromhex(meta.get("hash", ""))
    return blk


def pack_chain(blocks: List[Block]) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    metas = []
    arrays: Dict[str, np.ndarray] = {}
    for i, blk in enumerate(blocks):
        m, a = pack_block(blk)
        metas.append(m)
        arrays.update({f"b{i}.{k}": v for k, v in a.items()})
    return {"blocks": metas}, arrays


def unpack_chain(meta: Dict[str, Any], arrays: Dict[str, np.ndarray]) -> List[Block]:
    out = []
    for i, m in enumerate(meta.get("blocks", [])):
        sub = {k[len(f"b{i}."):]: v for k, v in arrays.items()
               if k.startswith(f"b{i}.")}
        out.append(unpack_block(m, sub))
    return out
