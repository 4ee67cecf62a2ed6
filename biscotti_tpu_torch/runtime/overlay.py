# The port's own copy of biscotti_tpu/runtime/overlay.py: torch-free, and it imports nothing of biscotti_tpu.
"""Hierarchical aggregation overlay: the wire plane's O(N) -> O(log N)
cross-host traffic tree (docs/OVERLAY.md).

The hive runtime broke the single-box scale wall, which moved the live
frontier onto bandwidth: gossip and share fan-out are flat — every peer
talks to a constant fraction of the cluster — so bytes/round grows O(N)
while device time is milliseconds. This module derives a deterministic,
seed-derived aggregation tree per round:

  * **leaves** are peers;
  * the **first interior level** is the hive host itself — peers are
    grouped into contiguous id blocks of `cfg.overlay_group`, matching
    the `pod_launch --peers-per-host` layout, so the leaf -> interior hop
    is loopback (nearly free) on a co-hosted deployment;
  * the **root** is the round's elected miner set (the leader mints).

Each group elects one RELAY per round — a pure function of
(seed, iteration, group), so every peer derives the same tree with no
coordination and the relay duty rotates instead of pinning one peer hot.
Interior nodes are ordinary untrusted peers: their admission plans class
relay/aggregate frames as bulk (a hot interior node sheds, it doesn't
melt), and a missing relay degrades to the seed's direct delivery for
its orphaned subtree within the round (the sender falls back on the
first transport failure).

What flows through the tree:

  * secure-agg share fan-out — workers offer their full share/blind/
    commitment tensors to the relay (`OverlayOffer`); the relay sums the
    share rows, sums the blind rows mod q, and homomorphically sums the
    Pedersen commitment grids (crypto/commitments.sum_commitment_grids),
    then sends ONE `RegisterAggregate` per miner; the miner verifies the
    whole subtree against the summed commitment in one RLC check
    (vss_verify_multi, single instance = exact) and falls back to the
    per-update path for exact rejection evidence when it fails;
  * plain-mode update fan-out and the minted-block broadcast — relayed
    verbatim (`RelayFrames`): content is untouched (chains stay
    bit-identical), but a frame crosses TCP once per remote subtree
    instead of once per remote peer.

Per-update verification traffic (Krum/FoolsGold/RONI evidence, verifier
signature quorums, stake debits) stays point-to-point and unaggregated,
so the VERDICT plane is unchanged by construction.

KNOWN RESIDUAL (docs/OVERLAY.md §trust-model): the miner verifies a
subtree against the relay-supplied summed grid; the per-member digest
binding (vss_digest(comms) == signed commitment) is enforceable only
where per-member grids exist — at the relay, not the root. A Byzantine
RELAY can therefore substitute a self-consistent aggregate for its own
subtree while reusing the members' genuine signed metadata. In the
deployed shape this adds no power — the interior level is the members'
own hive host, which already computes their SGD and holds their key
streams — and that is exactly why aggregation is restricted to a
worker's OWN group. Operators forming groups across trust domains are
choosing to trust the rotating relay with its subtree's round
contribution (never with stake, identity, or the verdict plane).

`cfg.overlay` defaults OFF: the disabled configuration produces the
seed's flat fan-out bit-for-bit (every overlay path is gated at the send
site; tests/test_overlay.py guards this).
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

# wire frame types the overlay adds (classed `bulk` by the admission
# plane, runtime/admission.py)
OFFER = "OverlayOffer"
AGGREGATE = "RegisterAggregate"
RELAY = "RelayFrames"

# telemetry (docs/OBSERVABILITY.md §overlay)
DEPTH_GAUGE = "biscotti_overlay_tree_depth"
DEPTH_HELP = "levels in the round's aggregation tree (1 = flat fan-out)"
SUBTREE_GAUGE = "biscotti_overlay_subtree_size"
SUBTREE_HELP = "peers in this peer's overlay subtree (its relay group)"
SAVED_METRIC = "biscotti_overlay_bytes_saved_total"
SAVED_HELP = ("estimated cross-host bytes the overlay avoided "
              "(raw64-frame estimate of the deduplicated sends)")
FRAMES_METRIC = "biscotti_overlay_frames_total"
FRAMES_HELP = "overlay frames by kind (aggregated / relayed / fallback)"


def frame_estimate(meta, arrays) -> int:
    """Bytes this payload would cost as one raw64 frame (JSON header +
    raw array bytes + framing) — the bytes-saved accounting estimates
    avoided traffic the same way the hive's loopback accounting does."""
    n = 64
    try:
        n += len(json.dumps(meta or {}, separators=(",", ":"),
                            default=str))
    except (TypeError, ValueError):
        n += 256
    for a in (arrays or {}).values():
        n += np.asarray(a).nbytes
    return n


class Router:
    """Deterministic tree derivation + routing plans for one peer.

    Groups are contiguous id blocks of `group` peers (the pod_launch
    host layout); the per-round relay inside each group is
    members[H(seed, iteration, gid) % len] — every peer derives the
    identical tree from config alone. Inactive (enabled=False) when the
    overlay flag is off or the group size cannot form a subtree."""

    def __init__(self, overlay: bool, group: int, num_nodes: int,
                 seed: int):
        self.group = int(group)
        self.num_nodes = int(num_nodes)
        self.seed = int(seed)
        self.enabled = bool(overlay) and self.group >= 2
        # leaves -> host relays -> miner root when armed; flat otherwise
        self.depth = 3 if self.enabled else 1

    @classmethod
    def from_config(cls, cfg) -> "Router":
        return cls(cfg.overlay, cfg.overlay_group, cfg.num_nodes, cfg.seed)

    # ------------------------------------------------------- derivation

    def gid_of(self, pid: int) -> int:
        return int(pid) // self.group if self.group else 0

    def members(self, gid: int) -> List[int]:
        lo = gid * self.group
        return list(range(lo, min(lo + self.group, self.num_nodes)))

    def relay(self, gid: int, iteration: int) -> int:
        """The group's relay for `iteration` — seed-derived rotation, so
        the interior duty (and its bandwidth/CPU cost) moves every
        round instead of pinning one peer."""
        mem = self.members(gid)
        h = hashlib.sha256(
            f"biscotti-overlay|{self.seed}|{int(iteration)}|{gid}"
            .encode()).digest()
        return mem[int.from_bytes(h[:8], "little") % len(mem)]

    def my_relay(self, pid: int, iteration: int) -> int:
        return self.relay(self.gid_of(pid), iteration)

    # ---------------------------------------------------------- routing

    def plan(self, targets: Sequence[int], iteration: int,
             self_id: int) -> Tuple[List[int], Dict[int, List[int]]]:
        """Split a fan-out target list into (direct, {relay: targets}).

        A subtree is relayed only when it actually deduplicates traffic
        (>= 2 targets inside it) and the relay is a third party — the
        sender's own group is always direct (those links are loopback or
        same-host already), as is a group whose relay IS the sender."""
        direct: List[int] = []
        relayed: Dict[int, List[int]] = {}
        if not self.enabled:
            return list(targets), relayed
        by_gid: Dict[int, List[int]] = {}
        for t in targets:
            by_gid.setdefault(self.gid_of(t), []).append(int(t))
        my_gid = self.gid_of(self_id)
        for gid, ts in sorted(by_gid.items()):
            if gid == my_gid or len(ts) < 2:
                direct.extend(ts)
                continue
            r = self.relay(gid, iteration)
            if r == self_id:
                direct.extend(ts)
            else:
                relayed.setdefault(r, []).extend(ts)
        return direct, relayed
