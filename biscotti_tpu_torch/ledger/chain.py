"""The port's copy of `biscotti_tpu/ledger/chain.py`, the same in behaviour.

In-memory hash chain with the reference's append/replace semantics.

Capability parity with DistSys/blockchain.go:
  * AddBlock / getBlock / getLatestGradient / getLatestBlockHash / PrintChain
    (ref: DistSys/blockchain.go:12-96)
  * structural invariant chain[i].iteration == i-1, enforced fatally
    (ref: DistSys/blockchain.go:77-96)
  * block-quality ordering — matching prev-hash first, then non-empty beats
    empty (ref: DistSys/honest.go:631-647) — and same-height replacement
    (ref: DistSys/honest.go:649-653)
  * longest-chain adoption for late joiners (ref: DistSys/main.go:1001-1013)

`dump()` is the chain-equality oracle: every peer prints its chain at exit
and all dumps must be byte-identical (ref: DistSys/localTest.sh:40-96).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np

from biscotti_tpu_torch.ledger.block import Block, genesis_block


class ChainInvariantError(RuntimeError):
    pass


class Blockchain:
    # Snapshot-bootstrap support (docs/MEMBERSHIP.md): a late joiner
    # adopting a chain SUFFIX holds [genesis] + blocks[pruned_before..head]
    # — the heights in [0, pruned_before) are absent by design (the whole
    # point of the snapshot is not fetching them). Class-level defaults so
    # instances built via __new__ (checkpoint.load, the announce path)
    # stay contiguous full chains with zero behavior change.
    pruned_before: int = 0
    # fork-choice weight CLAIMED for the pruned-away range (advisory, like
    # the join path's have_weight — over/underclaiming only affects which
    # chains this peer bothers adopting; adopted chains are verified)
    pruned_weight: int = 0

    def __init__(self, num_params: int, num_nodes: int, default_stake: int = 10):
        self.blocks: List[Block] = [genesis_block(num_params, num_nodes, default_stake)]

    # ------------------------------------------------------------- accessors

    def __len__(self) -> int:
        return len(self.blocks)

    @property
    def latest(self) -> Block:
        return self.blocks[-1]

    def get_block(self, iteration: int) -> Optional[Block]:
        if self.pruned_before:
            if iteration == -1:
                return self.blocks[0]
            if iteration < self.pruned_before:
                return None  # pruned away: the snapshot's whole purpose
            idx = iteration - self.pruned_before + 1
        else:
            idx = iteration + 1
        if 0 <= idx < len(self.blocks):
            return self.blocks[idx]
        return None

    def latest_gradient(self) -> np.ndarray:
        """Copy of the current global model (ref: blockchain.go:31-37)."""
        return self.latest.data.global_w.copy()

    def latest_hash(self) -> bytes:
        return self.latest.hash

    def latest_stake_map(self) -> Dict[int, int]:
        return dict(self.latest.stake_map)

    @property
    def next_iteration(self) -> int:
        return self.latest.iteration + 1

    # ------------------------------------------------------------- mutation

    def _check_links(self, blk: Block) -> None:
        if blk.iteration != self.latest.iteration + 1:
            raise ChainInvariantError(
                f"append iteration {blk.iteration} onto chain at {self.latest.iteration}"
            )
        if blk.prev_hash != self.latest.hash:
            raise ChainInvariantError("block prev-hash does not link to chain head")

    def add_block(self, blk: Block) -> None:
        """Append, enforcing chain[i].iteration == i-1 (ref: blockchain.go:77-96)."""
        self._check_links(blk)
        if blk.hash != blk.compute_hash():
            raise ChainInvariantError("block hash does not match contents")
        self.blocks.append(blk)

    @staticmethod
    def block_quality(blk: Block, prev_hash: bytes) -> int:
        """Ordering key: prev-hash match dominates, then non-empty beats empty
        (ref: DistSys/honest.go:631-647)."""
        return (2 if blk.prev_hash == prev_hash else 0) + (0 if blk.is_empty() else 1)

    def consider_block(self, blk: Block) -> bool:
        """Add / replace / ignore an incoming block for its height.

        Returns True if the chain changed. Same-height replacement keeps the
        higher-quality block (ref: honest.go:649-653); future blocks are the
        caller's problem (the runtime parks them, ref: main.go:1300-1320).
        """
        if blk.iteration == self.latest.iteration + 1:
            # tampered or unlinked network blocks are ignored, never raised:
            # a Byzantine peer must not be able to crash an honest one
            try:
                self.add_block(blk)
            except ChainInvariantError:
                return False
            return True
        if blk.iteration == self.latest.iteration and len(self.blocks) >= 2:
            if blk.hash != blk.compute_hash():
                return False
            # the head's true parent hash: equals blocks[-2].hash on a
            # contiguous chain (the append invariant), and stays correct
            # when blocks[-2] is genesis across a pruned gap
            prev = self.latest.prev_hash
            if self.block_quality(blk, prev) > self.block_quality(self.latest, prev):
                self.blocks[-1] = blk
                return True
        return False

    def adoption_key(self) -> tuple:
        """The fork-choice comparison key: (weight, length), weight =
        non-empty block count. A chain is adopted over another iff its key
        is strictly greater — the single source of truth shared by
        maybe_adopt and the join path's chain-omission gate. A pruned
        (snapshot-bootstrapped) chain counts its absent range via the
        snapshot's advisory weight claim plus the range's known length."""
        return (sum(1 for b in self.blocks if not b.is_empty())
                + self.pruned_weight,
                len(self.blocks) + self.pruned_before)

    def maybe_adopt(self, other: "Blockchain") -> bool:
        """Fork-choice adoption on (re)join (ref: main.go:1001-1013 adopts
        any longer chain blindly).

        Rule: WEIGHT (count of non-empty blocks) then LENGTH, from the same
        pinned genesis, structurally verified, deep-copied. Weight means a
        fabricated chain of free-to-seal empty filler can never displace
        real history. Weight itself is only unforgeable when the non-empty
        blocks' update records are authenticated — the ledger layer checks
        structure only, so the RUNTIME must (and does) verify each
        candidate block's verifier-signature quorums against the committees
        the candidate chain itself elects before calling this
        (PeerAgent._chain_quorums_ok); callers adopting from untrusted
        suppliers without that check inherit the reference's blind-adopt
        trust model.
        """
        # Fork choice on rejoin: WEIGHT-then-length, where weight = number
        # of non-empty blocks. The reference adopts any longer chain
        # blindly (main.go:1001-1013); pure length would let anyone
        # fabricate a long chain of empty timeout-filler (empty blocks are
        # free to seal) and wipe real history. Weighing non-empty blocks
        # means a partitioned minority that padded its chain with empties —
        # or even minted a minority-side real block — heals onto the
        # majority chain (which accumulated strictly more real rounds),
        # while an attacker must out-mint the honest network's real blocks
        # to rewrite anything. Genesis is pinned: a chain grown from a
        # forged genesis is refused outright.
        if not other.blocks or not self.blocks or \
                other.blocks[0].hash != self.blocks[0].hash:
            return False  # different genesis — refuse before any O(n) work
        if other.adoption_key() <= self.adoption_key():
            return False
        try:
            other.verify()
        except ChainInvariantError:
            return False
        self.blocks = copy.deepcopy(other.blocks)
        self.pruned_before = other.pruned_before
        self.pruned_weight = other.pruned_weight
        return True

    # ------------------------------------------------------------- oracle

    def dump(self) -> str:
        """Deterministic chain dump; byte-equality across peers is the
        top-level integration oracle (ref: DistSys/localTest.sh:40-96). A
        pruned chain interleaves an explicit gap marker so a
        snapshot-bootstrapped peer's dump is honest about what it never
        held (the churn oracle compares per-height `iter=` lines and
        skips the marker; runtime/membership.surviving_prefix_oracle)."""
        lines = [self.blocks[0].summary()]
        if self.pruned_before:
            lines.append(f"pruned heights=0..{self.pruned_before - 1} "
                         f"claimed_weight={self.pruned_weight}")
        lines.extend(b.summary() for b in self.blocks[1:])
        return "\n".join(lines)

    def verify(self) -> None:
        """Full structural re-check: hashes, links, iteration numbering.
        A pruned chain is allowed exactly ONE numbering/link gap — between
        genesis and the snapshot suffix's first block (whose prev_hash
        names a block deliberately not held); everything else is checked
        identically."""
        for i, b in enumerate(self.blocks):
            expect_iter = (i - 1 if not self.pruned_before or i == 0
                           else self.pruned_before + i - 1)
            if b.iteration != expect_iter:
                raise ChainInvariantError(f"block {i} has iteration {b.iteration}")
            if b.hash != b.compute_hash():
                raise ChainInvariantError(f"block {i} hash mismatch")
            if i > 0 and b.prev_hash != self.blocks[i - 1].hash \
                    and not (self.pruned_before and i == 1):
                raise ChainInvariantError(f"block {i} prev-hash mismatch")
