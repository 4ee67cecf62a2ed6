"""Stake-weighted role election — verifier/miner/noiser committees per round.

The port's copy of `biscotti_tpu/parallel/roles.py`, on the port's `vrf`:
committees, noiser draws and role maps equal the reference's.

Reference behavior (DistSys/vrf.go:54-182, main.go:497-565):
  * lottery tickets ∝ stake: node i appears stake[i] times in the ticket list
  * winners drawn from 2-byte big-endian windows of an entropy string,
    `idx = (e[i]·256 + e[i+1]) mod len(tickets)`, advancing one byte per
    draw and re-hashing with SHA-256 when the string is exhausted
  * verifier/miner draws consume the *public* latest block hash
    (vrf.go:134-141 draws from `input`, not the VRF output) — every peer
    computes the same committees with no communication; we keep that
    common-coin behavior deliberately
  * noiser draws consume the requester's *private* VRF output over the block
    hash (vrf.go:57-83), excluding the requester; the proof lets a chosen
    noiser check it was really selected
  * roles are encoded per node as a product of primes V=2/M=3/N=5
    (main.go:41-43, 497-527); contributors ("vanilla") are the nodes whose
    role id is 1 or NOISER_PRIME only (main.go:530-565)
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from biscotti_tpu_torch.crypto.vrf import VRFKey, verify as vrf_verify

VERIFIER_PRIME = 2  # ref: main.go:41
MINER_PRIME = 3  # ref: main.go:42
NOISER_PRIME = 5  # ref: main.go:43


def lottery_tickets(stake_map: Dict[int, int], total_nodes: int) -> List[int]:
    """node i gets stake[i] tickets (ref: vrf.go:67-72, 119-124)."""
    tickets: List[int] = []
    for node in range(total_nodes):
        tickets.extend([node] * max(0, stake_map.get(node, 0)))
    if not tickets:
        raise ValueError("empty lottery: no node holds positive stake")
    return tickets


class _EntropyWindows:
    """2-byte sliding windows over an entropy string, SHA-256 re-hash on
    exhaustion (ref: vrf.go:77-83, 134-141)."""

    def __init__(self, entropy: bytes):
        self.entropy = entropy
        self.i = 0

    def next_index(self, modulus: int) -> int:
        if self.i >= len(self.entropy) - 1:
            self.entropy = hashlib.sha256(self.entropy).digest()
            self.i = 0
        idx = (self.entropy[self.i] * 256 + self.entropy[self.i + 1]) % modulus
        self.i += 1
        return idx


def draw_winners(entropy: bytes, tickets: Sequence[int], count: int,
                 exclude: Optional[int] = None) -> List[int]:
    """First `count` distinct ticket holders along the entropy stream."""
    distinct = len(set(tickets) - ({exclude} if exclude is not None else set()))
    if count > distinct:
        raise ValueError(f"cannot draw {count} distinct winners from {distinct}")
    windows = _EntropyWindows(entropy)
    winners: List[int] = []
    seen = set()
    while len(winners) < count:
        w = tickets[windows.next_index(len(tickets))]
        if w not in seen and w != exclude:
            seen.add(w)
            winners.append(w)
    return winners


def elect_committees(stake_map: Dict[int, int], block_hash: bytes,
                     num_verifiers: int, num_miners: int,
                     total_nodes: int) -> Tuple[List[int], List[int]]:
    """Deterministic verifier + miner committees from the public block hash.

    Every peer runs this locally and agrees (the reference's draws read the
    shared block hash, vrf.go:134-141, so its committees are likewise a
    common coin; we drop the vestigial per-node VRF it computes but never
    uses for these draws). Verifiers and miners continue one shared entropy
    stream, so the sets may overlap exactly as in the reference
    (vrf.go:127-179)."""
    tickets = lottery_tickets(stake_map, total_nodes)
    windows = _EntropyWindows(block_hash)

    def take(count: int) -> List[int]:
        got: List[int] = []
        seen = set()
        while len(got) < count:
            w = tickets[windows.next_index(len(tickets))]
            if w not in seen:
                seen.add(w)
                got.append(w)
        return got

    if num_verifiers + num_miners > 0 and num_verifiers > len(set(tickets)):
        raise ValueError("more verifiers requested than staked nodes")
    if num_miners > len(set(tickets)):
        raise ValueError("more miners requested than staked nodes")
    verifiers = take(num_verifiers)
    miners = take(num_miners)
    return verifiers, miners


@dataclass
class NoiserDraw:
    """A requester's private noiser selection plus the proof that binds it
    to (requester key, block hash) — ref: vrf.go:54-99 returns
    (noisers, vrfOutput, vrfProof)."""

    noisers: List[int]
    output: bytes
    proof: bytes


def elect_noisers(noise_key: VRFKey, stake_map: Dict[int, int],
                  block_hash: bytes, source_id: int, num_noisers: int,
                  total_nodes: int) -> NoiserDraw:
    beta, pi = noise_key.prove(block_hash)
    tickets = lottery_tickets(stake_map, total_nodes)
    noisers = draw_winners(beta, tickets, num_noisers, exclude=source_id)
    return NoiserDraw(noisers=noisers, output=beta, proof=pi)


def verify_noiser_draw(public: bytes, stake_map: Dict[int, int],
                       block_hash: bytes, source_id: int, draw: NoiserDraw,
                       total_nodes: int) -> bool:
    """A selected noiser checks the requester's lottery honestly picked it
    (the capability the reference's returned-but-unchecked proof was for)."""
    beta = vrf_verify(public, block_hash, draw.proof)
    if beta is None or beta != draw.output:
        return False
    tickets = lottery_tickets(stake_map, total_nodes)
    try:
        expected = draw_winners(beta, tickets, len(draw.noisers),
                                exclude=source_id)
    except ValueError:
        return False
    return expected == draw.noisers


# --------------------------------------------------------------- role codec


@dataclass
class RoleMap:
    """Prime-product role encoding, one int per node (ref: main.go:497-565)."""

    roles: Dict[int, int] = field(default_factory=dict)

    @classmethod
    def build(cls, total_nodes: int, verifiers: Sequence[int],
              miners: Sequence[int], noisers: Sequence[int] = ()) -> "RoleMap":
        roles = {i: 1 for i in range(total_nodes)}
        for v in verifiers:
            roles[v] *= VERIFIER_PRIME
        for m in miners:
            roles[m] *= MINER_PRIME
        for n in noisers:
            roles[n] *= NOISER_PRIME
        return cls(roles)

    def is_verifier(self, node: int) -> bool:
        return self.roles.get(node, 1) % VERIFIER_PRIME == 0

    def is_miner(self, node: int) -> bool:
        return self.roles.get(node, 1) % MINER_PRIME == 0

    def is_noiser(self, node: int) -> bool:
        return self.roles.get(node, 1) % NOISER_PRIME == 0

    def is_vanilla(self, node: int) -> bool:
        """Plain contributor: role id 1 or noiser-only (ref: main.go:539-541)."""
        return self.roles.get(node, 1) in (1, NOISER_PRIME)

    def committee(self) -> Tuple[List[int], List[int], List[int], int]:
        """(sorted verifiers, miners, noisers, #vanilla) — the reference
        sorts verifiers because Krum's threshold fan-out needs a stable
        order (ref: main.go:560-562)."""
        verifiers = sorted(n for n in self.roles if self.is_verifier(n))
        miners = [n for n in self.roles if self.is_miner(n)]
        noisers = [n for n in self.roles if self.is_noiser(n)]
        vanilla = sum(1 for n in self.roles if self.is_vanilla(n))
        return verifiers, miners, noisers, vanilla
