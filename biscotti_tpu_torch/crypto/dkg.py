"""Dealerless genesis: Pedersen-verifiable distributed key generation.

The port's copy of `biscotti_tpu/crypto/dkg.py`, on the port's
`commitments` and `secretshare`: deals, joint grids, shares and exclusions
equal the reference's on the same seeds.

The last trusted role in the bootstrap story was the keygen dealer —
every other trust assumption (commitment key, VRF transcripts, share
verification) was already transparent or verifiable, but node genesis
still meant one process that saw everything. This module closes that
gap with a Joint-Feldman-style ceremony built from the resharing
kernels that already ship (`ops/secretshare.reshare_*`,
`crypto/commitments.reshare_commit_row` / `vss_verify_multi`): every
party is simultaneously a dealer (it Shamir-shares its own random
contribution under a Pedersen commitment grid) and a recipient (it
verifies every other dealer's deal against that dealer's grid before
accepting). The joint secret is the sum of the accepted contributions'
constant terms; nobody — including every dealer — ever holds it,
because the Pedersen homomorphism lets the joint commitment grid and
the joint shares be summed without reconstruction.

What each primitive contributes:

* `ss.reshare_coeffs`   — the dealer's sharing polynomial per chunk
  (constant term = the contribution, masks deterministic from the
  dealer seed, so a test ceremony is replayable end to end);
* `cm.reshare_commit_row` — the public Pedersen grid over those
  coefficients (constant blinding pinned to the dealer's own blind0);
* `ss.reshare_subshares` — the per-recipient share rows;
* `cm.vss_verify_multi` — recipient-side deal verification: a share
  row inconsistent with the dealer's own grid is refused loudly
  (`verify_deal`), which is the corrupted-deal rejection the
  acceptance gate demands;
* `cm.sum_commitment_grids` / `sum_blind_row_tensors` + a plain int64
  sum — aggregation into the joint grid / joint shares;
* `ss.reshare_recover_rows` — threshold recovery of the joint secret
  with the exact-integrality corruption detector (any ≥ `threshold`
  verified holders can pool rows; a perturbed row raises ValueError).

The ceremony transcript (sorted dealer digests) seeds the commitment-
key label, so no single party picks the generator ladder either:
`commit_key_label(deals)` is a pure function of every accepted deal.

In-process ceremonies (`run_ceremony`) simulate the N parties inside
one process for keygen and tests; the per-party API (`contribute` /
`verify_deal` / `aggregate` / `recover_secret`) is message-separable so
the same math can ride the `DkgDeal` RPC between live peers (protocol
v8, docs/PLACEMENT.md §Genesis DKG).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from biscotti_tpu_torch.crypto import commitments as cm
from biscotti_tpu_torch.crypto import ed25519 as ed
from biscotti_tpu_torch.ops import secretshare as ss

# Genesis contributions are small by construction: the joint secret is
# ceremony entropy (it seeds labels and genesis randomness), not model
# data, so a handful of chunks suffices and the exactness budget
# (|value| + n·k·RESHARE_COEF_BOUND·S^(k-1) « 2^53) stays comfortable
# for every plausible ceremony size.
DKG_CHUNKS = 8
SECRET_BOUND = 1 << 20

_CONTEXT = b"biscotti-dkg-v1"

# Metric family for live-ceremony deal intake (emitted by the DkgDeal
# RPC handler in runtime/peer.py; row in docs/OBSERVABILITY.md).
DEALS_METRIC = "biscotti_dkg_deals_total"
DEALS_HELP = ("genesis DKG deals received over the DkgDeal RPC, by "
              "verification verdict")


def share_points(n_parties: int) -> List[int]:
    """The ceremony's share points: party i holds x = i + 1 (zero is the
    secret's point and must never be dealt)."""
    return [i + 1 for i in range(int(n_parties))]


@dataclass
class DkgDeal:
    """One dealer's complete deal: the public commitment grid plus the
    per-recipient share/blind rows. In a live ceremony only
    (`comms`, `for_recipient(j)`) travel to recipient j; the in-process
    simulation keeps the whole tensor for convenience."""

    dealer_id: int
    comms: np.ndarray       # uint8 [C, k, 64] Pedersen grid
    xs: List[int]           # the share points this deal was evaluated at
    rows: np.ndarray        # int64 [S, C] share rows (row j -> party j)
    blind_rows: np.ndarray  # uint8 [S, C, 32] blinding rows

    def digest(self) -> bytes:
        """Binding digest of the public grid — what the transcript and
        any dealer-equivocation check are computed over."""
        return cm.vss_digest(self.comms)

    def for_recipient(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(share row [C], blind row [C, 32]) destined for party `idx`
        (position in `xs`, not the x value)."""
        return self.rows[idx], self.blind_rows[idx]


@dataclass
class DkgShare:
    """One party's aggregated ceremony output: its joint share of the
    genesis secret plus the joint public grid every holder agrees on."""

    party_id: int
    x: int
    row: np.ndarray         # int64 [C] joint share values
    blind_row: np.ndarray   # uint8 [C, 32] joint blinding values
    joint_comms: np.ndarray  # uint8 [C, k, 64] summed grid
    dealers: List[int]      # accepted dealer ids, sorted

    def verify(self) -> bool:
        """Check this party's joint share against the joint grid — the
        holder-side invariant any later resharing/migration re-proves."""
        return cm.vss_verify_multi([
            (self.joint_comms, [self.x],
             self.row.reshape(1, -1).astype(np.int64),
             self.blind_row.reshape(1, -1, 32))])


def _xof(seed: bytes, tag: bytes, nbytes: int) -> bytes:
    return hashlib.shake_256(seed + _CONTEXT + tag).digest(nbytes)


def contribute(dealer_id: int, xs: Sequence[int], threshold: int,
               seed: bytes, chunks: int = DKG_CHUNKS) -> DkgDeal:
    """Build dealer `dealer_id`'s deal: a random bounded secret row, a
    degree-(threshold-1) sharing polynomial per chunk, the Pedersen grid
    over the coefficients, and the evaluation at every party's point.
    Deterministic in `seed` — same seed, same deal — so ceremonies are
    replayable like every other plane."""
    xs = [int(x) for x in xs]
    k = int(threshold)
    if k < 2:
        raise ValueError("DKG threshold must be >= 2 (a 1-threshold "
                         "ceremony hands every dealer the joint secret)")
    if len(xs) < k:
        raise ValueError(
            f"{len(xs)} parties cannot hold a threshold-{k} secret")
    if len(set(xs)) != len(xs) or 0 in xs:
        raise ValueError(f"share points must be distinct and nonzero: {xs}")
    # the contribution: one bounded-uniform int64 row [1, C]
    raw = _xof(seed, b"|secret", 8 * chunks)
    vals = np.frombuffer(raw, dtype="<u8").astype(np.int64)
    secret_row = (np.abs(vals) % (2 * SECRET_BOUND + 1)) - SECRET_BOUND
    secret_row = secret_row.reshape(1, chunks)
    # constant blinding values, one per chunk, full-width in Z_q
    braw = _xof(seed, b"|blind0", 32 * chunks)
    blind0 = [int.from_bytes(braw[32 * i: 32 * i + 32], "little") % ed.Q
              for i in range(chunks)]
    coeffs = ss.reshare_coeffs(secret_row, k, seed,
                               _CONTEXT + b"|deal%d" % int(dealer_id))
    comms, blinds = cm.reshare_commit_row(
        coeffs[0], blind0, seed, _CONTEXT + b"|deal%d" % int(dealer_id))
    rows = ss.reshare_subshares(coeffs, xs)[:, 0, :]  # [S, C]
    blind_rows = cm.vss_blind_rows(blinds, xs)        # [S, C, 32]
    return DkgDeal(dealer_id=int(dealer_id), comms=comms, xs=xs,
                   rows=rows, blind_rows=blind_rows)


def verify_deal(deal: DkgDeal) -> bool:
    """Recipient-side acceptance check: every share row must open the
    dealer's own grid (batched Pedersen VSS). There is no binding check
    against an 'original' grid — at genesis the dealer's grid IS the
    original; what binds the dealer is that its constant-term commitment
    is published before any share is accepted, so it cannot deal
    different secrets to different recipients without the grids (and
    hence the transcript) diverging."""
    comms = np.asarray(deal.comms)
    if comms.ndim != 3 or comms.shape[2] != 64:
        return False
    rows = np.asarray(deal.rows, np.int64)
    if rows.shape != (len(deal.xs), comms.shape[0]):
        return False
    return cm.vss_verify_multi([
        (comms, list(deal.xs), rows,
         np.asarray(deal.blind_rows, np.uint8))])


def transcript_hash(deals: Sequence[DkgDeal]) -> bytes:
    """Ceremony transcript: SHA-256 over the sorted (dealer, grid-digest)
    pairs of the ACCEPTED deals. Every honest party computes the same
    value, and no single party controls it — one honest dealer's
    unpredictable grid randomizes the whole hash."""
    h = hashlib.sha256(_CONTEXT + b"|transcript")
    for deal in sorted(deals, key=lambda d: d.dealer_id):
        h.update(int(deal.dealer_id).to_bytes(4, "little"))
        h.update(deal.digest())
    return h.digest()


def commit_key_label(deals: Sequence[DkgDeal]) -> str:
    """The commitment-key label a DKG-booted cluster derives its
    generator ladder from: transcript-bound, so the ladder is fixed by
    the ceremony rather than picked by any party (the dealer path's
    static label is the legacy alternative)."""
    return f"biscotti-dkg-v1:{transcript_hash(deals).hex()}"


def aggregate(deals: Sequence[DkgDeal],
              reject: Optional[List[int]] = None) -> List[DkgShare]:
    """Verify every deal, sum the accepted ones, and hand each party its
    joint share. Deals that fail verification are EXCLUDED (their dealer
    ids land in `reject` when provided) — exclusion is loud, never a
    silent fallback, because a party that accepts an unverified deal
    holds a share that opens nothing."""
    accepted = []
    for deal in deals:
        if verify_deal(deal):
            accepted.append(deal)
        elif reject is not None:
            reject.append(int(deal.dealer_id))
    if not accepted:
        raise ValueError("DKG ceremony has no verifiable deals")
    xs = accepted[0].xs
    if any(d.xs != xs for d in accepted):
        raise ValueError("accepted deals disagree on the share points")
    joint_comms = cm.sum_commitment_grids([d.comms for d in accepted])
    if joint_comms is None:
        raise ValueError("accepted deal grid failed to load during "
                         "aggregation (off-curve cell)")
    joint_rows = np.sum(np.stack([d.rows for d in accepted]), axis=0)
    joint_blinds = cm.sum_blind_row_tensors(
        [d.blind_rows for d in accepted])
    dealers = sorted(int(d.dealer_id) for d in accepted)
    return [DkgShare(party_id=j, x=int(x), row=joint_rows[j].copy(),
                     blind_row=joint_blinds[j].copy(),
                     joint_comms=joint_comms, dealers=dealers)
            for j, x in enumerate(xs)]


def recover_secret(shares: Sequence[DkgShare], threshold: int) -> np.ndarray:
    """Threshold recovery of the joint genesis secret from any
    >= `threshold` holders' joint shares: exact rational interpolation
    with the integrality corruption detector (a perturbed row makes some
    recovered coefficient non-integer and raises ValueError — recovery
    never silently absorbs a corrupt holder)."""
    if len(shares) < int(threshold):
        raise ValueError(
            f"{len(shares)} shares below the ceremony threshold "
            f"{threshold}")
    xs = [s.x for s in shares]
    sub = np.stack([np.asarray(s.row, np.int64) for s in shares])
    return ss.reshare_recover_rows(sub[:, None, :], xs,
                                   poly_size=int(threshold))[0]


def secret_digest(secret_row: np.ndarray) -> bytes:
    """Digest of the recovered joint secret — the ceremony's genesis
    entropy (seeds, labels), never the secret itself, is what artifacts
    carry."""
    return hashlib.sha256(
        _CONTEXT + b"|secret"
        + np.ascontiguousarray(secret_row, np.int64).tobytes()).digest()


@dataclass
class CeremonyResult:
    """Everything keygen needs from a finished in-process ceremony."""

    shares: List[DkgShare]
    deals: List[DkgDeal]
    rejected: List[int]
    threshold: int

    @property
    def transcript(self) -> bytes:
        accepted = [d for d in self.deals
                    if int(d.dealer_id) not in set(self.rejected)]
        return transcript_hash(accepted)

    @property
    def label(self) -> str:
        accepted = [d for d in self.deals
                    if int(d.dealer_id) not in set(self.rejected)]
        return commit_key_label(accepted)


def run_ceremony(n_parties: int, threshold: int,
                 rng_seed: Optional[int] = None,
                 chunks: int = DKG_CHUNKS) -> CeremonyResult:
    """Simulate the N-party ceremony in one process (keygen, tests).

    Each simulated party draws its dealer seed independently (from OS
    randomness, or deterministically from `rng_seed` for replayable test
    ceremonies), deals, verifies every other deal, and aggregates. The
    simulation preserves the trust structure — every deal passes through
    `verify_deal` before any share sums it, exactly as live peers would
    over the `DkgDeal` RPC — it only collapses the transport."""
    import secrets as _secrets

    xs = share_points(n_parties)
    deals = []
    for i in range(int(n_parties)):
        if rng_seed is None:
            seed = _secrets.token_bytes(32)
        else:
            seed = hashlib.sha256(
                _CONTEXT + b"|party%d|%d" % (i, int(rng_seed))).digest()
        deals.append(contribute(i, xs, threshold, seed, chunks=chunks))
    rejected: List[int] = []
    shares = aggregate(deals, reject=rejected)
    return CeremonyResult(shares=shares, deals=deals, rejected=rejected,
                          threshold=int(threshold))
