# The port's own copy of biscotti_tpu/ops/trust.py: torch-free, and it imports nothing of biscotti_tpu.
"""Adaptive defense plane: cross-round trust ledger + ensemble verdicts.

Every shipped single-round defense (Krum, MultiKrum, FoolsGold, RONI) is
memoryless: it sees one pool of deltas and must decide from geometry
alone. The attack matrix showed what that costs — the
threshold-hugging poisoner walks its poison scale up to just under the
accept boundary and defeats both KRUM (0.228 → 0.425 final error) and
MULTIKRUM (0.443 → 0.710). But the protocol owns something the attacker
cannot rewrite: the committed chain. Which identities landed accepted
records, in which rounds, at what step magnitude — that history is
signed, replicated, and identical on every honest peer. This module
turns it into a defense.

Three scorers, one ledger:

* **Cross-round consistency (drift)** — per peer, the verifier keeps a
  short series of observed log-residuals (distance from the round's
  Krum-kept centroid) and correlates its increments with the peer's
  chain-derived accept/reject walk. A hugger's scale controller moves
  *with* its verdicts (up on accept, down on reject) — that coupling is
  the signature; honest minibatch noise is uncorrelated with verdicts.
* **Ensemble verdict with hysteresis** — per round, four near-zero
  false-positive vetoes are unioned: Krum-geometry outlier (score far
  above the kept set's worst), FoolsGold pairwise similarity (max mutual
  cosine above a bar calibrated on the kept set's own pairs), magnitude
  band (norm above a multiple of the pool median — one-sided, because an
  update's influence is proportional to its norm: boosting is the
  dangerous direction, while a scaled-down probe carries proportionally
  little poison), and the drift flag. Any veto arms a
  hold-down counter so a flagged peer cannot flap back in the moment one
  scorer loses sight of it (e.g. its only cluster partner is on the
  committee this round). The two one-shot vetoes (geometry, magnitude)
  are additionally gated on chain history: an identity with a recent
  majority-accepted walk is *proven* and exempt — non-IID honest shards
  converge at wildly different rates, so single-round geometry misfires
  on veterans, while attacker identities can never become proven
  (rejection leaves no chain record to graduate on).
* **Stake-weighted slow-trust** — a fresh or recycled identity carries
  reduced weight until it accrues `ramp_rounds` accepted on-chain
  records. Weight gates admission through a duty-cycle credit
  accumulator (an update either aggregates fully or not at all — under
  secure aggregation the miner only ever sees the Shamir *sum*, so a
  fractional multiplier is not implementable verifier-side), and an
  eligible identity that goes absent for `absence_reset` consecutive
  real blocks restarts its ramp — the sybil campaign's churn-recycled
  identities never graduate.

Calibration is self-referential, not absolute: every bar is derived from
the current round's Krum-kept set (minus peers currently flagged or
held), so the same defaults work on near-duplicate creditcard gradients
(honest cos ≈ 0.9) and non-IID Dirichlet MNIST shards (honest cos ≈
0.04) without per-dataset knobs.

Determinism contract: the ledger is a pure function of (plan, the block
sequence fed to ``sync_block``, the decision sequence fed to
``decide``). No wall clock, no RNG, float math in plain python — two
verifiers fed the same chain and the same pools produce bit-identical
snapshots on any transport layout (TCP vs hive-loopback).

Stdlib-only at module level, like ``runtime/adversary.py``: the config
layer imports :class:`TrustPlan` for CLI plumbing, so importing this
module must not drag in jax/numpy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

TRUST_METRIC = "biscotti_trust_score"
TRUST_HELP = ("per-peer trust score on this verifier's ledger: slow-trust "
              "weight x (1 - drift score), 0 while flagged/held")
#: slow-trust duty-cycle credit ceiling: a long eligible-absent streak
#: banks at most this many future passes, so a throttled identity cannot
#: stockpile unbounded catch-up acceptance (credit is chain-derived —
#: see TrustLedger.sync_block — and this cap keeps it bounded state)
CREDIT_CAP = 2.0

VOTES_METRIC = "biscotti_defense_votes_total"
VOTES_HELP = ("ensemble defense votes by scorer (geometry/similarity/"
              "magnitude/drift/slow_trust/hold reject votes, plus the "
              "composed ensemble verdict per peer-round)")

#: scorer names, in vote order (also the `scorer=` label values)
SCORERS = ("geometry", "similarity", "magnitude", "drift", "slow_trust",
           "hold")


@dataclass(frozen=True)
class TrustPlan:
    """Knobs for the ensemble defense (``--defense ENSEMBLE``).

    Defaults are tuned at the attack-matrix operating point (10 nodes,
    3 verifiers, Dirichlet-0.3 MNIST, 30% poisoners) and validated by
    the clean-run zero-false-reject criterion; see docs/DEFENSES.md for
    the knob table and the threat model each scorer answers.
    """

    # -- ensemble vote calibration (anchored on the Krum-kept set) -----
    geo_ratio: float = 2.5     # Krum score > ratio x worst kept score
    sim_margin: float = 0.15   # cosine bar = kept-pair median + margin
    sim_mad_mult: float = 6.0  # ... or + mult x kept-pair MAD if larger
    sim_min_pairs: int = 3     # anchor pairs needed before the bar is
    #                            trusted (1 pair = an unusable sample)
    mag_band: float = 2.5      # norm > band x pool-median norm. One-
    #                            sided and pool-anchored: an update's
    #                            influence is proportional to its norm,
    #                            so only the boosted direction is
    #                            dangerous, and the pool median survives
    #                            Krum capturing an accidental tiny-norm
    #                            cluster as its kept set (honest non-IID
    #                            shards converge at different rates)
    # -- chain-history gate on the one-shot vetoes ---------------------
    proven_accepts: int = 1    # accepted records in the recent walk that
    #                            exempt a peer from geometry/magnitude
    #                            (0 = never exempt). Non-IID honest norms
    #                            go bimodal as shards converge, so the
    #                            one-shot vetoes are scoped to identities
    #                            with no earned chain history — exactly
    #                            the set every campaign's attackers live
    #                            in, since rejection leaves no record.
    proven_window: int = 8     # walk entries the gate looks back over
    # -- temporal-drift scorer -----------------------------------------
    drift_window: int = 16     # observations kept per peer
    drift_min_obs: int = 4     # pairs needed before the score can form
    drift_hi: float = 0.6      # Schmitt trigger: flag at/above
    drift_lo: float = 0.3      # ... unflag at/below
    drift_slope: float = 0.3   # constant-verdict ramp: |mean dlog| bar
    drift_range: float = 0.35  # log-residual span needed in the window
    # -- hysteresis ----------------------------------------------------
    hold_rounds: int = 3       # rounds a veto keeps rejecting after it
    # -- stake-weighted slow-trust ramp --------------------------------
    ramp_rounds: int = 4       # accepted blocks to graduate (0 = off)
    ramp_floor: float = 0.4    # weight of a zero-history identity
    absence_reset: int = 3     # consecutive eligible-absent rounds that
    #                            restart an identity's ramp
    # -- bounded evidence ----------------------------------------------
    stream_cap: int = 256      # verdict-stream entries kept per verifier

    def validate(self) -> None:
        if self.geo_ratio <= 1.0:
            raise ValueError("trust: geo_ratio must be > 1 (it multiplies "
                             "the worst KEPT Krum score)")
        if not 0.0 < self.sim_margin < 1.0:
            raise ValueError("trust: sim_margin must be in (0, 1)")
        if self.sim_mad_mult < 0.0:
            raise ValueError("trust: sim_mad_mult must be >= 0")
        if self.sim_min_pairs < 1:
            raise ValueError("trust: sim_min_pairs must be >= 1")
        if self.mag_band <= 1.0:
            raise ValueError("trust: mag_band must be > 1 (a multiplicative "
                             "norm band)")
        if self.proven_accepts < 0:
            raise ValueError("trust: proven_accepts must be >= 0")
        if self.proven_window < 1:
            raise ValueError("trust: proven_window must be >= 1")
        if self.drift_window < 2 or self.drift_min_obs < 2:
            raise ValueError("trust: drift_window and drift_min_obs must "
                             "be >= 2 (the scorer works on increments)")
        if not 0.0 <= self.drift_lo < self.drift_hi <= 1.0:
            raise ValueError("trust: need 0 <= drift_lo < drift_hi <= 1 "
                             "(Schmitt trigger would flap or never fire)")
        if self.drift_slope <= 0.0 or self.drift_range <= 0.0:
            raise ValueError("trust: drift_slope and drift_range must be "
                             "positive")
        if self.hold_rounds < 0:
            raise ValueError("trust: hold_rounds must be >= 0")
        if self.ramp_rounds < 0:
            raise ValueError("trust: ramp_rounds must be >= 0")
        if not 0.0 < self.ramp_floor <= 1.0:
            raise ValueError("trust: ramp_floor must be in (0, 1] — 0 "
                             "would permanently mute a fresh identity")
        if self.absence_reset < 1:
            raise ValueError("trust: absence_reset must be >= 1")
        if self.stream_cap < 1:
            raise ValueError("trust: stream_cap must be >= 1")


def pearson(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Plain-python Pearson correlation; 0.0 when either side is
    constant (the callers handle the constant regimes explicitly)."""
    n = len(xs)
    if n < 2 or n != len(ys):
        return 0.0
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    syy = sum((y - my) ** 2 for y in ys)
    if sxx <= 0.0 or syy <= 0.0:
        return 0.0
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    return sxy / math.sqrt(sxx * syy)


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


@dataclass
class _PeerState:
    """Everything the ledger tracks for one identity."""

    #: chain-derived accept walk: iteration -> accepted. An *eligible*
    #: identity absent from a real block records False — a verifier
    #: rejection leaves no record at all (the worker declines), so
    #: absence-while-eligible IS the reject signal, the same inference
    #: the hug campaign itself runs on (`_campaign_observe`).
    walk: Dict[int, bool] = field(default_factory=dict)
    #: (iteration, log residual) series from this verifier's own pools
    obs: List[Tuple[int, float]] = field(default_factory=list)
    absent_run: int = 0
    ramp: Optional[int] = None   # accepted-since-reset; None = graduated
    resets: int = 0
    #: slow-trust duty-cycle accumulator — CHAIN-derived (accrued and
    #: consumed in sync_block, only read at decide time), so verifiers
    #: that folded the same blocks agree on it regardless of which
    #: rounds each happened to decide
    credit: float = 0.0
    flagged: bool = False        # drift Schmitt state
    drift_score: float = 0.0
    hold: int = 0                # hysteresis hold-down counter


class TrustLedger:
    """Per-verifier adaptive-defense state: chain walk + drift series +
    slow-trust ramps + the ensemble decision procedure."""

    def __init__(self, plan: TrustPlan, num_nodes: int):
        plan.validate()
        if num_nodes < 1:
            raise ValueError("trust: num_nodes must be >= 1")
        self.plan = plan
        self.num_nodes = num_nodes
        self.synced_it = -1
        self.decisions = 0
        self._peers: Dict[int, _PeerState] = {}
        self._votes: Dict[str, int] = {}

    def _peer(self, pid: int) -> _PeerState:
        st = self._peers.get(pid)
        if st is None:
            st = self._peers[pid] = _PeerState()
        return st

    # ------------------------------------------------------- chain walk

    def sync_block(self, iteration: int, records: Dict[int, bool],
                   committee: Optional[Set[int]]) -> None:
        """Fold one settled block into the ledger.

        ``records`` maps source_id -> accepted flag for the block's delta
        records; ``committee`` is the round's verifier+miner set (those
        identities do not submit, so their absence carries no signal) or
        None when the electorate cannot be re-derived (pruned prev
        block). Empty/fallback blocks carry no information and are
        skipped entirely. Idempotent per iteration; out-of-order blocks
        are ignored so the walk stays append-only and replayable."""
        if iteration <= self.synced_it:
            return
        self.synced_it = iteration
        if not records:
            return
        ramp_on = self.plan.ramp_rounds > 0
        for pid in range(self.num_nodes):
            if pid in records:
                st = self._peer(pid)
                st.absent_run = 0
                st.walk[iteration] = records[pid]
                if ramp_on and st.ramp is not None:
                    if records[pid]:
                        # slow-trust credit is CHAIN-derived (not
                        # decide()-local): an accepted record is the
                        # chain's own evidence that the duty-cycle gate
                        # passed this round — consume the pass, advance
                        # the ramp, then accrue the new weight. Every
                        # verifier folding the same blocks holds the
                        # same credit, so churned/rotated committees
                        # issue UNANIMOUS slow_trust verdicts.
                        st.credit = max(0.0, st.credit - 1.0)
                        st.ramp += 1
                        if st.ramp >= self.plan.ramp_rounds:
                            st.ramp = None     # graduated: full weight
                            st.credit = 0.0
                        else:
                            st.credit = min(
                                CREDIT_CAP,
                                st.credit + self.weight(pid))
                    else:
                        st.credit = min(CREDIT_CAP,
                                        st.credit + self.weight(pid))
            elif committee is not None and pid not in committee:
                st = self._peer(pid)
                st.walk[iteration] = False
                st.absent_run += 1
                if ramp_on and st.absent_run == self.plan.absence_reset:
                    # ramp restart: credit restarts at the floor too —
                    # starting from zero would need 1/ramp_floor eligible
                    # absences before the FIRST pass, and at the default
                    # plan that streak re-triggers this very reset: a
                    # fresh identity would starve in a reset loop
                    st.ramp = 0
                    st.credit = self.plan.ramp_floor
                    st.resets += 1
                elif ramp_on and st.ramp is not None:
                    # a throttled (or rejected) eligible round still
                    # banks duty-cycle credit toward the next pass
                    st.credit = min(CREDIT_CAP,
                                    st.credit + self.weight(pid))
            # committee members (or unknown electorate): no signal

    # ------------------------------------------------------- slow-trust

    def weight(self, pid: int) -> float:
        """Aggregation weight in (0, 1]: 1.0 for graduated identities,
        a floor-to-1 ramp over accepted blocks for fresh/reset ones."""
        if self.plan.ramp_rounds <= 0:
            return 1.0
        st = self._peers.get(pid)
        if st is None or st.ramp is None:
            return 1.0
        f = self.plan.ramp_floor
        return f + (1.0 - f) * min(1.0, st.ramp / self.plan.ramp_rounds)

    def seed_fresh(self, pids: Sequence[int]) -> None:
        """Mark identities as ramp-fresh (zero verified history). Called
        for join-round admissions; pre-genesis members are grandfathered
        at full weight so arming the plane mid-deployment cannot starve
        the existing fleet."""
        if self.plan.ramp_rounds <= 0:
            return
        for pid in pids:
            st = self._peer(pid)
            if st.ramp is None and not any(st.walk.values()):
                st.ramp = 0
                st.credit = self.plan.ramp_floor

    def proven(self, pid: int) -> bool:
        """Whether a peer's recent chain walk has earned it out of the
        one-shot geometry/magnitude vetoes: at least ``proven_accepts``
        accepted records at a majority accept rate over the last
        ``proven_window`` walk entries. Attackers cannot reach this
        state — a rejected update leaves no chain record, so a
        consistently-vetoed identity's walk never accrues accepts —
        while honest peers graduate within a couple of rounds, before
        shard convergence makes their norms bimodal and single-round
        geometry unreliable."""
        p = self.plan
        if p.proven_accepts <= 0:
            return False
        st = self._peers.get(pid)
        if st is None or not st.walk:
            return False
        recent = [st.walk[t] for t in sorted(st.walk)[-p.proven_window:]]
        acc = sum(1 for ok in recent if ok)
        return acc >= p.proven_accepts and 2 * acc >= len(recent)

    def committee_clean(self, pid: int) -> bool:
        """Whether a peer's empty walk is fully committee-explained: real
        blocks have settled, yet the peer has no walk entries — every
        absence was committee duty (sync_block only skips committee
        members), so there is no negative evidence either. Such a peer
        earns the same benefit of the doubt as a proven one: an unlucky
        early committee draw must not expose an honest peer to the
        one-shot vetoes once honest norms go bimodal. An attacker can
        ride this at most one round — its first rejection (or eligible
        absence) writes the negative walk entry that ends the exemption."""
        if self.synced_it < 0:
            return False
        st = self._peers.get(pid)
        return st is None or (not st.walk and st.absent_run == 0)

    # ------------------------------------------------------ drift score

    def _drift(self, st: _PeerState) -> float:
        """Correlation between the peer's log-residual increments and its
        chain verdict walk across the same gaps. Returns a score in
        [0, 1]; the Schmitt trigger in :meth:`decide` turns it into the
        flag. Honest peers: increments are minibatch noise, uncorrelated
        with verdicts, and the walk is constant-accept (handled by the
        monotone regime, which additionally demands a sustained slope)."""
        p = self.plan
        obs = st.obs[-p.drift_window:]
        if len(obs) < 2:
            return 0.0
        xs: List[float] = []
        ys: List[float] = []
        for (it1, r1), (it2, r2) in zip(obs, obs[1:]):
            verdicts = [1.0 if ok else -1.0
                        for t, ok in st.walk.items() if it1 <= t < it2]
            if not verdicts:
                continue
            xs.append(sum(verdicts))
            ys.append(r2 - r1)
        if len(xs) < p.drift_min_obs:
            return 0.0
        span = max(r for _, r in obs) - min(r for _, r in obs)
        if span < p.drift_range:
            return 0.0
        if min(xs) < max(xs):
            return max(0.0, pearson(xs, ys))
        # constant-verdict regime: always-accepted (honest, or a hugger
        # the defense has not caught) ramping steadily, or an
        # always-rejected hugger backing its scale off — both move the
        # residual monotonically WITH the verdict sign
        sign = 1.0 if xs[0] > 0 else -1.0
        mean_dy = sum(ys) / len(ys)
        return 1.0 if sign * mean_dy >= p.drift_slope else 0.0

    # --------------------------------------------------------- decision

    def decide(self, iteration: int, ids: Sequence[int],
               norms: Sequence[float], residuals: Sequence[float],
               scores: Sequence[float], keep: Sequence[bool],
               cos: Sequence[Sequence[float]],
               ) -> Tuple[List[bool], List[List[str]], Dict[str, float]]:
        """One ensemble verdict over a verifier pool.

        Inputs are per-pool-index, pool sorted by source id: ``norms``
        delta L2 norms, ``residuals`` distances from the Krum-kept
        centroid, ``scores`` Krum scores, ``keep`` the Krum accept mask,
        ``cos`` the pairwise cosine matrix (diagonal ignored). Returns
        (accept flags, per-peer reject votes, calibration detail)."""
        p = self.plan
        n = len(ids)
        # calibration anchor: the Krum-kept set minus anyone this ledger
        # already distrusts — a hugger sits geometrically central, so
        # without the exclusion it would poison its own bar
        kept = [i for i in range(n) if keep[i]]
        clean = [i for i in kept
                 if not (self._peers.get(ids[i]) is not None
                         and (self._peers[ids[i]].flagged
                              or self._peers[ids[i]].hold > 0))]
        anchor = clean if clean else kept
        ref_geo = max((scores[i] for i in anchor), default=0.0)
        # similarity bar: prefer the clean anchor's pairs, but when holds
        # have thinned it below a usable sample fall back to the full
        # kept set — its median survives one attacker pair among >= 3,
        # and a single-pair anchor (tiny pools) disables the veto rather
        # than calibrating a bar from one cosine sample
        pairs = [cos[i][j] for i in anchor for j in anchor if j > i]
        if len(pairs) < p.sim_min_pairs and anchor is not kept:
            pairs = [cos[i][j] for i in kept for j in kept if j > i]
        if len(pairs) >= p.sim_min_pairs:
            ref_sim = _median(pairs)
            mad = _median([abs(c - ref_sim) for c in pairs])
            sim_bar = ref_sim + max(p.sim_margin, p.sim_mad_mult * mad)
        else:
            sim_bar = 2.0  # unusable anchor: similarity veto disabled
        lognorms = [math.log(norms[i]) for i in range(n) if norms[i] > 0.0]
        ref_mag = _median(lognorms) if lognorms else None
        mag_bar = math.log(p.mag_band)

        # record this round's observations before voting so the drift
        # scorer sees the freshest increment
        for i, pid in enumerate(ids):
            if residuals[i] > 0.0:
                st = self._peer(pid)
                st.obs.append((iteration, math.log(residuals[i])))
                if len(st.obs) > 2 * p.drift_window:
                    del st.obs[:-p.drift_window]

        accepts: List[bool] = []
        votes_out: List[List[str]] = []
        for i, pid in enumerate(ids):
            st = self._peer(pid)
            votes: List[str] = []
            # the one-shot vetoes only scrutinise unproven identities:
            # honest non-IID shards converge at different rates, making
            # single-round geometry/norm bands misfire on veterans,
            # while every attacker identity stays unproven (its rejected
            # updates leave no chain record to graduate on)
            unproven = not (self.proven(pid) or self.committee_clean(pid))
            if (unproven and ref_geo > 0.0
                    and scores[i] > p.geo_ratio * ref_geo):
                votes.append("geometry")
            vmax = max((cos[i][j] for j in range(n) if j != i),
                       default=-1.0)
            if vmax >= sim_bar:
                votes.append("similarity")
            if (unproven and ref_mag is not None and norms[i] > 0.0
                    and math.log(norms[i]) - ref_mag > mag_bar):
                votes.append("magnitude")
            st.drift_score = self._drift(st)
            if st.drift_score >= p.drift_hi:
                st.flagged = True
            elif st.drift_score <= p.drift_lo:
                st.flagged = False
            if st.flagged:
                votes.append("drift")
            # slow-trust is READ-ONLY here: the credit accumulator is a
            # pure function of the committed chain (sync_block), so any
            # verifier — including one that just joined a churned
            # committee mid-ramp — reaches the identical verdict. The
            # pass itself is consumed by the accepted record the chain
            # commits, not by this decision.
            if self.weight(pid) < 1.0 and st.credit < 1.0:
                votes.append("slow_trust")
            if votes:
                # slow_trust is a duty-cycle throttle, not an accusation:
                # arming the hold for it would starve a ramping identity
                # forever (throttled -> held -> absent -> reset). Only
                # the suspicion vetoes arm hysteresis.
                if any(v != "slow_trust" for v in votes):
                    st.hold = p.hold_rounds
                reject = True
            elif st.hold > 0:
                st.hold -= 1
                votes = ["hold"]
                reject = True
            else:
                reject = False
            for v in votes:
                self._votes[v] = self._votes.get(v, 0) + 1
            accepts.append(not reject)
            votes_out.append(votes)
        self.decisions += 1
        detail = {"ref_geo": ref_geo, "sim_bar": sim_bar,
                  "ref_mag": ref_mag if ref_mag is not None else 0.0}
        return accepts, votes_out, detail

    # -------------------------------------------------------- reporting

    def trust_scores(self) -> Dict[int, float]:
        """Per-peer score in [0, 1] for the pull-model gauge: slow-trust
        weight x (1 - drift score), zeroed while flagged or held."""
        out: Dict[int, float] = {}
        for pid in range(self.num_nodes):
            st = self._peers.get(pid)
            if st is None:
                out[pid] = 1.0
                continue
            if st.flagged or st.hold > 0:
                out[pid] = 0.0
            else:
                out[pid] = self.weight(pid) * (1.0 - st.drift_score)
        return out

    def snapshot(self) -> Dict[str, object]:
        """JSON-safe ledger state for telemetry_snapshot()/obs merging."""
        ramping = {str(pid): st.ramp for pid, st in sorted(self._peers.items())
                   if st.ramp is not None}
        resets = {str(pid): st.resets
                  for pid, st in sorted(self._peers.items()) if st.resets}
        held = {str(pid): st.hold
                for pid, st in sorted(self._peers.items()) if st.hold > 0}
        drift = {str(pid): round(st.drift_score, 4)
                 for pid, st in sorted(self._peers.items())
                 if st.obs or st.drift_score}
        return {
            "synced_it": self.synced_it,
            "decisions": self.decisions,
            "votes": dict(sorted(self._votes.items())),
            "flagged": sorted(pid for pid, st in self._peers.items()
                              if st.flagged),
            "held": held,
            "ramping": ramping,
            "resets": resets,
            "drift": drift,
            "weights": {str(pid): round(self.weight(pid), 4)
                        for pid in range(self.num_nodes)
                        if self.weight(pid) < 1.0},
        }
