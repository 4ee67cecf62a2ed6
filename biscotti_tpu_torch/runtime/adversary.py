# The port's own copy of biscotti_tpu/runtime/adversary.py: torch-free, and it imports nothing of biscotti_tpu.
"""Adaptive-adversary campaign plane: seeded, state-observing attack
strategies for the live runtime (docs/ADVERSARY.md).

Every hostile knob the repo already ships is STATIC: the poisoned set is
a pure function of the seed (`poison_fraction` → top ids), `--fault-flood`
replays every outbound frame regardless of who the round elected, and the
churn plane kills on a fixed timetable. Real adversaries adapt — Garfield
(arXiv:2010.05888) and the Byzantine setting of "Secure Distributed
Training at Scale" (arXiv:2106.11257) both treat coordinated, state-aware
attackers as the operating regime, not unit faults. This module is that
adversary, built with the same contract as every other hostile plane here:

  * `CampaignPlan` — frozen config surface on `BiscottiConfig` (like
    `FaultPlan` / `AdmissionPlan`); disabled by default, and a disabled
    plan is bit-identical to the seed schedule (guarded by
    tests/test_adversary.py).
  * Campaign strategies — one object per ATTACKER peer, observing only
    what a real attacker at that peer could see (the public VRF committee
    election, its own noiser draw, block contents, its own submission's
    fate) and deciding actions as a pure function of
    (campaign seed, observed state). Same seed + same chain ⇒ the
    identical action schedule, on any transport layout.
  * Every decision is traced (`campaign_round` / `campaign_poison`
    events) and counted (`biscotti_campaign_actions_total{campaign,
    action}`), so a campaign run's behavior is auditable from a scrape
    and replayable from its flags (`tools/chaos --campaign`).

The three shipped campaigns:

  roleflood — role-aware coordinated attack: colluding peers observe the
      per-round VRF election and aim their frame-storm at the elected
      miners (and, when drawn, their own noisers) instead of flooding
      blind; a fallback block re-elects, and the flood retargets with it.
      Composes with poisoning via `poison_fraction` (attacker ids mirror
      the poisoned-id formula, so one fraction arms both).
  sybil — churn-riding identity recycling: attackers kill themselves on a
      seeded schedule and rejoin as fresh incarnations (new connections,
      new ephemeral ports — the "fresh identity" a P2P transport actually
      grants), attempting to mint fresh admission burst allowances and
      shake off breaker quarantine / stake debits. What they CANNOT forge:
      node keys and the id space are fixed, so stake, debits and breaker
      history — all keyed on the node id or re-derived from chain state —
      follow the recycled identity (the admission plane's overflow-bucket
      and lossless-eviction claims, exercised live).
  hug — threshold-hugging poisoner: modulates its update per round to sit
      just under the Krum-distance / FoolsGold-similarity rejection
      thresholds it can estimate from accepted blocks — it blends its
      poisoned delta toward the observed honest aggregate step, ramps the
      poison component up while blocks keep accepting it and backs off
      when rejected, and decorrelates from fellow attackers with seeded
      per-attacker jitter (FoolsGold keys on sybil mutual similarity).

Campaign hooks live at seams the existing planes already own: the peer
round loop for observation, `faults.FaultInjector` for frame-level
actions, the churn self-kill seam (`membership.ChurnRunner` relaunches)
for identity recycling, and the trainer-delta post-processing point in
the worker flow for adaptive poison.

stdlib-only, like faults.py/admission.py: imported by the config layer.
The float arithmetic of delta shaping happens in peer.py (which owns
numpy); this module only DECIDES — scale factors, jitter seeds, targets.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from biscotti_tpu_torch.runtime import faults

# campaign names (str constants, not an Enum: they ride into JSON traces,
# metric labels and CLI flags as-is)
ROLEFLOOD = "roleflood"
SYBIL = "sybil"
HUG = "hug"
CAMPAIGNS = (ROLEFLOOD, SYBIL, HUG)

CAMPAIGN_METRIC = "biscotti_campaign_actions_total"
CAMPAIGN_HELP = "adversary campaign decisions by campaign and action"

# bounded deterministic action log (snapshot + determinism assertions);
# live runs are short, but a long campaign must not grow memory unbounded
_SCHEDULE_CAP = 4096


def _digest_u48(*parts) -> int:
    h = hashlib.sha256("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:6], "big")


@dataclass(frozen=True)
class CampaignPlan:
    """Seeded adversary-campaign configuration (surfaced as
    cfg.campaign_plan). `campaign=""` disables the plane entirely — the
    seed behavior, bit-identical (no campaign objects are built, no
    counters exist, no frame is touched).

    Attacker membership mirrors the reference's poisoned-id formula
    (`parallel/sim._poisoned_ids` → tools/verdicts.poisoned_ids): the top
    `attackers` fraction of node ids, so setting `attackers` equal to
    `poison_fraction` makes the colluding set and the poisoned set the
    SAME peers — the "flood while poisoning" composition is one knob.
    `attacker_node` pins one extra id into the set (the single-attacker
    scenario, and the `chaos --flood-node miner` sentinel's flooder).
    Node 0 is never an attacker: it is the oracle anchor every harness
    measures against, exactly like the churn plane's exemption."""

    campaign: str = ""        # "" disables; roleflood | sybil | hug
    seed: int = -1            # campaign decision seed (-1: protocol seed)
    attackers: float = 0.0    # fraction of the membership, top ids
    attacker_node: int = -1   # pin this id into the attacker set (-1: none)
    # roleflood: targeted frame-replay factor — frames bound for an
    # observed target are written 1 + flood times (the admission plane's
    # flood semantics, docs/ADMISSION.md, but aimed per round)
    flood: int = 20
    # sybil: rounds between identity recycles, and rounds an attacker
    # stays down before its fresh incarnation rejoins
    recycle_period: int = 4
    recycle_down: int = 1
    # hug: initial poison blend scale, multiplicative ramp on observed
    # acceptance, back-off on rejection, clamps, and the per-attacker
    # decorrelation jitter (fraction of the observed honest step norm)
    hug_start: float = 0.25
    hug_up: float = 1.6
    hug_down: float = 0.5
    hug_max: float = 4.0
    hug_min: float = 0.05
    hug_jitter: float = 0.25

    @property
    def enabled(self) -> bool:
        return bool(self.campaign)

    def validate(self) -> None:
        if not self.enabled:
            return
        if self.campaign not in CAMPAIGNS:
            raise ValueError(
                f"campaign_plan.campaign={self.campaign!r} unknown: "
                f"pick from {CAMPAIGNS}")
        if not (0.0 <= self.attackers < 1.0):
            raise ValueError(
                f"campaign_plan.attackers={self.attackers} must be in "
                "[0, 1): it is the membership fraction drawn as attackers")
        if self.attacker_node == 0:
            raise ValueError(
                "campaign_plan.attacker_node=0 is refused: node 0 is the "
                "oracle anchor (same exemption as the churn plane)")
        if self.flood < 0:
            raise ValueError("campaign_plan.flood must be >= 0")
        if self.recycle_period < 2:
            raise ValueError("campaign_plan.recycle_period must be >= 2")
        if not (1 <= self.recycle_down < self.recycle_period):
            raise ValueError(
                "campaign_plan.recycle_down must be in "
                "[1, recycle_period): a recycled attacker has to fit its "
                "rejoin inside the window it was killed in")
        for name, v in (("hug_start", self.hug_start),
                        ("hug_up", self.hug_up),
                        ("hug_down", self.hug_down),
                        ("hug_max", self.hug_max),
                        ("hug_min", self.hug_min)):
            if v <= 0.0:
                raise ValueError(f"campaign_plan.{name} must be > 0")
        if self.hug_up < 1.0 or self.hug_down > 1.0:
            raise ValueError(
                "campaign_plan.hug_up must be >= 1 and hug_down <= 1 "
                "(ramp on acceptance, back off on rejection)")
        if not (self.hug_min <= self.hug_start <= self.hug_max):
            raise ValueError(
                "campaign_plan.hug_start must sit inside "
                "[hug_min, hug_max]")
        if self.hug_jitter < 0.0:
            raise ValueError("campaign_plan.hug_jitter must be >= 0")

    def resolve_seed(self, protocol_seed: int) -> int:
        return protocol_seed if self.seed < 0 else self.seed

    def attacker_ids(self, num_nodes: int) -> frozenset:
        """The colluding set — THE poisoned-id formula
        (tools/verdicts.poisoned_ids, one definition), so `attackers ==
        poison_fraction` makes the colluding and poisoned sets
        identical, plus the pinned id. Pure in the plan fields; node 0
        exempt (the oracle anchor)."""
        from biscotti_tpu_torch.tools.verdicts import poisoned_ids

        out = poisoned_ids(num_nodes, self.attackers)
        if 0 < self.attacker_node < num_nodes:
            out.add(self.attacker_node)
        out.discard(0)
        return frozenset(out)

    def recycle_schedule(self, num_nodes: int, max_rounds: int,
                         protocol_seed: int = 0) -> List[faults.ChurnEvent]:
        """The sybil campaign's deterministic identity-recycling
        timeline, in the churn plane's own event vocabulary so
        `membership.ChurnRunner` (and any supervisor) replays it
        unchanged: per window w >= 1 every attacker gets a KILL at a
        hashed in-window offset and a RESTART `recycle_down` rounds
        later. Window 0 is exempt — attackers launch at genesis (an
        attacker with no history has nothing to ride). Pure in
        (resolved seed, attackers, period, down, num_nodes,
        max_rounds); pass the cluster's protocol seed so a plan left on
        `seed=-1` keys off the same seed the agents resolve."""
        if not self.enabled or self.campaign != SYBIL:
            return []
        ids = self.attacker_ids(num_nodes)
        if not ids or max_rounds <= 0:
            return []
        seed = self.resolve_seed(protocol_seed)
        period = max(2, int(self.recycle_period))
        down = max(1, int(self.recycle_down))
        events: List[faults.ChurnEvent] = []
        for w in range(1, -(-max_rounds // period)):
            start = w * period
            span = max(1, period - down)
            for node in sorted(ids):
                at = start + _digest_u48(
                    "biscotti-campaign-recycle", seed, node, w) % span
                if at >= max_rounds:
                    continue
                events.append(faults.ChurnEvent(
                    round=at, node=node, kind=faults.KILL))
                if at + down < max_rounds:
                    events.append(faults.ChurnEvent(
                        round=at + down, node=node, kind=faults.RESTART))
        events.sort(key=lambda e: (e.round, e.node, e.kind))
        return events


# ------------------------------------------------------------- strategies


class Campaign:
    """One attacker peer's strategy state. Subclasses override the hook
    methods they use; every decision they make is appended to
    `.schedule` — the deterministic (round, action, detail) log the
    layout-invariance tests compare — and counted via `_act` into both
    the in-process tally and `biscotti_campaign_actions_total`."""

    name = ""

    def __init__(self, plan: CampaignPlan, node: int, num_nodes: int,
                 seed: int):
        self.plan = plan
        self.node = node
        self.num_nodes = num_nodes
        self.seed = seed
        self.metrics = None  # telemetry.MetricsRegistry, armed by the peer
        self.counts: Dict[str, int] = {}
        self.targets_hit: Dict[int, int] = {}
        self.schedule: List[Tuple] = []
        self._targets: frozenset = frozenset()

    # ------------------------------------------------------------ tallies

    def _act(self, action: str, n: int = 1) -> None:
        self.counts[action] = self.counts.get(action, 0) + n
        if self.metrics is not None:
            self.metrics.counter(CAMPAIGN_METRIC, CAMPAIGN_HELP).inc(
                n, campaign=self.name, action=action)

    def _log(self, *entry) -> None:
        if len(self.schedule) < _SCHEDULE_CAP:
            self.schedule.append(entry)

    # -------------------------------------------------------------- hooks

    def observe_round(self, it: int, miners: Sequence[int],
                      verifiers: Sequence[int],
                      accepted_last: Optional[bool] = None) -> Dict:
        """Round-start observation: the public committee election this
        peer computed from its own chain (what any participant sees) and
        the fate of our previous submission (readable from the latest
        block). Returns a JSON-clean dict describing this round's
        decisions, traced by the peer as `campaign_round`."""
        return {}

    def observe_noisers(self, it: int, noisers: Sequence[int]) -> None:
        """The attacker's OWN private noiser draw for the round — the
        one committee it can observe beyond the public election."""

    def flood_factor(self, dst: int, msg_type: str) -> int:
        """Extra frame replays toward `dst` (consulted per outbound
        frame by faults.FaultInjector; 0 = untouched). PURE — the
        injector calls `record_flood` only for frames whose storm
        actually fires (the plan's own draw may supersede it)."""
        return 0

    def record_flood(self, dst: int) -> None:
        """One frame toward `dst` was really storm-replayed by this
        campaign (called by the injector AFTER precedence resolved)."""
        self._act("flood_frame")
        self.targets_hit[dst] = self.targets_hit.get(dst, 0) + 1

    def shape(self, it: int) -> Optional[Tuple[float, int, float]]:
        """Adaptive-poison decision for our round-`it` update:
        (blend scale, jitter seed, jitter fraction), or None to leave
        the delta untouched. The peer applies the arithmetic."""
        return None

    def kill_rounds(self, max_rounds: int) -> frozenset:
        """Rounds at which this attacker self-kills (rides the churn
        plane's self-kill seam; the launcher relaunches it)."""
        return frozenset()

    # ------------------------------------------------------------ readout

    def snapshot(self) -> Dict:
        """Structured readout under telemetry_snapshot()["campaign"] —
        `schedule` is the deterministic decision log (pure in seed +
        observed chain state), `actions`/`targets_hit` are execution
        tallies (frame counts may differ across layouts; the schedule
        must not)."""
        return {
            "campaign": self.name,
            "node": self.node,
            "actions": dict(self.counts),
            "targets_hit": {str(t): n
                            for t, n in sorted(self.targets_hit.items())},
            "schedule": [list(e) for e in self.schedule],
        }


class RoleFloodCampaign(Campaign):
    """Role-aware coordinated flood: aim the frame storm at whoever the
    VRF election just made important. Poisoning composes via
    poison_fraction (same id formula — see CampaignPlan docstring)."""

    name = ROLEFLOOD

    def observe_round(self, it, miners, verifiers, accepted_last=None):
        targets = frozenset(m for m in miners if m != self.node)
        self._targets = targets
        self._log(it, "target", sorted(targets))
        self._act("target_round")
        return {"targets": sorted(targets)}

    def observe_noisers(self, it, noisers):
        extra = frozenset(n for n in noisers if n != self.node)
        if extra - self._targets:
            self._targets = self._targets | extra
            self._log(it, "target_noisers", sorted(extra))
            self._act("target_noisers")

    def flood_factor(self, dst, msg_type):
        if self.plan.flood > 0 and dst in self._targets:
            return self.plan.flood
        return 0


class SybilCampaign(Campaign):
    """Churn-riding identity recycling: die on schedule, rejoin fresh.
    The recycle timetable is the plan's pure function; this object only
    counts/logs the kills it observes arriving (the kill itself rides
    the churn self-kill seam in the peer round loop)."""

    name = SYBIL

    def __init__(self, plan, node, num_nodes, seed):
        super().__init__(plan, node, num_nodes, seed)
        self._kills: frozenset = frozenset()

    def kill_rounds(self, max_rounds):
        # called once at agent construction with the run's horizon; the
        # cached set also feeds observe_round's recycle accounting
        self._kills = frozenset(
            e.round for e in self.plan.recycle_schedule(
                self.num_nodes, max_rounds, protocol_seed=self.seed)
            if e.node == self.node and e.kind == faults.KILL)
        return self._kills

    def observe_round(self, it, miners, verifiers, accepted_last=None):
        if it in self._kills:
            self._log(it, "recycle")
            self._act("recycle_kill")
            return {"recycle": True}
        return {}


class HugCampaign(Campaign):
    """Threshold-hugging poisoner: estimate the honest aggregate step
    from accepted blocks, blend the poisoned delta toward it, and walk
    the poison scale against the defense's observed verdicts — up while
    accepted, down when rejected — staying just under the rejection
    threshold it cannot read but can probe. Seeded per-attacker jitter
    decorrelates the colluders (FoolsGold keys on mutual similarity)."""

    name = HUG

    def __init__(self, plan, node, num_nodes, seed):
        super().__init__(plan, node, num_nodes, seed)
        self.scale = float(plan.hug_start)

    def observe_round(self, it, miners, verifiers, accepted_last=None):
        p = self.plan
        if accepted_last is True:
            self.scale = min(p.hug_max, self.scale * p.hug_up)
            self._act("hug_ramp_up")
        elif accepted_last is False:
            self.scale = max(p.hug_min, self.scale * p.hug_down)
            self._act("hug_back_off")
        else:
            self._act("hug_hold")
        self._log(it, "hug", round(self.scale, 6))
        return {"hug_scale": round(self.scale, 6)}

    def shape(self, it):
        jitter_seed = _digest_u48(
            "biscotti-campaign-hug", self.seed, self.node, it)
        return (self.scale, jitter_seed, float(self.plan.hug_jitter))

    def snapshot(self):
        out = super().snapshot()
        out["hug_scale"] = round(self.scale, 6)
        return out


_CAMPAIGN_CLASSES = {
    ROLEFLOOD: RoleFloodCampaign,
    SYBIL: SybilCampaign,
    HUG: HugCampaign,
}


def build(plan: CampaignPlan, node: int, num_nodes: int,
          protocol_seed: int) -> Optional[Campaign]:
    """The campaign strategy for `node`, or None when the plane is
    disabled or `node` is not an attacker (honest peers carry no
    campaign state at all — the disabled path allocates nothing)."""
    if not plan.enabled or node not in plan.attacker_ids(num_nodes):
        return None
    cls = _CAMPAIGN_CLASSES[plan.campaign]
    return cls(plan, node, num_nodes, plan.resolve_seed(protocol_seed))
