# The port's own copy of biscotti_tpu/runtime/faults.py: torch-free, and it imports nothing of biscotti_tpu.
"""Deterministic fault-injection plane + peer-health robustness primitives.

The reference tests robustness only from the OUTSIDE — shell scripts that
`fuser -k` random nodes and open 30 s iptables DROP windows (ref:
DistSys/failAndRestartLocal.sh, blockNode.sh; see tests/test_fault_injection
docstring). Partial faults — a dropped frame, a slow link, duplicated
gossip, a mid-round connection reset — were untested and unreproducible.
This module turns those ad-hoc crash scripts into a seeded chaos plane:

  * `FaultPlan` — a pure function of (seed, src, dst, msg_type, attempt)
    deciding drop / delay / duplicate / reset for every frame the RPC pool
    writes. Same seed ⇒ byte-identical fault schedule, so any chaos run is
    replayable (the determinism contract, docs/FAULT_PLANE.md).
  * `FaultInjector` — a FaultPlan bound to one agent (src id + address→peer
    resolution), tallying and optionally recording every decision so tests
    and artifacts can assert on the schedule itself.
  * `backoff_schedule` — exponential backoff with decorrelated jitter
    (retry sleeps for PeerAgent._call); seeded rng ⇒ reproducible schedule.
  * `HealthLedger` — per-peer consecutive-failure circuit breaker with
    half-open probing, so gossip fan-out and committee RPCs skip dead
    peers instead of burning the round budget re-timing-out on them
    (the retry-with-backoff + peer-health design argued for by Garfield
    [arXiv:2010.05888] and "Secure Distributed Training at Scale"
    [arXiv:2106.11257] — fault tolerance in the communication layer).

Injection happens at the sender's `_Conn` boundary (rpc.Pool), so real TCP
loopback traffic is perturbed — delayed and duplicated frames actually
cross the wire; dropped frames die before the socket exactly as a lossy
network would eat them; resets tear the shared multiplexed connection down
mid-flight. From the caller's perspective a dropped request and a dropped
reply are the same event (a timeout), so sender-side injection covers both
directions of the frame exchange.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# Circuit-breaker states (str constants, not an Enum: they ride into JSON
# trace events and health snapshots as-is)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitOpenError(ConnectionError):
    """Fast-fail raised instead of dialing a quarantined peer. Subclasses
    ConnectionError so every existing transport-failure except-clause
    (eviction, gather fan-outs, _safe_call) handles it unchanged."""


class ChurnExit(Exception):
    """A peer's own churn schedule told it to die this round (the
    `--fault-churn` self-kill, docs/MEMBERSHIP.md). Raised out of the
    round loop and caught in PeerAgent.run() as a CLEAN early exit — no
    crash dump, sockets released synchronously — so an external launcher
    (tools/chaos --churn, runtime/membership.ChurnRunner, a k8s restart
    policy) can relaunch the process at the scheduled restart round."""

    def __init__(self, round_: int):
        super().__init__(f"churn schedule kill at round {round_}")
        self.round = round_


@dataclass(frozen=True)
class FaultAction:
    """One frame's fate. Precedence when several faults draw true:
    reset > drop > (delay, duplicate, flood) — a reset connection can
    deliver nothing, a dropped frame cannot also arrive twice."""

    drop: bool = False
    duplicate: bool = False
    reset: bool = False
    delay_s: float = 0.0
    # frame-storm replay count (the flood fault kind, docs/ADMISSION.md):
    # the frame is written 1 + flood times back-to-back, turning this
    # peer into a deterministic flooder — the adversary the admission
    # plane's shedding is tested against
    flood: int = 0

    @property
    def benign(self) -> bool:
        return not (self.drop or self.duplicate or self.reset
                    or self.delay_s > 0.0 or self.flood > 0)

    def kind(self) -> str:
        """Compact label for tallies/logs."""
        if self.reset:
            return "reset"
        if self.drop:
            return "drop"
        if self.flood > 0:
            return "flood"
        if self.duplicate and self.delay_s > 0:
            return "delay+dup"
        if self.duplicate:
            return "dup"
        if self.delay_s > 0:
            return "delay"
        return "none"


_BENIGN = FaultAction()


@dataclass(frozen=True)
class ChurnEvent:
    """One scheduled membership change: at the start of `round`, `node` is
    killed / restarted / first launched. Emitted by FaultPlan.churn_schedule
    — a pure function of the seed, so any churn run's exact join/leave
    timeline replays from the flags alone (docs/MEMBERSHIP.md)."""

    round: int
    node: int
    kind: str  # KILL | RESTART | JOIN | MIGRATE


KILL = "kill"
RESTART = "restart"
JOIN = "join"
# live migration (runtime/placement.py, docs/PLACEMENT.md): the runner
# captures a serialized ticket BEFORE the kill and relaunches the fresh
# incarnation from it — unlike RESTART, state survives the move
MIGRATE = "migrate"


@dataclass(frozen=True)
class SlowProfile:
    """One peer's speed profile under the `slow` fault kind
    (docs/STRAGGLERS.md): `compute_factor` multiplies the wall-clock of
    the peer's heavy compute paths (Trainer/stepper SGD step, worker
    commitment/share generation, miner intake crypto — emulated by
    padding each measured segment to factor× its duration), and
    `service_s` is an extra per-RPC service delay the peer's handler
    seam charges every inbound request (applied identically by the TCP
    server dispatch and the hive loopback dispatch, so TCP and
    co-hosted layouts see the same schedule)."""

    compute_factor: float = 1.0
    service_s: float = 0.0
    preset: str = ""

    @property
    def slowed(self) -> bool:
        return self.compute_factor > 1.0 or self.service_s > 0.0


NO_SLOW = SlowProfile()

# Named speed-profile presets for the drawn slow subset (docs/STRAGGLERS.md):
#   tee      — confidential-compute peer, calibrated from "Characterization
#              of GPU TEE Overheads" (arXiv:2501.11771): kernel compute in
#              TEE mode is near-native (<10%), but encrypted CPU↔GPU bounce
#              transfers dominate transfer-bound workloads — and a
#              federated round ships the full model both ways every
#              iteration, exactly that regime. 4× compute (the paper's
#              transfer-dominated small-batch penalty band) + 20 ms
#              per-RPC service latency (encrypted-channel setup per
#              request).
#   bimodal  — half the drawn peers mildly slow (2×), half badly (8×):
#              the two-cluster fleet (e.g. one old GPU generation).
#   longtail — severity v^-0.7 capped at 16×: most drawn peers are
#              modestly slow, a few are severe (the volunteer-fleet tail).
SLOW_PRESETS = ("tee", "bimodal", "longtail")


@dataclass(frozen=True)
class FaultPlan:
    """Seeded link-fault configuration (surfaced as cfg.fault_plan).

    Every probability is per-frame and independent: `action()` is a pure
    function of (seed, src, dst, msg_type, attempt, seq) — no shared RNG
    state, so concurrent tasks and process restarts all see the same
    schedule. `seq` is the per-(dst, msg_type) frame ordinal maintained by
    the FaultInjector: without it, every RegisterBlock gossip post on one
    link (always attempt 0) would share ONE draw and a 10% drop plan would
    blackhole ~10% of LINKS for the whole run instead of dropping ~10% of
    FRAMES on every link. Retries land on a new attempt number (and a new
    seq) and therefore a fresh draw: a retried frame is not doomed to
    re-lose forever.
    """

    seed: int = 0
    drop: float = 0.0       # P(frame silently lost before the socket)
    delay: float = 0.0      # P(frame delayed before the write)
    delay_s: float = 0.05   # max per-frame delay; actual in [½·delay_s, delay_s]
    duplicate: float = 0.0  # P(frame written twice back-to-back)
    reset: float = 0.0      # P(connection torn down instead of writing)
    # flood replay factor: every outbound frame is written 1 + flood
    # times, so an armed peer sustains (1 + flood)× the honest frame rate
    # toward every target — the deterministic frame storm the admission
    # plane's shedding is asserted against (docs/ADMISSION.md). Applied
    # to every frame (no draw needed: replay count is the knob), except
    # frames that reset or drop first.
    flood: int = 0
    # churn: fraction of the membership killed-and-restarted per
    # `churn_period` rounds (0 disables). The schedule — which node goes
    # down at which round, when it comes back, and which nodes JOIN late
    # instead of launching at genesis — is a pure function of the seed
    # (churn_schedule below), so a churn run is replayable exactly like a
    # drop/delay/flood run. Node 0 is never churned: it is the anchor the
    # oracle (and a real deployment's bootstrap list) measures against.
    churn: float = 0.0
    churn_period: int = 10  # rounds per churn window (20% per 10 by default)
    churn_down: int = 3     # rounds a killed peer stays down
    # membership-timeline seed override (-1: use `seed`). Lets a churn
    # ablation vary the join/leave schedule while the frame-fault
    # schedule (drop/delay/dup/reset/flood, keyed on `seed`) stays
    # fixed — chaos `--churn-seed` rides this, never a plan reseed.
    churn_seed: int = -1
    # slow: fraction of the membership assigned a heterogeneous speed
    # profile (0 disables) — the straggler fault kind
    # (docs/STRAGGLERS.md). Which peers are slow, and how slow, is a
    # pure function of (seed, node) via slow_profile() below, so a
    # straggler run replays from the flags exactly like drop/flood/
    # churn — and because the profile is consulted by the PEER (compute
    # pads + handler service delay), TCP and hive-loopback layouts see
    # the identical schedule by construction. Unlike churn, node 0 is
    # drawable: a slow peer still participates honestly.
    slow: float = 0.0
    slow_factor: float = 4.0   # compute-slowdown multiple for drawn peers
    slow_service_s: float = 0.0  # extra per-RPC service delay for them
    # named preset overriding (slow_factor, slow_service_s) for the
    # drawn subset: "tee" | "bimodal" | "longtail" (see SLOW_PRESETS)
    slow_preset: str = ""
    # pin this node slow regardless of the fraction draw (-1: none) —
    # the deterministic single-straggler scenario (chaos --slow-node)
    slow_node: int = -1

    @property
    def enabled(self) -> bool:
        """Frame-level injection armed? (Churn is NOT a frame fault: it is
        consumed by the launch harness / the peer's own round loop, so a
        churn-only plan does not pay the per-frame draw.)"""
        return (self.drop > 0.0 or self.delay > 0.0 or self.duplicate > 0.0
                or self.reset > 0.0 or self.flood > 0)

    @property
    def churn_enabled(self) -> bool:
        return self.churn > 0.0

    @property
    def slow_enabled(self) -> bool:
        """Heterogeneous speed profiles armed? (Not a frame fault: the
        profile is consumed by the peer's compute pads and handler seam,
        so a slow-only plan does not pay the per-frame draw.)"""
        return self.slow > 0.0 or self.slow_node >= 0

    def slow_profile(self, node: int, num_nodes: int) -> SlowProfile:
        """The deterministic speed profile of `node` — pure in
        (seed, node), so every peer (and every harness) derives the same
        fleet table from the flags alone. Membership draw and severity
        draw are carved from one digest; `slow_node` pins its node into
        the slow set regardless of the fraction."""
        if not self.slow_enabled or not (0 <= node < num_nodes):
            return NO_SLOW
        h = hashlib.sha256(
            f"biscotti-slow|{self.seed}|{node}".encode()).digest()
        u = int.from_bytes(h[:6], "big") / float(1 << 48)
        if node != self.slow_node and u >= self.slow:
            return NO_SLOW
        v = int.from_bytes(h[6:12], "big") / float(1 << 48)
        preset = self.slow_preset
        if preset == "tee":
            factor, service = 4.0, 0.02
        elif preset == "bimodal":
            factor, service = (2.0 if v < 0.5 else 8.0), 0.01
        elif preset == "longtail":
            factor = min(16.0, max(1.0, max(v, 1e-12) ** -0.7))
            service = 0.01
        elif preset:
            raise ValueError(
                f"unknown slow_preset {preset!r}: pick from {SLOW_PRESETS}")
        else:
            factor = max(1.0, float(self.slow_factor))
            service = max(0.0, float(self.slow_service_s))
        return SlowProfile(compute_factor=factor, service_s=service,
                           preset=preset)

    def slow_table(self, num_nodes: int) -> Dict[int, SlowProfile]:
        """Every slowed node's profile — the fleet table chaos reports
        and the obs 'slowest peers' view render."""
        out: Dict[int, SlowProfile] = {}
        for n in range(num_nodes):
            p = self.slow_profile(n, num_nodes)
            if p.slowed:
                out[n] = p
        return out

    def churn_schedule(self, num_nodes: int,
                       max_rounds: int) -> List[ChurnEvent]:
        """Deterministic membership timeline: per `churn_period` window,
        ~`churn`·num_nodes victims are drawn by seeded hash; each victim
        gets a KILL at a hashed offset inside the window and a RESTART
        `churn_down` rounds later (when that still fits the run). A
        window-0 victim instead becomes a late JOINER: it is not launched
        at genesis and JOINs at its drawn round — so one knob exercises
        join, leave, AND rejoin. Events are sorted by (round, node); node
        0 is exempt (the anchor). Same (seed, churn, period, down,
        num_nodes, max_rounds) ⇒ the identical list, always."""
        if not self.churn_enabled or num_nodes <= 1 or max_rounds <= 0:
            return []
        seed = self.seed if self.churn_seed < 0 else self.churn_seed
        period = max(1, int(self.churn_period))
        down = max(1, int(self.churn_down))
        events: List[ChurnEvent] = []
        for w in range(-(-max_rounds // period)):
            start = w * period
            for node in range(1, num_nodes):
                h = hashlib.sha256(
                    f"biscotti-churn|{seed}|{node}|{w}".encode()
                ).digest()
                u = int.from_bytes(h[:6], "big") / float(1 << 48)
                if u >= self.churn:
                    continue
                # drawn offset keeps the kill early enough in the window
                # that the restart (kill + down) lands inside the run for
                # every full window
                span = max(1, period - down)
                at = start + int.from_bytes(h[6:12], "big") % span
                if at >= max_rounds:
                    continue
                if w == 0:
                    # late joiner: skip genesis launch, join at the drawn
                    # round (at=0 degenerates to a genesis launch — skip)
                    if at > 0:
                        events.append(ChurnEvent(round=at, node=node,
                                                 kind=JOIN))
                    continue
                events.append(ChurnEvent(round=at, node=node, kind=KILL))
                if at + down < max_rounds:
                    events.append(ChurnEvent(round=at + down, node=node,
                                             kind=RESTART))
        events.sort(key=lambda e: (e.round, e.node, e.kind))
        return events

    def action(self, src: int, dst: int, msg_type: str,
               attempt: int = 0, seq: int = 0) -> FaultAction:
        """The deterministic fate of one (src→dst, msg_type, attempt, seq)
        frame."""
        if not self.enabled:
            return _BENIGN
        h = hashlib.sha256(
            f"biscotti-fault|{self.seed}|{src}|{dst}|{msg_type}|{attempt}"
            f"|{seq}".encode()).digest()
        # five independent uniforms in [0,1) carved from one digest
        u = [int.from_bytes(h[6 * i: 6 * i + 6], "big") / float(1 << 48)
             for i in range(5)]
        if u[0] < self.reset:
            return FaultAction(reset=True)
        if u[1] < self.drop:
            return FaultAction(drop=True)
        dup = u[2] < self.duplicate
        d = 0.0
        if u[3] < self.delay:
            d = self.delay_s * (0.5 + 0.5 * u[4])
        if not dup and d == 0.0 and self.flood <= 0:
            return _BENIGN
        return FaultAction(duplicate=dup, delay_s=d,
                           flood=max(0, int(self.flood)))


class FaultInjector:
    """A FaultPlan bound to one agent: resolves the pool's (host, port)
    targets back to peer ids and tallies every non-benign decision.
    Attach to `rpc.Pool.faults`; the pool consults it per frame.

    Maintains the per-(dst, msg_type) frame ordinal `seq` that keys each
    frame's draw (see FaultPlan.action): repeated frames of the same type
    on one link — block gossip round after round — each get their own
    independent fate.

    With `record=True` every decision (including benign ones) is appended
    to `.log` as (dst, msg_type, attempt, seq, kind) so a test can replay
    the exact schedule against a fresh plan and assert reproducibility."""

    def __init__(self, plan: FaultPlan, src: int,
                 peer_of: Callable[[str, int], Optional[int]],
                 record: bool = False):
        self.plan = plan
        self.src = src
        self._peer_of = peer_of
        self._seq: Dict[Tuple[int, str], int] = {}
        self.counts: Dict[str, int] = {}
        # optional adversary campaign (runtime/adversary.py): consulted
        # per frame for TARGETED extra replays (the role-aware flood) on
        # top of the plan's static draw — the campaign plane's one
        # frame-level seam, so chaos schedules stay layout-invariant
        # (the draw happens before any loopback shortcut, like every
        # other fault kind)
        self.campaign = None
        # optional telemetry registry (telemetry.MetricsRegistry): armed
        # by the peer agent so injected-fault tallies ride the same
        # scrapeable plane as everything else; `counts` stays as the
        # in-process back-compat view
        self.metrics = None
        self.log: Optional[List[Tuple[int, str, int, int, str]]] = \
            [] if record else None

    def action(self, host: str, port: int, msg_type: str,
               attempt: int = 0) -> FaultAction:
        dst = self._peer_of(host, port)
        if dst is None or dst == self.src:
            return _BENIGN  # unknown target / self-loop: never perturbed
        key = (dst, msg_type)
        seq = self._seq.get(key, 0)
        self._seq[key] = seq + 1
        act = self.plan.action(self.src, dst, msg_type, attempt, seq)
        if self.campaign is not None and not (act.reset or act.drop):
            # role-aware targeted flood: the campaign names this round's
            # targets from the election it observed; a frame bound for
            # one of them is replayed like the static flood kind, same
            # precedence (a reset/dropped frame cannot also storm). The
            # campaign's tallies count only storms that actually FIRE —
            # a plan-level flood >= the campaign's supersedes it
            extra = self.campaign.flood_factor(dst, msg_type)
            if extra > act.flood:
                act = FaultAction(duplicate=act.duplicate,
                                  delay_s=act.delay_s, flood=extra)
                self.campaign.record_flood(dst)
        kind = act.kind()
        if kind != "none":
            self.counts[kind] = self.counts.get(kind, 0) + 1
            if self.metrics is not None:
                self.metrics.counter(
                    "biscotti_faults_injected_total",
                    "frames perturbed by the seeded fault plane").inc(
                    kind=kind, msg_type=msg_type)
        if self.log is not None:
            self.log.append((dst, msg_type, attempt, seq, kind))
        return act


def backoff_schedule(rng, base_s: float, cap_s: float):
    """Generator of retry sleeps: exponential backoff with DECORRELATED
    jitter (each sleep ~ U[base, 3·previous], capped) — spreads synchronized
    retry storms apart while keeping the expected growth exponential.
    `rng` is a `random.Random`; a seeded instance yields a reproducible
    schedule (asserted by tests — the determinism contract extends to the
    retry plane)."""
    prev = base_s
    while True:
        prev = min(cap_s, rng.uniform(base_s, prev * 3.0))
        yield prev


@dataclass
class _PeerHealth:
    state: str = CLOSED
    failures: int = 0        # consecutive transport failures
    opened_at: float = 0.0
    probing: bool = False    # half-open probe in flight
    # lifetime counters (exposed via snapshot())
    opens: int = 0
    closes: int = 0
    fast_fails: int = 0
    successes: int = 0
    total_failures: int = 0


class HealthLedger:
    """Per-peer consecutive-failure circuit breaker with half-open probing.

    closed --K consecutive failures--> open --cooldown elapses--> half_open
    half_open: exactly ONE probe call may proceed; its success closes the
    breaker (failure count reset), its failure re-opens it for another
    cooldown. Any success in any state closes the breaker — one good RPC
    is full rehabilitation (the reference's `alive` set, by contrast,
    evicts on a single timeout and only re-admits on inbound traffic).

    `clock` is injectable so transition tests run on a fake clock.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._peers: Dict[int, _PeerHealth] = {}

    def _h(self, pid: int) -> _PeerHealth:
        h = self._peers.get(pid)
        if h is None:
            h = self._peers[pid] = _PeerHealth()
        return h

    def state(self, pid: int) -> str:
        return self._h(pid).state

    def allow(self, pid: int) -> bool:
        """May a unicast RPC toward `pid` proceed now? Consumes the single
        half-open probe slot when the cooldown has elapsed; callers that
        get False should fail fast (CircuitOpenError) without dialing."""
        h = self._h(pid)
        if h.state == CLOSED:
            return True
        if h.state == OPEN:
            if self._clock() - h.opened_at >= self.cooldown_s:
                h.state = HALF_OPEN
                h.probing = True
                return True
            h.fast_fails += 1
            return False
        # HALF_OPEN: one probe at a time
        if h.probing:
            h.fast_fails += 1
            return False
        h.probing = True
        return True

    def release_probe(self, pid: int) -> None:
        """Return an UNRESOLVED half-open probe slot (the probe call was
        cancelled before any outcome was recorded) — without this the slot
        leaks and the peer stays quarantined until unrelated traffic
        records an outcome for it. No-op in every other state."""
        h = self._peers.get(pid)
        if h is not None and h.state == HALF_OPEN:
            h.probing = False

    def available(self, pid: int) -> bool:
        """Non-consuming view for fan-out target selection (gossip): False
        only while the breaker is open and still cooling down. Does NOT
        claim the half-open probe slot — a gossip post toward a half-open
        peer is itself probe-shaped (its failure re-opens the breaker)."""
        h = self._peers.get(pid)
        if h is None or h.state != OPEN:
            return True
        if self._clock() - h.opened_at >= self.cooldown_s:
            return True
        h.fast_fails += 1
        return False

    def record_success(self, pid: int) -> bool:
        """One RPC toward `pid` completed (or the peer answered, even with a
        protocol-level error — the TRANSPORT is healthy). Returns True iff
        this closed an open/half-open breaker."""
        h = self._h(pid)
        was_tripped = h.state != CLOSED
        h.state = CLOSED
        h.failures = 0
        h.probing = False
        h.successes += 1
        if was_tripped:
            h.closes += 1
        return was_tripped

    def note_inbound(self, pid: int) -> None:
        """Inbound traffic from `pid` is liveness evidence for the
        THEM→US path ONLY — it must not touch the outbound failure
        streak: under an asymmetric partition (their frames reach us,
        ours die) inbound gossip would otherwise zero the streak every
        round and the breaker could never open, leaving each outbound
        RPC to burn its full retry budget. For a TRIPPED breaker it
        expires the cooldown so the very next outbound call becomes the
        half-open probe: a genuinely rejoined peer re-closes on that
        probe's success without waiting out the cooldown, while a
        one-way-partitioned peer fails the probe and stays quarantined."""
        h = self._peers.get(pid)
        if h is None or h.state == CLOSED:
            return
        if h.state == OPEN:
            h.opened_at = self._clock() - self.cooldown_s
        else:  # HALF_OPEN: free a possibly-stale slot; a fresh probe decides
            h.probing = False

    def record_failure(self, pid: int) -> bool:
        """One transport failure (timeout/refused/reset) toward `pid`.
        Returns True iff this TRIPPED the breaker open."""
        h = self._h(pid)
        h.failures += 1
        h.total_failures += 1
        if h.state == HALF_OPEN:
            # the probe itself failed: straight back to open
            h.state = OPEN
            h.opened_at = self._clock()
            h.probing = False
            h.opens += 1
            return True
        if h.state == OPEN:
            # a failure observed while quarantined (e.g. a fan-out post
            # that rode available()'s post-cooldown implicit probe): the
            # peer is demonstrably still dead — RE-ARM the cooldown, or
            # after the first cooldown the quarantine would never
            # re-engage for gossip and every round would re-burn rpc_s
            h.opened_at = self._clock()
            return False
        if h.state == CLOSED and h.failures >= self.threshold:
            h.state = OPEN
            h.opened_at = self._clock()
            h.opens += 1
            return True
        return False

    def snapshot(self) -> Dict[int, Dict[str, object]]:
        """Per-peer health for artifacts / assertions (run() result)."""
        return {
            pid: {
                "state": h.state, "failures": h.failures,
                "opens": h.opens, "closes": h.closes,
                "fast_fails": h.fast_fails, "successes": h.successes,
                "total_failures": h.total_failures,
            }
            for pid, h in self._peers.items()
        }

    def export_state(self) -> Dict[str, Dict[str, object]]:
        """Full breaker state for a migration ticket (runtime/placement.py):
        snapshot() plus the fields it elides because they only matter to a
        LIVE ledger — the open timestamp (exported clock-RELATIVE, as the
        age of the open, so a restore under a different clock re-anchors
        it) and the probe slot. JSON-clean: keys are strings."""
        now = self._clock()
        out: Dict[str, Dict[str, object]] = {}
        for pid, h in self._peers.items():
            out[str(pid)] = {
                "state": h.state, "failures": h.failures,
                "opened_age_s": (round(now - h.opened_at, 6)
                                 if h.state != CLOSED else 0.0),
                "probing": h.probing, "opens": h.opens,
                "closes": h.closes, "fast_fails": h.fast_fails,
                "successes": h.successes,
                "total_failures": h.total_failures,
            }
        return out

    def restore_state(self, state: Dict[str, Dict[str, object]]) -> None:
        """Rehydrate an export into THIS ledger (a migrated peer resumes
        with its quarantine view intact: open breakers stay open with
        their remaining cooldown, streaks and lifetime counters carry
        over). Existing entries for the same peer are overwritten — the
        ticket is the authority on the pre-move state."""
        now = self._clock()
        for pid_s, rec in state.items():
            h = self._h(int(pid_s))
            h.state = str(rec.get("state", CLOSED))
            h.failures = int(rec.get("failures", 0))
            h.opened_at = now - float(rec.get("opened_age_s", 0.0))
            h.probing = bool(rec.get("probing", False))
            h.opens = int(rec.get("opens", 0))
            h.closes = int(rec.get("closes", 0))
            h.fast_fails = int(rec.get("fast_fails", 0))
            h.successes = int(rec.get("successes", 0))
            h.total_failures = int(rec.get("total_failures", 0))
