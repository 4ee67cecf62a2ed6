# The port's own copy of biscotti_tpu/runtime/admission.py: torch-free, and it imports nothing of biscotti_tpu.
"""Overload-governance plane: admission control for the live runtime.

Biscotti's threat model lets ANY peer send ANYTHING — and before this
module, send it *as fast as it likes*: the RPC server spawned one unbounded
task per inbound frame, handlers parked callers in unbounded wait loops,
and no per-peer budget existed anywhere, so a single flooding or slow-loris
peer could exhaust an honest peer's memory and event loop without ever
failing a signature check. Making overload a survivable, *observable*
condition is the system-support-for-Byzantine-ML line of Garfield
(arXiv:2010.05888) and the volunteer-hostile setting of "Secure Distributed
Training at Scale" (arXiv:2106.11257).

Pieces (docs/ADMISSION.md):

  * `AdmissionPlan` — frozen config surface on `BiscottiConfig` (like
    `fault_plan`): per-message-class token-bucket rates, per-peer and
    global inflight-handler caps, a bounded parked-waiter budget, and the
    mid-frame read deadline `rpc.FrameStream` enforces against slow-loris
    connections. Disabled by default: a bare config behaves like the seed.
  * `TokenBucket` — standard refill-on-read bucket with injectable clock.
  * `ParkingLot` — the counted, capped replacement for the unbounded
    `_wait_for_iteration`/`_wait_round_ready` sleep loops: when the budget
    is exhausted the OLDEST waiter is shed (woken with a retryable busy
    signal) rather than the lot growing without bound.
  * `AdmissionController` — per-agent enforcement state. The RPC server
    consults `try_admit(peer, msg_type)` for every decoded frame; over-
    budget work is SHED with a retryable `rpc.BusyError` wire status
    instead of queued without bound. Every shed increments
    `biscotti_shed_total{reason,msg_type}`; inflight/parked levels ride
    `biscotti_inflight_handlers` / `biscotti_parked_waiters` gauges plus
    high-water marks in the structured snapshot.

Shedding is deliberately NOT a security verdict: a busy honest peer and a
flooding Byzantine one get the same `BusyError`, and the client side
(`PeerAgent._call`) treats it as retry-with-backoff that never feeds the
`HealthLedger` breaker — overload must not quarantine honest peers.

stdlib-only, like `faults.py`: imported by the config layer, so it must
pull in neither numpy nor asyncio machinery.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

# metric names shared by the controller's push-on-change updates and the
# peer's pull-refresh at scrape time — one definition, or the registry
# would fork the series on any drift
SHED_METRIC = "biscotti_shed_total"
SHED_HELP = "inbound work refused by the admission plane"
INFLIGHT_GAUGE = "biscotti_inflight_handlers"
INFLIGHT_HELP = "inbound RPC handler tasks currently running"
PARKED_GAUGE = "biscotti_parked_waiters"
PARKED_HELP = "handlers parked waiting for a future round"

# ------------------------------------------------------- message classes

# Token-bucket rates are per MESSAGE CLASS, not per method: the classes
# group methods by cost profile, so the config surface stays three knobs
# instead of thirteen.
BULK = "bulk"        # multi-MB bodies: block push/pull, chain adoption
UPDATE = "update"    # per-round protocol writes: updates, shares, verify
CONTROL = "control"  # small control/read frames

_MSG_CLASS: Dict[str, str] = {
    "RegisterBlock": BULK,
    "RegisterPeer": BULK,
    "GetBlock": BULK,
    "RegisterUpdate": UPDATE,
    "RegisterSecret": UPDATE,
    "VerifyUpdateKRUM": UPDATE,
    "VerifyUpdateRONI": UPDATE,
    "RequestNoise": UPDATE,
    # membership plane (docs/MEMBERSHIP.md): a snapshot reply is the
    # biggest frame the protocol serves (a whole sealed chain suffix),
    # and a reshare deal carries per-row commitment grids — both budget
    # as bulk so join storms and reshare rounds cannot starve the
    # round-critical update class
    "GetSnapshot": BULK,
    "GetReshareDeal": BULK,
    # hierarchical aggregation overlay (runtime/overlay.py,
    # docs/OVERLAY.md): offers carry a worker's FULL share/blind/
    # commitment tensors, aggregates a whole subtree's sums, and relay
    # frames fan a block/update out — all multi-payload bodies. Classed
    # bulk so a hot interior node SHEDS overlay load (the sender then
    # degrades to the seed's direct delivery) instead of melting.
    "OverlayOffer": BULK,
    "RegisterAggregate": BULK,
    "RelayFrames": BULK,
    "AdvertiseBlock": CONTROL,
    "RegisterDecline": CONTROL,
    "GetUpdateList": CONTROL,
    "GetMinerPart": CONTROL,
    "Metrics": CONTROL,
}


def msg_class(msg_type: str) -> str:
    """Unknown methods are classed BULK — the conservative budget (they
    will be rejected by dispatch anyway, but they must not enjoy the
    generous control-plane rate while doing so)."""
    return _MSG_CLASS.get(msg_type, BULK)


@dataclass(frozen=True)
class AdmissionPlan:
    """Overload-governance knobs (surfaced as cfg.admission_plan).

    Rates are tokens/second PER (peer, class); bucket capacity is
    rate × burst_factor, so short honest bursts (a round boundary's
    gossip fan-in) ride the burst while sustained floods drain the
    bucket and shed. Inflight caps bound concurrently-running handler
    tasks; `max_parked` bounds waiters parked for a future round;
    `read_deadline_s` bounds how long one frame may stay partially
    received before the connection is dropped (slow-loris)."""

    enabled: bool = False
    update_rate: float = 80.0
    bulk_rate: float = 40.0
    control_rate: float = 160.0
    burst_factor: float = 2.0
    peer_inflight: int = 32      # concurrent handlers per peer
    global_inflight: int = 256   # concurrent handlers, all peers
    max_parked: int = 128        # parked round-waiters, all peers
    # sized so one window fits a full wire-chunk (4 MiB default) on a
    # ~1.5 Mbps link: chunk completions count as progress, so a chunked
    # multi-MB transfer only needs one chunk per window — but UNCHUNKED
    # near-MAX_FRAME payloads on slow WAN links need this raised above
    # frame_bytes / link_rate
    read_deadline_s: float = 30.0

    def class_rate(self, cls: str) -> Tuple[float, float]:
        """(tokens/s, bucket capacity) for one message class."""
        rate = {UPDATE: self.update_rate, BULK: self.bulk_rate,
                CONTROL: self.control_rate}.get(cls, self.bulk_rate)
        return rate, rate * self.burst_factor

    def validate(self) -> None:
        if not self.enabled:
            return
        for name, v in (("update_rate", self.update_rate),
                        ("bulk_rate", self.bulk_rate),
                        ("control_rate", self.control_rate),
                        ("burst_factor", self.burst_factor)):
            if v <= 0:
                raise ValueError(f"admission_plan.{name} must be > 0")
        for name, v in (("peer_inflight", self.peer_inflight),
                        ("global_inflight", self.global_inflight),
                        ("max_parked", self.max_parked)):
            if int(v) < 1:
                raise ValueError(f"admission_plan.{name} must be >= 1")


class TokenBucket:
    """Refill-on-read token bucket. `clock` is injectable so rate tests
    run on a fake clock (same pattern as faults.HealthLedger)."""

    __slots__ = ("rate", "burst", "tokens", "_last", "_clock")

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._clock = clock
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def is_full(self) -> bool:
        """True when the bucket has refilled to its full burst — its
        state is then indistinguishable from a brand-new bucket's (the
        lossless-eviction invariant)."""
        self._refill()
        return self.tokens >= self.burst


class ParkToken:
    """One parked waiter. The parked coroutine polls `shed` each tick of
    its wait loop (the loops already sleep in 20–50 ms ticks, so a shed
    surfaces within one tick) and raises `rpc.BusyError` when set."""

    __slots__ = ("kind", "shed", "seq")

    def __init__(self, kind: str, seq: int):
        self.kind = kind
        self.shed: Optional[str] = None
        self.seq = seq


class ParkingLot:
    """Counted, capped parked-waiter budget. At capacity the OLDEST
    waiter is shed to make room — the newest message is the freshest
    evidence of real traffic, while the oldest waiter has already
    burned the most of its budget and is the most likely to be stale.
    With cap <= 0 the lot only counts (legacy unbounded behavior)."""

    def __init__(self, cap: int = 0):
        self.cap = int(cap)
        self._seq = 0
        self._waiting: Dict[int, ParkToken] = {}  # insertion-ordered
        self.peak = 0
        self.shed_count = 0

    def __len__(self) -> int:
        return len(self._waiting)

    def park(self, kind: str) -> Tuple[ParkToken, Optional[ParkToken]]:
        """Returns (token, shed_victim): the victim is the oldest waiter
        evicted to make room (already marked shed), None otherwise."""
        self._seq += 1
        tok = ParkToken(kind, self._seq)
        shed: Optional[ParkToken] = None
        if self.cap > 0 and len(self._waiting) >= self.cap:
            oldest = next(iter(self._waiting))
            shed = self._waiting.pop(oldest)
            shed.shed = "parked_cap"
            self.shed_count += 1
        self._waiting[tok.seq] = tok
        self.peak = max(self.peak, len(self._waiting))
        return tok, shed

    def unpark(self, tok: ParkToken) -> None:
        self._waiting.pop(tok.seq, None)


class AdmissionController:
    """Per-agent admission state: one consult per decoded inbound frame.

    `try_admit(peer, msg_type)` returns None when the frame may spawn a
    handler (the caller MUST pair it with `release(peer)` when the
    handler finishes) or a shed-reason string when it must be refused
    with `rpc.BusyError`. With the plan disabled every frame is admitted
    and only the (cheap) inflight accounting runs, so the gauges stay
    meaningful in observability-only deployments."""

    # bucket-table cardinality cap: past it, NEW budget keys share one
    # overflow bucket per class. Closes the fresh-bucket bypass — a
    # flooder spinning fabricated source_ids (or redialing for a new
    # ephemeral-port peername) would otherwise mint itself a full burst
    # allowance per spin AND grow this dict without bound; spun keys all
    # landing in one fast-draining bucket makes the spin itself the
    # thing that gets rate-limited. Honest clusters (N well below the
    # cap, 3 classes each) never touch the overflow path.
    BUCKET_CAP = 4096

    def __init__(self, plan: AdmissionPlan, metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        self.plan = plan
        self.metrics = metrics  # telemetry.MetricsRegistry or None
        self._clock = clock
        self._buckets: Dict[Tuple[object, str], TokenBucket] = {}
        # per-peer inflight is self-bounding (entries are removed when
        # they drain, so the dict never exceeds the concurrent-handler
        # count), unlike the bucket table above
        self._inflight: Dict[object, int] = {}
        self.inflight_total = 0
        self.inflight_peak = 0
        self.parking = ParkingLot(plan.max_parked if plan.enabled else 0)
        # shed tallies by reason (msg_type detail rides the metric labels)
        self.shed_counts: Dict[str, int] = {}

    # ------------------------------------------------------------ admit

    def try_admit(self, peer, msg_type: str) -> Optional[str]:
        plan = self.plan
        if plan.enabled:
            if self.inflight_total >= plan.global_inflight:
                return self._shed("global_inflight", msg_type)
            if self._inflight.get(peer, 0) >= plan.peer_inflight:
                return self._shed("peer_inflight", msg_type)
            cls = msg_class(msg_type)
            key = (peer, cls)
            bucket = self._buckets.get(key)
            if bucket is None:
                if len(self._buckets) >= self.BUCKET_CAP:
                    self._evict_full_buckets()
                if len(self._buckets) >= self.BUCKET_CAP:
                    key = ("overflow", cls)
                    bucket = self._buckets.get(key)
                if bucket is None:
                    rate, burst = plan.class_rate(cls)
                    bucket = self._buckets[key] = TokenBucket(
                        rate, burst, clock=self._clock)
            if not bucket.try_take():
                return self._shed("rate", msg_type)
        self._inflight[peer] = self._inflight.get(peer, 0) + 1
        self.inflight_total += 1
        self.inflight_peak = max(self.inflight_peak, self.inflight_total)
        if self.metrics is not None:
            self.metrics.gauge(INFLIGHT_GAUGE, INFLIGHT_HELP).set(
                self.inflight_total)
        return None

    def _evict_full_buckets(self) -> None:
        """Drop every bucket that has refilled to its full burst — a
        LOSSLESS eviction (TokenBucket.is_full). Dead keys (closed
        connections, departed peers) go idle, refill, and get reaped
        here the next time the table hits its cap, so reconnect churn
        cannot saturate the cap permanently; an attacker's
        actively-drained buckets are NOT full and stay pinned, so
        spinning identities still funnels into the shared overflow
        bucket instead of minting fresh burst."""
        dead = [k for k, b in self._buckets.items() if b.is_full()]
        for k in dead:
            del self._buckets[k]

    def release(self, peer) -> None:
        n = self._inflight.get(peer, 0)
        if n <= 1:
            self._inflight.pop(peer, None)
        else:
            self._inflight[peer] = n - 1
        self.inflight_total = max(0, self.inflight_total - 1)
        if self.metrics is not None:
            self.metrics.gauge(INFLIGHT_GAUGE, INFLIGHT_HELP).set(
                self.inflight_total)

    def _shed(self, reason: str, msg_type: str) -> str:
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1
        if self.metrics is not None:
            self.metrics.counter(SHED_METRIC, SHED_HELP).inc(
                reason=reason, msg_type=msg_type)
        return reason

    # ------------------------------------------------------------- park

    def park(self, kind: str) -> ParkToken:
        tok, victim = self.parking.park(kind)
        if victim is not None:
            # namespaced label: park kinds must not masquerade as RPC
            # method names in the shed metric's msg_type vocabulary
            self._shed("parked_cap", "park:" + victim.kind)
        if self.metrics is not None:
            self.metrics.gauge(PARKED_GAUGE, PARKED_HELP).set(
                len(self.parking))
        return tok

    def unpark(self, tok: ParkToken) -> None:
        self.parking.unpark(tok)
        if self.metrics is not None:
            self.metrics.gauge(PARKED_GAUGE, PARKED_HELP).set(
                len(self.parking))

    # ---------------------------------------------------------- readout

    def snapshot(self) -> Dict[str, object]:
        """Structured readout for `PeerAgent.telemetry_snapshot()` — the
        chaos report and the acceptance assertions (bounded peaks, shed
        tallies) read THIS, not private state."""
        return {
            "enabled": self.plan.enabled,
            "shed": dict(self.shed_counts),
            "shed_total": sum(self.shed_counts.values()),
            "inflight": self.inflight_total,
            "inflight_peak": self.inflight_peak,
            "parked": len(self.parking),
            "parked_peak": self.parking.peak,
            "caps": {
                "peer_inflight": self.plan.peer_inflight,
                "global_inflight": self.plan.global_inflight,
                "max_parked": self.plan.max_parked,
            },
        }

    # --------------------------------------------------------- migration

    def export_state(self) -> Dict[str, object]:
        """Rate-governance state for a migration ticket
        (runtime/placement.py): shed tallies + peaks (forensics survive
        the move) and every token bucket's current fill, keyed by
        "peer|class" strings so the export is JSON-clean. Inflight and
        parked waiters are NOT exported — they are handler tasks, which
        by definition die with the old incarnation."""
        buckets = {}
        for (peer, cls), b in self._buckets.items():
            b._refill()
            buckets[f"{peer}|{cls}"] = round(float(b.tokens), 6)
        return {
            "shed_counts": dict(self.shed_counts),
            "inflight_peak": self.inflight_peak,
            "parked_peak": self.parking.peak,
            "parked_shed": self.parking.shed_count,
            "buckets": buckets,
        }

    def restore_state(self, state: Dict[str, object]) -> None:
        """Rehydrate an export: a flooder must not get a fresh burst
        allowance just because its victim migrated — drained buckets
        come back drained. Bucket keys whose peer id parses as an int
        are restored under the int key (the runtime's peer key type);
        anything else (overflow, peername tuples) restores under the
        string, which the overflow path still matches."""
        for reason, n in dict(state.get("shed_counts", {})).items():
            self.shed_counts[reason] = (self.shed_counts.get(reason, 0)
                                        + int(n))
        self.inflight_peak = max(self.inflight_peak,
                                 int(state.get("inflight_peak", 0)))
        self.parking.peak = max(self.parking.peak,
                                int(state.get("parked_peak", 0)))
        self.parking.shed_count += int(state.get("parked_shed", 0))
        for key, tokens in dict(state.get("buckets", {})).items():
            peer_s, _, cls = key.rpartition("|")
            try:
                peer: object = int(peer_s)
            except ValueError:
                peer = peer_s
            rate, burst = self.plan.class_rate(cls)
            b = self._buckets.get((peer, cls))
            if b is None:
                if len(self._buckets) >= self.BUCKET_CAP:
                    continue  # the overflow path re-limits organically
                b = self._buckets[(peer, cls)] = TokenBucket(
                    rate, burst, clock=self._clock)
            b.tokens = min(b.burst, float(tokens))
            b._last = self._clock()
