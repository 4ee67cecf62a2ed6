# The port's own copy of biscotti_tpu/runtime/stragglers.py: torch-free, and it imports nothing of biscotti_tpu.
"""Straggler-tolerance plane: adaptive round deadlines + stall forensics.

The reference advances rounds on FIXED deadline constants sized for a
homogeneous 100-node fleet (`Timeouts.block_s=300`, `update_s=90`;
ref: DistSys/main.go:28-36) — a healthy fast cluster waits the full 300 s
on a dead miner, while a slow-but-honest fleet gets silently cut out of
rounds it could have finished. This module replaces the blind constants
with a per-peer **DeadlineController**: each deadline-bearing phase
(block wait, miner update/share intake, verifier krum timer, worker
collection fan-outs) feeds its observed durations into an EWMA + rolling
p95, and the NEXT round's deadline becomes

    clamp(max(ewma, p95) * margin,  floor_s,  legacy constant)

so the legacy constant is the ceiling the controller can only tighten
(never exceed — the reference's scaled() budget stays the worst case) and
the floor keeps a burst of fast rounds from collapsing the deadline below
network jitter. Until `min_samples` observations exist the controller
answers the legacy constant verbatim: warm-up is bit-identical seed
behavior, and so is the disabled controller (cfg.adaptive_deadlines=0).

Stall forensics ride along (armed or not): collection points publish
WHAT they are waiting on (phase + peer ids), a per-round watchdog counts
rounds stuck past half their block deadline
(`biscotti_round_stalls_total{phase}`), and partial-quorum proceeds count
the honest stragglers they left behind
(`biscotti_straggler_excluded_total{phase}`) — exclusions are an
observability event, NEVER breaker or stake evidence (the BusyError
precedent, docs/ADMISSION.md).

stdlib-only by design, like faults.py/admission.py: imported next to the
config layer and by the telemetry-off path.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional

# deadline-bearing phase names (one vocabulary for the controller, the
# metrics labels, the waiting-on readout, and the docs)
BLOCK = "block"      # everyone: round-advancing block wait
UPDATE = "update"    # miner: plain-mode update intake
SHARE = "share"      # miner: secure-agg share intake
KRUM = "krum"        # verifier: defense-decision timer
VERIFY = "verify"    # worker: verifier-signature fan-out
NOISE = "noise"      # worker: noiser-response fan-out

EXCLUDED_METRIC = "biscotti_straggler_excluded_total"
EXCLUDED_HELP = ("honest stragglers a partial-quorum collection point "
                 "proceeded without (never breaker/stake evidence)")
STALLS_METRIC = "biscotti_round_stalls_total"
STALLS_HELP = "rounds observed stuck past the stall threshold, by phase"
DEADLINE_GAUGE = "biscotti_deadline_seconds"
DEADLINE_HELP = "current adaptive deadline decision per phase"


class DeadlineController:
    """Per-peer adaptive deadline state (see module docstring).

    `observe(phase, dt)` feeds one completed-phase duration;
    `deadline(phase, legacy)` answers the budget the NEXT wait on that
    phase should use, recording the decision for the snapshot/trace
    surfaces. `clock` is injectable for tests (history timestamps only —
    the math itself is clock-free).
    """

    def __init__(self, enabled: bool = False, margin: float = 1.5,
                 floor_s: float = 1.0, quantile: float = 0.95,
                 window: int = 64, min_samples: int = 3,
                 alpha: float = 0.2,
                 clock: Callable[[], float] = time.monotonic,
                 history: int = 128):
        self.enabled = bool(enabled)
        self.margin = max(1.0, float(margin))
        self.floor_s = max(0.0, float(floor_s))
        self.quantile = min(1.0, max(0.0, float(quantile)))
        self.window = max(4, int(window))
        self.min_samples = max(1, int(min_samples))
        self.alpha = min(1.0, max(0.0, float(alpha)))
        self._clock = clock
        self._samples: Dict[str, deque] = {}
        self._ewma: Dict[str, float] = {}
        self._last: Dict[str, Dict] = {}     # last decision per phase
        # bounded decision log (chaos report "deadline history")
        self.history: deque = deque(maxlen=max(8, int(history)))

    # ------------------------------------------------------------ intake

    def observe(self, phase: str, dt: float) -> None:
        """One completed phase duration (seconds). Cheap: a deque append
        and one multiply — safe on the hot path whether or not the
        controller is enabled (observations are how a later --adaptive-
        deadlines restart would warm up instantly from a chaos rerun)."""
        dt = max(0.0, float(dt))
        q = self._samples.get(phase)
        if q is None:
            q = self._samples[phase] = deque(maxlen=self.window)
            self._ewma[phase] = dt
        else:
            a = self.alpha
            self._ewma[phase] = a * dt + (1.0 - a) * self._ewma[phase]
        q.append(dt)

    # ----------------------------------------------------------- readout

    def p95(self, phase: str) -> Optional[float]:
        q = self._samples.get(phase)
        if not q:
            return None
        s = sorted(q)
        # index of the quantile-crossing sample (ceil rank, 0-based)
        idx = min(len(s) - 1, max(0, int(self.quantile * len(s) + 0.999) - 1))
        return s[idx]

    def estimate(self, phase: str) -> Optional[float]:
        """The controller's raw duration estimate: max(EWMA, p95) — EWMA
        tracks drift, the windowed p95 keeps one fast burst from
        forgetting the distribution's tail."""
        p = self.p95(phase)
        if p is None:
            return None
        return max(self._ewma.get(phase, p), p)

    def deadline(self, phase: str, legacy: float) -> float:
        """The budget the next `phase` wait should use, with the decision
        recorded (snapshot + history). Disabled, or short of
        `min_samples` observations: the legacy constant verbatim — the
        bit-identity contract."""
        decided = float(legacy)
        est = self.estimate(phase)
        samples = len(self._samples.get(phase, ()))
        adaptive = (self.enabled and est is not None
                    and samples >= self.min_samples)
        if adaptive:
            decided = min(float(legacy),
                          max(self.floor_s, est * self.margin))
        rec = {"phase": phase, "deadline_s": round(decided, 4),
               "legacy_s": float(legacy), "adaptive": adaptive,
               "samples": samples,
               "est_s": round(est, 4) if est is not None else None}
        if self._last.get(phase, {}).get("deadline_s") != rec["deadline_s"] \
                or self._last.get(phase, {}).get("adaptive") != adaptive:
            self.history.append({**rec, "ts": self._clock()})
        self._last[phase] = rec
        return decided

    def snapshot(self) -> Dict:
        """Structured readout for telemetry_snapshot()["stragglers"]:
        per-phase sample stats + the last decision, plus the bounded
        decision history."""
        phases: Dict[str, Dict] = {}
        for phase, q in self._samples.items():
            phases[phase] = {
                "samples": len(q),
                "ewma_s": round(self._ewma.get(phase, 0.0), 4),
                "p95_s": round(self.p95(phase) or 0.0, 4),
            }
            last = self._last.get(phase)
            if last is not None:
                phases[phase].update(
                    deadline_s=last["deadline_s"],
                    adaptive=last["adaptive"])
        return {"enabled": self.enabled, "margin": self.margin,
                "floor_s": self.floor_s, "phases": phases,
                "history": list(self.history)}


class StragglerLedger:
    """Per-peer straggler forensics: who each collection point is
    currently waiting on, how many honest stragglers partial-quorum
    proceeds excluded, and how many rounds stalled. One instance per
    agent; `metrics` (a telemetry registry) is attached by the peer so
    every tally is scrape-visible."""

    def __init__(self):
        self.metrics = None
        self.excluded: Dict[str, int] = {}     # phase -> count
        self.stalls: Dict[str, int] = {}       # phase -> count
        # live waiting-on view: phase -> sorted awaited peer ids. Entries
        # are set while a collection point is blocked and cleared when it
        # resolves — the obs cluster table's `waiting-on` column.
        self.waiting_on: Dict[str, List[int]] = {}
        self.last_stall: Optional[Dict] = None

    # ------------------------------------------------------- bookkeeping

    def waiting(self, phase: str, peers) -> None:
        peers = sorted(int(p) for p in peers)
        if peers:
            self.waiting_on[phase] = peers
        else:
            self.waiting_on.pop(phase, None)

    def clear(self, phase: str) -> None:
        self.waiting_on.pop(phase, None)

    def exclude(self, phase: str, peers) -> int:
        n = len(list(peers))
        if n <= 0:
            return 0
        self.excluded[phase] = self.excluded.get(phase, 0) + n
        if self.metrics is not None:
            self.metrics.counter(EXCLUDED_METRIC, EXCLUDED_HELP).inc(
                n, phase=phase)
        return n

    def stall(self, phase: str, peers, height: int) -> None:
        self.stalls[phase] = self.stalls.get(phase, 0) + 1
        self.last_stall = {"phase": phase,
                           "peers": sorted(int(p) for p in peers),
                           "height": int(height)}
        if self.metrics is not None:
            self.metrics.counter(STALLS_METRIC, STALLS_HELP).inc(phase=phase)

    # ----------------------------------------------------------- readout

    def snapshot(self) -> Dict:
        return {
            "excluded": dict(self.excluded),
            "stalls": dict(self.stalls),
            "waiting_on": {ph: list(ps)
                           for ph, ps in self.waiting_on.items()},
            "last_stall": dict(self.last_stall) if self.last_stall else None,
        }
