# The port's own copy of biscotti_tpu/runtime/placement.py: torch-free, and it imports nothing of biscotti_tpu.
"""Elastic fleet plane: load-aware placement + live peer migration.

The hive runtime (docs/HIVE.md) broke the single-box wall, but placement
froze at launch: a hot or slow host kept its peers forever. This module
makes co-hosted peers MOVABLE — the controller drains a live peer from
one hive, serializes it into a *migration ticket* (chain via the
snapshot-bootstrap representation, breaker ledger, admission buckets,
error-feedback residual), and resumes it on another hive with identity,
stake, and round position intact. The surviving-prefix oracle
(runtime/membership.py) is the correctness instrument: a rebalance that
forks the chain or debits honest stake fails its run.

Design rules, inherited from the fault/admission/campaign planes:

* **Decisions are pure and seeded.** `decide(plan, signals, round_idx)`
  is a pure function of the placement seed, the decision round, and
  signals the planes already export — hive RSS / loop-lag drift gauges
  (runtime/hive.py monitor), admission shed rates (docs/ADMISSION.md),
  straggler speed profiles (docs/STRAGGLERS.md) — so every rebalance
  replays from its flags like a fault run.
* **Default OFF is bit-identical.** A disabled `PlacementPlan`
  constructs no controller, emits no `biscotti_migration_*` metric, and
  leaves the seed schedule untouched (tests/test_placement.py guards
  this the same way test_adversary.py guards campaigns).
* **The layout helper is shared.** `hive_layout` is the ONE function
  that maps a cluster onto hosts; `tools/pod_launch` (launcher AND
  supervisor) and the overlay's contiguous-group assumption both
  consume it, so a supervisor-resized host cannot silently break
  `--overlay-group` alignment (`aligned_overlay_group`).

stdlib-only at module level, like `faults.py`/`admission.py`: the config
layer imports `PlacementPlan` from here, so numpy / asyncio / the wire
plane load lazily inside the functions that need them.
"""

from __future__ import annotations

import json
import random
import time
from dataclasses import dataclass, field
from math import gcd
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# Metric families (docs/OBSERVABILITY.md; the tier-1 metric lint checks
# name + label sets both directions).
MOVES_METRIC = "biscotti_migration_moves_total"
MOVES_HELP = ("live peer migrations applied by the placement controller, "
              "by the dominant pressure signal that triggered the move")
DOWNTIME_METRIC = "biscotti_migration_downtime_seconds"
DOWNTIME_HELP = ("per-move wall-clock between drain start and the "
                 "relaunched incarnation's task start")
TICKET_BYTES_METRIC = "biscotti_migration_ticket_bytes"
TICKET_HELP = ("serialized migration-ticket size per move (chain suffix "
               "+ breaker/admission exports + EF residual)")


# --------------------------------------------------------------- layout


def hive_layout(num_nodes: int, num_hosts: int,
                per_host: int = 0) -> List[Tuple[int, int]]:
    """THE host layout: contiguous `(start, count)` peer ranges, one per
    host. With `per_host` pinned (pod_launch's `--peers-per-host`),
    every host gets exactly that many and the cluster size is their sum;
    otherwise `num_nodes` splits as evenly as contiguity allows (the
    first `num_nodes % num_hosts` hosts take one extra). Both the
    launcher and the overlay-group derivation consume THIS function —
    duplicating the arithmetic is how a resized host silently breaks
    the overlay's contiguous-group assumption."""
    hosts = int(num_hosts)
    if hosts < 1:
        raise ValueError("hive_layout needs >= 1 host")
    out: List[Tuple[int, int]] = []
    start = 0
    if per_host:
        for _ in range(hosts):
            out.append((start, int(per_host)))
            start += int(per_host)
        return out
    n = int(num_nodes)
    base, extra = divmod(n, hosts)
    for h in range(hosts):
        count = base + (1 if h < extra else 0)
        out.append((start, count))
        start += count
    return out


def aligned_overlay_group(layout: Sequence[Tuple[int, int]]) -> int:
    """The largest overlay group size that keeps every contiguous group
    inside one host of `layout`: the gcd of the per-host counts (group i
    spans ids [i*g, (i+1)*g), so any host boundary must be a multiple of
    g). Uniform layouts get the whole host as one group — exactly what
    pod_launch passed before — while a supervisor-resized, uneven fleet
    degrades to a smaller aligned group instead of a straddling one."""
    counts = [c for _, c in layout if c > 0]
    if not counts:
        return 1
    g = 0
    for c in counts:
        g = gcd(g, int(c))
    return max(1, g)


# ----------------------------------------------------------------- plan


@dataclass
class PlacementPlan:
    """Seeded load-aware placement (docs/PLACEMENT.md). Disabled by
    default: no controller is constructed and behavior is bit-identical
    to the static fleet."""

    enabled: bool = False
    # decision seed: `decide` is a pure function of (seed, round,
    # signals) — a failing rebalance replays from its flags
    seed: int = 0
    # decision cadence in anchor rounds, and the per-decision move cap
    interval: int = 2
    max_moves: int = 2
    # pressure thresholds; 0 disables the corresponding signal
    rss_hot_bytes: int = 0          # absolute hive RSS
    rss_drift_hot_bytes: int = 0    # windowed RSS drift (leak shape)
    lag_hot_s: float = 0.05         # hive event-loop lag
    shed_hot: float = 0.25          # admission shed fraction of frames
    slow_hot: float = 1.5           # straggler compute-factor multiple
    # never drain a hive below this many peers
    min_hive_peers: int = 1

    def validate(self) -> None:
        if not self.enabled:
            return
        if self.interval < 1:
            raise ValueError("placement_plan.interval must be >= 1")
        if self.max_moves < 1:
            raise ValueError("placement_plan.max_moves must be >= 1")
        if self.min_hive_peers < 1:
            raise ValueError("placement_plan.min_hive_peers must be >= 1")
        for name in ("rss_hot_bytes", "rss_drift_hot_bytes", "lag_hot_s",
                     "shed_hot", "slow_hot"):
            if float(getattr(self, name)) < 0:
                raise ValueError(f"placement_plan.{name} must be >= 0")


@dataclass
class HostSignals:
    """One host's observed load — every field is a signal some plane
    already exports (hive monitor gauges, admission snapshot, straggler
    profiles, trace_round critical path); the controller invents no new
    measurement, it only reads."""

    hive_id: str
    peers: Tuple[int, ...]
    rss_bytes: int = 0
    rss_drift_bytes: int = 0
    loop_lag_s: float = 0.0
    loop_lag_drift_s: float = 0.0
    shed_rate: float = 0.0            # shed frames / admitted+shed frames
    slow_factors: Dict[int, float] = field(default_factory=dict)
    critical_path_s: float = 0.0      # trace_round attribution (optional)


@dataclass(frozen=True)
class Move:
    """One placement decision: relocate `node` from hive `src` to `dst`
    because of the dominant pressure `reason`."""

    node: int
    src: str
    dst: str
    reason: str


def host_pressure(plan: PlacementPlan,
                  sig: HostSignals) -> Tuple[float, str]:
    """Composite normalized pressure of one host, with the DOMINANT
    signal named (it becomes the move's `reason` label). Each armed
    threshold contributes `observed/threshold - 1` when exceeded; an
    idle host scores <= 0. Pure arithmetic — no clocks, no randomness."""
    contributions: List[Tuple[float, str]] = []
    if plan.rss_hot_bytes > 0 and sig.rss_bytes > 0:
        contributions.append(
            (sig.rss_bytes / plan.rss_hot_bytes - 1.0, "rss"))
    if plan.rss_drift_hot_bytes > 0 and sig.rss_drift_bytes > 0:
        contributions.append(
            (sig.rss_drift_bytes / plan.rss_drift_hot_bytes - 1.0,
             "rss_drift"))
    if plan.lag_hot_s > 0 and sig.loop_lag_s > 0:
        contributions.append(
            (sig.loop_lag_s / plan.lag_hot_s - 1.0, "loop_lag"))
    if plan.shed_hot > 0 and sig.shed_rate > 0:
        contributions.append(
            (sig.shed_rate / plan.shed_hot - 1.0, "shed"))
    if plan.slow_hot > 0 and sig.slow_factors:
        worst = max(sig.slow_factors.values())
        contributions.append((worst / plan.slow_hot - 1.0, "slow"))
    if not contributions:
        return 0.0, "none"
    total = sum(max(0.0, c) for c, _ in contributions)
    dominant = max(contributions, key=lambda t: t[0])
    return (total if total > 0 else max(c for c, _ in contributions),
            dominant[1])


def decide(plan: PlacementPlan, signals: Sequence[HostSignals],
           round_idx: int) -> List[Move]:
    """The placement decision: up to `plan.max_moves` relocations from
    hot hosts to the coldest host, PURE in (plan.seed, round_idx,
    signals). Victim selection prefers the hot host's slowest peer (a
    straggler dragging a loaded host is the highest-value move); ties
    break through the seeded RNG so equal clusters still rebalance
    deterministically. A disabled plan — or a fleet with nowhere to
    move to — returns no moves."""
    if not plan.enabled or len(signals) < 2:
        return []
    rng = random.Random((int(plan.seed) * 9973 + int(round_idx)) & 0x7FFFFFFF)
    # mutable working view: peers move between hosts as moves accrue so
    # one decision point cannot overshoot into oscillation
    work = {s.hive_id: {"sig": s, "peers": list(s.peers),
                        "pressure": host_pressure(plan, s)}
            for s in signals}
    moves: List[Move] = []
    for _ in range(plan.max_moves):
        ranked = sorted(work.values(),
                        key=lambda w: (-w["pressure"][0], w["sig"].hive_id))
        hot = next((w for w in ranked
                    if w["pressure"][0] > 0
                    and len(w["peers"]) > plan.min_hive_peers), None)
        if hot is None:
            break
        cold = min((w for w in ranked if w is not hot),
                   key=lambda w: (w["pressure"][0], len(w["peers"]),
                                  w["sig"].hive_id))
        if cold["pressure"][0] >= hot["pressure"][0]:
            break  # nowhere meaningfully colder
        slow = hot["sig"].slow_factors
        worst = max((slow.get(p, 1.0) for p in hot["peers"]), default=1.0)
        candidates = [p for p in hot["peers"]
                      if slow.get(p, 1.0) >= worst] or hot["peers"]
        victim = candidates[rng.randrange(len(candidates))]
        moves.append(Move(node=int(victim), src=hot["sig"].hive_id,
                          dst=cold["sig"].hive_id,
                          reason=hot["pressure"][1]))
        hot["peers"].remove(victim)
        cold["peers"].append(victim)
        # proportional relief: shedding 1 of P peers sheds ~1/P of the
        # host's pressure (and loads the destination by the same grain)
        relief = hot["pressure"][0] / max(1, len(hot["peers"]) + 1)
        hot["pressure"] = (hot["pressure"][0] - relief, hot["pressure"][1])
        cold["pressure"] = (cold["pressure"][0] + relief,
                            cold["pressure"][1])
    return moves


# --------------------------------------------------------------- tickets


def ticket_from_agent(agent) -> Dict:
    """Serialize a LIVE peer into a migration ticket: the chain in its
    snapshot-bootstrap representation (wire.pack_chain — the snapshot path,
    so a pruned chain migrates pruned), the breaker ledger, the
    admission buckets, the top-k error-feedback residual, and the round
    position. Identity keys are NOT in the ticket: keyed deployments
    read them from the shared key_dir and keyless ones re-derive from
    (seed, id) — a ticket on the wire must never be a key-exfiltration
    channel. Must run on the owning event loop (the chain is only ever
    mutated there, so the capture is consistent)."""
    from biscotti_tpu_torch.runtime import wire

    cmeta, carrays = wire.pack_chain(agent.chain.blocks)
    ef = agent._ef_residual
    return {
        "node": int(agent.id),
        "iteration": int(agent.iteration),
        "pruned_weight": int(agent.chain.pruned_weight),
        "pruned_before": int(agent.chain.pruned_before),
        "membership_epoch": int(agent.membership_epoch),
        "health": agent.health.export_state(),
        "admission": agent.admission.export_state(),
        "chain_meta": cmeta,
        "chain_arrays": carrays,
        "ef_residual": None if ef is None else ef,
    }


def ticket_nbytes(ticket: Dict) -> int:
    """Wire-size estimate of one ticket: array payloads + JSON meta —
    what the `biscotti_migration_ticket_bytes` histogram observes and
    the bench's `migration_bytes` key regresses."""
    n = 0
    for arr in ticket.get("chain_arrays", {}).values():
        n += int(getattr(arr, "nbytes", 0))
    ef = ticket.get("ef_residual")
    if ef is not None:
        n += int(getattr(ef, "nbytes", 0))
    meta = {k: v for k, v in ticket.items()
            if k not in ("chain_arrays", "ef_residual")}
    n += len(json.dumps(meta, default=str).encode())
    return n


def ticket_wire(ticket: Dict) -> Tuple[Dict, Dict]:
    """Split a ticket into the (meta, arrays) shape the
    GetMigrationTicket RPC serves: arrays carry the chain payload plus
    the EF residual (when present) under a reserved key the chain codec
    never emits."""
    meta = {k: v for k, v in ticket.items()
            if k not in ("chain_arrays", "ef_residual")}
    arrays = dict(ticket.get("chain_arrays", {}))
    ef = ticket.get("ef_residual")
    if ef is not None:
        arrays["__ef_residual__"] = ef
    return meta, arrays


def ticket_unwire(meta: Dict, arrays: Dict) -> Dict:
    """Reassemble a ticket from a GetMigrationTicket reply — the
    supervisor-side inverse of `ticket_wire`."""
    arrays = dict(arrays)
    ef = arrays.pop("__ef_residual__", None)
    ticket = dict(meta)
    ticket["chain_arrays"] = arrays
    ticket["ef_residual"] = ef
    return ticket


def restore_agent(agent, ticket: Dict) -> bool:
    """Rehydrate a fresh PeerAgent from a ticket (the `ticket=`
    constructor seam): adopt the carried chain through the SAME guarded
    path a snapshot donor's reply takes (_adopt_snapshot — genesis pin,
    quorum authentication, structural verify; a forged ticket is refused
    exactly like a forged snapshot), then restore breaker state,
    admission buckets, EF residual, and the membership epoch. Returns
    True when the chain was adopted (a genesis-height ticket has nothing
    to adopt and still restores the ledgers)."""
    import numpy as np

    from biscotti_tpu_torch.runtime import wire

    blocks = wire.unpack_chain(ticket["chain_meta"],
                               ticket["chain_arrays"])
    adopted = False
    if len(blocks) >= 2:
        adopted = agent._adopt_snapshot(
            blocks, int(ticket.get("pruned_weight", 0)),
            source=int(ticket.get("node", -1)))
    agent.health.restore_state(ticket.get("health", {}))
    agent.admission.restore_state(ticket.get("admission", {}))
    ef = ticket.get("ef_residual")
    if ef is not None:
        agent._ef_residual = np.asarray(ef)
    agent.membership_epoch = max(agent.membership_epoch,
                                 int(ticket.get("membership_epoch", 0)))
    agent._trace("migration_restored",
                 height=int(agent.chain.latest.iteration),
                 adopted=bool(adopted))
    return adopted


# ------------------------------------------------------------ controller


def default_signals(assignment: Dict[int, str],
                    agents: Dict[int, object]) -> List[HostSignals]:
    """Signals derived from live in-process agents: the hive monitor's
    shared readout (when the agents are hive-hosted), each agent's
    admission snapshot, and its seeded straggler profile. Supervisors
    scraping remote processes build HostSignals from the Metrics RPC
    instead (tools/pod_launch --supervise)."""
    by_hive: Dict[str, List[int]] = {}
    for node, hid in sorted(assignment.items()):
        by_hive.setdefault(hid, []).append(node)
    out: List[HostSignals] = []
    for hid, nodes in sorted(by_hive.items()):
        rss = drift = 0
        lag = lag_drift = 0.0
        shed = admitted = 0
        slow: Dict[int, float] = {}
        for n in nodes:
            a = agents.get(n)
            if a is None:
                continue
            info = getattr(a, "hive_info", None)
            if info:
                rss = max(rss, int(info.get("rss_bytes", 0)))
                drift = max(drift, int(info.get("rss_drift_bytes", 0)))
                lag = max(lag, float(info.get("loop_lag_s", 0.0)))
                lag_drift = max(lag_drift,
                                float(info.get("loop_lag_drift_s", 0.0)))
            snap = a.admission.snapshot()
            shed += int(snap.get("shed_total", 0))
            admitted += int(snap.get("inflight_peak", 0)) + 1
            factor = float(getattr(a.slow, "compute_factor", 1.0))
            if factor != 1.0:
                slow[n] = factor
        out.append(HostSignals(
            hive_id=hid, peers=tuple(nodes), rss_bytes=rss,
            rss_drift_bytes=drift, loop_lag_s=lag,
            loop_lag_drift_s=lag_drift,
            shed_rate=shed / max(1, shed + admitted),
            slow_factors=slow))
    return out


class PlacementController:
    """Drive a live cluster under a placement plan — the elastic-fleet
    sibling of membership.ChurnRunner (and deliberately shaped like it:
    anchor-height decision points, hard drains, fresh incarnations).

    `make_agent(node_id, hive_id, ticket)` constructs an agent for
    `node_id` placed on `hive_id`; `ticket` is None at initial launch
    and a migration ticket on every relocation (the factory passes it to
    PeerAgent(..., ticket=...) so the incarnation resumes instead of
    rejoining cold). `signals_fn(assignment, agents)` produces the
    HostSignals each decision point reads — defaulting to
    `default_signals` over the live agents; tests inject synthetic
    signal sequences through it, which is the controller seam the
    tests drive."""

    def __init__(self, make_agent: Callable[[int, str, Optional[Dict]],
                                            object],
                 assignment: Dict[int, str], plan: PlacementPlan,
                 signals_fn: Optional[Callable[[Dict[int, str],
                                               Dict[int, object]],
                                              List[HostSignals]]] = None,
                 anchor: int = 0, poll_s: float = 0.1, registry=None):
        if not plan.enabled:
            # the bit-identity guard is structural: a disabled plan never
            # reaches a controller object at all
            raise ValueError("PlacementController requires an enabled "
                             "PlacementPlan (--placement)")
        self.make_agent = make_agent
        self.assignment = dict(assignment)
        self.plan = plan
        self.signals_fn = signals_fn or default_signals
        self.anchor = anchor
        self.poll_s = poll_s
        self.registry = registry
        self.moves_applied: List[Tuple[int, int, str, str]] = []
        self.downtimes_s: List[float] = []
        self.ticket_bytes: List[int] = []

    # ------------------------------------------------------------ moves

    async def _hard_kill(self, agent, task) -> None:
        task.cancel()
        try:
            await task
        except BaseException:
            pass
        agent.pool.close()
        agent.server.close_now()

    async def migrate(self, mv: Move, agents: Dict[int, object],
                      tasks: Dict[int, object], round_idx: int) -> bool:
        """Apply one move: capture the ticket from the LIVE agent (on
        the loop, so the chain view is consistent), hard-drain the old
        incarnation, relaunch on the destination with the ticket. Public
        — the mid-intake degradation tests drive this seam directly."""
        import asyncio

        agent = agents.get(mv.node)
        task = tasks.get(mv.node)
        if agent is None or task is None or task.done():
            return False
        t0 = time.monotonic()
        ticket = ticket_from_agent(agent)
        nbytes = ticket_nbytes(ticket)
        await self._hard_kill(agent, task)
        self.assignment[mv.node] = mv.dst
        agents[mv.node] = self.make_agent(mv.node, mv.dst, ticket)
        tasks[mv.node] = asyncio.ensure_future(agents[mv.node].run())
        downtime = time.monotonic() - t0
        self.moves_applied.append((int(round_idx), int(mv.node),
                                   mv.src, mv.dst))
        self.downtimes_s.append(downtime)
        self.ticket_bytes.append(nbytes)
        if self.registry is not None:
            self.registry.counter(MOVES_METRIC, MOVES_HELP).inc(
                reason=mv.reason)
            self.registry.histogram(DOWNTIME_METRIC,
                                    DOWNTIME_HELP).observe(downtime)
            self.registry.histogram(TICKET_BYTES_METRIC,
                                    TICKET_HELP).observe(float(nbytes))
        return True

    # -------------------------------------------------------------- run

    async def run(self) -> List[Dict]:
        import asyncio

        agents: Dict[int, object] = {}
        tasks: Dict[int, object] = {}
        for node, hid in sorted(self.assignment.items()):
            agents[node] = self.make_agent(node, hid, None)
            tasks[node] = asyncio.ensure_future(agents[node].run())
        next_decision = self.plan.interval
        try:
            while True:
                anchor_task = tasks.get(self.anchor)
                if anchor_task is not None and anchor_task.done():
                    break
                height = agents[self.anchor].iteration
                if height >= next_decision:
                    round_idx = next_decision
                    next_decision += self.plan.interval
                    signals = self.signals_fn(dict(self.assignment),
                                              agents)
                    for mv in decide(self.plan, signals, round_idx):
                        await self.migrate(mv, agents, tasks, round_idx)
                await asyncio.sleep(self.poll_s)
            results = await asyncio.gather(*tasks.values(),
                                           return_exceptions=True)
        except BaseException:
            for t in tasks.values():
                t.cancel()
            await asyncio.gather(*tasks.values(), return_exceptions=True)
            raise
        out = []
        for node, res in zip(tasks.keys(), results):
            if isinstance(res, BaseException):
                a = agents[node]
                out.append({"node": node, "iterations": a.iteration,
                            "converged": a.converged,
                            "chain_dump": a.chain.dump(),
                            "counters": dict(a.counters),
                            "telemetry": a.telemetry_snapshot(),
                            "killed": True})
            else:
                out.append(res)
        for r in out:
            r["hive"] = self.assignment.get(int(r["node"]))
            r["migrations"] = sum(1 for _, n, _, _ in self.moves_applied
                                  if n == int(r["node"]))
        return sorted(out, key=lambda r: int(r["node"]))

    def summary(self) -> Dict:
        """Replayable record of what the controller did — chaos/soak
        reports embed this next to the churn/upgrade timelines."""
        return {
            "enabled": True,
            "seed": self.plan.seed,
            "interval": self.plan.interval,
            "moves": [[r, n, s, d] for r, n, s, d in self.moves_applied],
            "downtime_s": [round(d, 4) for d in self.downtimes_s],
            "ticket_bytes": list(self.ticket_bytes),
            "assignment": {str(k): v
                           for k, v in sorted(self.assignment.items())},
        }
