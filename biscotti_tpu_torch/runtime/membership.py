# The port's own copy of biscotti_tpu/runtime/membership.py: torch-free, and it imports nothing of biscotti_tpu.
"""Dynamic-membership harness: drive a live cluster through a seeded
churn schedule, and judge the outcome on the SURVIVING prefix.

The schedule itself is pure in the seed (faults.FaultPlan.churn_schedule:
kill / restart / join events per (node, round)); this module is the
launcher that makes those events REAL against in-process PeerAgents —
kills tear sockets down mid-round exactly like the hard-kill chaos tests,
restarts and late joins construct a fresh agent (optionally bootstrapping
from its own checkpoint dir, or from a cluster snapshot when
cfg.snapshot_bootstrap is set) and re-announce. `tools/chaos --churn` and
the churn test suite (tests/test_membership.py) both drive clusters
through this one runner, so a failing churn run replays from its flags
(docs/MEMBERSHIP.md §replay).

Multi-process deployments don't need the runner for kills — each peer's
own round loop honors its schedule (`--fault-churn` self-kill,
faults.ChurnExit) and any supervisor (pod_launch, k8s, systemd) handles
the relaunch; the runner exists so single-box tests get BOTH hard-kill
semantics and deterministic relaunches without shelling out.

The oracle here differs from tools/chaos.chain_oracle on purpose: under
churn, a late joiner that snapshot-bootstrapped holds a PRUNED chain (it
never fetched the pre-snapshot blocks — that's the feature), so dumps
cannot be compared line-by-line from genesis. `surviving_prefix_oracle`
aligns dumps per block HEIGHT and requires equality over every height all
peers hold, up to the settled prefix.
"""

from __future__ import annotations

import asyncio
import re
from typing import Callable, Dict, List, Optional, Tuple

from biscotti_tpu_torch.runtime import faults

_ITER_RE = re.compile(r"^iter=(-?\d+) ")


def _dump_heights(dump: str) -> Dict[int, str]:
    """Chain dump → {height: summary line}, skipping non-block lines
    (the pruned-gap marker a snapshot-bootstrapped chain interleaves)."""
    out: Dict[int, str] = {}
    for ln in dump.splitlines():
        m = _ITER_RE.match(ln)
        if m:
            out[int(m.group(1))] = ln
    return out


def surviving_prefix_oracle(results) -> Tuple[bool, int, int]:
    """Chain-equality judged on the surviving prefix: every height that a
    peer holds inside the cluster's settled range must carry the
    identical block on every other peer that holds it. Returns
    (equal, settled_height, real_blocks) like chaos.chain_oracle —
    settled = min over SURVIVORS of (own head − 1): each peer's last
    block may still be in flight at exit, and a peer whose FINAL
    incarnation died mid-run — hard-killed by the runner (`killed`) or
    self-killed by its own schedule with no restart left (`churned`) —
    reports a legitimately low head that must not collapse the checked
    range: its blocks still join the per-height equality check, it just
    doesn't define how far the check reaches.
    real_blocks counts settled non-empty blocks on the anchor (a run
    whose every surviving block is empty carries no training signal and
    must fail)."""
    maps = [_dump_heights(r["chain_dump"]) for r in results]
    alive_maps = [m for m, r in zip(maps, results)
                  if not (r.get("killed") or r.get("churned"))] or maps
    settled = min(max(m) for m in alive_maps) - 1
    equal = True
    for h in range(-1, settled + 1):
        lines = {m[h] for m in maps if h in m}
        if len(lines) > 1:
            equal = False
            break
    anchor = maps[0]
    real = sum(1 for h in range(0, settled + 1)
               if h in anchor and "ndeltas=0" not in anchor[h])
    return equal, settled, real


class ChurnRunner:
    """Run a cluster under a churn schedule, tearing down and relaunching
    live agents.

    `make_agent(node_id)` constructs a fresh PeerAgent for `node_id`
    (the factory decides ckpt dirs, snapshot bootstrap, etc. — a
    restarted node gets a NEW agent, never a resumed object: real churn
    loses all in-memory state). Kills are driven by the VICTIM's own
    height when its schedule self-kill fires (cfg.fault_plan.churn armed
    on the agents), and by the runner as a hard external kill otherwise;
    restarts/joins are driven by the ANCHOR's height — node 0, which the
    schedule never churns."""

    def __init__(self, make_agent: Callable[[int], object],
                 num_nodes: int, schedule: List[faults.ChurnEvent],
                 anchor: int = 0, poll_s: float = 0.1,
                 migrate_factory: Optional[Callable] = None):
        self.make_agent = make_agent
        self.num_nodes = num_nodes
        self.schedule = sorted(schedule,
                               key=lambda e: (e.round, e.node, e.kind))
        self.anchor = anchor
        self.poll_s = poll_s
        self.events_applied: List[Tuple[int, int, str]] = []
        # MIGRATE events relaunch through this (node, ticket) factory so
        # the fresh incarnation rehydrates from the serialized ticket
        # (runtime/placement.py); without one, MIGRATE degrades to
        # RESTART — real churn semantics, state lost — so a schedule
        # built for a migration-aware harness still runs everywhere
        self.migrate_factory = migrate_factory
        self.migrations: List[Dict] = []

    async def _hard_kill(self, agent, task: asyncio.Task) -> None:
        task.cancel()
        try:
            await task
        except BaseException:
            pass
        # the cancel path already released sockets synchronously
        # (run()'s CancelledError handler); belt and braces for agents
        # killed before run() armed that handler
        agent.pool.close()
        agent.server.close_now()

    async def run(self) -> List[Dict]:
        late = {e.node for e in self.schedule if e.kind == faults.JOIN}
        agents: Dict[int, object] = {}
        tasks: Dict[int, asyncio.Task] = {}
        for i in range(self.num_nodes):
            if i in late:
                continue
            agents[i] = self.make_agent(i)
            tasks[i] = asyncio.ensure_future(agents[i].run())
        pending = list(self.schedule)
        try:
            while pending:
                anchor_task = tasks.get(self.anchor)
                if anchor_task is not None and anchor_task.done():
                    break  # anchor finished: remaining events are moot
                height = agents[self.anchor].iteration
                while pending and pending[0].round <= height:
                    ev = pending.pop(0)
                    await self._apply(ev, agents, tasks)
                await asyncio.sleep(self.poll_s)
            results = await asyncio.gather(
                *tasks.values(), return_exceptions=True)
        except BaseException:
            for t in tasks.values():
                t.cancel()
            await asyncio.gather(*tasks.values(), return_exceptions=True)
            raise
        out = []
        for node, res in zip(tasks.keys(), results):
            if isinstance(res, BaseException):
                # a hard-killed agent whose final incarnation never ran
                # to completion: report its last observable state
                a = agents[node]
                out.append({"node": node, "iterations": a.iteration,
                            "converged": a.converged,
                            "chain_dump": a.chain.dump(),
                            "counters": dict(a.counters),
                            "telemetry": a.telemetry_snapshot(),
                            "killed": True})
            else:
                out.append(res)
        return out

    async def _apply(self, ev: faults.ChurnEvent, agents, tasks) -> None:
        self.events_applied.append((ev.round, ev.node, ev.kind))
        if ev.kind == faults.KILL:
            task = tasks.get(ev.node)
            if task is not None and not task.done():
                await self._hard_kill(agents[ev.node], task)
        elif (ev.kind == faults.MIGRATE
                and self.migrate_factory is not None):
            # live migration (docs/PLACEMENT.md): serialize BEFORE the
            # kill — the ticket is the only thing that survives the
            # teardown — then relaunch from it; downtime spans capture
            # through first schedulable relaunch, the window the bench
            # `migration_downtime_s` key regresses on
            import time as _time

            from biscotti_tpu_torch.runtime import placement

            old = tasks.get(ev.node)
            agent = agents.get(ev.node)
            t0 = _time.monotonic()
            ticket = (placement.ticket_from_agent(agent)
                      if agent is not None else None)
            if old is not None and not old.done():
                await self._hard_kill(agent, old)
            agents[ev.node] = self.migrate_factory(ev.node, ticket)
            tasks[ev.node] = asyncio.ensure_future(agents[ev.node].run())
            self.migrations.append({
                "round": ev.round, "node": ev.node,
                "downtime_s": round(_time.monotonic() - t0, 4),
                "ticket_bytes": (placement.ticket_nbytes(ticket)
                                 if ticket is not None else 0)})
        else:  # RESTART / JOIN: fresh agent, fresh incarnation
            old = tasks.get(ev.node)
            if old is not None and not old.done():
                await self._hard_kill(agents[ev.node], old)
            agents[ev.node] = self.make_agent(ev.node)
            tasks[ev.node] = asyncio.ensure_future(agents[ev.node].run())
