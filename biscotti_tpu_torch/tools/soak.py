# The port's own copy of biscotti_tpu/tools/soak.py; it imports nothing of biscotti_tpu.
# It drops the reference's jax switches and adds `--device`, the peers' torch device.
"""Long-run endurance soak harness: compose churn + an adversary
campaign + stragglers + a flood on ONE seed, loop full cluster cycles
until the wall-clock budget is spent, sample process telemetry on an
interval, and gate the merged readouts on explicit SLOs (docs/SOAK.md).

    python -m biscotti_tpu_torch.tools.soak --minutes 30 --nodes 6 \
        --out SOAK_main.json

Every cycle is a complete composed cluster run — seeded frame faults,
membership churn via the ChurnRunner, a roleflood campaign aimed at the
per-round elected miner, seeded slow speed profiles with adaptive
deadlines, and the admission plane armed — whose protocol seed derives
from ``--seed + cycle``, so any failing cycle replays standalone through
``tools/chaos`` with the same knobs. A 0.25 s poller timestamps the
anchor's height transitions (the per-round latency series the p99 gate
reads) and samples process RSS every ``--sample-s``.

``--migrations-per-cycle`` live-migrates seeded-drawn peers mid-cycle
through the placement ticket path (state survives the move,
docs/PLACEMENT.md) and ``--rolling-upgrade`` starts each cycle's
non-anchor fleet on a historical protocol row and restarts it
wave-by-wave onto the current build mid-cycle (docs/PROTOCOL.md) — so
endurance cycles exercise rebalance + upgrade under churn. The gate
verdicts are unchanged; the scenario (including the drill knobs) is
echoed in the artifact.

SLO gates (lower is better, every limit CLI-overridable; the keys are
named so ``tools/bench_diff`` regresses two soak artifacts out of the
box — its DEFAULT_REGRESS covers all five):

  p99_round_latency_s         p99 over every settled round of every cycle
  cross_host_bytes_per_round  merged outbound TCP bytes / settled rounds
  rss_drift_bytes_per_h       quarter-median RSS drift scaled per hour
                              (runtime/hive.drift — sawtooth-immune)
  shed_rate                   admission sheds per settled round
  stall_rate                  straggler round-stalls per settled round

Exit 0 iff every gate passed AND every cycle's surviving-prefix oracle
held with >= 1 real block. The artifact (``SOAK_<tag>.json``) carries
the gate verdicts ({value, limit, pass}), a top-level ``slos`` mirror of
the gated values (flattened keys end exactly in the gate names), the
per-cycle reports, and the sampled RSS series.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import random
import time
from typing import Dict, List, Tuple


def p99(values: List[float]) -> float:
    """Nearest-rank p99 (no interpolation: a single catastrophic round
    must not be averaged away by its neighbor)."""
    if not values:
        return 0.0
    vs = sorted(values)
    return vs[min(len(vs) - 1, max(0, math.ceil(0.99 * len(vs)) - 1))]


def drift_per_hour(samples: List[Tuple[float, float]]) -> float:
    """RSS leak rate: quarter-median drift (runtime/hive.drift) scaled
    to bytes/hour. The quarter medians sit ~0.75 of the span apart, so
    the scale uses that separation, not the raw span — a window half as
    long must report the same rate for the same slope."""
    from biscotti_tpu_torch.runtime.hive import drift

    if len(samples) < 4:
        return 0.0
    span_s = samples[-1][0] - samples[0][0]
    if span_s <= 0:
        return 0.0
    return drift([v for _, v in samples]) / (0.75 * span_s / 3600.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="long-run composed-scenario soak with SLO gates")
    ap.add_argument("--minutes", type=float, default=30.0,
                    help="wall-clock budget; cycles launch until it is "
                         "spent (at least one always runs) — CI scales "
                         "this down, the acceptance run scales it up")
    ap.add_argument("--nodes", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=12,
                    help="training rounds per cycle")
    ap.add_argument("--seed", type=int, default=0,
                    help="base protocol seed; cycle c runs at seed+c")
    ap.add_argument("--base-port", type=int, default=14200)
    ap.add_argument("--dataset", default="creditcard")
    ap.add_argument("--device", default=None,
                    help="torch device of every peer (default: the "
                         "GPU, which must exist; 'cpu' to run on the "
                         "CPU)")
    ap.add_argument("--secure-agg", type=int, default=0)
    ap.add_argument("--codec", default="f32+zlib",
                    help="wire codec, so the endurance run also soaks "
                         "the coded/chunked frame path")
    ap.add_argument("--churn", type=float, default=0.2)
    ap.add_argument("--churn-period", type=int, default=4)
    ap.add_argument("--churn-down", type=int, default=2)
    ap.add_argument("--campaign-flood", type=int, default=10,
                    help="roleflood replay factor aimed at the elected "
                         "miner (0 disables the campaign)")
    ap.add_argument("--campaign-node", type=int, default=1,
                    help="the flooding attacker id")
    ap.add_argument("--slow", type=float, default=0.25,
                    help="fraction of peers drawn slow per cycle")
    ap.add_argument("--slow-preset", default="bimodal",
                    choices=["", "tee", "bimodal", "longtail"])
    ap.add_argument("--fault-drop", type=float, default=0.05)
    ap.add_argument("--migrations-per-cycle", type=int, default=0,
                    help="live-migrate this many seeded-drawn peers per "
                         "cycle (runtime/placement.py ticket path — "
                         "state survives the move, unlike churn "
                         "restarts), spread evenly across the cycle's "
                         "rounds; gate verdicts unchanged "
                         "(docs/PLACEMENT.md)")
    ap.add_argument("--rolling-upgrade", type=int, default=-1,
                    help="start every non-anchor peer pinned to this "
                         "historical protocol row EACH cycle, then "
                         "restart them wave-by-wave onto the current "
                         "build mid-cycle (docs/PROTOCOL.md) — so "
                         "endurance cycles soak the mixed-version span "
                         "under churn; -1 disables")
    ap.add_argument("--upgrade-period", type=int, default=3,
                    help="rounds between rolling-upgrade waves")
    ap.add_argument("--upgrade-wave", type=int, default=2,
                    help="peers restarted per rolling-upgrade wave")
    ap.add_argument("--sample-s", type=float, default=5.0,
                    help="RSS sampling interval")
    ap.add_argument("--out", default="",
                    help="artifact path (default SOAK_<utc>.json)")
    # --- SLO limits (docs/SOAK.md rationale for each default) ---------
    ap.add_argument("--slo-p99-s", type=float, default=30.0,
                    help="p99 round latency limit: the composed fast-"
                         "timeout scenario settles rounds well under "
                         "half this; past it the cluster is thrashing")
    ap.add_argument("--slo-bytes-per-round", type=float,
                    default=float(64 << 20),
                    help="cross-host bytes/round limit (64 MiB: ~10x "
                         "the composed N=6 scenario's honest traffic)")
    ap.add_argument("--slo-rss-drift", type=float,
                    default=float(512 << 20),
                    help="RSS drift limit in bytes/hour (512 MiB/h: "
                         "JIT warm-up lives in the first quarter-"
                         "median; sustained growth past this is a leak)")
    ap.add_argument("--slo-shed-rate", type=float, default=500.0,
                    help="admission sheds per round limit (the armed "
                         "flood SHOULD shed — the gate bounds runaway "
                         "shedding of honest traffic)")
    ap.add_argument("--slo-stall-rate", type=float, default=5.0,
                    help="straggler round-stalls per round limit")
    ns = ap.parse_args(argv)

    # mid-cycle rolling-upgrade waves (docs/PROTOCOL.md): same shape as
    # tools/chaos --rolling-upgrade, validated before any cycle launches
    # — a no-op or truncated drill must refuse, not soak mislabeled
    from biscotti_tpu_torch.runtime import protocol

    upgrade_round: Dict[int, int] = {}
    upgrade_waves: List[List] = []
    if ns.rolling_upgrade >= 0:
        if not 0 <= ns.rolling_upgrade < protocol.CURRENT_VERSION:
            ap.error(f"--rolling-upgrade {ns.rolling_upgrade} must be a "
                     f"historical row in "
                     f"0..{protocol.CURRENT_VERSION - 1}")
        wave = max(1, ns.upgrade_wave)
        targets = list(range(1, ns.nodes))
        for w in range(0, len(targets), wave):
            at = ns.upgrade_period * (w // wave + 1)
            upgrade_waves.append([at, targets[w:w + wave]])
            for node in targets[w:w + wave]:
                upgrade_round[node] = at
        if upgrade_waves[-1][0] >= ns.rounds:
            ap.error(f"rolling upgrade's last wave lands at round "
                     f"{upgrade_waves[-1][0]} but each cycle stops at "
                     f"--rounds {ns.rounds}: raise --rounds or widen "
                     f"--upgrade-wave")
    if ns.migrations_per_cycle >= ns.rounds:
        ap.error(f"--migrations-per-cycle {ns.migrations_per_cycle} "
                 f"cannot fit inside --rounds {ns.rounds}")

    from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts
    from biscotti_tpu_torch.runtime import adversary, faults, hive
    from biscotti_tpu_torch.runtime.admission import AdmissionPlan
    from biscotti_tpu_torch.runtime.faults import FaultPlan
    from biscotti_tpu_torch.runtime.membership import (ChurnRunner,
                                                 surviving_prefix_oracle)
    from biscotti_tpu_torch.runtime.peer import PeerAgent
    from biscotti_tpu_torch.tools import obs

    fast = Timeouts(update_s=4.0, block_s=12.0, krum_s=3.0, share_s=4.0,
                    rpc_s=4.0)
    admission = AdmissionPlan(enabled=True, update_rate=8.0,
                              bulk_rate=6.0, control_rate=16.0)

    deadline = time.monotonic() + ns.minutes * 60.0
    t_start = time.monotonic()
    latencies: List[float] = []
    rss_samples: List[Tuple[float, float]] = []
    cycles: List[Dict] = []
    total_rounds = 0
    total_bytes = 0
    total_sheds = 0
    total_stalls = 0
    prefix_held = True

    async def run_cycle(cycle: int) -> Dict:
        nonlocal total_rounds, total_bytes, total_sheds, total_stalls
        nonlocal prefix_held
        seed = ns.seed + cycle
        plan = FaultPlan(seed=seed, drop=ns.fault_drop,
                         churn=ns.churn, churn_period=ns.churn_period,
                         churn_down=ns.churn_down, churn_seed=seed,
                         slow=ns.slow, slow_preset=ns.slow_preset)
        camp = adversary.CampaignPlan(
            campaign="roleflood" if ns.campaign_flood > 0 else "",
            seed=seed, attacker_node=ns.campaign_node,
            flood=ns.campaign_flood)
        # rotate the port block across cycles so a lingering TIME_WAIT
        # from the previous cycle never races the next cycle's bind
        base_port = ns.base_port + (cycle % 16) * ns.nodes

        made: Dict[int, PeerAgent] = {}

        def _cfg(i: int) -> BiscottiConfig:
            # under --rolling-upgrade a non-anchor peer speaks the old
            # row until its wave has fired at the anchor — any relaunch
            # from that point on (upgrade restart, churn restart, or a
            # migration) comes up on the current build, exactly like a
            # supervisor rolling a new binary (tools/chaos does the same)
            pin = -1
            if ns.rolling_upgrade >= 0 and i != 0:
                height = made[0].iteration if 0 in made else 0
                pin = (ns.rolling_upgrade
                       if height < upgrade_round.get(i, 0) else -1)
            return BiscottiConfig(
                node_id=i, num_nodes=ns.nodes, dataset=ns.dataset,
                base_port=base_port, num_verifiers=1, num_miners=1,
                num_noisers=1, secure_agg=bool(ns.secure_agg),
                noising=False, verification=False, defense=Defense.NONE,
                max_iterations=ns.rounds, convergence_error=0.0,
                sample_percent=1.0, batch_size=8, timeouts=fast,
                seed=seed, fault_plan=plan, admission_plan=admission,
                campaign_plan=camp, adaptive_deadlines=True,
                protocol_version=pin, wire_codec=ns.codec)

        def make_agent(i: int) -> PeerAgent:
            a = PeerAgent(_cfg(i), device=ns.device)
            made[i] = a
            return a

        def migrate_agent(i: int, ticket) -> PeerAgent:
            a = PeerAgent(_cfg(i), ticket=ticket, device=ns.device)
            made[i] = a
            return a

        # per-cycle migration schedule (docs/PLACEMENT.md §replay):
        # seeded in the CYCLE seed like every other plan, victims drawn
        # from the non-anchor ids, moves spread evenly across the rounds
        migrate_events = []
        if ns.migrations_per_cycle > 0:
            rng = random.Random((seed * 9973 + 17) & 0x7FFFFFFF)
            mperiod = max(1, ns.rounds // (ns.migrations_per_cycle + 1))
            migrate_events = [
                faults.ChurnEvent(round=mperiod * (j + 1),
                                  node=rng.randrange(1, ns.nodes),
                                  kind=faults.MIGRATE)
                for j in range(ns.migrations_per_cycle)]
        upgrade_events = [
            faults.ChurnEvent(round=at, node=node, kind=faults.RESTART)
            for node, at in sorted(upgrade_round.items())]

        schedule = sorted(
            plan.churn_schedule(ns.nodes, ns.rounds) + migrate_events
            + upgrade_events,
            key=lambda e: (e.round, e.node, e.kind))
        runner = ChurnRunner(make_agent, ns.nodes, schedule,
                             migrate_factory=migrate_agent)
        task = asyncio.ensure_future(runner.run())
        # anchor-height poller: one latency sample per crossed round
        # (0.25 s resolution — the same cadence the hive monitor uses)
        last_h = made[0].iteration if 0 in made else 0
        last_t = time.monotonic()
        next_rss = last_t
        while not task.done():
            await asyncio.sleep(0.25)
            now = time.monotonic()
            a = made.get(0)
            h = a.iteration if a is not None else last_h
            if h > last_h:
                latencies.extend([(now - last_t) / (h - last_h)]
                                 * (h - last_h))
                last_h, last_t = h, now
            if now >= next_rss:
                rss_samples.append((now, float(hive.rss_bytes())))
                next_rss = now + ns.sample_s
        results = await task
        equal, settled, real = surviving_prefix_oracle(results)
        merged = obs.merge_snapshots(
            [r["telemetry"] for r in results if "telemetry" in r])
        rounds = max(1, settled + 1)
        total_rounds += rounds
        total_bytes += merged["wire"]["cross_host_bytes"]
        total_sheds += merged["admission"]["shed_total"]
        total_stalls += merged["stragglers"]["stalls_total"]
        prefix_held = prefix_held and equal and real >= 1
        return {
            "cycle": cycle, "seed": seed, "base_port": base_port,
            "prefix_equal": equal, "settled_height": settled,
            "real_blocks": real, "rounds": rounds,
            "cross_host_bytes": merged["wire"]["cross_host_bytes"],
            "sheds": merged["admission"]["shed_total"],
            "stalls": merged["stragglers"]["stalls_total"],
            "churn_events_applied": len(runner.events_applied),
            # elastic-fleet drills (docs/PLACEMENT.md, docs/PROTOCOL.md):
            # per-move downtime/ticket-bytes, restore confirmations, and
            # the upgrade restarts that actually landed this cycle
            "migrations": runner.migrations,
            "migrations_restored": merged["counters"].get(
                "migration_restored", 0),
            "upgrades_applied": [
                [r, n] for (r, n, k) in runner.events_applied
                if k == faults.RESTART and upgrade_round.get(n) == r],
            "faults": {k: v for k, v in sorted(
                merged.get("faults", {}).items())},
        }

    cycle = 0
    while cycle == 0 or time.monotonic() < deadline:
        rec = asyncio.run(run_cycle(cycle))
        cycles.append(rec)
        print(json.dumps({"progress": rec}), flush=True)
        cycle += 1

    elapsed_s = time.monotonic() - t_start
    slos = {
        "p99_round_latency_s": round(p99(latencies), 4),
        "cross_host_bytes_per_round": round(
            total_bytes / max(1, total_rounds), 1),
        "rss_drift_bytes_per_h": round(drift_per_hour(rss_samples), 1),
        "shed_rate": round(total_sheds / max(1, total_rounds), 4),
        "stall_rate": round(total_stalls / max(1, total_rounds), 4),
    }
    limits = {
        "p99_round_latency_s": ns.slo_p99_s,
        "cross_host_bytes_per_round": ns.slo_bytes_per_round,
        "rss_drift_bytes_per_h": ns.slo_rss_drift,
        "shed_rate": ns.slo_shed_rate,
        "stall_rate": ns.slo_stall_rate,
    }
    gates = {k: {"value": slos[k], "limit": limits[k],
                 "pass": slos[k] <= limits[k]} for k in slos}
    ok = prefix_held and all(g["pass"] for g in gates.values())
    artifact = {
        "schema": "soak-v1",
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "minutes_requested": ns.minutes,
        "elapsed_s": round(elapsed_s, 1),
        "scenario": {
            "nodes": ns.nodes, "rounds_per_cycle": ns.rounds,
            "seed": ns.seed, "dataset": ns.dataset, "codec": ns.codec,
            "secure_agg": bool(ns.secure_agg),
            "churn": ns.churn, "churn_period": ns.churn_period,
            "churn_down": ns.churn_down,
            "campaign_flood": ns.campaign_flood,
            "campaign_node": ns.campaign_node,
            "slow": ns.slow, "slow_preset": ns.slow_preset,
            "fault_drop": ns.fault_drop,
            "migrations_per_cycle": ns.migrations_per_cycle,
            "rolling_upgrade": ns.rolling_upgrade,
            "upgrade_period": ns.upgrade_period,
            "upgrade_wave": ns.upgrade_wave,
            "upgrade_waves": upgrade_waves,
        },
        "cycles_run": len(cycles),
        "settled_rounds": total_rounds,
        "latency_samples": len(latencies),
        "p50_round_latency_s": round(
            sorted(latencies)[len(latencies) // 2], 4) if latencies
            else 0.0,
        "prefix_held": prefix_held,
        # the gated values, mirrored flat so bench_diff's flattened keys
        # end exactly in the gate names its DEFAULT_REGRESS matches
        "slos": slos,
        "gates": gates,
        "pass": ok,
        "cycles": cycles,
        "rss_series_bytes": [[round(t - t_start, 1), int(v)]
                             for t, v in rss_samples],
    }
    out = ns.out or time.strftime("SOAK_%Y%m%dT%H%M%SZ.json",
                                  time.gmtime())
    with open(out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps({k: artifact[k] for k in
                      ("schema", "cycles_run", "settled_rounds",
                       "prefix_held", "slos", "gates", "pass")},
                     indent=2))
    print(f"artifact: {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
