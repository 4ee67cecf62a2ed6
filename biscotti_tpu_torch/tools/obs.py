# The port's own copy of biscotti_tpu/tools/obs.py; it imports nothing of biscotti_tpu.
"""Live-cluster observability CLI: scrape every peer's `Metrics` RPC and
merge the per-peer snapshots into one cluster table.

    python -m biscotti_tpu_torch.tools.obs --nodes 4 --base-port 8000
    python -m biscotti_tpu_torch.tools.obs --nodes 4 --tail 20      # + recent events
    python -m biscotti_tpu_torch.tools.obs --nodes 4 --json         # machine-readable
    python -m biscotti_tpu_torch.tools.obs --nodes 4 --watch 2      # rescrape loop

What the reference could only reconstruct after the fact by parsing
timestamped text logs (SURVEY §5.1) is here one command against a RUNNING
cluster: per-peer round height + cluster skew, circuit-breaker states,
injected-fault tallies, and per-phase latency quantiles (p50/p99 from the
fixed log-scale histograms, merged bucket-wise across peers — valid
because every peer shares registry.DEFAULT_BUCKETS).

`merge_snapshots` is also the ONE definition of the cluster-level readout:
the chaos CLI report and the test suites consume it rather than each
reinventing their own aggregation over private peer state
(docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import Dict, List, Optional

from biscotti_tpu_torch.telemetry.registry import quantile_from_buckets

OPEN_STATES = ("open", "half_open")


def merge_phase_histograms(snaps: List[Dict]) -> Dict[str, Dict]:
    """Merge every peer's `biscotti_phase_seconds` histogram bucket-wise
    and return {phase: {p50, p99, count, total_s}}. Peers with telemetry
    disabled contribute their PhaseClock summary instead (mean only —
    quantiles need the buckets)."""
    merged: Dict[str, Dict] = {}
    for snap in snaps:
        fam = (snap.get("metrics") or {}).get("biscotti_phase_seconds")
        if fam and fam.get("series"):
            bounds = fam["bounds"]
            for row in fam["series"]:
                phase = row["labels"].get("phase", "?")
                m = merged.setdefault(phase, {
                    "bounds": bounds,
                    "buckets": [0] * (len(bounds) + 1),
                    "count": 0, "total_s": 0.0})
                if m["buckets"] is None:
                    # a telemetry-off peer created this entry first:
                    # upgrade it so this peer's buckets still merge
                    m["bounds"] = bounds
                    m["buckets"] = [0] * (len(bounds) + 1)
                m["buckets"] = [a + b for a, b in zip(m["buckets"],
                                                      row["buckets"])]
                m["count"] += row["count"]
                m["total_s"] += row["sum"]
        else:  # telemetry-off peer: PhaseClock totals only — counts and
            # totals still aggregate; the buckets (if any peer has them)
            # are left untouched, so quantiles cover the enabled subset
            for phase, row in (snap.get("phases") or {}).items():
                m = merged.setdefault(phase, {"bounds": None, "buckets": None,
                                              "count": 0, "total_s": 0.0})
                m["count"] += row["calls"]
                m["total_s"] += row["total_s"]
    out: Dict[str, Dict] = {}
    for phase, m in sorted(merged.items(), key=lambda kv: -kv[1]["total_s"]):
        row = {"count": m["count"], "total_s": round(m["total_s"], 4)}
        if m["buckets"] is not None:
            row["p50_s"] = quantile_from_buckets(m["bounds"], m["buckets"], .5)
            row["p99_s"] = quantile_from_buckets(m["bounds"], m["buckets"],
                                                 .99)
        out[phase] = row
    return out


def merge_wire(snaps: List[Dict]) -> Dict:
    """Merge every peer's `biscotti_wire_bytes_total` counters into one
    cluster traffic table: totals per direction, outbound split by codec
    and by message type. Outbound is the attribution axis (summing both
    directions would double-count every loopback-socket frame).
    `loopback_bytes` counts frames between co-hosted hive peers
    (runtime/hive.py) at their would-be raw64 size — traffic the fast
    path AVOIDED; without it a fully co-hosted cluster reads "out 0B"
    and the layout comparison the accounting exists for goes dark."""
    out = {"out_bytes": 0, "in_bytes": 0, "loopback_bytes": 0,
           "cross_host_bytes": 0, "overlay_saved_bytes": 0,
           "out_by_codec": {}, "out_by_msg_type": {}}
    for snap in snaps:
        metrics = snap.get("metrics") or {}
        fam = metrics.get("biscotti_wire_bytes_total")
        for row in (fam or {}).get("series", []):
            labels = row.get("labels", {})
            v = int(row.get("value", 0))
            if labels.get("direction") == "out":
                out["out_bytes"] += v
                codec = labels.get("codec", "?")
                mt = labels.get("msg_type", "?")
                out["out_by_codec"][codec] = \
                    out["out_by_codec"].get(codec, 0) + v
                out["out_by_msg_type"][mt] = \
                    out["out_by_msg_type"].get(mt, 0) + v
            elif labels.get("direction") == "in":
                out["in_bytes"] += v
            elif labels.get("direction") == "loopback":
                out["loopback_bytes"] += v
        saved = metrics.get("biscotti_overlay_bytes_saved_total")
        for row in (saved or {}).get("series", []):
            out["overlay_saved_bytes"] += int(row.get("value", 0))
    # first-class split (docs/OVERLAY.md §accounting): `cross_host_bytes`
    # is outbound traffic that actually left the process over TCP —
    # direction="out" by construction (loopback frames carry their own
    # direction) — vs `loopback_bytes`, the co-hosted traffic the hive
    # fast path AVOIDED. The O(N)->O(log N) headline reads straight off
    # this pair; `overlay_saved_bytes` is the overlay's own estimate of
    # the deduplicated/aggregated frames it kept off TCP.
    out["cross_host_bytes"] = out["out_bytes"]
    return out


def merge_admission(snaps: List[Dict]) -> Dict:
    """Merge every peer's admission readout (overload-governance plane,
    docs/ADMISSION.md) into one cluster table: shed totals by reason and
    by message type, plus the worst inflight/parked peaks seen — peaks
    take `max` across peers (each peer's cap bounds its OWN runtime),
    sheds sum. `shed_by_msg_type` comes off the `biscotti_shed_total`
    metric labels; the structured `admission` snapshot carries reasons."""
    out: Dict = {"enabled_peers": 0, "shed_total": 0, "shed_by_reason": {},
                 "shed_by_msg_type": {}, "inflight_peak": 0,
                 "parked_peak": 0}
    for snap in snaps:
        a = snap.get("admission") or {}
        if a.get("enabled"):
            out["enabled_peers"] += 1
        out["shed_total"] += int(a.get("shed_total", 0))
        for k, v in (a.get("shed") or {}).items():
            out["shed_by_reason"][k] = \
                out["shed_by_reason"].get(k, 0) + int(v)
        out["inflight_peak"] = max(out["inflight_peak"],
                                   int(a.get("inflight_peak", 0)))
        out["parked_peak"] = max(out["parked_peak"],
                                 int(a.get("parked_peak", 0)))
        fam = (snap.get("metrics") or {}).get("biscotti_shed_total")
        for row in (fam or {}).get("series", []):
            mt = row.get("labels", {}).get("msg_type", "?")
            out["shed_by_msg_type"][mt] = \
                out["shed_by_msg_type"].get(mt, 0) + int(row.get("value", 0))
    return out


def merge_stragglers(snaps: List[Dict]) -> Dict:
    """Merge every peer's straggler readout (straggler-tolerance plane,
    docs/STRAGGLERS.md) into one cluster view: excluded-straggler and
    round-stall totals by phase, the live `waiting-on` map (which peer
    is blocked on whom — the stuck-round forensics column), and the
    slow-fleet table (every peer reporting an emulated slowdown,
    slowest first)."""
    out: Dict = {"excluded_total": 0, "excluded_by_phase": {},
                 "stalls_total": 0, "stalls_by_phase": {},
                 "waiting_on": {}, "slow_peers": [],
                 "adaptive_peers": 0, "deadlines": {}}
    for snap in snaps:
        s = snap.get("stragglers") or {}
        for ph, v in (s.get("excluded") or {}).items():
            out["excluded_total"] += int(v)
            out["excluded_by_phase"][ph] = \
                out["excluded_by_phase"].get(ph, 0) + int(v)
        for ph, v in (s.get("stalls") or {}).items():
            out["stalls_total"] += int(v)
            out["stalls_by_phase"][ph] = \
                out["stalls_by_phase"].get(ph, 0) + int(v)
        waiting = {ph: ps for ph, ps in (s.get("waiting_on") or {}).items()
                   if ps}
        if waiting:
            out["waiting_on"][str(snap.get("node"))] = waiting
        prof = s.get("profile") or {}
        if prof.get("slowed"):
            out["slow_peers"].append({
                "node": snap.get("node"),
                "compute_factor": prof.get("compute_factor", 1.0),
                "service_s": prof.get("service_s", 0.0),
                "preset": prof.get("preset", "")})
        dl = s.get("deadlines") or {}
        if dl.get("enabled"):
            out["adaptive_peers"] += 1
        for ph, row in (dl.get("phases") or {}).items():
            if not row.get("adaptive"):
                continue
            cur = out["deadlines"].setdefault(
                ph, {"min_s": row["deadline_s"], "max_s": row["deadline_s"],
                     "peers": 0})
            cur["min_s"] = min(cur["min_s"], row["deadline_s"])
            cur["max_s"] = max(cur["max_s"], row["deadline_s"])
            cur["peers"] += 1
    out["slow_peers"].sort(key=lambda r: -r["compute_factor"])
    return out


def merge_hives(snaps: List[Dict]) -> Dict[str, Dict]:
    """Per-host hive table (runtime/hive.py, docs/HIVE.md): every
    co-hosted peer's snapshot carries its hive's shared readout under
    `hive`; peers of one hive all reference the SAME dict, so rows
    collapse by hive id. Columns make co-hosting starvation VISIBLE:
    co-hosted peer count, RSS per peer, and the event-loop lag gauge —
    an overloaded hive shows a climbing lag, not just slow rounds."""
    out: Dict[str, Dict] = {}
    for snap in snaps:
        h = snap.get("hive")
        if not h:
            continue
        hid = str(h.get("id", "?"))
        row = out.setdefault(hid, {
            "peers_cohosted": int(h.get("peers", 0)),
            "scraped": 0,
            "rss_bytes": int(h.get("rss_bytes", 0)),
            "rss_peak_bytes": int(h.get("rss_peak_bytes", 0)),
            "loop_lag_s": float(h.get("loop_lag_s", 0.0)),
            "rss_drift_bytes": int(h.get("rss_drift_bytes", 0)),
            "loop_lag_drift_s": float(h.get("loop_lag_drift_s", 0.0)),
        })
        row["scraped"] += 1
        # a later snapshot of the same hive may carry fresher samples;
        # drift keeps the worst (most positive) window — a leak that
        # briefly plateaus should not launder the gauge
        row["rss_bytes"] = max(row["rss_bytes"], int(h.get("rss_bytes", 0)))
        row["rss_peak_bytes"] = max(row["rss_peak_bytes"],
                                    int(h.get("rss_peak_bytes", 0)))
        row["loop_lag_s"] = max(row["loop_lag_s"],
                                float(h.get("loop_lag_s", 0.0)))
        row["rss_drift_bytes"] = max(row["rss_drift_bytes"],
                                     int(h.get("rss_drift_bytes", 0)))
        row["loop_lag_drift_s"] = max(
            row["loop_lag_drift_s"], float(h.get("loop_lag_drift_s", 0.0)))
    for row in out.values():
        row["rss_per_peer_bytes"] = int(
            row["rss_peak_bytes"] / max(1, row["peers_cohosted"]))
    return out


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GB"


def merge_overlay(snaps: List[Dict]) -> Dict:
    """Merge every peer's aggregation-overlay readout (docs/OVERLAY.md)
    into one cluster table: armed-peer count, tree shape, and the
    aggregated / relayed / fallback frame tallies the acceptance runs
    and the chaos report's `overlay` key assert on."""
    out: Dict = {"enabled_peers": 0, "group_size": 0, "depth": 1,
                 "aggregated": 0, "aggregates_sent": 0, "offers": 0,
                 "relayed": 0, "forwarded": 0, "direct": 0, "fallback": 0}
    for snap in snaps:
        o = snap.get("overlay") or {}
        if o.get("enabled"):
            out["enabled_peers"] += 1
            out["group_size"] = max(out["group_size"],
                                    int(o.get("group_size", 0)))
            out["depth"] = max(out["depth"], int(o.get("depth", 1)))
        for k in ("aggregated", "aggregates_sent", "offers", "relayed",
                  "forwarded", "direct", "fallback"):
            out[k] += int(o.get(k, 0))
    return out


def merge_placement(snaps: List[Dict]) -> Dict:
    """Merge the elastic-fleet readouts (docs/PLACEMENT.md): which peers
    rehydrated from a migration ticket this incarnation, how many drains
    each peer served, and the genesis-DKG deal tallies by verdict (off
    the `biscotti_dkg_deals_total` labels). The supervisor's own move
    log lives in its summary (tools/pod_launch --supervise); this table
    is the PEER-side evidence a scrape can see."""
    out: Dict = {"migrated_in": [], "tickets_served": 0,
                 "dkg_deals": {}}
    for snap in snaps:
        c = snap.get("counters") or {}
        if c.get("migration_restored"):
            out["migrated_in"].append(snap.get("node"))
        out["tickets_served"] += int(c.get("migration_ticket_served", 0))
        fam = (snap.get("metrics") or {}).get("biscotti_dkg_deals_total")
        for row in (fam or {}).get("series", []):
            v = row.get("labels", {}).get("verdict", "?")
            out["dkg_deals"][v] = \
                out["dkg_deals"].get(v, 0) + int(row.get("value", 0))
    out["migrated_in"].sort(key=str)
    return out


def merge_campaign(snaps: List[Dict]) -> Dict:
    """Merge the adversary-campaign readouts (docs/ADVERSARY.md): which
    peers run which campaign, the summed action tallies, and the
    per-target flood hit counts — the chaos report's `campaign` key and
    the attack-matrix artifact read exactly this."""
    out: Dict = {"active": [], "actions": {}, "targets_hit": {}}
    for snap in snaps:
        c = snap.get("campaign")
        if not c:
            continue
        out["active"].append({"node": snap.get("node"),
                              "campaign": c.get("campaign")})
        for k, v in (c.get("actions") or {}).items():
            out["actions"][k] = out["actions"].get(k, 0) + int(v)
        for t, v in (c.get("targets_hit") or {}).items():
            out["targets_hit"][t] = out["targets_hit"].get(t, 0) + int(v)
    return out


def merge_trust(snaps: List[Dict], streams: bool = True) -> Dict:
    """Merge the adaptive-defense readouts (docs/DEFENSES.md): which
    verifiers recorded verdicts, the summed ensemble vote tallies, the
    union of flagged peers and slow-trust resets, and (streams=True) the
    full per-verifier verdict streams — the chaos report's `trust` key
    and the attack-matrix cell rows read exactly this. streams=False
    keeps the merged cluster table numeric-lean for bench artifacts."""
    out: Dict = {"defense": "", "verifiers": [], "decisions": 0,
                 "stream_rounds": 0, "votes": {}, "flagged": [],
                 "resets": {}}
    if streams:
        out["streams"] = {}
    flagged: set = set()
    for snap in snaps:
        t = snap.get("trust")
        if not t:
            continue
        out["defense"] = t.get("defense") or out["defense"]
        node = snap.get("node")
        stream = t.get("stream") or []
        if stream:
            out["verifiers"].append(node)
            out["stream_rounds"] += len(stream)
            if streams:
                out["streams"][str(node)] = stream
        led = t.get("ledger") or {}
        out["decisions"] += int(led.get("decisions", 0))
        for k, v in (led.get("votes") or {}).items():
            out["votes"][k] = out["votes"].get(k, 0) + int(v)
        flagged.update(led.get("flagged") or [])
        for pid, n in (led.get("resets") or {}).items():
            out["resets"][pid] = out["resets"].get(pid, 0) + int(n)
    out["flagged"] = sorted(flagged)
    out["verifiers"].sort()
    return out


def merge_snapshots(snaps: List[Dict]) -> Dict:
    """One cluster table from per-peer telemetry snapshots (the schema
    `PeerAgent.telemetry_snapshot()` / the `Metrics` RPC serve)."""
    heights = {s.get("node", i): int(s.get("iter", 0))
               for i, s in enumerate(snaps)}
    faults: Dict[str, int] = {}
    counters: Dict[str, int] = {}
    per_node = []
    breakers_open = 0
    for s in snaps:
        for k, v in (s.get("faults") or {}).items():
            faults[k] = faults.get(k, 0) + int(v)
        for k, v in (s.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + int(v)
        health = s.get("health") or {}
        quarantined = sorted(p for p, h in health.items()
                             if h.get("state") in OPEN_STATES)
        breakers_open += len(quarantined)
        member = s.get("membership") or {}
        strag = s.get("stragglers") or {}
        waiting = {ph: ps for ph, ps in
                   (strag.get("waiting_on") or {}).items() if ps}
        prof = strag.get("profile") or {}
        per_node.append({
            "node": s.get("node"),
            "iter": s.get("iter", 0),
            "converged": bool(s.get("converged", False)),
            "quarantined": quarantined,
            "breaker_opens": sum(h.get("opens", 0) for h in health.values()),
            "fast_fails": sum(h.get("fast_fails", 0)
                              for h in health.values()),
            "faults": dict(s.get("faults") or {}),
            # membership plane (docs/MEMBERSHIP.md): this peer's observed
            # epoch + live-set size (and whether it bootstrapped pruned)
            "epoch": int(member.get("epoch", 0)),
            "alive": int(member.get("alive", 0)),
            "pruned_before": int(member.get("pruned_before", 0)),
            # straggler plane (docs/STRAGGLERS.md): what this peer is
            # blocked on RIGHT NOW ("phase:peers" forensics) and its
            # emulated slowdown, the obs table's waiting-on column
            "waiting_on": waiting,
            "slow_factor": float(prof.get("compute_factor", 1.0)),
            "straggler_excluded": sum(
                (strag.get("excluded") or {}).values()),
        })
    hs = list(heights.values()) or [0]
    wire = merge_wire(snaps)
    # bytes/round: cluster outbound traffic amortized over settled
    # rounds — THE comms-cost number the wire plane exists to shrink
    wire["bytes_per_round"] = round(wire["out_bytes"] / max(1, max(hs)), 1)
    # the overlay headline pair, first-class: TCP-crossing bytes per
    # round vs the loopback traffic the hive fast path avoided — read
    # straight off the artifact instead of hand-derived (docs/OVERLAY.md)
    wire["cross_host_bytes_per_round"] = round(
        wire["cross_host_bytes"] / max(1, max(hs)), 1)
    wire["loopback_avoided_bytes_per_round"] = round(
        wire["loopback_bytes"] / max(1, max(hs)), 1)
    return {
        "nodes": len(snaps),
        "round_height": {"min": min(hs), "max": max(hs),
                         "skew": max(hs) - min(hs)},
        "membership": {
            "max_epoch": max((n["epoch"] for n in per_node), default=0),
            "joins": counters.get("member_join", 0),
            "leaves": counters.get("member_leave", 0),
            "reshare_rounds": counters.get("reshare_round", 0),
        },
        "breakers_open": breakers_open,
        "faults": faults,
        "counters": counters,
        "wire": wire,
        "overlay": merge_overlay(snaps),
        "placement": merge_placement(snaps),
        "campaign": merge_campaign(snaps),
        # streams stay out of the merged cluster table (bench artifacts
        # flatten its numeric leaves); the chaos report and the matrix
        # cells merge them separately with streams=True
        "trust": merge_trust(snaps, streams=False),
        "admission": merge_admission(snaps),
        "stragglers": merge_stragglers(snaps),
        "hives": merge_hives(snaps),
        "phases": merge_phase_histograms(snaps),
        "per_node": per_node,
    }


def format_table(merged: Dict) -> str:
    """Human-readable cluster table."""
    rh = merged["round_height"]
    lines = [
        f"cluster: {merged['nodes']} peers   "
        f"round height {rh['min']}..{rh['max']} (skew {rh['skew']})   "
        f"breakers open: {merged['breakers_open']}",
        "",
        f"{'node':>5} {'iter':>5} {'conv':>5} {'epoch':>6} {'alive':>6} "
        f"{'opens':>6} {'fastfail':>8} {'waiting-on':>12}  "
        "quarantined / faults",
    ]
    for n in merged["per_node"]:
        extra = []
        if n["quarantined"]:
            extra.append("quarantine=" + ",".join(map(str, n["quarantined"])))
        if n["faults"]:
            extra.append("faults=" + ",".join(
                f"{k}:{v}" for k, v in sorted(n["faults"].items())))
        if n.get("pruned_before"):
            extra.append(f"pruned<{n['pruned_before']}")
        if n.get("slow_factor", 1.0) > 1.0:
            extra.append(f"slow={n['slow_factor']:g}x")
        if n.get("straggler_excluded"):
            extra.append(f"excluded={n['straggler_excluded']}")
        # stuck-round forensics (docs/STRAGGLERS.md): "phase:ids" of
        # whatever collection point this peer is blocked on right now
        waiting = n.get("waiting_on") or {}
        wcol = ";".join(
            f"{ph}:{','.join(map(str, ps[:4]))}"
            + ("+" if len(ps) > 4 else "")
            for ph, ps in sorted(waiting.items())) or "-"
        lines.append(f"{n['node']!s:>5} {n['iter']:>5} "
                     f"{str(n['converged'])[:1]:>5} {n.get('epoch', 0):>6} "
                     f"{n.get('alive', 0):>6} {n['breaker_opens']:>6} "
                     f"{n['fast_fails']:>8} {wcol:>12}  {' '.join(extra)}")
    wire = merged.get("wire") or {}
    if (wire.get("out_bytes") or wire.get("in_bytes")
            or wire.get("loopback_bytes")):
        by_codec = ", ".join(
            f"{k}={_fmt_bytes(v)}"
            for k, v in sorted(wire["out_by_codec"].items(),
                               key=lambda kv: -kv[1]))
        lb = wire.get("loopback_bytes", 0)
        lines += ["", f"wire: out {_fmt_bytes(wire['out_bytes'])}  "
                      f"in {_fmt_bytes(wire['in_bytes'])}  "
                      f"({_fmt_bytes(wire.get('bytes_per_round', 0))}/round)"
                      + (f"   loopback {_fmt_bytes(lb)} avoided"
                         if lb else "")
                      + (f"   [{by_codec}]" if by_codec else "")]
        xh = _fmt_bytes(wire.get("cross_host_bytes", 0))
        xh_r = _fmt_bytes(wire.get("cross_host_bytes_per_round", 0))
        lb_r = _fmt_bytes(wire.get("loopback_avoided_bytes_per_round", 0))
        lines += [f"wire: cross-host {xh} ({xh_r}/round)   "
                  f"loopback-avoided {lb_r}/round"]
    olay = merged.get("overlay") or {}
    if olay.get("enabled_peers"):
        lines += ["", f"overlay: {olay['enabled_peers']} peers armed  "
                      f"depth {olay['depth']}  group {olay['group_size']}  "
                      f"aggregated {olay['aggregated']}  "
                      f"relayed {olay['relayed']}  "
                      f"forwarded {olay['forwarded']}  "
                      f"fallback {olay['fallback']}  "
                      f"direct {olay['direct']}"]
    adm = merged.get("admission") or {}
    if adm.get("enabled_peers") or adm.get("shed_total"):
        by_reason = ", ".join(f"{k}:{v}" for k, v in
                              sorted(adm["shed_by_reason"].items()))
        lines += ["", f"admission: shed {adm['shed_total']}"
                      + (f" ({by_reason})" if by_reason else "")
                      + f"   inflight peak {adm['inflight_peak']}"
                      f"   parked peak {adm['parked_peak']}"
                      f"   [{adm['enabled_peers']} peers enforcing]"]
    strag = merged.get("stragglers") or {}
    if (strag.get("excluded_total") or strag.get("stalls_total")
            or strag.get("slow_peers") or strag.get("adaptive_peers")):
        by_phase = ", ".join(f"{k}:{v}" for k, v in
                             sorted(strag["excluded_by_phase"].items()))
        slow = ", ".join(
            f"{r['node']}@{r['compute_factor']:g}x"
            + (f"+{r['service_s'] * 1e3:.0f}ms" if r["service_s"] else "")
            for r in strag["slow_peers"][:6])
        dl = ", ".join(f"{ph}:{row['min_s']:g}-{row['max_s']:g}s"
                       for ph, row in sorted(strag["deadlines"].items()))
        lines += ["", f"stragglers: excluded {strag['excluded_total']}"
                      + (f" ({by_phase})" if by_phase else "")
                      + f"   stalls {strag['stalls_total']}"
                      + (f"   slow [{slow}]" if slow else "")
                      + (f"   deadlines [{dl}]" if dl else "")
                      + f"   [{strag['adaptive_peers']} peers adaptive]"]
    plc = merged.get("placement") or {}
    if (plc.get("migrated_in") or plc.get("tickets_served")
            or plc.get("dkg_deals")):
        deals = ", ".join(f"{k}={v}" for k, v in
                          sorted(plc["dkg_deals"].items()))
        lines += ["", "placement: migrated-in "
                      f"{plc['migrated_in'] or '-'}   tickets served "
                      f"{plc['tickets_served']}"
                      + (f"   dkg deals [{deals}]" if deals else "")]
    camp = merged.get("campaign") or {}
    if camp.get("active"):
        who = ", ".join(f"{a['node']}:{a['campaign']}"
                        for a in camp["active"])
        acts = ", ".join(f"{k}={v}" for k, v in
                         sorted(camp["actions"].items()))
        hits = ", ".join(f"→{t}:{v}" for t, v in
                         sorted(camp["targets_hit"].items(),
                                key=lambda kv: -kv[1])[:6])
        lines += ["", f"campaign: [{who}]"
                      + (f"   actions [{acts}]" if acts else "")
                      + (f"   flood hits [{hits}]" if hits else "")]
    tr = merged.get("trust") or {}
    if tr.get("verifiers"):
        votes = ", ".join(f"{k}={v}" for k, v in
                          sorted(tr["votes"].items()))
        lines += ["", f"defense: {tr['defense'] or '-'}"
                      f"   verdict rounds {tr['stream_rounds']} on "
                      f"{len(tr['verifiers'])} verifiers"
                      + (f"   votes [{votes}]" if votes else "")
                      + (f"   flagged {tr['flagged']}"
                         if tr["flagged"] else "")
                      + (f"   ramp resets {tr['resets']}"
                         if tr["resets"] else "")]
    hives = merged.get("hives") or {}
    if hives:
        lines += ["", f"{'hive':<16} {'peers':>6} {'scraped':>8} "
                      f"{'rss':>9} {'rss/peer':>9} {'rssdrift':>9} "
                      f"{'looplag':>8}"]
        for hid, h in sorted(hives.items()):
            lines.append(
                f"{hid:<16} {h['peers_cohosted']:>6} {h['scraped']:>8} "
                f"{_fmt_bytes(h['rss_peak_bytes']):>9} "
                f"{_fmt_bytes(h['rss_per_peer_bytes']):>9} "
                f"{_fmt_bytes(h.get('rss_drift_bytes', 0)):>9} "
                f"{h['loop_lag_s']:>8.4f}")
    if merged["faults"]:
        lines += ["", "injected faults (cluster): " + ", ".join(
            f"{k}={v}" for k, v in sorted(merged["faults"].items()))]
    if merged["phases"]:
        lines += ["", f"{'phase':<16} {'calls':>7} {'total_s':>9} "
                      f"{'p50_s':>9} {'p99_s':>9}"]
        for phase, row in merged["phases"].items():
            p50 = row.get("p50_s")
            p99 = row.get("p99_s")
            lines.append(
                f"{phase:<16} {row['count']:>7} {row['total_s']:>9.3f} "
                f"{p50 if p50 is not None else '-':>9} "
                f"{p99 if p99 is not None else '-':>9}")
    return "\n".join(lines)


async def scrape(host: str, ports: List[int], tail: int = 0,
                 timeout: float = 5.0,
                 cursors: Optional[Dict[int, int]] = None) -> List[Dict]:
    """Pull every peer's Metrics RPC concurrently; unreachable peers are
    reported as {'unreachable': True} rows rather than sinking the
    scrape (a dead peer is exactly when you want the rest of the
    table).

    `cursors` (a mutable {port: last_seq} dict) switches the event tail
    to the RPC's incremental `since_seq` mode: the FIRST contact with a
    port keeps the legacy newest-N fetch and seeds the cursor from the
    reply's head `seq`, then each later scrape fetches only events past
    the cursor — a bounded page instead of the whole ring. After every
    fetch the cursor jumps to the ring head, so a beat that produced
    more events than one page skips forward (exactly what the
    pre-cursor newest-N view did) instead of lagging ever further
    behind live. The watch loop passes one dict across iterations, so
    a long `--watch --tail` session stops re-fetching (and
    re-printing) the same events every beat."""
    from biscotti_tpu_torch.runtime import rpc

    async def one(port: int) -> Dict:
        try:
            meta: Dict = {"tail": tail} if tail else {}
            if tail and cursors is not None and port in cursors:
                meta["since_seq"] = cursors[port]
            rmeta, _ = await rpc.call(host, port, "Metrics", meta,
                                      timeout=timeout)
            snap = rmeta["snapshot"]
            if tail:
                snap["events"] = rmeta.get("events", [])
                if cursors is not None:
                    cursors[port] = int(rmeta.get("seq",
                                                  cursors.get(port, 0)))
            return snap
        except Exception as e:
            return {"node": None, "port": port, "unreachable": True,
                    "error": f"{type(e).__name__}: {e}"}

    return list(await asyncio.gather(*(one(p) for p in ports)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="scrape a live biscotti cluster's telemetry")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--base-port", type=int, default=8000)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--ports", default="",
                    help="explicit comma-separated ports (overrides "
                         "--base-port/--nodes arithmetic)")
    ap.add_argument("--tail", type=int, default=0,
                    help="also print the newest N flight-recorder events "
                         "per peer, merged and time-sorted")
    ap.add_argument("--json", action="store_true",
                    help="print the merged snapshot as JSON")
    ap.add_argument("--watch", type=float, default=0.0,
                    help="rescrape every N seconds until interrupted")
    ap.add_argument("--timeout", type=float, default=5.0)
    ns = ap.parse_args(argv)
    ports = ([int(p) for p in ns.ports.split(",") if p] if ns.ports
             else [ns.base_port + i for i in range(ns.nodes)])

    # watch mode keeps per-port cursors so repeated --tail scrapes pull
    # only NEW events via the Metrics RPC's since_seq option; a one-shot
    # scrape keeps the newest-N semantics
    cursors: Optional[Dict[int, int]] = {} if ns.watch > 0 else None

    def once() -> int:
        snaps = asyncio.run(scrape(ns.host, ports, tail=ns.tail,
                                   timeout=ns.timeout, cursors=cursors))
        up = [s for s in snaps if not s.get("unreachable")]
        down = [s for s in snaps if s.get("unreachable")]
        merged = merge_snapshots(up)
        merged["unreachable"] = [s["port"] for s in down]
        if ns.json:
            print(json.dumps(merged, indent=2, default=str))
        else:
            print(format_table(merged))
            if down:
                print(f"\nunreachable: ports "
                      f"{', '.join(str(s['port']) for s in down)}")
            if ns.tail:
                events = [e for s in up for e in s.get("events", [])]
                events.sort(key=lambda e: e.get("ts", 0.0))
                print(f"\nlast events ({len(events)}):")
                for e in events[-ns.tail:]:
                    print(json.dumps(e, default=str))
        return 0 if up else 1

    if ns.watch > 0:
        try:
            while True:
                print(f"--- scrape @ {time.strftime('%H:%M:%S')} ---")
                once()
                time.sleep(ns.watch)
        except KeyboardInterrupt:
            return 0
    return once()


if __name__ == "__main__":
    sys.exit(main())
