# The port's own copy of biscotti_tpu/tools/trace_round.py; it imports nothing of biscotti_tpu.
# One departure: a trace's round is the one its id names, None for a detached
# trace (`trace_round_of`).
"""Cross-peer round reconstruction: stitch N flight-recorder rings into
one causal round timeline, attribute the critical path, export Perfetto.

    # against a live cluster (peers launched with --trace 1)
    python -m biscotti_tpu_torch.tools.trace_round --nodes 8 --base-port 8000 \
        --rounds 1 --chrome-out round.trace.json

    # offline, from recorder spill files (--log-dir events_*.jsonl)
    python -m biscotti_tpu_torch.tools.trace_round --spill logs/events_*.jsonl

With `cfg.trace` armed (docs/OBSERVABILITY.md §Distributed tracing),
every span/event carries (`trace`, `span`, `parent`) ids and every RPC
frame a compact context — so SGD → commit → share fan-out → relay
aggregate → miner verify → mint → broadcast forms one causally-linked
tree per round ACROSS peers. This tool:

  1. **Collects** recorder tails from a live cluster through the
     existing `Metrics` RPC, polling incrementally via its `since_seq`
     cursor (no full-ring re-fetch per scrape), or reads spill JSONL.
  2. **Aligns clocks** per peer pair with the NTP offset trick: a
     client `rpc_call` span and the server dispatch span it parented
     are one request/reply exchange; the midpoint difference of the two
     spans estimates the pair's clock offset (median over exchanges),
     and offsets compose over the pair graph to one reference clock.
     (`mono` stamps are system-wide on one host, so same-host offsets
     measure ~0; cross-host offsets are real and this is what removes
     them.)
  3. **Stitches** spans into per-round waterfalls — every peer roots
     round `it` in the same `{seed:08x}-r{it}` trace id — and computes
     the **critical path**: the ancestor chain of the round's settle
     point (the last block acceptance), swept so every instant of the
     chain window is attributed to the deepest covering span, gaps
     filled with the owning node's concurrent spans. Segments:
     device / crypto_cpu / crypto_device / wire / relay / parked /
     other / untraced — the crypto segment is split by residency so a
     --device-crypto run shows exactly what moved onto the accelerator
     (crypto_device spans are tagged at the kernel call sites).
  4. **Exports** Chrome trace-event JSON (one process per peer, greedy
     lane assignment, flow arrows on cross-node parent links) loadable
     in Perfetto / chrome://tracing, plus a text critical-path table.

stdlib only — the reconstruction must run where only the scrape CLI is
available.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import re
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

# ------------------------------------------------------ segment taxonomy

DEVICE = "device"
# the crypto segment is split by residency: crypto_cpu is the
# host bigint/EC work, crypto_device the limb-kernel work the
# --device-crypto plane moved onto the accelerator. `crypto_device`
# spans are emitted at the kernel call sites (crypto/kernels/instrument
# → Telemetry.span), nested inside the host phase that invoked them, so
# the deepest-covering-span sweep attributes exactly the moved portion.
CRYPTO_CPU = "crypto_cpu"
CRYPTO_DEVICE = "crypto_device"
# legacy alias: pre-split consumers (and the r11 trace artifacts) called
# the whole host-crypto segment "crypto" — it maps to the CPU half
CRYPTO = CRYPTO_CPU
WIRE = "wire"
RELAY = "relay"
PARKED = "parked"
OTHER = "other"
UNTRACED = "untraced"

_SEGMENT_EXACT = {
    "sgd": DEVICE, "spec_sgd": DEVICE, "metrics": DEVICE,
    "crypto_commit": CRYPTO_CPU, "spec_commit": CRYPTO_CPU,
    "share_gen": CRYPTO_CPU, "miner_verify": CRYPTO_CPU,
    "sig_check": CRYPTO_CPU, "intake_validate": CRYPTO_CPU,
    "intake_fold": CRYPTO_CPU, "recovery": CRYPTO_CPU,
    "reshare_verify": CRYPTO_CPU, "reshare_deal": CRYPTO_CPU,
    "mint": CRYPTO_CPU,
    "crypto_device": CRYPTO_DEVICE,
    "rpc_call": WIRE,
    "overlay_aggregate": RELAY,
    "rpc.RelayFrames": RELAY, "rpc.OverlayOffer": RELAY,
    "rpc.RegisterAggregate": RELAY,
    "verify_wait": PARKED, "block_wait": PARKED, "intake_wait": PARKED,
}


def segment_of(phase: str) -> str:
    """Map a span phase to its critical-path segment."""
    seg = _SEGMENT_EXACT.get(phase)
    if seg is not None:
        return seg
    if phase.startswith("rpc."):
        return WIRE
    return OTHER


# ------------------------------------------------------------ collection


def collect_spans(events: List[Dict]) -> Tuple[Dict[str, Dict], List[Dict]]:
    """Split a mixed event stream into the span table (by span id) and
    the point events that carry trace linkage. Raw `end` stays on the
    recording node's own clock until alignment. Duplicate span ids
    (a poller double-fetch) collapse to one."""
    spans: Dict[str, Dict] = {}
    points: List[Dict] = []
    for ev in events:
        if ev.get("event") == "span" and ev.get("span"):
            sid = str(ev["span"])
            if sid in spans:
                continue
            dur = float(ev.get("dur_s", 0.0) or 0.0)
            spans[sid] = {
                "span": sid,
                "parent": ev.get("parent"),
                "trace": ev.get("trace"),
                "node": ev.get("node"),
                "phase": str(ev.get("phase", "?")),
                "iter": ev.get("iter"),
                "dur": dur,
                "end_raw": float(ev["mono"]),
                "msg": ev.get("msg"),
                "peer": ev.get("peer"),
            }
        elif ev.get("trace") or ev.get("event") in ("round_start",
                                                    "round_end",
                                                    "block_accepted"):
            points.append(ev)
    return spans, points


# -------------------------------------------------------- clock alignment


def pair_offsets(spans: Dict[str, Dict]) -> Dict[Tuple, List[float]]:
    """Per-ordered-pair offset samples θ(a, b) = clock_a − clock_b, one
    per matched request/reply exchange: a client `rpc_call` span on node
    a whose id is the parent of a server `rpc.*` dispatch span on node
    b. Midpoint of each span ≈ the same physical instant (the exchange's
    center), so their difference reads the clock skew — the NTP trick,
    symmetrized by the median over many exchanges."""
    out: Dict[Tuple, List[float]] = {}
    for s in spans.values():
        if not s["phase"].startswith("rpc."):
            continue
        parent = spans.get(s.get("parent") or "")
        if parent is None or parent["phase"] != "rpc_call":
            continue
        a, b = parent["node"], s["node"]
        if a is None or b is None or a == b:
            continue
        mid_a = parent["end_raw"] - parent["dur"] / 2.0
        mid_b = s["end_raw"] - s["dur"] / 2.0
        out.setdefault((a, b), []).append(mid_a - mid_b)
    return out


def estimate_offsets(spans: Dict[str, Dict],
                     anchor: Optional[int] = None) -> Dict[int, float]:
    """Compose per-pair median offsets over the exchange graph into one
    per-node offset to the anchor's clock: aligned_t = raw_t + off[node].
    Nodes with no exchange path to the anchor keep offset 0 (flagged by
    their absence from the returned map — callers may warn)."""
    pairs = pair_offsets(spans)
    theta: Dict[Tuple, float] = {}
    for (a, b), samples in pairs.items():
        theta[(a, b)] = statistics.median(samples)
    graph: Dict[int, set] = {}
    for (a, b) in theta:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set()).add(a)
    nodes = {s["node"] for s in spans.values() if s["node"] is not None}
    if not nodes:
        return {}
    if anchor is None or anchor not in nodes:
        anchor = min(nodes)
    off: Dict[int, float] = {anchor: 0.0}
    frontier = [anchor]
    while frontier:
        a = frontier.pop()
        for b in graph.get(a, ()):
            if b in off:
                continue
            if (a, b) in theta:
                # θ(a,b) = clock_a − clock_b: a b-clock stamp + θ(a,b)
                # reads on a's clock
                t_ab = theta[(a, b)]
            else:
                t_ab = -theta[(b, a)]
            off[b] = off[a] + t_ab
            frontier.append(b)
    for n in nodes:  # unreachable nodes: unaligned, assume zero skew
        off.setdefault(n, 0.0)
    return off


# ----------------------------------------------------------- trace forest


_TRACE_ID = re.compile(r"^[0-9a-f]{8}-r(-?[0-9]+)$")


def trace_round_of(tid: str) -> Optional[int]:
    """The round a trace id names (`{seed:08x}-r{it}`, tracectx's
    `trace_id_for`), or None for any other id: a `detached-{node}` trace
    holds work opened outside any round's scope (say a miner verifying an
    update whose frame carried no context because the trace capability
    was not yet negotiated), which belongs to no round. The reference
    labels a trace with its first span's `iter` instead, the recording
    peer's own iteration, so such a trace, or a lagging peer's span of
    another round's trace, can give two traces one round; the id cannot."""
    m = _TRACE_ID.match(str(tid))
    return int(m.group(1)) if m else None


def build_traces(spans: Dict[str, Dict], points: List[Dict],
                 offsets: Dict[int, float]) -> Dict[str, Dict]:
    """Group aligned spans/points per trace id (= per round). Each span
    gains aligned [start, end]; each trace records its nodes, round, the
    round_start stamps, and the settle points."""
    traces: Dict[str, Dict] = {}

    def aligned(t: float, node) -> float:
        return t + offsets.get(node, 0.0)

    for s in spans.values():
        tid = s.get("trace")
        if not tid:
            continue
        end = aligned(s["end_raw"], s["node"])
        s = dict(s, end=end, start=end - s["dur"],
                 segment=segment_of(s["phase"]))
        tr = traces.setdefault(tid, {"spans": {}, "points": [],
                                     "nodes": set(),
                                     "round": trace_round_of(tid)})
        tr["spans"][s["span"]] = s
        tr["nodes"].add(s["node"])
    for ev in points:
        tid = ev.get("trace")
        if not tid or tid not in traces:
            continue
        tr = traces[tid]
        tr["points"].append(dict(ev, t=aligned(float(ev["mono"]),
                                               ev.get("node"))))
        tr["nodes"].add(ev.get("node"))
    return traces


def is_complete(trace: Dict, min_nodes: int = 3) -> bool:
    """A reconstructable round: rooted (round_start seen), settled (a
    block acceptance or round end seen), spanning >= min_nodes peers."""
    names = {ev.get("event") for ev in trace["points"]}
    return ("round_start" in names
            and ({"block_accepted", "round_end"} & names)
            and len({n for n in trace["nodes"] if n is not None})
            >= min_nodes)


# ---------------------------------------------------------- critical path


def _terminal_span(trace: Dict) -> Optional[Dict]:
    """The settle point's span: the span enclosing the LAST
    block-acceptance event (its recorded parent), falling back to the
    latest-ending span in the trace."""
    spans = trace["spans"]
    settles = [ev for ev in trace["points"]
               if ev.get("event") == "block_accepted"
               and ev.get("parent") in spans]
    if settles:
        last = max(settles, key=lambda ev: ev["t"])
        return spans[last["parent"]]
    if not spans:
        return None
    return max(spans.values(), key=lambda s: s["end"])


def critical_path(trace: Dict) -> Dict:
    """The longest causal chain from round start to block settle, with
    per-segment time attribution.

    Chain = the terminal span's ancestors (parent links — each RPC hop's
    receiver span points at its sender span, so the chain crosses
    peers). The chain window [round start, settle] is swept instant by
    instant: the DEEPEST covering chain span wins the instant; gaps are
    filled by whatever span the gap-adjacent node was running (parked
    waits, concurrent work), and instants nobody covers are `untraced`.
    Segment totals therefore sum exactly to the wall time they
    describe."""
    spans = trace["spans"]
    terminal = _terminal_span(trace)
    if terminal is None:
        return {"chain": [], "segments": {}, "wall_s": 0.0,
                "covered_s": 0.0, "coverage": 0.0, "nodes": []}
    chain: List[Dict] = []
    seen = set()
    cur: Optional[Dict] = terminal
    while cur is not None and cur["span"] not in seen:
        seen.add(cur["span"])
        chain.append(cur)
        cur = spans.get(cur.get("parent") or "")
    chain.reverse()  # root-most first; depth = index

    starts = [ev["t"] for ev in trace["points"]
              if ev.get("event") == "round_start"]
    t0 = min(starts + [chain[0]["start"]])
    t1 = terminal["end"]
    if t1 <= t0:
        t1 = t0

    # sweep boundaries: chain span edges + window edges
    cuts = {t0, t1}
    for s in chain:
        cuts.add(min(max(s["start"], t0), t1))
        cuts.add(min(max(s["end"], t0), t1))
    cuts = sorted(cuts)

    # gap filler: per node, spans sorted by start (chain spans excluded)
    by_node: Dict[int, List[Dict]] = {}
    for s in trace["spans"].values():
        if s["span"] in seen:
            continue
        by_node.setdefault(s["node"], []).append(s)
    for lst in by_node.values():
        lst.sort(key=lambda s: s["start"])

    def filler(lo: float, hi: float, node) -> Optional[Dict]:
        best, best_ov = None, 0.0
        for s in by_node.get(node, ()):
            ov = min(hi, s["end"]) - max(lo, s["start"])
            if ov > best_ov:
                best, best_ov = s, ov
        return best

    segments: Dict[str, float] = {}
    steps: List[Dict] = []
    for lo, hi in zip(cuts, cuts[1:]):
        if hi <= lo:
            continue
        mid = (lo + hi) / 2.0
        cover = None
        for depth, s in enumerate(chain):
            if s["start"] <= mid < s["end"]:
                cover = s  # deepest (latest in chain) covering span wins
        if cover is None:
            # the node about to act next on the chain was doing
            # SOMETHING — find its concurrent span (parked waits live
            # here), else the instant is honestly untraced
            nxt = next((s for s in chain if s["start"] >= hi - 1e-9), None)
            owner = nxt["node"] if nxt is not None else chain[-1]["node"]
            cover = filler(lo, hi, owner)
        seg = cover["segment"] if cover is not None else UNTRACED
        segments[seg] = segments.get(seg, 0.0) + (hi - lo)
        if steps and steps[-1]["span"] == (cover and cover["span"]):
            steps[-1]["end"] = hi
            steps[-1]["dur_s"] = round(steps[-1]["end"] - steps[-1]["start"],
                                       6)
            continue
        steps.append({
            "span": cover["span"] if cover else None,
            "node": cover["node"] if cover else None,
            "phase": cover["phase"] if cover else UNTRACED,
            "msg": (cover or {}).get("msg"),
            "segment": seg, "start": lo, "end": hi,
            "dur_s": round(hi - lo, 6),
        })
    wall = t1 - t0
    covered = sum(v for k, v in segments.items() if k != UNTRACED)
    return {
        "chain": steps,
        "chain_spans": [s["span"] for s in chain],
        "segments": {k: round(v, 6) for k, v in
                     sorted(segments.items(), key=lambda kv: -kv[1])},
        "wall_s": round(wall, 6),
        "covered_s": round(covered, 6),
        "coverage": round(covered / wall, 4) if wall > 0 else 1.0,
        "nodes": sorted({s["node"] for s in chain if s["node"] is not None}),
        "terminal": terminal["span"],
    }


def format_critical_table(cp: Dict, round_id="?") -> str:
    """The text critical-path table: one row per attributed step."""
    lines = [
        f"critical path — round {round_id}: wall {cp['wall_s']:.3f}s, "
        f"{len(cp['chain'])} steps across peers {cp['nodes']}, "
        f"coverage {cp['coverage'] * 100:.1f}%",
        f"{'node':>5} {'segment':<9} {'phase':<22} {'dur_s':>9}  span",
    ]
    for step in cp["chain"]:
        phase = step["phase"] + (f"[{step['msg']}]" if step.get("msg")
                                 else "")
        lines.append(
            f"{step['node'] if step['node'] is not None else '-':>5} "
            f"{step['segment']:<9} {phase:<22} {step['dur_s']:>9.4f}  "
            f"{step['span'] or '-'}")
    seg = "  ".join(f"{k}={v:.3f}s" for k, v in cp["segments"].items())
    lines.append(f"segments: {seg}")
    return "\n".join(lines)


# ------------------------------------------------------------ chrome JSON


def chrome_trace(traces: Dict[str, Dict]) -> Dict:
    """Chrome trace-event JSON (Perfetto / chrome://tracing loadable):
    one process per peer, spans as complete ('X') events on greedily
    assigned lanes (overlapping spans never share a lane), flow arrows
    ('s'/'f') on cross-node parent links, microsecond timestamps
    rebased to the earliest span."""
    events: List[Dict] = []
    all_spans = [s for tr in traces.values() for s in tr["spans"].values()]
    if not all_spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t_base = min(s["start"] for s in all_spans)
    nodes = sorted({s["node"] for s in all_spans if s["node"] is not None})
    for n in nodes:
        events.append({"ph": "M", "name": "process_name", "pid": n,
                       "tid": 0, "args": {"name": f"peer {n}"}})

    def us(t: float) -> int:
        return int(round((t - t_base) * 1e6))

    # greedy lane assignment per node: lowest lane whose last span ended
    lanes: Dict[int, List[float]] = {}
    lane_of: Dict[str, int] = {}
    for s in sorted(all_spans, key=lambda s: s["start"]):
        node_lanes = lanes.setdefault(s["node"], [])
        for i, busy_until in enumerate(node_lanes):
            if busy_until <= s["start"] + 1e-9:
                node_lanes[i] = s["end"]
                lane_of[s["span"]] = i
                break
        else:
            node_lanes.append(s["end"])
            lane_of[s["span"]] = len(node_lanes) - 1

    span_table = {s["span"]: s for s in all_spans}
    flow = 0
    for s in all_spans:
        name = s["phase"] + (f" {s['msg']}" if s.get("msg") else "")
        events.append({
            "ph": "X", "name": name, "cat": s["segment"],
            "pid": s["node"], "tid": lane_of[s["span"]],
            "ts": us(s["start"]), "dur": max(1, int(s["dur"] * 1e6)),
            "args": {"span": s["span"], "parent": s.get("parent"),
                     "trace": s.get("trace"), "iter": s.get("iter")},
        })
        parent = span_table.get(s.get("parent") or "")
        if parent is not None and parent["node"] != s["node"]:
            flow += 1
            # bind the arrow inside each slice: start point clamped into
            # the parent's interval, finish at the child's start
            ts_s = min(max(s["start"], parent["start"]),
                       max(parent["end"] - 1e-6, parent["start"]))
            events.append({"ph": "s", "id": flow, "name": "causal",
                           "cat": "flow", "pid": parent["node"],
                           "tid": lane_of[parent["span"]], "ts": us(ts_s)})
            events.append({"ph": "f", "bp": "e", "id": flow,
                           "name": "causal", "cat": "flow",
                           "pid": s["node"], "tid": lane_of[s["span"]],
                           "ts": us(s["start"])})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome(obj: Dict) -> None:
    """Schema check for the trace-event JSON (what the checked-in
    fixture test runs): raises ValueError on any malformation."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("missing traceEvents")
    for ev in obj["traceEvents"]:
        if not isinstance(ev, dict):
            raise ValueError("event not an object")
        ph = ev.get("ph")
        if ph not in ("X", "M", "s", "f", "t", "B", "E", "i"):
            raise ValueError(f"bad ph {ph!r}")
        if ph == "X":
            for k in ("name", "ts", "dur", "pid", "tid"):
                if k not in ev:
                    raise ValueError(f"X event missing {k}")
            if not isinstance(ev["ts"], (int, float)) \
                    or not isinstance(ev["dur"], (int, float)) \
                    or ev["dur"] < 0:
                raise ValueError("bad ts/dur")
        if ph in ("s", "f") and "id" not in ev:
            raise ValueError("flow event missing id")
    json.dumps(obj)  # must be serializable as-is


# ------------------------------------------------------------- collection


async def poll_cluster(host: str, ports: List[int], rounds: int = 1,
                       budget_s: float = 120.0, poll_s: float = 0.5,
                       min_nodes: int = 3, page: int = 1000,
                       timeout: float = 5.0) -> List[Dict]:
    """Incrementally pull every peer's recorder via the Metrics RPC
    `since_seq` cursor until >= `rounds` complete round traces exist (or
    the budget expires). Returns the accumulated event list."""
    from biscotti_tpu_torch.runtime import rpc

    cursors: Dict[int, int] = {}
    events: List[Dict] = []
    deadline = time.monotonic() + budget_s

    async def sweep_one(port: int) -> None:
        while True:  # drain this peer's pages
            before = cursors.get(port, 0)
            try:
                rmeta, _ = await rpc.call(
                    host, port, "Metrics",
                    {"since_seq": before, "tail": page},
                    timeout=timeout)
            except Exception:
                return  # unreachable this sweep: others still merge
            got = rmeta.get("events") or []
            events.extend(got)
            # a peer that does not speak the cursor (a pre-cursor build
            # ignoring since_seq) replies without last_seq: stop after
            # one page rather than re-fetching the identical tail
            # forever; same guard if the cursor ever fails to advance
            last = int(rmeta.get("last_seq", before) or before)
            cursors[port] = max(before, last)
            if len(got) < page or cursors[port] <= before:
                return

    while time.monotonic() < deadline:
        await asyncio.gather(*(sweep_one(p) for p in ports))
        spans, points = collect_spans(events)
        traces = build_traces(spans, points, estimate_offsets(spans))
        done = [t for t in traces.values() if is_complete(t, min_nodes)]
        if len(done) >= rounds:
            break
        await asyncio.sleep(poll_s)
    return events


def reconstruct(events: List[Dict], min_nodes: int = 3) -> Dict:
    """events -> {offsets, traces, rounds: [{trace, round, nodes,
    critical}]} — the one entry point tests and the CLI share."""
    spans, points = collect_spans(events)
    offsets = estimate_offsets(spans)
    traces = build_traces(spans, points, offsets)
    rounds = []
    for tid, tr in sorted(traces.items(),
                          key=lambda kv: (kv[1]["round"] is None,
                                          kv[1]["round"] or 0, kv[0])):
        row = {"trace": tid, "round": tr["round"],
               "nodes": sorted(n for n in tr["nodes"] if n is not None),
               "spans": len(tr["spans"]),
               "complete": is_complete(tr, min_nodes)}
        if tr["spans"]:
            row["critical"] = critical_path(tr)
        rounds.append(row)
    return {"offsets": offsets, "traces": traces, "rounds": rounds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="reconstruct cross-peer round timelines from a live "
                    "cluster's flight recorders (--trace 1 peers)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--base-port", type=int, default=8000)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--ports", default="",
                    help="explicit comma-separated ports (overrides "
                         "--base-port/--nodes)")
    ap.add_argument("--spill", nargs="*", default=[],
                    help="offline mode: read recorder spill JSONL files "
                         "instead of scraping a live cluster")
    ap.add_argument("--rounds", type=int, default=1,
                    help="complete rounds to collect before stopping")
    ap.add_argument("--round", type=int, default=None,
                    help="only report this blockchain iteration")
    ap.add_argument("--min-nodes", type=int, default=3,
                    help="peers a round's tree must span to count as "
                         "complete")
    ap.add_argument("--budget", type=float, default=120.0,
                    help="polling budget, seconds")
    ap.add_argument("--poll", type=float, default=0.5,
                    help="seconds between incremental scrapes")
    ap.add_argument("--chrome-out", default="",
                    help="write Chrome trace-event JSON here (load in "
                         "Perfetto / chrome://tracing)")
    ap.add_argument("--json", default="",
                    help="write the reconstruction (rounds + critical "
                         "paths) as JSON here")
    ns = ap.parse_args(argv)

    if ns.spill:
        events = []
        for path in ns.spill:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        events.append(json.loads(line))
    else:
        ports = ([int(p) for p in ns.ports.split(",") if p] if ns.ports
                 else [ns.base_port + i for i in range(ns.nodes)])
        events = asyncio.run(poll_cluster(
            ns.host, ports, rounds=ns.rounds, budget_s=ns.budget,
            poll_s=ns.poll, min_nodes=ns.min_nodes))

    out = reconstruct(events, min_nodes=ns.min_nodes)
    shown = 0
    for row in out["rounds"]:
        if ns.round is not None and row["round"] != ns.round:
            continue
        if not row["complete"] and ns.round is None:
            continue
        cp = row.get("critical")
        print(f"\ntrace {row['trace']}  round {row['round']}  "
              f"spans {row['spans']}  peers {row['nodes']}")
        if cp:
            print(format_critical_table(cp, round_id=row["round"]))
        shown += 1
    if not shown:
        print("no complete round reconstructed — are peers running "
              "with --trace 1?", file=sys.stderr)
    skewed = {n: round(o, 6) for n, o in out["offsets"].items()
              if abs(o) > 1e-4}
    if skewed:
        print(f"\nclock offsets vs anchor (s): {skewed}")
    if ns.chrome_out:
        obj = chrome_trace(out["traces"])
        validate_chrome(obj)
        with open(ns.chrome_out, "w") as f:
            json.dump(obj, f)
        print(f"chrome trace: {ns.chrome_out} "
              f"({len(obj['traceEvents'])} events)")
    if ns.json:
        serializable = {
            "offsets": {str(k): v for k, v in out["offsets"].items()},
            "rounds": out["rounds"],
        }
        with open(ns.json, "w") as f:
            json.dump(serializable, f, indent=1, default=str)
    return 0 if shown else 1


if __name__ == "__main__":
    sys.exit(main())
