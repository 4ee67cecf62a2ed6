# The port's own copy of biscotti_tpu/tools/profile_round.py; it imports nothing of biscotti_tpu.
# It drops the reference's jax switches and adds `--device`, the peers' torch device.
"""Profile live rounds from telemetry spans into a phase-overlap table.

    python -m biscotti_tpu_torch.tools.profile_round --nodes 8 --iterations 3 \
        --pipeline 1

Runs a small in-process live cluster (same harness shape as
eval/eval_cost_breakdown.py), then reads every peer's flight-recorder
span events — each carries (iteration, phase, dur_s) plus the recorder's
monotonic stamp — and answers the question the pipelined round engine
exists for: HOW MUCH of each round's phase time ran overlapped?

Per round (aggregated over peers, but measured PER PEER so ordinary
inter-peer concurrency — different hosts working at the same time, which
the serial engine has too — never masquerades as pipelining):

    serial_s      Σ over peers of each peer's span durations charged to
                  the round — the phase work, as if each peer ran its
                  own phases back to back
    wall_s        the slowest peer's own round_start→round_end window
    overlap_s     Σ over peers of max(0, own serial − own wall) —
                  seconds of a peer's OWN phase work hidden under its
                  other phases (the pipelining/speculation win; compare
                  --pipeline 1 vs --pipeline 0 runs for the delta)

plus the per-phase totals and the crypto batch sizes the batched miner
intake actually settled (`vss_batch_settled` / `plain_batch_verified`
events), so a pipelined run shows both WHERE the time went and HOW WIDE
the batches were. Exits 0 iff the cluster's chains are equal.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
from typing import Dict, List

# tracing-only spans that are NOT phase work: waits (the peer parked),
# wire time (rpc_call covers the await on a reply), and composites
# whose children are already counted (mint nests recovery/verify).
# Counting them into serial_s would report waiting as overlapped work.
_NON_WORK_PHASES = frozenset({
    "rpc_call", "block_wait", "intake_wait", "mint",
})

# counted into the phase totals (they ARE work — the crypto_split_s row
# reads them) but NOT into serial_s: a crypto_device span is nested
# inside the host phase (miner_verify / intake_fold / recovery) that
# invoked the kernel, whose own span already covers the same seconds —
# double-charging would report the device time as phantom overlap
_NESTED_WORK_PHASES = frozenset({"crypto_device"})


def collect_round_table(agents) -> Dict:
    """Aggregate span/trace events from live agents' flight recorders
    into the per-round overlap table (pure function of the rings, so
    tests can drive it without the CLI)."""
    # keyed (node, iter): overlap must be judged within ONE peer — the
    # serial engine already runs peers concurrently, and summing spans
    # across peers against a cluster-wide wall would report that
    # ordinary concurrency as pipelining
    per: Dict[tuple, Dict] = {}
    phases: Dict[str, float] = {}
    batch_sizes: List[int] = []
    # per-round trace linkage (docs/OBSERVABILITY.md §Distributed
    # tracing): when the cluster ran with tracing, each overlap row
    # carries the round's cluster-wide trace id and its span count, so
    # a row cross-references straight into tools/trace_round output
    # (and the --chrome-out timeline) by trace id / span id. Majority
    # vote per iteration: a handful of boundary spans (the block gossip
    # of round r lands after `iteration` advanced to r+1) straddle
    # rounds and must not claim the row.
    trace_votes: Dict[int, Dict[str, int]] = {}
    span_count: Dict[int, int] = {}
    for a in agents:
        for ev in a.tele.recorder.tail(100000):
            it = ev.get("iter")
            node = ev.get("node")
            name = ev.get("event")
            if name == "span" and it is not None:
                if ev.get("trace"):
                    votes = trace_votes.setdefault(it, {})
                    tid = str(ev["trace"])
                    votes[tid] = votes.get(tid, 0) + 1
                    span_count[it] = span_count.get(it, 0) + 1
                phase = ev.get("phase", "?")
                if phase in _NON_WORK_PHASES or phase.startswith("rpc."):
                    # timeline coverage, not phase work: rpc.* dispatch
                    # spans WRAP handler work whose own spans are counted
                    continue
                r = per.setdefault((node, it), {"serial_s": 0.0,
                                                "start": None, "end": None})
                dur = float(ev.get("dur_s", 0.0))
                if phase not in _NESTED_WORK_PHASES:
                    r["serial_s"] += dur
                phases[phase] = phases.get(phase, 0.0) + dur
            elif name == "round_start" and it is not None:
                r = per.setdefault((node, it), {"serial_s": 0.0,
                                                "start": None, "end": None})
                r["start"] = float(ev["mono"])
            elif name == "round_end":
                # the event's own iter stamp has already advanced past
                # the accepted block; `height` names the finished round
                key = ev.get("height", it)
                if key is None:
                    continue
                r = per.setdefault((node, key), {"serial_s": 0.0,
                                                 "start": None, "end": None})
                r["end"] = float(ev["mono"])
            elif name in ("vss_batch_settled", "plain_batch_verified"):
                n = int(ev.get("n", 0))
                if n:
                    batch_sizes.append(n)
    table = []
    for it in sorted({k[1] for k in per}):
        serial = 0.0
        overlap = 0.0
        wall = None
        for (node, rit), r in per.items():
            if rit != it:
                continue
            serial += r["serial_s"]
            if r["start"] is not None and r["end"] is not None:
                own_wall = r["end"] - r["start"]
                wall = own_wall if wall is None else max(wall, own_wall)
                overlap += max(0.0, r["serial_s"] - own_wall)
        row = {"iter": it, "serial_s": round(serial, 4)}
        if wall is not None:
            row["wall_s"] = round(wall, 4)
            row["overlap_s"] = round(overlap, 4)
        if it in trace_votes:
            row["trace"] = max(trace_votes[it].items(),
                               key=lambda kv: kv[1])[0]
            row["trace_spans"] = span_count.get(it, 0)
        table.append(row)
    # crypto residency split: how much of the phase time was
    # host EC/bigint work vs device-kernel work, judged by the same
    # phase → segment taxonomy the trace_round critical path uses.
    # crypto_device spans are tagged at the kernel call sites, NESTED
    # inside the host crypto phase that invoked them (prewarm spans are
    # suppressed at the source), so the device seconds are SUBTRACTED
    # from the host-phase total: crypto_cpu is the wrapper/bigint work
    # that actually stayed on the CPU, and the two rows sum to the
    # crypto phase time instead of double-counting the moved portion.
    from biscotti_tpu_torch.tools import trace_round as _tr

    crypto_split = {_tr.CRYPTO_CPU: 0.0, _tr.CRYPTO_DEVICE: 0.0}
    for phase, total in phases.items():
        seg = _tr.segment_of(phase)
        if seg in crypto_split:
            crypto_split[seg] += total
    crypto_split[_tr.CRYPTO_CPU] = max(
        0.0, crypto_split[_tr.CRYPTO_CPU] - crypto_split[_tr.CRYPTO_DEVICE])
    return {
        "rounds": table,
        "phase_totals_s": {k: round(v, 4)
                           for k, v in sorted(phases.items(),
                                              key=lambda kv: -kv[1])},
        "crypto_split_s": {k: round(v, 4) for k, v in crypto_split.items()},
        "crypto_batch_sizes": sorted(batch_sizes),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="profile live rounds: phase overlap + batch sizes")
    ap.add_argument("--dataset", default="creditcard")
    ap.add_argument("--device", default=None,
                    help="torch device of every peer (default: the "
                         "GPU, which must exist; 'cpu' to run on the "
                         "CPU)")
    ap.add_argument("--nodes", type=int, default=6)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--secure-agg", type=int, default=1)
    ap.add_argument("--pipeline", type=int, default=1,
                    help="1 = pipelined engine (overlap + speculation + "
                         "batched intake); 0 = the serial seed schedule")
    ap.add_argument("--device-crypto", type=int, default=0,
                    help="1 = run the harness cluster with the "
                         "accelerator-resident crypto plane armed, so "
                         "the crypto_split_s row shows what moved "
                         "on-device (docs/CRYPTO_KERNELS.md)")
    ap.add_argument("--base-port", type=int, default=28410)
    ap.add_argument("--json", default="",
                    help="also write the table to this path")
    ap.add_argument("--trace", type=int, default=1,
                    help="1 = run the harness cluster with distributed "
                         "tracing so overlap rows carry trace/span ids "
                         "and --chrome-out works (0 = untraced)")
    ap.add_argument("--chrome-out", default="",
                    help="write the cluster's causal timeline as Chrome "
                         "trace-event JSON (tools/trace_round exporter; "
                         "load in Perfetto). Implies --trace 1.")
    args = ap.parse_args(argv)
    if args.chrome_out:
        args.trace = 1
    from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts
    from biscotti_tpu_torch.runtime.peer import PeerAgent

    timeouts = Timeouts(update_s=20, block_s=60, krum_s=15, share_s=20,
                        rpc_s=20)
    cfgs = [
        BiscottiConfig(
            node_id=i, num_nodes=args.nodes, dataset=args.dataset,
            base_port=args.base_port, secure_agg=bool(args.secure_agg),
            noising=True, verification=True, defense=Defense.KRUM,
            max_iterations=args.iterations, convergence_error=0.0,
            sample_percent=0.70, seed=2, timeouts=timeouts,
            pipeline=bool(args.pipeline), speculation=bool(args.pipeline),
            batch_intake=bool(args.pipeline), trace=bool(args.trace),
            device_crypto=bool(args.device_crypto),
        )
        for i in range(args.nodes)
    ]

    async def go():
        agents = [PeerAgent(c, device=args.device) for c in cfgs]
        results = await asyncio.gather(*(a.run() for a in agents))
        return agents, results

    agents, results = asyncio.run(go())
    out = collect_round_table(agents)
    dumps = [r["chain_dump"] for r in results]
    out["chains_equal"] = all(d == dumps[0] for d in dumps)
    out["pipeline"] = bool(args.pipeline)
    out["nodes"] = args.nodes

    print(f"{'iter':>5} {'serial_s':>9} {'wall_s':>8} {'overlap_s':>10}  "
          "trace")
    for row in out["rounds"]:
        print(f"{row['iter']:>5} {row['serial_s']:>9.3f} "
              f"{row.get('wall_s', float('nan')):>8.3f} "
              f"{row.get('overlap_s', 0.0):>10.3f}  "
              f"{row.get('trace', '-')}"
              + (f" ({row['trace_spans']} spans)"
                 if row.get("trace_spans") else ""))
    print("phase totals:", json.dumps(out["phase_totals_s"]))
    print("crypto split:", json.dumps(out["crypto_split_s"]))
    if out["crypto_batch_sizes"]:
        bs = out["crypto_batch_sizes"]
        print(f"crypto batches: n={len(bs)} sizes min/med/max = "
              f"{bs[0]}/{bs[len(bs) // 2]}/{bs[-1]}")
    print("chains_equal:", out["chains_equal"])
    if args.chrome_out:
        # reuse the trace_round exporter on the in-process recorders:
        # same span forest, zero clock skew (one process, one clock)
        from biscotti_tpu_torch.tools import trace_round as tr

        events = [ev for a in agents for ev in a.tele.recorder.tail(100000)]
        recon = tr.reconstruct(events, min_nodes=1)
        obj = tr.chrome_trace(recon["traces"])
        tr.validate_chrome(obj)
        with open(args.chrome_out, "w") as f:
            json.dump(obj, f)
        print(f"chrome trace: {args.chrome_out} "
              f"({len(obj['traceEvents'])} events)")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if out["chains_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
