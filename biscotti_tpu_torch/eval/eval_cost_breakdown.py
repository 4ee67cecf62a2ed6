# The port's counterpart of eval/eval_cost_breakdown.py; it imports nothing of biscotti_tpu.
"""Per-phase cost breakdown: where a protocol round's time goes, on the
port's live peers.

    python -m biscotti_tpu_torch.eval.eval_cost_breakdown [--dataset mnist] \
        [--nodes 20] [--iterations 3] [--secure-agg 1] [--pipeline 0] \
        [--trace-dir DIR] [--platform cuda] [--out DIR]

The reference published this as a figure from wall-clock deltas in node
logs (ref: usenix-eval/eval_cost_breakdown.pdf); here every peer carries a
PhaseClock, and the cluster's telemetry snapshots merge (tools/obs.py)
into per-phase totals, calls and p50/p99, the miner-crypto components and
the wire table. `--trace-dir` wraps the run in the port's
`utils/profiling.device_trace` on the run's device (a torch.profiler
window, `trace.json`). `--base-port` is the cluster's (the reference
fixes 29000).

Artifacts: cost_breakdown.json and cost_breakdown.csv, the reference's
keys plus `device`/`nvidia_smi`.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os

from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts
from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.eval import RESULTS, device_fields
from biscotti_tpu_torch.runtime.peer import PeerAgent
from biscotti_tpu_torch.tools import obs
from biscotti_tpu_torch.utils.profiling import device_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--nodes", type=int, default=20)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--secure-agg", type=int, default=1)
    ap.add_argument("--pipeline", type=int, default=0,
                    help="1 runs the pipelined round engine (overlapped "
                         "intake verification + speculation + batched "
                         "miner crypto)")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--trace-dir", default="",
                    help="also capture a torch.profiler device trace here")
    ap.add_argument("--base-port", type=int, default=29000)
    ap.add_argument("--platform", default="cuda",
                    help="torch device of the peers: 'cuda' (raises "
                         "without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

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
            batch_intake=bool(args.pipeline),
        )
        for i in range(args.nodes)
    ]

    async def go():
        agents = [PeerAgent(c, device=dev) for c in cfgs]
        return await asyncio.gather(*(a.run() for a in agents))

    ctx = (device_trace(args.trace_dir, device=dev) if args.trace_dir
           else contextlib.nullcontext())
    with ctx:
        results = asyncio.run(go())

    # per-phase costs across peers off the telemetry snapshots each run()
    # result carries: obs.merge_phase_histograms is the one aggregation
    snaps = [r["telemetry"] for r in results]
    quantiles = obs.merge_phase_histograms(snaps)
    phases = {
        name: {"total_s": round(row["total_s"], 3),
               "calls": row["count"],
               "s_per_call": round(row["total_s"] / max(1, row["count"]), 5)}
        for name, row in quantiles.items()
    }
    wire = obs.merge_snapshots(snaps)["wire"]

    def _tot(*names: str) -> float:
        return round(sum(phases.get(n, {}).get("total_s", 0.0)
                         for n in names), 3)

    miner_components = {
        # one-shot batch check + incremental fold + intake validation
        "commitment_verify_s": _tot("miner_verify", "intake_fold",
                                    "intake_validate"),
        # verifier-quorum Schnorr checks at intake
        "signature_check_s": _tot("sig_check"),
        # Vandermonde least-squares recovery of the aggregate
        "share_interpolation_s": _tot("recovery"),
    }

    dumps = [r["chain_dump"] for r in results]
    summary = {
        "experiment": "cost_breakdown", **device_fields(dev),
        "dataset": args.dataset, "nodes": args.nodes,
        "iterations": args.iterations,
        "secure_agg": bool(args.secure_agg),
        "pipeline": bool(args.pipeline),
        "chains_equal": all(d == dumps[0] for d in dumps),
        "phases": phases,  # already ordered by -total_s (obs merge)
        "miner_crypto_components": miner_components,
        "phase_quantiles": quantiles,
        "wire": wire,
        "device_trace": args.trace_dir or None,
    }
    print(json.dumps(summary))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "cost_breakdown.json"), "w") as f:
        json.dump(summary, f, indent=1)
    with open(os.path.join(args.out, "cost_breakdown.csv"), "w") as f:
        f.write("phase,total_s,calls,s_per_call\n")
        for name, agg in summary["phases"].items():
            f.write(f"{name},{agg['total_s']},{agg['calls']},"
                    f"{agg['s_per_call']}\n")
        f.write("\nmetric,value\n")
        for comp, val in miner_components.items():
            f.write(f"miner_{comp},{val}\n")
        f.write(f"wire_out_bytes,{wire['out_bytes']}\n")
        f.write(f"wire_in_bytes,{wire['in_bytes']}\n")
        f.write(f"wire_bytes_per_round,{wire['bytes_per_round']}\n")
    return 0 if summary["chains_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
