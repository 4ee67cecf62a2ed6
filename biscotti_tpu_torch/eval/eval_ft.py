# The port's counterpart of eval/eval_ft.py; it imports nothing of biscotti_tpu.
"""Fault-tolerance and churn eval: training progress under repeated kill
and restart, on the port's live peers.

    python -m biscotti_tpu_torch.eval.eval_ft [--dataset creditcard] \
        [--nodes 8] [--iterations 30] [--churn-every 6] [--platform cuda] \
        [--out DIR]

Reference experiments: eval/eval_FT/ (convergence under node churn) and
DistSys/failAndRestartLocal.sh (kill a node, relaunch it, loop). An
in-process cluster; each time the anchor's chain grows by --churn-every,
one of the last two peers (in turn) is killed (its round task cancelled,
its pool and server closed) and, two heights later, restarted as a fresh
agent on the same id, which rejoins through RegisterPeer and longest-chain
adoption. The run reports the error curve and whether the settled chains
agree. `--base-port` is the cluster's (the reference fixes 29500).

Artifacts: ft.json and ft.csv (iteration,error,timestamp), the
reference's keys plus `device`/`nvidia_smi`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os

from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts
from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.eval import RESULTS, device_fields
from biscotti_tpu_torch.runtime.peer import PeerAgent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="creditcard")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--churn-every", type=int, default=6,
                    help="kill+restart a peer each time the chain grows this much")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--base-port", type=int, default=29500)
    ap.add_argument("--platform", default="cuda",
                    help="torch device of the peers: 'cuda' (raises "
                         "without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

    timeouts = Timeouts(update_s=4, block_s=10, krum_s=4, share_s=4, rpc_s=5)

    def make_cfg(i):
        return BiscottiConfig(
            node_id=i, num_nodes=args.nodes, dataset=args.dataset,
            base_port=args.base_port, verification=True,
            defense=Defense.KRUM, secure_agg=False, noising=False,
            max_iterations=args.iterations, convergence_error=0.0,
            sample_percent=1.0, seed=2, timeouts=timeouts,
        )

    events = []

    async def wait_height(agent, h, budget=120.0):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + budget
        while agent.iteration < h:
            if loop.time() > deadline:
                raise TimeoutError(f"stuck below height {h}")
            await asyncio.sleep(0.05)

    async def go():
        agents = {i: PeerAgent(make_cfg(i), device=dev)
                  for i in range(args.nodes)}
        tasks = {i: asyncio.ensure_future(agents[i].run())
                 for i in range(args.nodes)}
        victim_cycle = [args.nodes - 1, args.nodes - 2]
        next_churn = args.churn_every
        k = 0
        while next_churn < args.iterations - 3:
            await wait_height(agents[0], next_churn)
            victim = victim_cycle[k % len(victim_cycle)]
            k += 1
            t = tasks[victim]
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass  # the killed peer's own end is not the outcome
            agents[victim].pool.close()
            await agents[victim].server.stop()
            events.append({"at_height": agents[0].iteration,
                           "event": "kill", "node": victim})
            await wait_height(agents[0], next_churn + 2)
            agents[victim] = PeerAgent(make_cfg(victim), device=dev)
            tasks[victim] = asyncio.ensure_future(agents[victim].run())
            events.append({"at_height": agents[0].iteration,
                           "event": "restart", "node": victim})
            next_churn += args.churn_every
        return await asyncio.gather(*tasks.values())

    results = asyncio.run(go())
    dumps = [r["chain_dump"].splitlines() for r in results]
    common = min(len(d) for d in dumps) - 1
    settled_equal = all(d[:common] == dumps[0][:common] for d in dumps)
    nonempty = sum(1 for ln in dumps[0][1:] if "ndeltas=0" not in ln)
    summary = {
        "experiment": "fault_tolerance_churn", **device_fields(dev),
        "dataset": args.dataset, "nodes": args.nodes,
        "iterations": args.iterations, "events": events,
        "settled_chains_equal": settled_equal,
        "common_height": common,
        "nonempty_blocks": nonempty,
        "final_error": results[0]["final_error"],
    }
    print(json.dumps(summary))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "ft.json"), "w") as f:
        json.dump(summary, f, indent=1)
    with open(os.path.join(args.out, "ft.csv"), "w") as f:
        for row in results[0]["logs"]:
            f.write(row + "\n")
    ok = settled_equal and nonempty >= args.iterations // 2
    print(json.dumps({"summary": "churn_tolerated", "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
