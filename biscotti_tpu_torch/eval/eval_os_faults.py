# The port's counterpart of eval/eval_os_faults.py; it imports nothing of biscotti_tpu.
"""OS-level fault-injection eval: real peer processes, real sockets, real
signals.

    python -m biscotti_tpu_torch.eval.eval_os_faults [--nodes 5] \
        [--dataset creditcard] [--iterations 6] [--platform cuda] [--out DIR]

Three scenarios through the port's local harness
(`python -m biscotti_tpu_torch.eval.local_test`), each closed by the
chain-equality oracle over the processes' printed dumps:

  baseline       N clean processes (ref: DistSys/localTest.sh:24-96)
  sigstop        one peer SIGSTOPped for a window mid-run, then SIGCONT
                 (ref: DistSys/blockNode.sh:1-17); the healed peer must
                 close with an identical chain
  kill_restart   one peer kill -9ed, then the same id relaunched; it must
                 rejoin and close identical (ref: failAndRestartLocal.sh)

Artifact: os_faults.json, the reference's keys plus `device`/`nvidia_smi`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.eval import RESULTS, device_fields
from biscotti_tpu_torch.tools.pod_launch import REPO


def run_scenario(name: str, extra, nodes: int, dataset: str, iters: int,
                 port: int, timeout: float, platform: str = "cuda"):
    cmd = [sys.executable, "-m", "biscotti_tpu_torch.eval.local_test",
           "--nodes", str(nodes), "--dataset", dataset,
           "--base-port", str(port),
           "--max-iterations", str(iters),
           # the run must outlive the fault window: convergence exit off,
           # so the victim always heals among live peers
           "--convergence-error", "0",
           "--timeout", str(timeout), "--platform", platform] + extra
    t0 = time.time()
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                         timeout=timeout + 120)
    wall = time.time() - t0
    summary = None
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            summary = json.loads(line)
    row = {"scenario": name, "rc": out.returncode,
           "wall_s": round(wall, 1), **(summary or {})}
    if summary is None:
        row["stderr_tail"] = out.stderr.splitlines()[-5:]
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--dataset", default="creditcard")
    ap.add_argument("--iterations", type=int, default=6)
    ap.add_argument("--base-port", type=int, default=23800)
    ap.add_argument("--timeout", type=float, default=420.0)
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--platform", default="cuda",
                    help="torch device of every peer process: 'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

    # faults target the last node id: with the harness's seed-3 committees
    # it is a plain worker in early rounds
    victim = args.nodes - 1
    rows = [
        run_scenario("baseline", [], args.nodes, args.dataset,
                     args.iterations, args.base_port, args.timeout,
                     args.platform),
        run_scenario(
            "sigstop",
            ["--sigstop-node", str(victim), "--sigstop-after", "6",
             "--sigstop-duration", "12"],
            args.nodes, args.dataset, args.iterations,
            args.base_port + 100, args.timeout, args.platform),
        run_scenario(
            "kill_restart",
            ["--kill-node", str(victim), "--kill-after", "6",
             "--restart-after", "4"],
            args.nodes, args.dataset, args.iterations,
            args.base_port + 200, args.timeout, args.platform),
    ]
    ok = all(r.get("chains_equal") and r.get("blocks", 0) > 0 for r in rows)
    payload = {
        "experiment": "os_faults", **device_fields(dev),
        "injection": "OS signals against real peer processes "
                     "(SIGSTOP/SIGCONT window, SIGKILL + same-id relaunch)",
        "nodes": args.nodes, "dataset": args.dataset,
        "iterations": args.iterations,
        "rows": rows, "ok": ok,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "os_faults.json"), "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps({"summary": "os_faults", "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
