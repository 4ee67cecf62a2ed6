# The port's counterpart of eval/local_test.py; it imports nothing of biscotti_tpu.
"""Local integration harness: the reference's localTest.sh as a Python
driver (ref: DistSys/localTest.sh:24-96), over the port's peer CLI.

    python -m biscotti_tpu_torch.eval.local_test --nodes 5 --dataset creditcard \
        [--max-iterations 3] [--fedsys] [--kill-node 2 --kill-after 5] \
        [--platform cuda]

Boots N peer processes (`python -m biscotti_tpu_torch.runtime.peer ...
--platform P`) on localhost ports, waits for all to exit (converged or
max-iterations), then compares every pair of chain dumps byte for byte:
any divergence fails the run. This is the top-level consistency oracle of
the whole system. On the card every process runs its peer on the GPU.

Fault-injection variants, at the OS level against real processes and
their sockets:

--kill-node/--kill-after     kill -9 a peer mid-run; the rest must keep
                             minting (ref: DistSys/failAndRestartLocal.sh)
--restart-after              with --kill-node: relaunch the same peer id
                             after this many seconds; it must rejoin and
                             close with the survivors' chain
--sigstop-node/--sigstop-after/--sigstop-duration
                             SIGSTOP one peer's process for the window,
                             then SIGCONT: it holds its sockets but answers
                             nothing, and on heal it must catch up and close
                             with an identical chain (ref:
                             DistSys/blockNode.sh:1-17)

Prints one JSON summary, the reference's keys plus `device`/`nvidia_smi`.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.eval import device_fields
from biscotti_tpu_torch.tools.pod_launch import REPO


def extract_chain(stdout: str) -> str:
    lines = stdout.splitlines()
    try:
        a = lines.index("=== CHAIN DUMP ===")
        b = lines.index("=== LOGS ===")
    except ValueError:
        return ""
    return "\n".join(lines[a + 1: b])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--dataset", default="creditcard")
    ap.add_argument("--base-port", type=int, default=23000)
    ap.add_argument("--max-iterations", type=int, default=3)
    ap.add_argument("--fedsys", action="store_true")
    ap.add_argument("--secure-agg", type=int, default=0)
    ap.add_argument("--noising", type=int, default=0)
    ap.add_argument("--verification", type=int, default=0)
    ap.add_argument("--num-verifiers", type=int, default=1)
    ap.add_argument("--num-miners", type=int, default=1)
    ap.add_argument("--kill-node", type=int, default=-1)
    ap.add_argument("--kill-after", type=float, default=5.0)
    ap.add_argument("--restart-after", type=float, default=-1.0,
                    help="with --kill-node: relaunch the killed peer this "
                         "many seconds after the kill (-1 = stay dead)")
    ap.add_argument("--sigstop-node", type=int, default=-1)
    ap.add_argument("--sigstop-after", type=float, default=5.0)
    ap.add_argument("--sigstop-duration", type=float, default=10.0)
    ap.add_argument("--convergence-error", type=float, default=0.05,
                    help="0 disables early convergence exit — fault "
                         "scenarios need the run to outlive the fault "
                         "window so the victim heals among live peers")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--platform", default="cuda",
                    help="torch device of every peer process: 'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def launch(i):
        cmd = [
            sys.executable, "-m", "biscotti_tpu_torch.runtime.peer",
            "-i", str(i), "-t", str(args.nodes), "-d", args.dataset,
            "-p", str(args.base_port),
            "-na", str(args.num_miners), "-nv", str(args.num_verifiers),
            "-sa", str(args.secure_agg), "-np", str(args.noising),
            "-vp", str(args.verification),
            "--max-iterations", str(args.max_iterations),
            "--convergence-error", str(args.convergence_error),
            "--fedsys", "1" if args.fedsys else "0",
            "--platform", args.platform,
        ]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                env=env, cwd=REPO)

    procs = []
    for i in range(args.nodes):
        procs.append(launch(i))
        time.sleep(0.1)  # node 0 listens first (ref: localTest.sh boot order)

    restarted = False
    if args.kill_node >= 0:
        time.sleep(args.kill_after)
        print(f"[harness] kill -9 node {args.kill_node}", file=sys.stderr)
        procs[args.kill_node].send_signal(signal.SIGKILL)
        if args.restart_after >= 0:
            procs[args.kill_node].communicate()  # reap; port freed
            time.sleep(args.restart_after)
            print(f"[harness] relaunching node {args.kill_node}",
                  file=sys.stderr)
            procs[args.kill_node] = launch(args.kill_node)
            restarted = True

    if args.sigstop_node >= 0:
        time.sleep(args.sigstop_after)
        print(f"[harness] SIGSTOP node {args.sigstop_node} for "
              f"{args.sigstop_duration}s", file=sys.stderr)
        procs[args.sigstop_node].send_signal(signal.SIGSTOP)
        time.sleep(args.sigstop_duration)
        procs[args.sigstop_node].send_signal(signal.SIGCONT)
        print(f"[harness] SIGCONT node {args.sigstop_node}", file=sys.stderr)

    deadline = time.time() + args.timeout
    outs = []
    for i, p in enumerate(procs):
        remain = max(1.0, deadline - time.time())
        try:
            out, err = p.communicate(timeout=remain)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            print(f"[harness] node {i} TIMED OUT; stderr tail:\n"
                  + "\n".join(err.splitlines()[-5:]), file=sys.stderr)
        except ValueError:
            out = ""  # already reaped (killed, not restarted)
        outs.append(out)

    chains = [extract_chain(o) for o in outs]
    # a killed-and-restarted peer is back in the oracle set; a killed-dead
    # peer is not; a SIGSTOPped peer must always close with the same chain
    survivors = [i for i in range(args.nodes)
                 if i != args.kill_node or restarted]
    ok = True
    ref_chain = chains[survivors[0]]
    if not ref_chain:
        print("[harness] node 0 produced no chain dump", file=sys.stderr)
        ok = False
    for i in survivors[1:]:
        if chains[i] != ref_chain:
            print(f"[harness] CHAIN MISMATCH node {i} vs node {survivors[0]}:",
                  file=sys.stderr)
            print(f"--- node {survivors[0]} ---\n{ref_chain}", file=sys.stderr)
            print(f"--- node {i} ---\n{chains[i]}", file=sys.stderr)
            ok = False
    n_blocks = len(ref_chain.splitlines()) if ref_chain else 0
    print(f"[harness] {'PASS' if ok else 'FAIL'}: "
          f"{len(survivors)} peers, {n_blocks} blocks, chains "
          f"{'identical' if ok else 'DIVERGED'}")
    print(json.dumps({
        "harness": "local_test", "nodes": args.nodes,
        "dataset": args.dataset, "fedsys": args.fedsys,
        **device_fields(dev),
        "kill_node": args.kill_node, "restarted": restarted,
        "sigstop_node": args.sigstop_node,
        "sigstop_duration_s": (args.sigstop_duration
                               if args.sigstop_node >= 0 else 0),
        "oracle_peers": len(survivors), "blocks": n_blocks,
        "chains_equal": ok,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
