# The port's counterpart of eval/eval_pod_launch.py; it imports nothing of biscotti_tpu.
"""Fleet-launch eval: the port's multi-host launcher end to end, recorded.

    python -m biscotti_tpu_torch.eval.eval_pod_launch [--nodes-per-host 4] \
        [--dataset creditcard] [--iterations 2] [--platform cuda] [--out DIR]

Drives `python -m biscotti_tpu_torch.tools.pod_launch` over a two-"host"
fleet where one host is `localhost` (direct subprocess launch) and the
other `127.0.0.1`, which takes the remote branch: scp of the key and peers
files, ssh launch, output collection, through `tools/sshim.py` (the local
ssh/scp stand-in). Every peer process runs the port's peer CLI on
`--platform`. Mirrors the reference's fleet driver
(azure/azure-run/runBiscotti.sh: keygen, peers file, scp, ssh launch,
collect logs, diff chains).

Artifact: pod_launch.json, the reference's keys plus `device`/`nvidia_smi`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.eval import RESULTS, device_fields
from biscotti_tpu_torch.tools import keygen
from biscotti_tpu_torch.tools.pod_launch import REPO


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes-per-host", type=int, default=4)
    ap.add_argument("--dataset", default="creditcard")
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--base-port", type=int, default=23560)
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--platform", default="cuda",
                    help="torch device of every peer process: 'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

    key_dir = keygen.make_ephemeral_dir(args.dataset,
                                        2 * args.nodes_per_host)
    hosts_fd, hosts_file = tempfile.mkstemp(prefix="biscotti_hosts_",
                                            suffix=".txt")
    with os.fdopen(hosts_fd, "w") as f:
        f.write("localhost\n127.0.0.1\n")
    peers_fd, peers_file = tempfile.mkstemp(prefix="biscotti_peers_")
    os.close(peers_fd)

    sshim = f"{sys.executable} -m biscotti_tpu_torch.tools.sshim"
    cmd = [sys.executable, "-m", "biscotti_tpu_torch.tools.pod_launch",
           "--hosts", hosts_file,
           "--nodes-per-host", str(args.nodes_per_host),
           "--dataset", args.dataset,
           "--iterations", str(args.iterations),
           "--base-port", str(args.base_port),
           "--secure-agg", "1", "--noising", "1", "--verification", "1",
           "--key-dir", key_dir,
           "--peers-file", peers_file,
           "--platform", args.platform,
           "--ssh-cmd", sshim, "--scp-cmd", f"{sshim} --scp"]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600, cwd=REPO, env=env)
    finally:
        for p in (hosts_file, peers_file):
            if os.path.exists(p):
                os.unlink(p)
        shutil.rmtree(key_dir, ignore_errors=True)
    wall = time.time() - t0
    summary = None
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            summary = json.loads(line)
    if summary is None:
        print(out.stdout[-500:], out.stderr[-500:], file=sys.stderr)
        return 1

    payload = {
        "experiment": "pod_launch", **device_fields(dev),
        "transport": "sshim (local ssh/scp stand-in; real fleets use "
                     "ssh/scp via the same flags)",
        "hosts": 2, "remote_hosts": 1,
        "nodes_per_host": args.nodes_per_host,
        "dataset": args.dataset, "keyed": True,
        "secure_agg": True, "noising": True, "verification": True,
        "wall_s": round(wall, 2),
        **summary,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "pod_launch.json"), "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload))
    return 0 if summary.get("chains_equal") else 1


if __name__ == "__main__":
    raise SystemExit(main())
