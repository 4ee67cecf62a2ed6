# The port's counterpart of eval/eval_fedsys_compare.py; it imports nothing of biscotti_tpu.
"""FedSys-against-Biscotti scale comparison: s/iteration for both systems
at several cluster sizes over the port's live peer runtime.

    python -m biscotti_tpu_torch.eval.eval_fedsys_compare [--dataset mnist] \
        [--sizes 40,100,200] [--iterations 3] [--platform cuda] [--out DIR]

Reference experiment: eval/eval_FedSys_scale (Biscotti 38.2-42.0 s/iter
against FedSys 7.1-9.1 s/iter at 100 nodes across a fleet). Each cell is
one process of the port's scale harness
(`python -m biscotti_tpu_torch.eval.scale_test`, verification on, keyed by
one dealer key dir sized for the largest cluster) on `--platform`.
`--base-port` is the first cell's (the reference fixes 27000); each cell
moves it on by nodes + 10.

Artifacts: fedsys_compare.csv and fedsys_compare.json, the reference's
keys plus `device`/`nvidia_smi`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.eval import RESULTS, device_fields
from biscotti_tpu_torch.tools import keygen
from biscotti_tpu_torch.tools.pod_launch import REPO


def run_cell(nodes, dataset, fedsys, iterations, base_port, key_dir="",
             platform="cuda"):
    cmd = [sys.executable, "-m", "biscotti_tpu_torch.eval.scale_test",
           "--nodes", str(nodes), "--dataset", dataset,
           "--iterations", str(iterations), "--verification", "1",
           "--base-port", str(base_port), "--platform", platform]
    if key_dir:
        cmd += ["--key-dir", key_dir]
    if fedsys:
        cmd.append("--fedsys")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                         cwd=REPO)
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no summary from cell: {out.stdout[-500:]}\n"
                       f"{out.stderr[-500:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--sizes", default="40,100,200")
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--base-port", type=int, default=27000)
    ap.add_argument("--platform", default="cuda",
                    help="torch device of the cells' agents: 'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

    # one dealer key dir for the largest size serves every cell (per-node
    # identities + a dims-sized commit key): the Biscotti cells pay the
    # full O(d) Pedersen plane
    sizes = [int(s) for s in args.sizes.split(",")]
    key_dir = keygen.make_ephemeral_dir(args.dataset, max(sizes))

    rows = []
    port = args.base_port
    for n in sizes:
        for fedsys in (False, True):
            cell = run_cell(n, args.dataset, fedsys, args.iterations, port,
                            key_dir, args.platform)
            port += n + 10
            row = {"nodes": n, "mode": cell["mode"],
                   "s_per_iter": cell["s_per_iter"],
                   "chains_equal": cell["chains_equal"],
                   "final_error": round(cell["final_error"], 4)}
            rows.append(row)
            print(json.dumps(row))

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "fedsys_compare.csv"), "w") as f:
        f.write("nodes,mode,s_per_iter,final_error\n")
        for r in rows:
            f.write(f"{r['nodes']},{r['mode']},{r['s_per_iter']},"
                    f"{r['final_error']}\n")
    with open(os.path.join(args.out, "fedsys_compare.json"), "w") as f:
        json.dump({"experiment": "fedsys_compare", **device_fields(dev),
                   "dataset": args.dataset,
                   "iterations": args.iterations, "keyed": True,
                   "rows": rows,
                   "host_note": "all peers share one host; see scale_test",
                   "reference": {"biscotti_100": "38.2-42.0 s/iter",
                                 "fedsys_100": "7.1-9.1 s/iter"}},
                  f, indent=1)
    ok = all(r["chains_equal"] for r in rows)
    print(json.dumps({"summary": "all_cells_chain_equal", "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
