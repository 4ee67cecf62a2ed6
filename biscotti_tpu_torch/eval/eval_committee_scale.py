# The port's counterpart of eval/eval_committee_scale.py; it imports nothing of biscotti_tpu.
"""Committee-size scaling eval: s/iteration as the verifier and miner
committees grow, over the port's live peer runtime.

    python -m biscotti_tpu_torch.eval.eval_committee_scale [--dataset mnist] \
        [--nodes 100] [--iterations 3] [--platform cuda] [--out DIR]

Reference experiment: eval/eval_vrf_scale/runEval.sh (committee sweeps)
and the BASELINE.md rows "Biscotti, 26 aggregators: 88-100 s/iter" and
"5 noisers / 26 verifiers / 26 aggregators: 158 s/iter" at 100 nodes.
Each cell is one process of the port's scale harness
(`python -m biscotti_tpu_torch.eval.scale_test`, secure aggregation,
noising and verification on, keyed by one dealer key dir for every cell)
on `--platform`. `--base-port` is the first cell's (the reference fixes
28000); each cell moves it on by nodes + 10.

Artifacts: committee_scale.csv and committee_scale.json, the reference's
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

# (num_verifiers, num_miners, num_noisers) cells; the last two mirror the
# reference's published large-committee operating points
CELLS = [(3, 3, 2), (5, 5, 2), (10, 10, 2), (26, 26, 5)]


def run_cell(nodes, dataset, nv, nm, nn, iterations, base_port, key_dir="",
             platform="cuda"):
    cmd = [sys.executable, "-m", "biscotti_tpu_torch.eval.scale_test",
           "--nodes", str(nodes), "--dataset", dataset,
           "--iterations", str(iterations), "--verification", "1",
           "--secure-agg", "1", "--noising", "1",
           "--num-verifiers", str(nv), "--num-miners", str(nm),
           "--num-noisers", str(nn), "--base-port", str(base_port),
           "--platform", platform]
    if key_dir:
        cmd += ["--key-dir", key_dir]
    # the hardened share_redundancy default where it holds, the
    # reference's r = 2.0 where it cannot, as scale_test resolves it
    cmd += ["--share-redundancy", "auto"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                         cwd=REPO)
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no summary: {out.stdout[-300:]} {out.stderr[-300:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--nodes", type=int, default=100)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--base-port", type=int, default=28000)
    ap.add_argument("--platform", default="cuda",
                    help="torch device of the cells' agents: 'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

    # one dealer key dir for every cell (same dims and nodes): each cell
    # pays the full crypto plane
    key_dir = keygen.make_ephemeral_dir(args.dataset, args.nodes)

    rows = []
    port = args.base_port
    for nv, nm, nn in CELLS:
        cell = run_cell(args.nodes, args.dataset, nv, nm, nn,
                        args.iterations, port, key_dir, args.platform)
        port += args.nodes + 10
        row = {"verifiers": nv, "miners": nm, "noisers": nn,
               "s_per_iter": cell["s_per_iter"],
               "chains_equal": cell["chains_equal"]}
        rows.append(row)
        print(json.dumps(row))

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "committee_scale.csv"), "w") as f:
        f.write("verifiers,miners,noisers,s_per_iter\n")
        for r in rows:
            f.write(f"{r['verifiers']},{r['miners']},{r['noisers']},"
                    f"{r['s_per_iter']}\n")
    with open(os.path.join(args.out, "committee_scale.json"), "w") as f:
        json.dump({"experiment": "committee_scale", "nodes": args.nodes,
                   "dataset": args.dataset, **device_fields(dev),
                   "keyed": True, "secure_agg": True, "noising": True,
                   "rows": rows,
                   "reference": {"26_aggregators": "88-100 s/iter",
                                 "5n_26v_26m": "158 s/iter"}}, f, indent=1)
    ok = all(r["chains_equal"] for r in rows)
    print(json.dumps({"summary": "all_cells_chain_equal", "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
