# The port's counterpart of eval/eval_privacy_utility.py; it imports nothing of biscotti_tpu.
"""Privacy-utility eval: final error against the DP ε, Krum on, on the
port's simulator.

    python -m biscotti_tpu_torch.eval.eval_privacy_utility [--dataset mnist] \
        [--nodes 100] [--rounds 100] [--platform cuda] [--out DIR]

Reference operating points: the ε sweep at 100 mnist nodes with Krum
(ref: eval/eval_privacy_utility_krum/runEval.sh:4-9) and the single-node DP
curves at ε ∈ {0.01, 0.1, 0.5, 1, 2, ∞}. Each cell is one
`Simulator.run_scan`. Two sweeps side by side: mode=model (`dp_in_model`:
the noise is part of the aggregated update) and mode=committee
(`noising`: the noise shields each update in transit and cancels in the
aggregate, but the verifiers judge the noised copies). Then the
mechanism rows: the Gaussian against mcmc13 at ε = 1 in model mode, the
mcmc13 row with a Trainer's presample acceptance rate.

Artifacts: privacy_utility.csv (mode,mechanism,epsilon,final_error,
best_error,attack_rate,mean_accepted) and privacy_utility.json, the
reference's keys plus `device`/`nvidia_smi`.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

from biscotti_tpu_torch.config import BiscottiConfig, Defense
from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.eval import RESULTS, device_fields
from biscotti_tpu_torch.models.trainer import Trainer
from biscotti_tpu_torch.parallel.sim import Simulator

EPSILONS = [0.01, 0.1, 0.5, 1.0, 2.0, math.inf]


def _row(sim: Simulator, rounds: int, **keys) -> dict:
    w, stake, errs, accepted = sim.run_scan(rounds)
    return {**keys,
            "final_error": round(float(errs[-1]), 4),
            "best_error": round(float(errs.min()), 4),
            "attack_rate": round(sim.attack_rate(w), 4),
            "mean_accepted": round(float(np.mean(accepted)), 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--nodes", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--platform", default="cuda",
                    help="torch device: 'cuda' (raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

    rows = []
    inf_row = None  # the eps=inf cell is mode-independent: compute once
    for mode in ("model", "committee"):
        for eps in EPSILONS:
            noisy = not math.isinf(eps)
            if not noisy and inf_row is not None:
                row = dict(inf_row, mode=mode)
                rows.append(row)
                print(json.dumps(row))
                continue
            cfg = BiscottiConfig(
                dataset=args.dataset, num_nodes=args.nodes,
                epsilon=eps if noisy else 1.0,
                dp_in_model=noisy and mode == "model",
                noising=noisy and mode == "committee",
                verification=True, defense=Defense.KRUM,
                sample_percent=0.70, seed=1,
            )
            row = _row(Simulator(cfg, device=dev), args.rounds, mode=mode,
                       epsilon="inf" if math.isinf(eps) else eps)
            if not noisy:
                inf_row = row
            rows.append(row)
            print(json.dumps(row))

    # the mechanism rows: Song & Sarwate '13's MCMC mechanism against the
    # Abadi '16 Gaussian at the same ε in dp-in-model mode
    for mech in ("gaussian", "mcmc13"):
        cfg = BiscottiConfig(
            dataset=args.dataset, num_nodes=args.nodes, epsilon=1.0,
            dp_in_model=True, noising=False, verification=True,
            defense=Defense.KRUM, sample_percent=0.70, seed=1,
            dp_mechanism=mech,
        )
        row = _row(Simulator(cfg, device=dev), args.rounds, mode="model",
                   mechanism=mech, epsilon=1.0)
        if mech == "mcmc13":
            # the live path's chain health: the Trainer's per-peer MCMC
            # presample records its acceptance rate
            tr = Trainer(args.dataset, f"{args.dataset}0",
                         cfg=cfg.replace(num_nodes=10), device=dev)
            row["mcmc_accept_rate"] = (round(tr.noise_accept_rate, 4)
                                       if tr.noise_accept_rate is not None
                                       else None)
        rows.append(row)
        print(json.dumps(row))

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "privacy_utility.csv"), "w") as f:
        f.write("mode,mechanism,epsilon,final_error,best_error,attack_rate,"
                "mean_accepted\n")
        for r in rows:
            f.write(f"{r['mode']},{r.get('mechanism', 'gaussian')},"
                    f"{r['epsilon']},{r['final_error']},"
                    f"{r['best_error']},{r['attack_rate']},"
                    f"{r['mean_accepted']}\n")
    with open(os.path.join(args.out, "privacy_utility.json"), "w") as f:
        json.dump({"experiment": "privacy_utility", **device_fields(dev),
                   "dataset": args.dataset, "nodes": args.nodes,
                   "rounds": args.rounds, "rows": rows,
                   "data_note": "synthetic shards (zero-egress env)"},
                  f, indent=1)
    model_rows = [r for r in rows
                  if r["mode"] == "model" and "mechanism" not in r]
    comm_rows = [r for r in rows if r["mode"] == "committee"]
    # the strictest model-noise cell must not beat the no-noise cell, and
    # committee noise (exact accepted aggregates) must stay at or below the
    # model-noise error at the strictest ε
    ok = model_rows[0]["final_error"] >= model_rows[-1]["final_error"]
    ok = ok and comm_rows[0]["final_error"] <= model_rows[0]["final_error"]
    print(json.dumps({"summary": "noise_costs_utility", "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
