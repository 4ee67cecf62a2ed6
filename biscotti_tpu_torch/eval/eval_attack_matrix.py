# The port's counterpart of eval/eval_attack_matrix.py; it imports nothing of biscotti_tpu.
"""Attack-matrix eval: adaptive-adversary campaigns × poisoning defenses
on live clusters of the port's peers.

    python -m biscotti_tpu_torch.eval.eval_attack_matrix [--dataset mnist@dir0.3] \
        [--nodes 10] [--rounds 8] [--seed 11] [--poison 0.3] \
        [--defenses NONE,KRUM,MULTIKRUM,FOOLSGOLD,ENSEMBLE] [--quick] \
        [--platform cuda] [--out DIR]

Every cell boots an in-process cluster (TCP loopback, full crypto,
admission plane armed) under one (campaign, defense, secure-agg)
combination and one seed, runs it to --rounds, and reads the outcome off
the settled ledgers and telemetry snapshots: the anchor's final error,
the surviving-prefix oracle across all peers (attackers included), the
defense verdict (tools/verdicts.cluster_defense_verdict: which poisoned
sources ever entered an accepted block record) and the verifiers' verdict
streams. `survived` means chains equal, at least one real block and, for
poison-bearing campaigns, no poisoned source ever accepted; `failed` is
the same bit as 0/1.

Campaigns (runtime/adversary.py): none, static (the reference's
label-flip poisoners), roleflood, sybil, hug. Committee DP noising is off:
the defense-geometry operating point. Every cell is replayable from one
seed through the recorded chaos command (`_replay_cmd`, which names
`python -m biscotti_tpu_torch.tools.chaos`).

Artifacts: <tag>.json and <tag>.csv, the reference's keys plus
`device`/`nvidia_smi`. Exit 0 iff every cell completed; survival is data.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os

from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts
from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.eval import RESULTS, device_fields
from biscotti_tpu_torch.runtime.admission import AdmissionPlan
from biscotti_tpu_torch.runtime.adversary import CampaignPlan
from biscotti_tpu_torch.runtime.membership import (ChurnRunner,
                                                   surviving_prefix_oracle)
from biscotti_tpu_torch.runtime.peer import PeerAgent
from biscotti_tpu_torch.tools import obs, verdicts

CAMPAIGN_CELLS = ("none", "static", "roleflood", "sybil", "hug")


def _cell_plan(campaign: str, ns):
    """The CampaignPlan for one matrix cell: attackers mirror the
    poisoned fraction, so the colluding set is the poisoned set."""
    if campaign in ("none", "static"):
        return CampaignPlan()
    kw = dict(attackers=ns.poison)
    if campaign == "roleflood":
        kw["flood"] = ns.flood
    elif campaign == "sybil":
        kw["recycle_period"] = max(2, ns.rounds // 2)
        kw["recycle_down"] = 1
    return CampaignPlan(campaign=campaign, **kw)


def _cell_cfg(i: int, campaign: str, defense, secure_agg: bool, port: int,
              ns):
    fast = Timeouts(update_s=6.0, block_s=18.0, krum_s=4.0, share_s=6.0,
                    rpc_s=5.0)
    poison = 0.0 if campaign == "none" else ns.poison
    return BiscottiConfig(
        node_id=i, num_nodes=ns.nodes, dataset=ns.dataset,
        base_port=port, num_verifiers=ns.verifiers, num_miners=1,
        num_noisers=1,
        secure_agg=secure_agg, noising=False,
        verification=defense != Defense.NONE, defense=defense,
        poison_fraction=poison,
        max_iterations=ns.rounds, convergence_error=0.0,
        sample_percent=1.0, batch_size=8, timeouts=fast, seed=ns.seed,
        # admission armed in every cell (the chaos defaults) so the shed
        # columns compare across campaigns
        admission_plan=AdmissionPlan(enabled=True, update_rate=8.0,
                                     bulk_rate=6.0, control_rate=16.0),
        campaign_plan=_cell_plan(campaign, ns),
    )


def _replay_cmd(campaign: str, defense, secure_agg: bool, port: int,
                ns) -> str:
    parts = [
        "python -m biscotti_tpu_torch.tools.chaos",
        f"--nodes {ns.nodes} --rounds {ns.rounds} --seed {ns.seed}",
        f"--dataset {ns.dataset} --base-port {port}",
        f"--verifiers {ns.verifiers}",
        f"--secure-agg {int(secure_agg)} --defense {defense.value}",
        "--admission 1",
    ]
    if campaign != "none":
        parts.append(f"--poison {ns.poison}")
    if campaign not in ("none", "static"):
        parts.append(f"--campaign {campaign} "
                     f"--campaign-attackers {ns.poison}")
    if campaign == "roleflood":
        parts.append(f"--campaign-flood {ns.flood}")
    return " ".join(parts)


def run_cell(campaign: str, defense, secure_agg: bool, port: int, ns,
             device=None) -> dict:
    """One live cell on `device` (None: the GPU)."""
    def make(i):
        return PeerAgent(_cell_cfg(i, campaign, defense, secure_agg,
                                   port, ns), device=device)

    plan = _cell_plan(campaign, ns)
    recycle = plan.recycle_schedule(ns.nodes, ns.rounds,
                                    protocol_seed=ns.seed)
    made = {}

    def make_tracked(i):
        a = make(i)
        made[i] = a  # latest incarnation; node 0 is never recycled
        return a

    async def go():
        if recycle:
            # sybil cells ride the membership runner: kills self-fire in
            # the attackers' round loops, the runner relaunches fresh
            # incarnations
            runner = ChurnRunner(make_tracked, ns.nodes, recycle)
            return await runner.run(), runner.events_applied
        agents = [make_tracked(i) for i in range(ns.nodes)]
        return await asyncio.gather(*(a.run() for a in agents)), None

    results, applied = asyncio.run(go())
    anchor_blocks = made[0].chain.blocks
    # per-verifier verdict streams: the evidence that the hugger's scale
    # walk happened (and, under ENSEMBLE, was suppressed)
    trust = obs.merge_trust([r["telemetry"] for r in results
                             if "telemetry" in r], streams=True)

    equal, settled, real = surviving_prefix_oracle(results)
    poison = 0.0 if campaign == "none" else ns.poison
    verdict = verdicts.cluster_defense_verdict(
        results, ns.nodes, poison, anchor_blocks=anchor_blocks)
    survived = bool(equal and real >= 1
                    and (campaign == "none"
                         or verdict["n_accepted_poisoned"] == 0))
    final_error = results[0].get("final_error")
    return {
        "campaign": campaign, "defense": defense.value,
        "secure_agg": secure_agg, "seed": ns.seed,
        "final_error": round(float(final_error), 4),
        "chains_equal": equal, "settled": settled, "real_blocks": real,
        "survived": survived, "failed": 0 if survived else 1,
        "accepted_poisoned_n": verdict.get("n_accepted_poisoned", 0),
        "verdict": verdict,
        "trust": trust if trust.get("verifiers") else None,
        "recycles_applied": applied,
        "replay": _replay_cmd(campaign, defense, secure_agg, port, ns),
    }


def format_matrix(rows) -> str:
    """The attack × defense table, one line per (campaign, sa) row."""
    defenses = sorted({r["defense"] for r in rows})
    lines = [f"{'campaign':<11} {'sa':<3} "
             + " ".join(f"{d:>22}" for d in defenses)]
    combos = sorted({(r["campaign"], r["secure_agg"]) for r in rows},
                    key=lambda c: (CAMPAIGN_CELLS.index(c[0]), not c[1]))
    for camp, sa in combos:
        cells = []
        for d in defenses:
            r = next((x for x in rows if x["campaign"] == camp
                      and x["defense"] == d
                      and x["secure_agg"] == sa), None)
            if r is None:
                cells.append(f"{'-':>22}")
                continue
            if "error" in r:
                cells.append(f"{'ERR':>22}")
                continue
            tag = "ok" if r["survived"] else "FAIL"
            cells.append(f"{tag} err={r['final_error']:.3f} "
                         f"p={r['accepted_poisoned_n']}".rjust(22))
        lines.append(f"{camp:<11} {'on' if sa else 'off':<3} "
                     + " ".join(cells))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist@dir0.3",
                    help="Dirichlet-skewed mnist by default: the "
                         "defense-geometry regime where honest non-IID "
                         "updates spread and the tight poison cluster is "
                         "separable")
    ap.add_argument("--nodes", type=int, default=10)
    ap.add_argument("--verifiers", type=int, default=3,
                    help="verifier committee size: majority approval (2 of "
                         "3) keeps one colluding verifier from "
                         "rubber-stamping its fellow poisoners")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--poison", type=float, default=0.3,
                    help="poison/attacker fraction: 0.3 at 10 nodes = "
                         "ids {8,9} (the reference's top-ids formula)")
    ap.add_argument("--flood", type=int, default=30,
                    help="roleflood targeted replay factor")
    ap.add_argument("--defenses",
                    default="NONE,KRUM,MULTIKRUM,FOOLSGOLD,ENSEMBLE")
    ap.add_argument("--campaigns", default=",".join(CAMPAIGN_CELLS))
    ap.add_argument("--base-port", type=int, default=14400)
    ap.add_argument("--quick", action="store_true",
                    help="2 campaigns x 2 defenses, secure-agg on only")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--tag", default="attack_matrix")
    ap.add_argument("--platform", default="cuda",
                    help="torch device of the peers: 'cuda' (raises "
                         "without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

    defenses = [Defense(d.strip()) for d in args.defenses.split(",") if d]
    campaigns = [c.strip() for c in args.campaigns.split(",") if c]
    for c in campaigns:
        if c not in CAMPAIGN_CELLS:
            ap.error(f"unknown campaign cell {c!r}")
    if args.quick:
        campaigns = [c for c in ("static", "hug") if c in campaigns] \
            or campaigns[:2]
        defenses = defenses[:2]

    # every campaign × defense with secure-agg on, plus secure-agg off
    # replicates of static and hug under the accept-mask defenses
    cells = [(c, d, True) for c in campaigns for d in defenses]
    if not args.quick:
        for c in ("static", "hug"):
            for d in defenses:
                if c in campaigns and d != Defense.NONE:
                    cells.append((c, d, False))

    rows = []
    port = args.base_port
    for camp, d, sa in cells:
        try:
            row = run_cell(camp, d, sa, port, args, device=dev)
        except Exception as e:
            # a failed cell becomes a recorded error row; the artifact still
            # lands, and the exit code says the matrix is incomplete
            row = {"campaign": camp, "defense": d.value,
                   "secure_agg": sa, "seed": args.seed,
                   "error": f"{type(e).__name__}: {e}"}
        rows.append(row)
        print(json.dumps({k: row.get(k) for k in
                          ("campaign", "defense", "secure_agg",
                           "final_error", "chains_equal", "survived",
                           "accepted_poisoned_n", "error")
                          if k in row}))
        port += args.nodes + 2  # fresh port block per cell

    # does the threshold-hugger degrade any defense cell relative to the
    # static poisoner?
    hug_vs_static = []
    for d in defenses:
        for sa in (True, False):
            h = next((r for r in rows if r["campaign"] == "hug"
                      and r["defense"] == d.value
                      and r["secure_agg"] == sa
                      and "error" not in r), None)
            s = next((r for r in rows if r["campaign"] == "static"
                      and r["defense"] == d.value
                      and r["secure_agg"] == sa
                      and "error" not in r), None)
            if h is None or s is None:
                continue
            worse_err, _ = verdicts.separates(s["final_error"], 0.0,
                                              h["final_error"], 0.0)
            hug_vs_static.append({
                "defense": d.value, "secure_agg": sa,
                "static_error": s["final_error"],
                "hug_error": h["final_error"],
                "hug_degrades_error": worse_err,
                "static_accepted_poisoned": s["accepted_poisoned_n"],
                "hug_accepted_poisoned": h["accepted_poisoned_n"],
                "hug_smuggles_more": (h["accepted_poisoned_n"]
                                      > s["accepted_poisoned_n"]),
            })

    os.makedirs(args.out, exist_ok=True)
    summary = {
        "experiment": "attack_matrix", **device_fields(dev),
        "dataset": args.dataset, "nodes": args.nodes,
        "rounds": args.rounds, "seed": args.seed,
        "poison": args.poison, "flood": args.flood,
        "noising": False,
        "operating_point_note": (
            "committee DP noising OFF — the defense-geometry operating "
            "point (at eps=1.0 the noise norm masks every geometry "
            "defense toward accept-everyone). survived = chains equal AND "
            ">=1 real block AND no poisoned source ever accepted."),
        "defenses": [d.value for d in defenses],
        "campaigns": campaigns,
        "rows": rows,
        "hug_vs_static": hug_vs_static,
        "table": format_matrix(rows),
    }
    with open(os.path.join(args.out, f"{args.tag}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    cols = ["campaign", "defense", "secure_agg", "final_error",
            "chains_equal", "settled", "real_blocks", "survived",
            "accepted_poisoned_n"]
    with open(os.path.join(args.out, f"{args.tag}.csv"), "w") as f:
        f.write(",".join(cols) + "\n")
        for r in rows:
            f.write(",".join(str(r.get(c, "")) for c in cols) + "\n")
    print(format_matrix(rows))
    complete = not any("error" in r for r in rows)
    return 0 if complete else 1


if __name__ == "__main__":
    raise SystemExit(main())
