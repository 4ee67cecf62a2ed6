# The port's counterpart of eval/scale_test.py; it imports nothing of biscotti_tpu.
"""Scale harness: N-peer clusters of the port's `PeerAgent` in one asyncio
process over real TCP loopback, with the chain-equality oracle and the
measured s/iteration.

    python -m biscotti_tpu_torch.eval.scale_test --nodes 100 \
        --dataset creditcard [--fedsys] [--secure-agg 1] [--noising 1] \
        [--verification 1] [--iterations 3] [--platform cuda] [--out DIR]

The reference's scale evals boot 100 OS processes across a fleet
(ref: eval/eval_FedSys_scale/runEval.sh); here the agents share one
process and, by default, one `BatchStepper` on the run's device (every
peer's SGD as one vmapped call a round; `--stepper 0` gives each agent its
own Trainer), while speaking real TCP RPC. Prints one JSON summary (s/iter
from node 0's round-log stamps, the reference's method) and, with --out,
writes scale_<tag>.json and the `iteration,error,timestamp` CSV.

`--platform` names the torch device of the agents and the stepper, `cuda`
by default (the reference's `--platform` is a jax platform that defaults
to the CPU); the reference's x64 and compile-cache switches have no
counterpart. The summary keys are the reference's plus
`device`/`nvidia_smi`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts
from biscotti_tpu_torch.data.datasets import spec as dspec
from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.eval import device_fields
from biscotti_tpu_torch.runtime.device_cluster import BatchStepper
from biscotti_tpu_torch.runtime.peer import PeerAgent
from biscotti_tpu_torch.runtime.rpc import geo_latency
from biscotti_tpu_torch.tools.verdicts import poisoned_ids


def build_cfgs(args):
    """One config a node, from the CLI's namespace (eval/scale_test.py:43)."""
    timeouts = Timeouts().scaled(
        args.nodes, args.num_verifiers, args.num_miners,
        defense_is_krum=args.defense == "KRUM")
    extra = {}
    if args.share_redundancy == "auto":
        # probe the exact config this run builds; fall back to the
        # reference's r = 2.0 only if its total_shares check rejects the
        # hardened default
        try:
            BiscottiConfig(
                node_id=0, num_nodes=args.nodes, dataset=args.dataset,
                num_miners=args.num_miners,
                num_verifiers=args.num_verifiers,
                num_noisers=args.num_noisers).total_shares
        except ValueError:
            print("[scale] share_redundancy=auto: hardened default "
                  "unavailable for this committee shape, using r=2.0",
                  file=sys.stderr)
            extra["share_redundancy"] = 2.0
    elif args.share_redundancy is not None:
        extra["share_redundancy"] = float(args.share_redundancy)
    return [BiscottiConfig(
        node_id=i, num_nodes=args.nodes, dataset=args.dataset,
        model_name=args.model_name, base_port=args.base_port,
        num_miners=args.num_miners, num_verifiers=args.num_verifiers,
        num_noisers=args.num_noisers,
        secure_agg=bool(args.secure_agg), noising=bool(args.noising),
        verification=bool(args.verification),
        fedsys=args.fedsys, defense=Defense(args.defense),
        epsilon=args.epsilon, poison_fraction=args.poison,
        max_iterations=args.iterations, convergence_error=0.0,
        sample_percent=args.sample_percent, seed=args.seed,
        timeouts=timeouts, **extra) for i in range(args.nodes)]


async def run_cluster(cfgs, log_dir="", key_dir="", geo_regions=0,
                      geo_rtt_s=0.0, pool_conns=0, use_stepper=True,
                      device=None):
    """Run every agent to the end; returns (agents, results, wall, raw
    wall). With `use_stepper` the agents share one single-device
    BatchStepper on `device`."""
    stepper = BatchStepper(cfgs[0], device=device) if use_stepper else None
    agents = [
        PeerAgent(c, key_dir=key_dir, stepper=stepper,
                  log_path=os.path.join(log_dir, f"events_{c.node_id}.jsonl")
                  if log_dir else "", device=device)
        for c in cfgs
    ]
    if pool_conns:
        # every loopback connection costs 2 fds in-process, so a very large
        # N needs a smaller pool a peer
        for a in agents:
            a.pool.max_conns = pool_conns
    if geo_regions > 1:
        n = len(cfgs)
        for a in agents:
            a.pool.latency = geo_latency(a.id, a.cfg.base_port,
                                         geo_regions, n, geo_rtt_s)
    stagger_s = 0.025

    async def launch(i, a):
        # stagger like the reference's shell launch loop: N simultaneous
        # announces hold O(N²) busy sockets before pool eviction closes any
        await asyncio.sleep(i * stagger_s)
        return await a.run()

    t0 = time.time()
    results = await asyncio.gather(*(launch(i, a)
                                     for i, a in enumerate(agents)))
    # wall charges the protocol, not the harness: subtract the launch ramp
    raw_wall = time.time() - t0
    wall = raw_wall - (len(agents) - 1) * stagger_s
    return agents, results, wall, raw_wall


def add_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--nodes", type=int, default=100)
    ap.add_argument("--dataset", default="creditcard")
    ap.add_argument("--model", dest="model_name", default="",
                    help="override the dataset's default model (zoo name, "
                         "e.g. cifar_cnn / mnist_cnn / svm)")
    ap.add_argument("--base-port", type=int, default=26000)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--fedsys", action="store_true")
    ap.add_argument("--secure-agg", type=int, default=0)
    ap.add_argument("--noising", type=int, default=0)
    ap.add_argument("--verification", type=int, default=0)
    ap.add_argument("--defense", default="KRUM")
    ap.add_argument("--epsilon", type=float, default=1.0)
    ap.add_argument("--poison", type=float, default=0.0)
    ap.add_argument("--sample-percent", type=float, default=0.70)
    ap.add_argument("--num-miners", type=int, default=3)
    ap.add_argument("--num-verifiers", type=int, default=3)
    ap.add_argument("--num-noisers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--stepper", type=int, default=1,
                    help="share one BatchStepper across the in-process "
                         "agents; 0 = one Trainer an agent")
    ap.add_argument("--pool-conns", type=int, default=0,
                    help="override each peer's connection-pool cap "
                         "(0 = library default)")
    ap.add_argument("--share-redundancy", default=None,
                    help="a float overrides the config default; 'auto' "
                         "keeps the default where its guarantee holds and "
                         "falls back to the reference's r=2.0 otherwise")
    ap.add_argument("--out", default="")
    ap.add_argument("--tag", default="")
    ap.add_argument("--log-dir", default="")
    ap.add_argument("--geo-regions", type=int, default=0,
                    help="split peers into this many synthetic regions; "
                         "cross-region RPCs pay --geo-rtt-ms (0 = off)")
    ap.add_argument("--geo-rtt-ms", type=float, default=80.0,
                    help="cross-region round-trip time in milliseconds")
    ap.add_argument("--key-dir", default="",
                    help="dealer key directory (tools/keygen.py); 'auto' "
                         "generates one for this run's dims and nodes")
    ap.add_argument("--platform", default="cuda",
                    help="torch device of the agents: 'cuda' (raises "
                         "without a GPU) or 'cpu'")


def main(argv=None) -> int:
    try:  # large-N clusters need sockets: lift the soft fd limit
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < hard:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ImportError, ValueError, OSError):
        pass
    ap = argparse.ArgumentParser()
    add_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

    cfgs = build_cfgs(args)
    key_dir = args.key_dir
    if key_dir == "auto":
        from biscotti_tpu_torch.tools import keygen

        key_dir = keygen.make_ephemeral_dir(args.dataset, args.nodes,
                                            args.model_name)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    agents, results, wall, raw_wall = asyncio.run(
        run_cluster(cfgs, args.log_dir, key_dir,
                    geo_regions=args.geo_regions,
                    geo_rtt_s=args.geo_rtt_ms / 1000.0,
                    pool_conns=args.pool_conns,
                    use_stepper=bool(args.stepper), device=dev))

    dumps = [r["chain_dump"] for r in results]
    equal = all(d == dumps[0] for d in dumps)
    n_blocks = len(dumps[0].splitlines()) - 1  # minus genesis
    nonempty = sum(1 for line in dumps[0].splitlines()[1:]
                   if "ndeltas=0" not in line)

    # s/iter from node 0's round-log stamps (the reference's method)
    rows = [tuple(x.split(",")) for x in results[0]["logs"]]
    if len(rows) >= 2:
        ts = [float(r[2]) for r in rows]
        s_per_iter = (ts[-1] - ts[0]) / (len(ts) - 1)
    else:
        s_per_iter = wall / max(1, n_blocks)

    mode = "fedsys" if args.fedsys else "biscotti"
    attack = {}
    if args.poison > 0:
        # the chain's final model (every peer's, as chains_equal asserts)
        # on the attack-source split, and the stake each group ends with
        w_final = agents[0].chain.latest_gradient()
        tr = agents[0].trainer
        attack = {
            "poison_fraction": args.poison,
            "attack_rate": round(tr.attack_rate(w_final), 4),
            "attack_success_rate": round(
                tr.attack_success_rate(w_final), 4),
        }
        stake_map = agents[0].chain.latest_stake_map()
        poisoned = poisoned_ids(args.nodes, args.poison)
        p_stakes = [stake_map.get(i, 0) for i in poisoned]
        h_stakes = [stake_map.get(i, 0) for i in range(args.nodes)
                    if i not in poisoned]
        if p_stakes and h_stakes:
            attack["mean_stake_poisoned"] = round(
                sum(p_stakes) / len(p_stakes), 1)
            attack["mean_stake_honest"] = round(
                sum(h_stakes) / len(h_stakes), 1)
    summary = {
        "mode": mode, "nodes": args.nodes, "dataset": args.dataset,
        "model": args.model_name or "default", **device_fields(dev),
        # TRIMMED_MEAN acts at miner aggregation, independent of the
        # verification flag; mask defenses need verifiers to run
        "defense": (args.defense
                    if args.verification or args.defense == "TRIMMED_MEAN"
                    else "NONE"),
        "num_verifiers": args.num_verifiers, "num_miners": args.num_miners,
        "num_noisers": args.num_noisers,
        # all N peers share this host's cores
        "host_cores": os.cpu_count(),
        "secure_agg": bool(args.secure_agg), "noising": bool(args.noising),
        "verification": bool(args.verification),
        "keyed": bool(key_dir),
        "batched_stepper": bool(args.stepper),
        "geo_regions": args.geo_regions,
        "geo_rtt_ms": args.geo_rtt_ms if args.geo_regions > 1 else 0,
        **attack,
        "iterations_run": n_blocks, "nonempty_blocks": nonempty,
        "chains_equal": equal, "wall_s": round(wall, 2),
        "raw_wall_s": round(raw_wall, 2),
        "launch_ramp_s": round(raw_wall - wall, 2),
        "s_per_iter": round(s_per_iter, 3),
        "final_error": results[0]["final_error"],
        "data_note": (
            "REAL data (bundled corpus, see data/datasets.py; shards may "
            "reuse rows when nodes exceed the corpus shard capacity)"
            if dspec(args.dataset).real else
            "synthetic Gaussian shards (zero-egress env); "
            "errors not comparable to real-data curves"),
        # per-phase wall-clock accounting: node 0 and the node with the
        # largest total
        "phases_node0": results[0].get("phases", {}),
        "phases_max": max(
            (r.get("phases", {}) for r in results),
            key=lambda p: sum(v.get("total_s", 0) for v in p.values())),
    }
    print(json.dumps(summary))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = args.tag or f"{mode}_{args.dataset}_{args.nodes}"
        with open(os.path.join(args.out, f"scale_{tag}.json"), "w") as f:
            json.dump(summary, f, indent=1)
        with open(os.path.join(args.out, f"scale_{tag}.csv"), "w") as f:
            for r in results[0]["logs"]:
                f.write(r + "\n")
    if not equal:
        print("[scale] FAIL: chain-equality oracle violated", file=sys.stderr)
        return 1
    if nonempty == 0:
        print("[scale] FAIL: no non-empty blocks minted", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
