# The port's counterpart of eval/eval_sim_scale.py; it imports nothing of biscotti_tpu.
"""Peer-count scaling of the simulator round: peers as rows of one device's
tensors.

    python -m biscotti_tpu_torch.eval.eval_sim_scale [--dataset mnist] \
        [--sizes 100,256,512,1024] [--rounds 50] [--platform cuda] [--out DIR]

The reference scales peers by booting OS processes (its published maximum
is 200 nodes across a VM fleet, 12.4 s/iter). Here every peer's SGD step,
DP noise, Krum over the contributor set, aggregation and stake scatter run
as the port's `Simulator` round, and a whole training run is one
`run_scan` (no host read-back until the end). At S contributors inside
`ops/krum_cuda.py`'s window (KERNEL_MIN_N..KERNEL_MAX_N, 512..4096) a CUDA
round scores them on kernel B1; `krum_launches` counts B1's launches in
the timed scan.

Timing, for each N: one untimed `run_scan` (`compile_s`: the port compiles
nothing, so this is the first run's host seconds), one timed by the host
clock (`s_per_iter`, `wall_s`) and by CUDA events around it
(`scan_event_ms_per_iter`: the stream's elapsed time, idle gaps included),
then one under torch.profiler, whose CUDA kernels' summed device time is
the scan's busy time (`device_ms_per_iter`); `device_idle_share` is one
minus that over the timed scan's host time. On the CPU the device columns
are null.

Artifact keys renamed from the reference's (eval/results/sim_scale.*):
`backend` → `platform`; `krum_path` reads `kernel` or `plain` (was
`pallas` or `xla`). Added: `scan_event_ms_per_iter`, `device_idle_share`,
`kernels_per_iter`, `krum_launches`, and `device`/`nvidia_smi`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from biscotti_tpu_torch.config import BiscottiConfig, Defense
from biscotti_tpu_torch.device import resolve_device, synchronize
from biscotti_tpu_torch.eval import RESULTS, device_fields
from biscotti_tpu_torch.ops import krum_cuda
from biscotti_tpu_torch.parallel.sim import Simulator


def scan_device_ms(sim: Simulator, rounds: int):
    """(device ms, CUDA kernels) of one `run_scan` of `rounds` on the card,
    summed over the kernels torch.profiler records."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim.run_scan(rounds)
        torch.cuda.synchronize(sim.device)
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in evs) / 1e3,
            sum(e.count for e in evs))


def size_row(dataset: str, n: int, rounds: int, dev: torch.device) -> dict:
    cfg = BiscottiConfig(
        dataset=dataset, num_nodes=n, batch_size=10,
        epsilon=1.0, noising=True, verification=True,
        defense=Defense.KRUM, sample_percent=0.70,
        max_iterations=rounds, seed=0)
    sim = Simulator(cfg, device=dev)
    t0 = time.perf_counter()
    sim.run_scan(rounds)  # first run
    synchronize(dev)
    compile_s = time.perf_counter() - t0
    kern = krum_cuda.krum_scores_kernel
    before = kern.launches
    cuda = dev.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    w, stake, errs, accepted = sim.run_scan(rounds)  # ends in a host copy
    wall = time.perf_counter() - t0
    event_ms = device_ms = kernels = idle = None
    if cuda:
        end.record()
        end.synchronize()
        event_ms = start.elapsed_time(end)
    launches = kern.launches - before
    if cuda:
        device_ms, kernels = scan_device_ms(sim, rounds)
        idle = 1.0 - device_ms / (1e3 * wall)
    contributors = int(cfg.num_samples)
    return {
        "nodes": n, "contributors_per_round": contributors,
        "rounds": rounds,
        "s_per_iter": round(wall / rounds, 6),
        "device_ms_per_iter": (round(device_ms / rounds, 3)
                               if device_ms is not None else None),
        "scan_event_ms_per_iter": (round(event_ms / rounds, 3)
                                   if event_ms is not None else None),
        "device_idle_share": idle,
        "kernels_per_iter": kernels / rounds if kernels is not None else None,
        "wall_s": round(wall, 3), "compile_s": round(compile_s, 2),
        "final_error": round(float(errs[-1]), 4),
        "mean_accepted": round(float(accepted.mean()), 1),
        "krum_path": ("kernel" if cuda and krum_cuda.KERNEL_MIN_N
                      <= contributors <= krum_cuda.KERNEL_MAX_N else "plain"),
        "krum_launches": launches,
    }


def run(dataset: str, sizes, rounds: int, dev: torch.device) -> list:
    rows = []
    for n in sizes:
        rows.append(size_row(dataset, n, rounds, dev))
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--sizes", default="100,256,512,1024")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--platform", default="cuda",
                    help="torch device: 'cuda' (raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)
    rows = run(args.dataset, [int(s) for s in args.sizes.split(",")],
               args.rounds, dev)

    os.makedirs(args.out, exist_ok=True)
    payload = {
        "experiment": "sim_scale", "platform": dev.type,
        **device_fields(dev), "dataset": args.dataset,
        "timing_note": ("s_per_iter is the host clock around a run_scan "
                        "that ends in a host copy; scan_event_ms_per_iter "
                        "is CUDA events around it; device_ms_per_iter is "
                        "the CUDA kernels' summed time from a torch.profiler "
                        "window over a third run_scan (null on the CPU)"),
        "reference": {"max_published_nodes": 200,
                      "fedsys_200": "12.4 s/iter (VM fleet)"},
        "rows": rows,
    }
    with open(os.path.join(args.out, "sim_scale.json"), "w") as f:
        json.dump(payload, f, indent=1)
    with open(os.path.join(args.out, "sim_scale.csv"), "w") as f:
        f.write("nodes,contributors,rounds,s_per_iter,device_ms_per_iter,"
                "final_error,krum_path\n")
        for r in rows:
            f.write(f"{r['nodes']},{r['contributors_per_round']},"
                    f"{r['rounds']},{r['s_per_iter']},"
                    f"{r['device_ms_per_iter']},{r['final_error']},"
                    f"{r['krum_path']}\n")
    print(json.dumps({"experiment": "sim_scale",
                      "max_nodes": rows[-1]["nodes"] if rows else 0,
                      "s_per_iter_at_max": rows[-1]["s_per_iter"]
                      if rows else None}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
