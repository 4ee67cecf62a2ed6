"""Run one cell of the benchmark of `biscotti_tpu_torch` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout with one CUDA card per chip the cell asks
for. The cell is `benchmark/workloads/<name>.json`; its metrics are the
entries of `BENCHMARK.json` that apply to it: `end_to_end` with --trace 0,
`per_layer` with --trace 1, each read by `benchmark/metrics/<metric>.py`.
The last line of standard output is the result as one JSON object; the
comparison's numbers, each beside its limit, are the last lines of
standard error and the result's last key. Exits non-zero, printing no
result, without the card, or if a module of JAX or of the JAX package is
loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FOREIGN = ("jax", "jaxlib", "flax", "biscotti_tpu")


def foreign_modules(names=None) -> list:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of FOREIGN, compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FOREIGN))


def metric_names(spec: dict, kind: str, workload: str) -> list:
    return [m["name"] for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache at a fixed path inside the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import cells, harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    kind = "per_layer" if args.trace else "end_to_end"
    names = metric_names(spec, kind, args.workload)
    units = {m["name"]: m["unit"] for m in spec[kind]}
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T0, names, log=log)
    foreign = foreign_modules()
    if foreign:
        log(f"modules of JAX or the JAX package are loaded: {foreign}")
        return 3
    r = out["run"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": r.memory_peak_bytes}
    line = {"correct": out["correct"], "attempted": r.rounds,
            "failed": r.failed,
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in out["values"].items()},
            "device": device}
    if r.trace:
        device["busy_s"] = r.trace["busy_s"]
        device["window_s"] = r.trace["window_s"]
        line["breakdown"] = {"device_ops": r.trace["device_ops"],
                             "idle_gaps": r.trace["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": cell.limits.get(k)}
                      for k, v in out["numbers"].items()}
    for k, c in line["checks"].items():
        log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    log(f"correct: {out['correct']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
