# The port's counterpart of eval/eval_krum_kernel.py; it imports nothing of biscotti_tpu.
"""Krum kernel benchmark: kernel B1 (`csrc/krum_scores.cu`) against the
plain torch path, timed on the card with CUDA events, across committee
sizes.

    python -m biscotti_tpu_torch.eval.eval_krum_kernel [--d 7850] \
        [--sizes 512,1024,2048,4096] [--platform cuda] [--out DIR]

For each n, x[n, d] is the reference's own input (numpy's
`default_rng(n).normal`, float32) and f = n // 2. B1 is called through its
wrapper (`krum_scores_kernel`) at every n, inside the dispatch window
(`ops/krum_cuda.py` KERNEL_MIN_N..KERNEL_MAX_N) or not, and held to the
plain path on the same x: scores within rtol 1e-4 and the same accept set.
`krum_times` gives the wrapper's time, the kernel's alone (the C interface
`krum_cuda.launch` on scratch allocated once), the plain path's and the
fp32 cuBLAS Gram x @ x.T's (CUDA events, median of REPS), and the card's
least time for the work; `chip_smoke.py` times B1 with the same code.
On the CPU (`--platform cpu`) the wrapper computes the plain version and
no time is measured: the time columns are null.

Artifact keys renamed from the reference's (eval/results/krum_kernel.*):
`xla_device_ms` → `plain_ms` (the plain torch path), `pallas_device_ms` →
`kernel_ms` (B1 through its wrapper), `backend` → `platform`. Added:
`kernel_only_ms`, `gram_cublas_ms`, `bound_ms`, `bound_by`,
`accept_set_equal`, and `device`/`nvidia_smi`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np
import torch

from biscotti_tpu_torch.device import resolve_device, synchronize
from biscotti_tpu_torch.eval import RESULTS, device_fields
from biscotti_tpu_torch.ops import krum_cuda
from biscotti_tpu_torch.ops.krum import rank_scores

# published peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit:
# fp32 FLOP/s outside the tensor cores, dense TF32 on the tensor cores, HBM
# bytes/s
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# the pipes a Krum Gram can run on: (products a dot product needs there,
# peak FLOP/s). csrc/krum_scores.cu runs on the fp32 FMA pipe; a 3xTF32
# Gram on the tensor pipe (hi.hi + hi.lo + lo.hi) is its yardstick
KRUM_PIPES = {"fp32_fma": (1, PEAK_FP32_FLOPS),
              "tf32x3_tensor": (3, PEAK_TF32_FLOPS)}
KRUM_PIPE = "fp32_fma"
RTOL = 1e-4
REPS = 20


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def krum_bound(n: int, d: int, pipe: str = KRUM_PIPE):
    """(ms, what bounds it): the least time for the scores of x[n, d] on
    `pipe` (KRUM_PIPES), the larger of its operations over its peak and x
    read once plus the scores written once over the memory rate. The
    operations are those of the n(n-1)/2 distinct off-diagonal dot products
    (D is symmetric), 2·d each: n(n-1)·d, three times over for a 3xTF32
    Gram. The kernel computes the upper Gram tiles only, the diagonal ones
    whole."""
    passes, peak = KRUM_PIPES[pipe]
    ops_ms = 1e3 * passes * n * (n - 1) * d / peak
    bytes_ms = 1e3 * 4.0 * (n * d + n) / PEAK_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def krum_times(x, num_adversaries: int) -> dict:
    """Kernel B1 at x[n, d] on the card: the wrapper's time, the kernel's
    alone (the C interface called directly on scratch allocated once, with
    sq computed once: three CUDA kernels, each one's device time from
    torch.profiler), the plain version's and the fp32 cuBLAS Gram
    x @ x.T's (CUDA events, median of REPS); its bound on the pipe it runs
    on and a 3xTF32 tensor-core Gram's; and whether two calls, and the
    direct launch, agree bit for bit (raises if not)."""
    from torch.profiler import ProfilerActivity, profile

    from biscotti_tpu_torch import _build

    n, d = x.shape
    f, k = num_adversaries, n - num_adversaries - 2
    kern, lib = krum_cuda.krum_scores_kernel, _build.load("krum_scores")
    ws = krum_cuda.workspace(n, d, x.device)
    sq = (x * x).sum(dim=-1)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    first = kern(x, f)
    rc = krum_cuda.launch(lib, x, sq, out, ws, k)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"krum kernel's direct launch failed: {rc}")
    row = {"splits": ws["splits"],
           "bit_identical": bool(torch.equal(first, kern(x, f))),
           "direct_launch_equal": bool(torch.equal(out, first)),
           "ms": time_ms(lambda: kern(x, f)),
           "kernel_only_ms": time_ms(
               lambda: krum_cuda.launch(lib, x, sq, out, ws, k)),
           "plain_ms": time_ms(lambda: krum_cuda.krum_scores_plain(x, f)),
           "gram_cublas_ms": time_ms(lambda: x @ x.T)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            krum_cuda.launch(lib, x, sq, out, ws, k)
        torch.cuda.synchronize()
    # per recorded launch: the profiler may not record all 5
    parts = {part: [e for e in prof.key_averages()
                    if f"krum_{part}_kernel" in e.key]
             for part in ("pad", "gram", "select")}
    row["kernel_parts_ms"] = {
        part: sum(e.self_device_time_total for e in evs) / 1e3
        / max(1, sum(e.count for e in evs)) for part, evs in parts.items()}
    row["kernel_parts_recorded"] = {part: sum(e.count for e in evs)
                                    for part, evs in parts.items()}
    row["bound_ms"], row["bound_by"] = krum_bound(n, d)
    row["bound_pipe"] = KRUM_PIPE
    row["tf32x3_tensor_bound_ms"] = krum_bound(n, d, "tf32x3_tensor")[0]
    if not (row["bit_identical"] and row["direct_launch_equal"]):
        raise AssertionError(f"krum kernel is not bit-identical from call to "
                             f"call at ({n}, {d}): {row}")
    return row


def rel_err(got, ref) -> float:
    return float(((got - ref).abs() / (ref.abs() + 1e-6)).max())


def accept_set(scores, keep: int):
    return set(rank_scores(scores)[:keep].tolist())


def size_row(n: int, d: int, dev: torch.device) -> dict:
    """One committee size: B1 through its wrapper against the plain path on
    the reference's x[n, d], with their times on the card."""
    f = n // 2
    x = torch.from_numpy(np.random.default_rng(n).normal(size=(n, d))
                         .astype(np.float32)).to(dev)
    got = krum_cuda.krum_scores_kernel(x, f)
    ref = krum_cuda.krum_scores_plain(x, f)
    synchronize(dev)
    rel = rel_err(got, ref)
    same = accept_set(got.cpu(), n - f) == accept_set(ref.cpu(), n - f)
    row = {"n": n, "d": d, "plain_ms": None, "kernel_ms": None,
           "speedup": None, "kernel_only_ms": None, "gram_cublas_ms": None,
           "bound_ms": None, "bound_by": None,
           "max_abs_err": float((got - ref).abs().max()),
           "max_rel_err": rel, "accept_set_equal": same,
           "agree": bool(rel < RTOL and same)}
    if dev.type == "cuda":
        t = krum_times(x, f)
        row.update(plain_ms=t["plain_ms"], kernel_ms=t["ms"],
                   speedup=t["plain_ms"] / t["ms"],
                   kernel_only_ms=t["kernel_only_ms"],
                   gram_cublas_ms=t["gram_cublas_ms"],
                   bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                   kernel_parts_ms=t["kernel_parts_ms"])
    return row


def run(sizes, d: int, dev: torch.device) -> list:
    """The rows of every size, each printed to stderr as it lands."""
    rows = []
    for n in sizes:
        rows.append(size_row(n, d, dev))
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=7850,
                    help="update dimension (mnist softmax default)")
    ap.add_argument("--sizes", default="512,1024,2048,4096")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--platform", default="cuda",
                    help="torch device: 'cuda' (raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)
    rows = run([int(s) for s in args.sizes.split(",")], args.d, dev)

    os.makedirs(args.out, exist_ok=True)
    payload = {"experiment": "krum_kernel", "platform": dev.type,
               **device_fields(dev),
               "timing": ("CUDA events around each call, median of "
                          f"{REPS}; null on the CPU"),
               "window": [krum_cuda.KERNEL_MIN_N, krum_cuda.KERNEL_MAX_N],
               "rows": rows}
    with open(os.path.join(args.out, "krum_kernel.json"), "w") as fp:
        json.dump(payload, fp, indent=1)
    with open(os.path.join(args.out, "krum_kernel.csv"), "w") as fp:
        fp.write("n,d,plain_ms,kernel_ms,speedup,max_rel_err\n")
        for r in rows:
            fp.write(f"{r['n']},{r['d']},{r['plain_ms']},{r['kernel_ms']},"
                     f"{r['speedup']},{r['max_rel_err']}\n")
    ok = all(r["agree"] for r in rows)
    print(json.dumps({"experiment": "krum_kernel", "platform": dev.type,
                      "all_agree": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
