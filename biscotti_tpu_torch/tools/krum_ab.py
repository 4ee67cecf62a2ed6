"""Kernel B1 built from two sources, timed in turns on one card.

    python -m biscotti_tpu_torch.tools.krum_ab --other PATH [--n 716]
                                               [--d 7850] [--rounds 4]

Builds `csrc/krum_scores.cu` and the source at PATH (another version of the
same C interface, such as an earlier commit's file unpacked by git) with the
same nvcc flags, then times the kernel alone (its C interface on scratch
allocated once, CUDA events, median of 20 launches) on one seeded x[n, d]
in the order other, this, this, other, `rounds` times over, so that the
card's clock and neighbours weigh on both alike. Prints one JSON line: each
version's times in turn order and their median, the largest score
difference between the two and whether their accept sets agree, and the
card's name and power limit as nvidia-smi prints them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
from pathlib import Path

import torch

from biscotti_tpu_torch import _build, bench
from biscotti_tpu_torch.ops import krum_cuda
from biscotti_tpu_torch.ops.krum import accept_mask, default_num_adversaries

REPS = 20


def _library(src: Path) -> ctypes.CDLL:
    out = _build.digest_path("krum_scores", src, _build.NVCC_FLAGS)
    _build.compile_once(_build.nvcc(), _build.NVCC_FLAGS, src, out)
    lib = ctypes.CDLL(str(out))
    _build.SIGNATURES["krum_scores"](lib)
    return lib


def _time_ms(launch) -> float:
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(other: Path, n: int, d: int, rounds: int) -> dict:
    dev = torch.device("cuda", 0)
    libs = {"other": _library(other), "this": _library(_build.source("krum_scores"))}
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(0)).to(dev)
    f = default_num_adversaries(n)
    k = n - f - 2
    sq = (x * x).sum(dim=-1)
    ws = krum_cuda.workspace(n, d, dev)
    outs = {v: torch.empty(n, dtype=torch.float32, device=dev) for v in libs}

    def launch(version):
        rc = krum_cuda.launch(libs[version], x, sq, outs[version], ws, k)
        if rc != 0:
            raise RuntimeError(f"{version} launch failed: {rc}")

    times = {v: [] for v in libs}
    for _ in range(rounds):
        for version in ("other", "this", "this", "other"):
            times[version].append(_time_ms(lambda: launch(version)))
    launch("other")
    launch("this")
    torch.cuda.synchronize()
    return {"n": n, "d": d, "reps": REPS, "rounds": rounds,
            "kernel_only_ms": times,
            "median_ms": {v: statistics.median(t) for v, t in times.items()},
            "max_abs_diff": float((outs["this"] - outs["other"]).abs().max()),
            "accept_sets_equal": bool(torch.equal(
                accept_mask(outs["this"], n - f), accept_mask(outs["other"], n - f))),
            "device": torch.cuda.get_device_name(dev),
            "nvidia_smi": bench.card_line()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="another krum_scores.cu with the same C interface")
    ap.add_argument("--n", type=int, default=716)
    ap.add_argument("--d", type=int, default=7850)
    ap.add_argument("--rounds", type=int, default=4)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("krum_ab: needs a CUDA device")
    print(json.dumps(run(ns.other, ns.n, ns.d, ns.rounds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
