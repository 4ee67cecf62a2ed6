#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`biscotti_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port only (nothing of JAX or of `biscotti_tpu`), in phases, each
printed as one JSON line:

  1. device   card name and power limit (nvidia-smi), TF32 off for matmul
              and cuDNN;
  2. build    the CUDA kernel built from the repo's source by nvcc, with
              ptxas's report;
  3. kernel   krum_scores kernel vs its plain PyTorch version on the card,
              random shapes up to (4096, 7850), a 30-row duplicate-tie case
              and a poison-cluster case whose accept set must be identical
              (rtol 1e-4 on scores); kernel and plain times (CUDA events,
              median of 20) beside the card's least time for the work
              (the H100 SXM's published fp32 and memory peaks);
  4. main     the simulator round at eval/eval_sim_scale.py's largest
              configuration (mnist softmax, N=1024, S=716, KRUM, DP ε=1,
              batch 10) with poison 0.3: 2 warm and 5 timed rounds, the
              kernel launched exactly once per round;
  5. parity   the kernel on the main path's own updates, its error held
              below half the Krum score gap at the accept boundary; one
              round's draws run on the card and on the CPU port: masks
              and stakes equal, w within rtol 1e-4;
  6. kernels  one line for every ported kernel (launches from phase 4).

Then the card's `name, power.limit` line as nvidia-smi prints it (the line
the run's records are keyed by) and, last, the device JSON. Any
failed check raises, and the script exits non-zero without the last line;
with no CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# published peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit:
# fp32 FLOP/s outside the tensor cores, HBM bytes/s
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
KERNEL_SHAPES = [(8, 16), (130, 50), (716, 7850), (1024, 7850), (4096, 7850)]
RTOL = 1e-4
REPS = 20


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call, by CUDA events around each call."""
    import torch

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


def krum_bound(n: int, d: int):
    """(ms, what bounds it): the least time for the scores of x[n, d], the
    larger of the fp32 operations over the fp32 peak and x read once plus the
    scores written once over the memory rate. The operations are those of the
    n(n-1)/2 distinct off-diagonal dot products (D is symmetric), 2·d each:
    n(n-1)·d. The kernel computes both halves of the Gram matrix, 2·n²·d."""
    ops_ms = 1e3 * n * (n - 1) * d / PEAK_FP32_FLOPS
    bytes_ms = 1e3 * 4.0 * (n * d + n) / PEAK_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def rel_err(got, ref) -> float:
    return float(((got - ref).abs() / (ref.abs() + 1e-6)).max())


def accept_set(scores, keep: int):
    import torch

    return set(torch.sort(scores, stable=True).indices[:keep].tolist())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from biscotti_tpu_torch import _build
    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.ops.krum import default_num_adversaries
    from biscotti_tpu_torch.parallel.sim import Simulator

    # 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         peak_fp32_flops=PEAK_FP32_FLOPS, peak_bytes_per_s=PEAK_BYTES_PER_S)
    dev = torch.device("cuda", 0)

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    log = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         source=str(_build.SOURCE.relative_to(_build.PKG.parent)),
         ptxas=[l for l in log.splitlines() if "registers" in l or "spill" in l])

    # 3. kernel vs plain --------------------------------------------------
    kern, plain = krum_cuda.krum_scores_kernel, krum_cuda.krum_scores_plain
    gen = torch.Generator(device=dev).manual_seed(0)

    def compare(case: str, x, check_accept: bool = False):
        n, d = x.shape
        f = default_num_adversaries(n)
        got, ref = kern(x, f), plain(x, f)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        row = {"case": case, "n": n, "d": d, "max_rel_err": err,
               "max_abs_err": float((got - ref).abs().max()),
               "ms": time_ms(lambda: kern(x, f)),
               "plain_ms": time_ms(lambda: plain(x, f))}
        row["bound_ms"], row["bound_by"] = krum_bound(n, d)
        if check_accept:
            same = accept_set(got, n - f) == accept_set(ref, n - f)
            row["accept_set_identical"] = same
        emit("kernel", **row)
        if not err < RTOL:
            raise AssertionError(f"krum kernel disagrees at {case}: {err}")
        if check_accept and not row["accept_set_identical"]:
            raise AssertionError(f"krum kernel accept set differs at {case}")
        return row

    for n, d in KERNEL_SHAPES:
        compare(f"normal_{n}x{d}",
                torch.randn(n, d, generator=gen, device=dev))
    x = torch.randn(716, 7850, generator=gen, device=dev)
    x[10:40] = x[10]  # 30 identical rows: exact ties at the k-th threshold
    compare("duplicate_ties_716x7850", x)
    x = torch.randn(140, 48, generator=gen, device=dev)
    x[100:] += 25.0  # 40 outliers, as tests/test_krum_pallas.py
    compare("poison_cluster_140x48", x, check_accept=True)

    # 4. main path ------------------------------------------------------
    cfg = BiscottiConfig(dataset="mnist", num_nodes=1024, sample_percent=0.70,
                         defense=Defense.KRUM, verification=True, noising=True,
                         epsilon=1.0, batch_size=10, poison_fraction=0.3,
                         seed=0)
    t0 = time.perf_counter()
    sim = Simulator(cfg)
    setup_s = time.perf_counter() - t0
    s = cfg.num_samples
    f = default_num_adversaries(s)
    w, stake = sim.init_state()
    for it in range(2):  # warm rounds
        w, stake, mask, err = sim.round_step(w, stake, it)
    torch.cuda.synchronize()
    kern.launches = 0
    round_ms = []
    for it in range(2, 7):
        before = kern.launches
        t0 = time.perf_counter()
        w, stake, mask, err = sim.round_step(w, stake, it)
        torch.cuda.synchronize()
        round_ms.append(1e3 * (time.perf_counter() - t0))
        if kern.launches - before != 1:
            raise AssertionError(f"round {it} launched the Krum kernel "
                                 f"{kern.launches - before} times, not once")
    main_launches = kern.launches
    final_err = float(err)
    moved = (stake - cfg.default_stake).abs()
    emit("main", nodes=cfg.num_nodes, contributors=s, params=sim.num_params,
         setup_s=setup_s, round_ms=round_ms,
         round_ms_median=statistics.median(round_ms),
         krum_launches=main_launches, accepted=int(mask.sum()),
         final_error=final_err, max_stake_move=int(moved.max()))
    if not (w.shape == (sim.num_params,) and bool(torch.isfinite(w).all())):
        raise AssertionError("main path: w is not finite or has the wrong shape")
    if int(mask.sum()) != s - f:
        raise AssertionError(f"main path: {int(mask.sum())} accepted, not {s - f}")
    if not 0.0 <= final_err < 0.9:
        raise AssertionError(f"main path: test error {final_err} is no better "
                             "than chance")
    if int(moved.max()) > 7 * cfg.stake_unit or bool((moved % cfg.stake_unit).any()):
        raise AssertionError("main path: stakes moved off the ±stake_unit grid")

    # where the round's time goes: device kernels over a profiled window
    from torch.profiler import ProfilerActivity, profile

    prof_rounds = 3
    pw, pstake = w, stake
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for it in range(7, 7 + prof_rounds):
            pw, pstake, _, _ = sim.round_step(pw, pstake, it)
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3 / prof_rounds
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]
    emit("profile", rounds=prof_rounds, device_ms_per_round=device_ms,
         device_idle_share=1.0 - device_ms / statistics.median(round_ms),
         kernels_per_round=sum(e.count for e in on_device) / prof_rounds,
         top=[{"name": e.key[:100],
               "ms_per_round": e.self_device_time_total / 1e3 / prof_rounds,
               "calls_per_round": e.count / prof_rounds} for e in top])

    # 5. card vs CPU on the same draws, and the kernel on main-path inputs
    draws = sim.draw_round(sim.gen, 7)
    cidx, batch_idx, noise, keep = draws
    _, noised = sim.local_updates(w, cidx, batch_idx, noise)
    got, ref = kern(noised, f), plain(noised, f)
    scores = torch.sort(ref).values
    main_kernel = {
        "max_abs_err": float((got - ref).abs().max()),
        "max_rel_err": rel_err(got, ref),
        "accept_set_identical": accept_set(got, s - f) == accept_set(ref, s - f),
        "boundary_rel_gap": float((scores[s - f] - scores[s - f - 1]) / scores[s - f]),
        "ms": time_ms(lambda: kern(noised, f)),
        "plain_ms": time_ms(lambda: plain(noised, f))}
    main_kernel["bound_ms"], main_kernel["bound_by"] = krum_bound(
        s, sim.num_params)
    gpu = sim.round_step_from_draws(w, stake, *draws)
    cpu_sim = Simulator(cfg, device="cpu")
    cpu = cpu_sim.round_step_from_draws(w.cpu(), stake.cpu(),
                                        *(t.cpu() for t in draws))
    w_gpu, w_cpu = gpu[0].cpu(), cpu[0]
    w_tol = 1e-4 * float(w_cpu.abs().max())
    parity = {"mask_equal": bool(torch.equal(gpu[2].cpu(), cpu[2])),
              "stake_equal": bool(torch.equal(gpu[1].cpu(), cpu[1])),
              "w_max_abs_diff": float((w_gpu - w_cpu).abs().max()),
              "w_atol": w_tol, "err_gpu": float(gpu[3]), "err_cpu": float(cpu[3])}
    emit("parity", main_path_kernel=main_kernel, **parity)
    if not main_kernel["max_rel_err"] < RTOL or not main_kernel["accept_set_identical"]:
        raise AssertionError("krum kernel disagrees with plain on main-path inputs")
    # a score error as large as half the boundary gap could flip the accept
    # set: a near-tie shows here, not as a later mask mismatch
    if not main_kernel["max_rel_err"] < main_kernel["boundary_rel_gap"] / 2:
        raise AssertionError("krum kernel error is not below half the score gap "
                             "at the accept boundary on main-path inputs")
    if not (parity["mask_equal"] and parity["stake_equal"]):
        raise AssertionError("card and CPU rounds disagree on mask or stake")
    if not torch.allclose(w_gpu, w_cpu, rtol=RTOL, atol=w_tol):
        raise AssertionError("card and CPU rounds disagree on w")

    # 6. kernels ----------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "krum_scores", "route": "cuda",
        "source": "biscotti_tpu_torch/csrc/krum_scores.cu",
        "replaces": "biscotti_tpu/ops/krum_pallas.py:72",
        "launches": main_launches,
        "max_abs_err": main_kernel["max_abs_err"],
        "ms": main_kernel["ms"], "plain_ms": main_kernel["plain_ms"],
        "bound_ms": main_kernel["bound_ms"], "bound_by": main_kernel["bound_by"],
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)  # the card's name and power limit, verbatim
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
