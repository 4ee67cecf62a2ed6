#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`biscotti_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port only (nothing of JAX or of `biscotti_tpu`), in phases, each
printed as one JSON line:

  1. device   card name and power limit (nvidia-smi), TF32 off for matmul
              and cuDNN;
  2. build    both CUDA kernels built from the repo's sources by nvcc, one
              process each, started together, with ptxas's register and
              spill report, the on-curve kernel's SASS instruction mix and
              the Krum Gram kernel's (its FFMA and HMMA counts);
  3. kernel   krum_scores kernel vs its plain PyTorch version on the card,
              random shapes up to (4096, 7850), a 30-row duplicate-tie case,
              a poison-cluster case whose accept set must be identical
              (rtol 1e-4 on scores) and a cancellation-heavy case (rows
              sharing one large mean) whose accept set must be identical
              and whose error against float64 scores must be no larger
              than the plain version's (10 % slack); the non-finite cases
              of ROADMAP C1 at (716, 7850) (a row whose squared norm
              overflows, +inf, −inf, a NaN input), B1 and the plain
              version on the card against the plain version on the CPU:
              accept sets equal, NaN bits and infinities equal, finite
              scores within rtol 1e-4; ROADMAP C2's x1e-20 rows at
              (716, 7850) (every product subnormal: B1 = plain = the
              reference's accept set, the n − f lowest ids, all scores
              0); at every shape two
              calls and a direct launch equal bit for bit; the wrapper's,
              the kernel's alone (the C interface on scratch allocated
              once), the plain version's and the fp32 cuBLAS Gram x @ x.T's
              times (CUDA events, median of 20) beside the card's least
              time for the work on the pipe the kernel uses and on the
              TF32 tensor pipe (the H100 SXM's published peaks);
  4. main     the simulator round at eval/eval_sim_scale.py's largest
              configuration (mnist softmax, N=1024, S=716, KRUM, DP ε=1,
              batch 10) with poison 0.3: 2 warm and 5 timed rounds, the
              kernel launched exactly once per round;
  5. parity   the kernel on the main path's own updates, its error held
              below half the Krum score gap at the accept boundary, its
              times as in phase 3 and two calls equal bit for bit; the
              same updates with one row's squared norm overflowing and
              rows of ±inf (C1), held as in phase 3, and scaled to a
              largest |x| of 1e-20 (C2, the reference's accept set);
              one round's draws
              run on the card and on the CPU port: masks and stakes
              equal, w within rtol 1e-4;
  crypto_kernel
              the on-curve kernel (B2) vs its plain PyTorch version on
              the VSS fold's 64 × 7,850 = 502,400 cells (valid points,
              bit flips, x + p, y + p, edge values, (0, −1), (0, 1),
              random limbs): masks exactly equal, the known-valid cells
              all True, a 20,000-cell sample held against the python-int
              oracle; the wrapper's, the kernel's alone and the plain
              version's times (CUDA events, median of 20) beside the
              card's least time for the work;
  crypto      the device crypto plane at the mnist secure-aggregation
              width (C = 785 chunks × k = 10 = 7,850 grid points, 35 grids
              a wave padded to 64), in VssIntakeBatch's order: validate
              and sum a wave with two bad grids (B2 launched once, exactly
              those two evicted), fold a second wave with ext_add, settle
              (msm == pedersen_commit_point, and not when one scalar
              changes); card == CPU port bit for bit on a small wave;
              host-clock times of every entry point and one
              torch.profiler window over the msm;
  secagg      the secure-aggregation plane at the bench's mnist_100_dp_eps1
              width (d = 7,850, C = 785, k = 10, 3 miners at r = 2: 21
              shares, 7 rows a miner), the native library loaded: one
              worker's quantize (from the card) → vss_commit_chunks →
              vss_blind_rows → make_shares, timed; 35 seeded workers, one
              grid with a single off-curve cell; miner 0's intake through
              VssIntakeBatch in two waves, armed on the card with
              BISCOTTI_PALLAS_CRYPTO=1 (B2 once a fold) and disarmed
              (native): the same sid evicted at the first fold, settle
              True on both; a second batch with one corrupted share row
              settles False on both; recover_update of the honest
              workers' aggregated shares armed and disarmed equals Σq/10⁴
              exactly; every fold, settle and recovery timed (host clock
              after a synchronize), `prewarm` timed;
  models      each CNN family (mnist_cnn, cifar_cnn, lfw_cnn) from flat_init
              weights: parameter count, the forward pass and the
              simulator's per-contributor step (S = 8, batch 10) on the
              card against the CPU port within rtol 1e-4, the TF32
              switches of matmuls (where the convolutions run) and cuDNN
              as read inside the step (both must be off; the phase turns
              both on around it), whether two steps are bit-identical;
  defenses    one warm and 3 timed rounds of each defense (KRUM, MULTIKRUM,
              FOOLSGOLD, RONI, TRIMMED_MEAN without secure aggregation,
              NONE, ENSEMBLE) at the main configuration, B1 launched once a
              round under KRUM and MULTIKRUM and never otherwise, and one
              round's draws on the card and on the CPU port (masks and
              stakes equal, w within rtol 1e-4);
  cnn         the mnist CNN at the main configuration's scale (d = 164,266,
              S = 716): 2 warm and 5 timed rounds with B1 once a round at
              (716, 164266); B1 against its plain version on one round's
              noised updates from flat_init weights (accept sets equal,
              error below half the boundary gap or, where plain's own
              error against float64 exceeds it, no less exact than plain;
              times and bound as in phase 3); a device_trace window over 3
              rounds (device ms a round, idle share, top kernels);
  bench       the eight BASELINE rows through biscotti_tpu_torch.bench
              (device_round_s, the crypto-inclusive keys and the six wire
              and cross-host byte columns each, the share round-trip
              exact, the device settle on creditcard_10, the
              mnist_100_dp_eps1 headline), and one round of each CNN row
              on the card and on the CPU port from flat_init weights;
  trainer     the per-peer Trainer on the card against the CPU port (mnist
              softmax and mnist_cnn), one private_fun's time, and mcmc13
              Trainers at d = 7,850 and 164,266: acceptance rate, mean row
              norm against the law's 2d/ε (within 1 %), presample time;
  ledger      the ledger and wire plane on the card's own rounds: 5 rounds
              of the main configuration, each sealed into a Block (global_w
              on the f32 grid, the card's stakes, one secure-agg Update for
              each accepted contributor: an empty delta and the SHA-256 of its
              update as the commitment) and appended with consider_block to
              a 1,024-node Blockchain; one plain-mode block of 70 accepted
              mnist_cnn updates (d = 164,266, ~92 MB as float64) on a chain
              of its own; every block sent through the port's Pool to the
              port's RPCServer on 127.0.0.1 under raw64 and f32+zlib (4 MiB
              chunks), the server appending it to a second chain: dumps
              equal, verify() passes, every decoded hash the sealed one, a
              checkpoint save/load equal; frame bytes, codec ratios,
              chunk frames and the encode, send and decode seconds of each
              block kind (host clock), and the bench's six byte columns for
              the main configuration;
  live        in-process clusters of port PeerAgents on the card over
              loopback TCP (1 verifier, 1 miner, 1 noiser each round; the
              verifier's pool holds every other peer's update): (a) 7
              peers, mnist softmax (d = 7,850), KRUM + noising + secure
              aggregation on the native host crypto, 3 rounds; (b) 4
              peers, the same with device_crypto armed on the card, batch
              intake and BISCOTTI_PALLAS_CRYPTO=1 (B2 once a miner's
              fold), 1 round, and its witness: the same 4-peer round on
              the native plane, whose chain (b)'s must equal hash for
              hash; (c) 7 peers, mnist_cnn (d = 164,266) in plain mode
              with KRUM verification, 2 rounds. Each: chains equal,
              rounds reached, non-empty blocks, each round's wall time,
              the peers' phase totals, every peer's Trainer on the card,
              the verifiers' pools and accept counts ((a) and (c): a pool
              of 5, so Krum scores on 1 neighbour and rejects 2 in a
              live block); (b) B2's launches. Then the verifier seam: an
              unstarted card peer and a CPU peer give the same KRUM,
              MULTIKRUM, FOOLSGOLD, RONI and ENSEMBLE masks on seeded
              12-row pools at d = 7,850 and on C2's x1e-20 rows;
  hive        co-hosted port peers on the card, one process, loopback
              transport, one batched SGD call a round (runtime/hive.py):
              (a) the reference's density entry at N = 100 (bench.py:452)
              through `bench.bench_peer_density`, a subprocess of `python -m
              biscotti_tpu_torch.runtime.hive -t 100 -d mnist --iterations
              2 -sa 0 -np 0 -vp 1 --seed 3` (d = 7,850): s/iter, peak RSS
              per peer, loop lag, stepper batches, chains equal; (b) a Hive
              of 100 mnist_cnn peers (d = 164,266), KRUM, 2 rounds, then one
              HiveStepper batch at the final weights: its draws' host ms,
              its time (CUDA events) and torch.profiler's device ms and
              kernel count, every peer's delta held to its standalone
              Trainer's on the card (rtol 1e-4); (c) a Hive of 528 mnist
              softmax peers, 1 verifier, 1 miner, 1 noiser, plain mode with
              KRUM, 2 rounds: the verifier's pool of 526 updates lies in
              B1's window, so B1 scores it inside the live round (its
              launch count must rise), then B1 on that pool against its
              plain version (accept sets equal, rtol 1e-4) and timed as in
              phase 3; (d) a single-device BatchStepper cluster of 8 mnist
              peers, 2 rounds. Each cell: chains equal, every round a
              non-empty block;
  6. kernels  one line for every ported kernel (B1's launches from phases
              4, defenses, cnn, ledger and hive (c), with its times at
              (716, 164266) and at the hive's live pool beside those at
              (716, 7850); B2's from the crypto and secagg phases' intakes
              and the live miners' folds).

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

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
# the integer pipes of one H100 SXM: 132 SMs at 1.98 GHz, the clock behind
# the data sheet's fp32 figure (67e12 / (132 SMs × 128 lanes × 2)); per SM
# and clock, 64 lanes of 32-bit integer results on each of the FMA pipe
# and the ALU pipe (CUDA C++ Programming Guide, arithmetic throughput
# table, compute capability 9.0) and 128 lanes issued (4 schedulers × 32)
SMS, CLOCK_HZ = 132, 1.98e9
PIPE_LANES, ISSUE_LANES = 64, 128
# SASS opcodes (the part before the first dot) by where they run; U* are the
# uniform datapath's, one per warp, and not counted either
FMA_PIPE = {"IMAD", "IMUL"}
ALU_PIPE = {"IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PLOP3", "IMNMX",
            "PRMT"}
EITHER_PIPE = {"VIADD"}
NOT_COUNTED = {"MOV", "LDC", "LDG", "STG", "S2R", "CS2R", "EXIT", "BRA", "NOP",
               "HFMA2", "BSSY", "BSYNC"}
KERNEL_SHAPES = [(8, 16), (130, 50), (716, 7850), (1024, 7850), (4096, 7850)]
RTOL = 1e-4
EXACT_SLACK = 1.1
REPS = 20
# the VSS intake at the bench's mnist secure-aggregation width
# (bench.py:849-858: N = 100, sample_percent 0.70; config.py:170)
CHUNKS, POLY = 785, 10  # C chunks of k coefficients: d = 7,850
WAVE = 35  # num_samples // 2 grids a wave (bench.py:272)
SHARES = 15  # share points of the Shamir recovery timing
LEDGER_ROUNDS = 5
# S of the bench's mnist_cnn rows at N = 100 (bench.py:849-858): the
# accepted updates a plain-mode mnist_cnn block carries in the ledger phase
LEDGER_CNN_ROWS = 70
LEDGER_CODECS = ("raw64", "f32+zlib")
# peers of clusters (a) and (c): a verifier's pool of 5, Krum's least pool
# that scores on a neighbour (k = n - f - 2 = 1); (b) and its witness take 4
LIVE_PEERS = 7
LIVE_ARMED_PEERS = 4
LIVE_BASE_PORT = 17500
# the hive phase: (a) the reference's density entry at N = 100 (its CLI's
# default ports, 8000 + id), (b) 100 mnist_cnn peers, (c) N = 528, whose
# verifier pools 526 updates, inside B1's 512..4096 window, (d) a
# single-device BatchStepper cluster
HIVE_DENSITY_N = 100
HIVE_CNN_N = 100
HIVE_POOL_N = 528
HIVE_POOL_ROUNDS = 2
HIVE_CLUSTER_N = 8
HIVE_BASE_PORT = 18000


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


def oncurve_bound(n: int, mix):
    """(ms, what bounds it, the counts): the least time for the on-curve
    mask of n cells, the larger of the bytes (each cell's 32 int64 limbs
    read once, its 1-byte verdict written once) over the memory rate and
    the cell's integer instructions over the rate of the pipes that run
    them. `mix` is the kernel's own SASS mix, {opcode: count}, as
    `sass_mix` reads it from the library this run built. The kernel has no
    loop and no data-dependent branch, so every cell issues the whole
    listing once. Per cell:
      * fma: the FMA pipe's lane-passes, IMAD and IMUL, each IMAD.WIDE (a
        limb product with a 64-bit result) counted twice for its two
        passes; IMAD.MOV is a move;
      * alu: the ALU pipe's adds, logic, shifts, LEA, compares and selects;
      * issued: every counted instruction once.
    The pipes run at once, so a cell needs max(fma / 64, alu / 64,
    issued / 128) clocks of an SM. VIADD may go to either pipe: the
    bound takes the placement that gives the least time, so it holds
    wherever VIADD runs. Moves, loads, the store, the uniform datapath and
    control instructions are not counted."""
    if not isinstance(mix, dict):
        raise AssertionError(f"oncurve_bound needs the kernel's SASS mix: {mix}")
    if mix.get("BRA", 0) > 1:
        raise AssertionError("the on-curve kernel's SASS has a branch besides "
                             "its final one: the per-cell count needs its "
                             "trip count")
    fma = alu = either = issued = 0
    for op, count in mix.items():
        base = op.split(".")[0]
        if base in NOT_COUNTED or base.startswith("U") \
                or op.startswith("IMAD.MOV"):
            continue
        if base in FMA_PIPE:
            fma += 2 * count if op.startswith("IMAD.WIDE") else count
        elif base in ALU_PIPE:
            alu += count
        elif base in EITHER_PIPE:
            either += count
        else:
            raise AssertionError(f"oncurve_bound: no pipe known for {op}")
        issued += count
    clocks = min(max((fma + f) / PIPE_LANES, (alu + either - f) / PIPE_LANES,
                     issued / ISSUE_LANES) for f in (0, either))
    ops_ms = 1e3 * n * clocks / (SMS * CLOCK_HZ)
    bytes_ms = 1e3 * n * (2 * 16 * 8 + 1) / PEAK_BYTES_PER_S
    counts = {"fma": fma, "alu": alu, "either": either, "issued": issued,
              "sm_clocks_per_cell": clocks, "ops_ms": ops_ms,
              "bytes_ms": bytes_ms}
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", counts
    return bytes_ms, "bytes", counts


def sass_mix(lib, kernel: str):
    """{opcode: count} of `kernel`'s SASS in the built library, read with
    the toolkit's cuobjdump, or why it could not be read."""
    import re

    from biscotti_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return "not measured: no cuobjdump beside nvcc"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120).stdout
    mix, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            mix[m.group(1)] = mix.get(m.group(1), 0) + 1
    return dict(sorted(mix.items(), key=lambda kv: -kv[1]))


def krum_scores_fp64(x, num_adversaries: int):
    """Krum scores of x computed in float64 throughout: the yardstick of
    how exact the kernel and the plain version are."""
    import torch

    n = x.shape[0]
    k = n - num_adversaries - 2
    xd = x.double()
    sq = (xd * xd).sum(dim=-1)
    d = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (xd @ xd.T), min=0.0)
    d.fill_diagonal_(float("inf"))
    return torch.sort(d, dim=-1).values[:, :k].sum(dim=-1)


def krum_times(x, num_adversaries: int) -> dict:
    """Kernel B1 at x[n, d]: the wrapper's time, the kernel's alone (the C
    interface called directly on scratch allocated once, with sq computed
    once: three CUDA kernels, each one's device time from torch.profiler),
    the plain version's and the fp32 cuBLAS Gram x @ x.T's (CUDA events,
    median of REPS); its bound on the pipe it runs on and a 3xTF32
    tensor-core Gram's; and whether two calls, and the direct launch, agree
    bit for bit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from biscotti_tpu_torch import _build
    from biscotti_tpu_torch.ops import krum_cuda

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


def boundary_rel_gap(ref, keep: int) -> float:
    """The relative gap of the plain scores at the accept boundary."""
    import torch

    s = torch.sort(ref).values
    return float((s[keep] - s[keep - 1]) / s[keep])


def rel_err(got, ref) -> float:
    return float(((got - ref).abs() / (ref.abs() + 1e-6)).max())


def accept_set(scores, keep: int):
    from biscotti_tpu_torch.ops.krum import rank_scores

    return set(rank_scores(scores)[:keep].tolist())


def nonfinite_case(case: str, x, num_adversaries: int) -> dict:
    """B1 and the plain version on the card against the plain version on
    the CPU for the same input x (on the card), the oracle the CPU tests
    hold to the reference: accept sets equal, the same NaN bits and
    infinities at the same places, finite scores within RTOL. Launches
    made here are comparisons, not main-path launches."""
    import torch

    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.ops.krum import same_nonfinite

    n, f = x.shape[0], num_adversaries
    oracle = krum_cuda.krum_scores_plain(x.cpu(), f)
    want = accept_set(oracle, n - f)
    fin = torch.isfinite(oracle)
    row = {"case": case, "n": n, "d": x.shape[1],
           "oracle_nan": int(torch.isnan(oracle).sum()),
           "oracle_inf": int(torch.isinf(oracle).sum())}
    for name, fn in (("kernel", krum_cuda.krum_scores_kernel),
                     ("plain_on_card", krum_cuda.krum_scores_plain)):
        got = fn(x, f)
        torch.cuda.synchronize()
        got = got.cpu()
        row[name] = {"accept_set_equal": accept_set(got, n - f) == want,
                     "nonfinite_equal": same_nonfinite(got, oracle),
                     "finite_max_rel_err": rel_err(got[fin], oracle[fin])}
    if not all(row[k]["accept_set_equal"] and row[k]["nonfinite_equal"]
               and row[k]["finite_max_rel_err"] < RTOL
               for k in ("kernel", "plain_on_card")):
        raise AssertionError(f"Krum on non-finite rows differs from the CPU "
                             f"oracle: {row}")
    return row


def host_s(fn, reps: int = 3):
    """(median host-clock seconds of `reps` calls, the last result). Every
    entry point of the crypto plane ends in a host copy of its result, so
    the clock covers its device work."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def valid_grid(seed: int):
    """One valid VSS commitment grid of C·k affine points aᵢ·B + bᵢ·H,
    with known aᵢ, bᵢ < q, from the port's fixed_base_mult on the card and
    its ed25519 copy for the affine form: ([C, k, 64] uint8, a, b)."""
    from biscotti_tpu_torch.crypto import ed25519 as ed
    from biscotti_tpu_torch.crypto.commitments import H_POINT
    from biscotti_tpu_torch.crypto.kernels import primitives as prim
    from biscotti_tpu_torch.crypto.kernels.cells import grid_bytes

    rng = np.random.default_rng(seed)
    n = CHUNKS * POLY
    a = [int.from_bytes(rng.bytes(32), "little") % ed.Q for _ in range(n)]
    b = [int.from_bytes(rng.bytes(32), "little") % ed.Q for _ in range(n)]
    grid = grid_bytes(a, b, prim.fixed_base_mult)
    for i in (0, 1, n - 1):  # the python-int oracle on a few points
        want = ed.to_affine(ed.point_add(ed.base_mult(a[i]),
                                         ed.scalar_mult(b[i], H_POINT)))
        got = (int.from_bytes(grid[i, :32].tobytes(), "little"),
               int.from_bytes(grid[i, 32:].tobytes(), "little"))
        if got != want:
            raise AssertionError(f"fixed_base_mult disagrees with the "
                                 f"oracle at point {i}")
    return grid.reshape(CHUNKS, POLY, 64), a, b


def oncurve_cells(grid_limbs: np.ndarray, waves: int, seed: int):
    """The VSS fold's cells with every kind of input mixed in: `waves`
    copies of the grid's [n, 2, 16] limbs, half left valid and half split
    among bit flips, x + p, y + p (on the curve, not canonical), edge
    values in either coordinate, the order-2 point (0, −1), the identity
    (0, 1) and random limbs. Returns (cells, {kind: indices}) for the
    kinds whose every cell lies on the curve."""
    from biscotti_tpu_torch.crypto import ed25519 as ed
    from biscotti_tpu_torch.crypto.kernels.cells import EDGE_FIELD, raw_limbs

    rng = np.random.default_rng(seed)
    cells = np.tile(grid_limbs.astype(np.int64), (waves, 1, 1))
    n = len(cells)
    order = rng.permutation(n)
    flip, xp, yp, edge, small, rand = np.array_split(order[:n // 2], 6)
    k = len(flip)
    cells[flip, rng.integers(0, 2, k), rng.integers(0, 16, k)] ^= \
        1 << rng.integers(0, 16, k)
    p_limbs = raw_limbs([ed.P])[0]
    for idx, coord in ((xp, 0), (yp, 1)):
        v, c = cells[idx, coord], 0
        for i in range(16):  # + p with the carry propagated: < 2²⁵⁶
            s = v[:, i] + p_limbs[i] + c
            v[:, i], c = s & 0xFFFF, s >> 16
        cells[idx, coord] = v
    edges = raw_limbs(EDGE_FIELD)
    k = len(edge)
    cells[edge, rng.integers(0, 2, k)] = edges[rng.integers(0, len(edges), k)]
    half = len(small) // 2
    cells[small[:half]] = raw_limbs([0, ed.P - 1])
    cells[small[half:]] = raw_limbs([0, 1])
    cells[rand] = rng.integers(0, 1 << 16, (len(rand), 2, 16))
    return cells, {"valid": order[n // 2:], "x_plus_p": xp, "y_plus_p": yp,
                   "order_2": small[:half], "identity": small[half:]}


def crypto_kernel_phase(dev, grid: np.ndarray, mix) -> dict:
    """Kernel B2 against its plain version on the VSS fold's cells; `mix`
    is its SASS mix from the build phase, for its bound."""
    import torch

    from biscotti_tpu_torch import _build
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
    from biscotti_tpu_torch.crypto.kernels import group as gp
    from biscotti_tpu_torch.crypto.kernels import primitives as prim

    t_phase = time.perf_counter()
    waves = prim._pow2(WAVE, prim.GRID_MIN_WAVES)
    cells, valid_kinds = oncurve_cells(
        gp.xy_bytes_to_limbs(grid.tobytes(), CHUNKS * POLY), waves, seed=0)
    n = len(cells)
    xy = torch.from_numpy(cells).to(dev)
    launches = cv.oncurve_mask.launches
    got, ref = cv.oncurve_mask(xy), cv.oncurve_mask_plain(xy)
    torch.cuda.synchronize()
    mask = got.cpu().numpy()
    sample = np.random.default_rng(1).choice(n, min(n, 20_000), replace=False)
    canon, full = prim._cell_canonical_mask(cells[sample][None])
    try:
        ones = torch.ones(2, 2, dtype=torch.int64, device=dev)
        int64_matmul = f"runs: {(ones @ ones).tolist()}"
    except RuntimeError as e:
        int64_matmul = str(e).splitlines()[0]
    row = {"cells": n, "waves": waves,
           "mismatches": int((got != ref).sum()),
           "max_abs_err": float((got.int() - ref.int()).abs().max()),
           "on_curve": int(mask.sum()),
           "valid_kinds_all_true": {k: bool(mask[i].all())
                                    for k, i in valid_kinds.items()},
           "oracle_sample_agrees": bool(np.array_equal(mask[sample] & canon[0],
                                                       full[0])),
           "int64_matmul_on_card": int64_matmul,
           "ms": time_ms(lambda: cv.oncurve_mask(xy)),
           "plain_ms": time_ms(lambda: cv.oncurve_mask_plain(xy))}
    row["launches"] = cv.oncurve_mask.launches - launches  # 1 + timing
    # the kernel alone, without the wrapper's flag fill and read-back
    lib, stream = _build.load("oncurve"), torch.cuda.current_stream().cuda_stream
    out = torch.empty(n, dtype=torch.bool, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    row["kernel_only_ms"] = time_ms(lambda: lib.oncurve_mask_i64(
        xy.data_ptr(), out.data_ptr(), flag.data_ptr(), n, stream))
    if not torch.equal(out, got) or int(flag):
        raise AssertionError("the on-curve kernel's direct launch disagrees "
                             "with its wrapper")
    row["bound_ms"], row["bound_by"], row["bound_counts"] = oncurve_bound(n, mix)
    row["seconds"] = time.perf_counter() - t_phase
    emit("crypto_kernel", **row)
    if row["mismatches"]:
        raise AssertionError(f"on-curve kernel disagrees with its plain "
                             f"version on {row['mismatches']} cells")
    if not all(row["valid_kinds_all_true"].values()):
        raise AssertionError("on-curve mask is False on a cell that lies on "
                             "the curve")
    if not row["oracle_sample_agrees"]:
        raise AssertionError("on-curve kernel disagrees with the python-int "
                             "oracle")
    return row


def crypto_phase(dev, grid: np.ndarray, a, b) -> dict:
    """The device crypto plane in VssIntakeBatch's order at full width,
    then card vs CPU, times and a profile of the settle's msm."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from biscotti_tpu_torch.crypto import ed25519 as ed
    from biscotti_tpu_torch.crypto.commitments import _xy_to_point
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
    from biscotti_tpu_torch.crypto.kernels import group as gp
    from biscotti_tpu_torch.crypto.kernels import primitives as prim

    t_phase = time.perf_counter()
    n = CHUNKS * POLY
    i_flip, i_nc = n // 5, 4 * n // 5  # one bad cell in each bad grid
    flip = grid.reshape(n, 64).copy()
    flip[i_flip, 0] ^= 1  # low bit of the cell's x: off the curve
    noncanon = grid.reshape(n, 64).copy()
    x = int.from_bytes(noncanon[i_nc, :32].tobytes(), "little")
    noncanon[i_nc, :32] = np.frombuffer((x + ed.P).to_bytes(32, "little"),
                                        np.uint8)
    if _xy_to_point(flip[i_flip].tobytes()) is not None \
            or _xy_to_point(noncanon[i_nc].tobytes()) is not None:
        raise AssertionError("the bad cells pass the CPU loader")
    bad = (5, 20)
    wave1 = [grid] * WAVE
    wave1[bad[0]], wave1[bad[1]] = flip, noncanon
    wave2 = [grid] * WAVE
    rng = np.random.default_rng(2)
    # RLC-shaped settle scalars: 8·v mod q, as VssIntakeBatch.verify forms
    gam = [(8 * int.from_bytes(rng.bytes(32), "little")) % ed.Q
           for _ in range(n)]

    # the intake, launches counted from 0: two wave folds and the settle
    os.environ["BISCOTTI_PALLAS_CRYPTO"] = "1"
    cv.oncurve_mask.launches = 0
    t0 = time.perf_counter()
    mask1, summed1 = prim.grid_validate_sum(wave1)
    wave1_launches = cv.oncurve_mask.launches
    mask2, summed2 = prim.grid_validate_sum(wave2)
    acc = prim.ext_add(summed1, summed2)
    m = int(mask1.sum()) + int(mask2.sum())
    rhs = prim.msm(gam, acc)
    lhs = prim.pedersen_commit_point(m * sum(g * s for g, s in zip(gam, a)),
                                     m * sum(g * s for g, s in zip(gam, b)))
    settled = ed.point_equal(lhs, rhs)
    intake_s = time.perf_counter() - t0
    launches = cv.oncurve_mask.launches
    gam_bad = list(gam)
    gam_bad[17] = (gam_bad[17] + 1) % ed.Q
    perturbed = ed.point_equal(lhs, prim.msm(gam_bad, acc))

    # card against the CPU port on a small wave (the switch still on)
    ns = min(64, n)
    small = grid.reshape(n, 64)[:ns].copy()
    small_bad = small.copy()
    small_bad[ns // 2, 40] ^= 2  # a bit of one cell's y
    wave_s = [small, small_bad, small]
    gm, gs = prim.grid_validate_sum(wave_s)
    cmask, cs = prim.grid_validate_sum(wave_s, device="cpu")
    ga, ca = prim.ext_add(gs, gs), prim.ext_add(cs, cs, device="cpu")
    parity = {"mask_equal": bool(np.array_equal(gm, cmask)),
              "summed_equal": bool(np.array_equal(gs, cs)),
              "ext_add_equal": bool(np.array_equal(ga, ca)),
              "msm_equal": prim.msm(gam[:ns], ga) == prim.msm(gam[:ns], ca,
                                                               device="cpu"),
              "mask": gm.tolist()}

    # times (host clock, median of 3; each call ends in a host copy)
    times = {}
    os.environ.pop("BISCOTTI_PALLAS_CRYPTO")
    times["fold_switch_off_s"] = host_s(lambda: prim.grid_validate_sum(wave2))[0]
    os.environ["BISCOTTI_PALLAS_CRYPTO"] = "1"
    times["fold_switch_on_s"] = host_s(lambda: prim.grid_validate_sum(wave2))[0]
    os.environ.pop("BISCOTTI_PALLAS_CRYPTO")
    xy2 = np.stack([gp.xy_bytes_to_limbs(g.tobytes(), n) for g in wave2])
    times["host_oracle_s"] = host_s(lambda: prim._cell_canonical_mask(xy2))[0]
    times["fold_switch_on_minus_oracle_s"] = (times["fold_switch_on_s"]
                                              - times["host_oracle_s"])
    times["ext_add_s"] = host_s(lambda: prim.ext_add(summed1, summed2))[0]
    times["msm_s"] = host_s(lambda: prim.msm(gam, acc))[0]
    times["pedersen_commit_point_s"] = host_s(
        lambda: prim.pedersen_commit_point(gam[0], gam[1]))[0]
    times["fixed_base_mult_s"] = host_s(lambda: prim.fixed_base_mult(a, "B"))[0]
    xs = np.arange(SHARES) - 10  # share points as ss.share_xs makes them
    vander = xs[:, None] ** np.arange(POLY)[None, :]
    pinv = np.linalg.pinv(vander.astype(np.float64))
    coeffs = rng.integers(-10**4, 10**4, (CHUNKS, POLY))
    times["shamir_recover_s"], recovered = host_s(
        lambda: prim.shamir_recover(pinv, vander @ coeffs.T))

    # one profiled msm: the 256-step ladder's device time and launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prim.msm(gam, acc)
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:5]
    msm_profile = {
        "device_ms": device_ms,
        "kernel_launches": sum(e.count for e in on_device),
        "device_idle_share": 1.0 - device_ms / (1e3 * times["msm_s"]),
        "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in top]}

    row = {"points": n, "wave": WAVE, "padded_waves":
           prim._pow2(WAVE, prim.GRID_MIN_WAVES), "msm_lanes":
           prim._pow2(n, prim.MSM_MIN_LANES),
           "wave1_mask_false": [int(i) for i in np.flatnonzero(~mask1)],
           "wave2_all_true": bool(mask2.all()), "valid_members": m,
           "oncurve_launches": launches, "wave1_launches": wave1_launches,
           "settled": settled, "perturbed_settles": perturbed,
           "intake_s": intake_s, "card_vs_cpu": parity,
           "shamir_exact": bool(np.array_equal(recovered, coeffs)),
           "times": times, "msm_profile": msm_profile,
           "seconds": time.perf_counter() - t_phase}
    emit("crypto", **row)
    if row["wave1_mask_false"] != list(bad) or not row["wave2_all_true"]:
        raise AssertionError("grid validation evicted the wrong grids")
    if wave1_launches != 1 or launches != 2:
        raise AssertionError(f"the on-curve kernel launched {wave1_launches} "
                             f"times in the first fold and {launches} in the "
                             "intake, not once per fold")
    if not settled or perturbed:
        raise AssertionError("the settle does not hold the RLC equation")
    if not all(v for k, v in parity.items() if k != "mask") \
            or parity["mask"] != [True, False, True]:
        raise AssertionError("card and CPU port disagree on the crypto plane")
    if not row["shamir_exact"]:
        raise AssertionError("shamir_recover is not exact")
    return row


def _settled_intake(members, waves, xs, rows, ent):
    """One miner intake through `VssIntakeBatch`: add each wave's members,
    fold it, then settle. Returns (rejected sids a fold, B2 launches a
    fold, settle, members, seconds a fold, settle seconds). Host clock
    after a synchronize."""
    import torch

    from biscotti_tpu_torch.crypto import commitments as cm
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv

    acc = cm.VssIntakeBatch(rows, CHUNKS, POLY, entropy=ent)
    rejected, per_fold, fold_s = [], [], []
    for wave in waves:
        for sid in wave:
            if not acc.add(sid, *members[sid]):
                raise AssertionError(f"intake refused worker {sid} at add")
        before = cv.oncurve_mask.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rejected.append(acc.fold())
        torch.cuda.synchronize()
        fold_s.append(time.perf_counter() - t0)
        per_fold.append(cv.oncurve_mask.launches - before)
    t0 = time.perf_counter()
    settled = acc.verify(xs)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    return (rejected, per_fold, settled, sorted(acc.members()), fold_s,
            settle_s)


def secagg_phase(dev) -> dict:
    """The secure-aggregation plane at the bench's mnist_100_dp_eps1 width
    (d = 7,850, C = 785, k = 10, N = 100, S = 70) with the reference
    protocol's r = 2 layout (3 miners, 21 shares, 7 rows a miner): one
    worker's quantize → commitments → blind rows → shares (timed), 35
    seeded workers (one grid with a single off-curve cell), miner 0's
    intake through VssIntakeBatch in two waves with the plane armed on the
    card (B2 on, once a fold) and disarmed (native), a second batch with a
    corrupted share row, and recovery armed and disarmed."""
    from dataclasses import replace

    import torch

    from biscotti_tpu_torch import bench
    from biscotti_tpu_torch.crypto import _native
    from biscotti_tpu_torch.crypto import commitments as cm
    from biscotti_tpu_torch.crypto import kernels
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
    from biscotti_tpu_torch.ops import secretshare as ss

    t_phase = time.perf_counter()
    if not _native.available():
        raise AssertionError(f"native EC library did not load: "
                             f"{_native.load_error()}")
    cfg = replace(bench.config("mnist_100_dp_eps1"), share_redundancy=2.0)
    d, k, total = CHUNKS * POLY, cfg.poly_size, cfg.total_shares
    sl = ss.miner_rows(total, 0, cfg.num_miners)
    rows = sl.stop - sl.start
    xs_all = [int(x) for x in ss.share_xs(total)]
    rng = np.random.default_rng(5)
    updates = rng.normal(0.0, 0.01, (WAVE, d)).astype(np.float32)

    def worker(sid: int, update):
        q = ss.quantize(update)
        comms, blinds = cm.vss_commit_chunks(
            ss.to_chunks(q, k), bytes([sid]) * 32, b"secagg-round")
        return q, comms, cm.vss_blind_rows(blinds, xs_all), \
            ss.make_shares(q, k, total)

    # the others first: worker 0 is timed with the native comb tables warm
    rest = [worker(sid, updates[sid]) for sid in range(1, WAVE)]
    card_update = torch.from_numpy(updates[0]).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    made = [worker(0, card_update)] + rest
    worker_s = time.perf_counter() - t0
    bad_sid, cell = 11, (CHUNKS // 2, 3)
    made[bad_sid][1][cell][0] ^= 1  # low bit of one cell's x: off the curve
    if cm._xy_to_point(made[bad_sid][1][cell].tobytes()) is not None:
        raise AssertionError("the flipped cell is still on the curve")
    members = {sid: (c, sh[sl], br[sl]) for sid, (_, c, br, sh)
               in enumerate(made)}
    honest = [sid for sid in range(WAVE) if sid != bad_sid]
    waves = [list(range(WAVE // 2 + 1)), list(range(WAVE // 2 + 1, WAVE))]
    ent = rng.bytes(16 * rows * CHUNKS)
    xs = xs_all[sl]
    corrupt = dict(members)
    c_rows = members[3][1].copy()
    c_rows[2, CHUNKS // 8] += 1
    corrupt[3] = (members[3][0], c_rows, members[3][2])

    # the plane's one-time costs, outside the intake's counts
    os.environ["BISCOTTI_PALLAS_CRYPTO"] = "1"
    kernels.set_enabled(True)
    try:
        t0 = time.perf_counter()
        kernels.prewarm(d)
        prewarm_s = time.perf_counter() - t0
        cv.oncurve_mask.launches = 0
        card = _settled_intake(members, waves, xs, rows, ent)
        card_bad = _settled_intake(corrupt, [honest], xs, rows, ent)
        b2_launches = cv.oncurve_mask.launches
        agg = ss.aggregate_shares(np.stack([made[s][3] for s in honest]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec_card = ss.recover_update(agg, xs_all, d)
        rec_card_s = time.perf_counter() - t0
    finally:
        kernels.set_enabled(False)
        os.environ.pop("BISCOTTI_PALLAS_CRYPTO")
    cpu = _settled_intake(members, waves, xs, rows, ent)
    cpu_bad = _settled_intake(corrupt, [honest], xs, rows, ent)
    t0 = time.perf_counter()
    rec_cpu = ss.recover_update(agg, xs_all, d)
    rec_cpu_s = time.perf_counter() - t0
    want = np.sum([made[s][0] for s in honest], axis=0).astype(np.float64) \
        / 10.0 ** cfg.precision

    def run_row(r):
        return {"rejected": r[0], "b2_launches_per_fold": r[1],
                "settled": r[2], "members": len(r[3]), "fold_s": r[4],
                "settle_s": r[5]}

    row = {"d": d, "chunks": CHUNKS, "poly": POLY, "total_shares": total,
           "rows_per_miner": rows, "workers": WAVE, "waves": [len(w) for w
                                                              in waves],
           "bad_sid": bad_sid, "native_loaded": True,
           "worker_s": worker_s, "prewarm_s": prewarm_s,
           "card": run_row(card), "cpu_native": run_row(cpu),
           "corrupted_row": {"card": run_row(card_bad),
                             "cpu_native": run_row(cpu_bad)},
           "b2_launches": b2_launches,
           "recover_card_exact": bool(np.array_equal(rec_card, want)),
           "recover_cpu_exact": bool(np.array_equal(rec_cpu, want)),
           "recover_card_s": rec_card_s, "recover_cpu_s": rec_cpu_s,
           "nvidia_smi": bench.card_line(),
           "seconds": time.perf_counter() - t_phase}
    emit("secagg", **row)
    for a, b in ((card, cpu), (card_bad, cpu_bad)):
        if (a[0], a[2], a[3]) != (b[0], b[2], b[3]):
            raise AssertionError("card and CPU intakes disagree")
    if card[0] != [[bad_sid], []] or card_bad[0] != [[]]:
        raise AssertionError(f"the intake evicted {card[0]}, not [{bad_sid}] "
                             "at the first fold")
    if card[1] != [1, 1] or card_bad[1] != [1] or b2_launches != 3:
        raise AssertionError(f"B2 launched {card[1]} + {card_bad[1]} times, "
                             "not once a fold")
    if cpu[1] != [0, 0] or cpu_bad[1] != [0]:
        raise AssertionError("B2 launched on the disarmed intake")
    if not card[2] or card[3] != honest or card_bad[3] != honest:
        raise AssertionError("the honest intake did not settle True")
    if card_bad[2] or cpu_bad[2]:
        raise AssertionError("a corrupted share row settled True")
    if not (row["recover_card_exact"] and row["recover_cpu_exact"]):
        raise AssertionError("recover_update is not Σq / 10^4 exactly")
    return row


# the CNN families and the datasets they run on (biscotti_tpu_torch/models/zoo.py)
CNNS = [("mnist_cnn", "mnist", 164_266), ("cifar_cnn", "cifar", 62_006),
        ("lfw_cnn", "lfw", 133_000)]
# eval/eval_sim_scale.py's largest row, the main configuration
MAIN = dict(dataset="mnist", num_nodes=1024, sample_percent=0.70,
            verification=True, noising=True, epsilon=1.0, batch_size=10,
            poison_fraction=0.3, seed=0)


def close_to(got, ref, rtol: float = RTOL) -> bool:
    """got within rtol of ref, with atol rtol·max|ref| (float32 sums in
    another order on the card)."""
    import torch

    got, ref = got.cpu(), ref.cpu()
    return bool(torch.allclose(got, ref, rtol=rtol,
                               atol=rtol * float(ref.abs().max())))


def round_card_vs_cpu(card, cpu, w, stake, draws) -> dict:
    """One round from the same weights and draws on the card and on the
    CPU port: masks and stakes must be equal and w within RTOL."""
    import torch

    g = card.round_step_from_draws(w, stake, *draws)
    c = cpu.round_step_from_draws(w.cpu(), stake.cpu(), *(t.cpu() for t in draws))
    row = {"mask_equal": bool(torch.equal(g[2].cpu(), c[2])),
           "stake_equal": bool(torch.equal(g[1].cpu(), c[1])),
           "w_equal_within_rtol": close_to(g[0], c[0]),
           "w_max_abs_diff": float((g[0].cpu() - c[0]).abs().max()),
           "accepted": int(g[2].sum()), "err_card": float(g[3]),
           "err_cpu": float(c[3])}
    if not (row["mask_equal"] and row["stake_equal"]
            and row["w_equal_within_rtol"]):
        raise AssertionError(f"card and CPU rounds disagree: {row}")
    return row


def models_phase(dev) -> dict:
    """Each CNN family on the card against the CPU port, from flat_init
    weights: the forward pass and the simulator's per-contributor step
    (S = 8, batch 10, `Simulator.local_updates`), with the TF32 switches of
    matmuls and cuDNN on outside it: the step must turn them off itself."""
    from dataclasses import replace

    import torch

    from biscotti_tpu_torch.config import BiscottiConfig
    from biscotti_tpu_torch.models.base import fp32_math
    from biscotti_tpu_torch.models.zoo import MODELS
    from biscotti_tpu_torch.parallel.sim import Simulator

    t_phase = time.perf_counter()
    rows = []
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        for family, dataset, params in CNNS:
            model = MODELS[family](dataset)
            seen = []

            def loss(w, x, y, _loss=model.loss_flat, _seen=seen):
                _seen.append((torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32))
                return _loss(w, x, y)

            probe = replace(model, loss_flat=loss)
            cfg = BiscottiConfig(dataset=dataset, model_name=family,
                                 num_nodes=14, noising=False, seed=0)  # S = 8
            card = Simulator(cfg, model=probe)
            cpu = Simulator(cfg, device="cpu", model=probe)
            w = model.flat_init(torch.Generator().manual_seed(1))
            cidx, bidx, noise, _ = cpu.draw_round(cpu.gen, 0)
            on_card = [t.to(dev) for t in (w, cidx, bidx, noise)]
            d_card = card.local_updates(*on_card)[0]
            d_again = card.local_updates(*on_card)[0]
            d_cpu = cpu.local_updates(w, cidx, bidx, noise)[0]
            torch.cuda.synchronize()
            with fp32_math():
                logits = model.apply_flat(on_card[0], card.x_val[:256])
            ref_logits = model.apply_flat(w, cpu.x_val[:256])
            rows.append({
                "family": family, "num_params": model.num_params,
                "contributors": int(cidx.shape[0]), "batch": cfg.batch_size,
                "logits_equal_within_rtol": close_to(logits, ref_logits),
                "logits_max_abs_diff": float((logits.cpu() - ref_logits).abs().max()),
                "step_equal_within_rtol": close_to(d_card, d_cpu),
                "step_max_abs_diff": float((d_card.cpu() - d_cpu).abs().max()),
                "step_max_abs": float(d_cpu.abs().max()),
                "matmul_allow_tf32_in_step": sorted({m for m, _ in seen}),
                "cudnn_allow_tf32_in_step": sorted({c for _, c in seen}),
                "step_bit_identical": bool(torch.equal(d_card, d_again))})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    emit("models", families=rows, seconds=time.perf_counter() - t_phase)
    for (family, _, params), row in zip(CNNS, rows):
        if row["num_params"] != params:
            raise AssertionError(f"{family}: {row['num_params']} parameters")
        if not (row["logits_equal_within_rtol"] and row["step_equal_within_rtol"]):
            raise AssertionError(f"{family}: card and CPU disagree: {row}")
        if row["matmul_allow_tf32_in_step"] != [False] \
                or row["cudnn_allow_tf32_in_step"] != [False]:
            raise AssertionError(f"{family}: the step ran with TF32 on")
    return {"families": rows}


def defenses_phase(dev) -> dict:
    """One round of each defense at the main configuration: a warm round,
    3 timed rounds, then one round's draws on the card and on the CPU
    port. B1 must launch once a round under KRUM and MULTIKRUM, and never
    under the others."""
    import torch

    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.parallel.sim import Simulator

    kern = krum_cuda.krum_scores_kernel
    t_phase = time.perf_counter()
    rows, launches = {}, 0
    for d in (Defense.KRUM, Defense.MULTIKRUM, Defense.FOOLSGOLD, Defense.RONI,
              Defense.TRIMMED_MEAN, Defense.NONE, Defense.ENSEMBLE):
        cfg = BiscottiConfig(defense=d, secure_agg=d != Defense.TRIMMED_MEAN,
                             **MAIN)
        sim = Simulator(cfg)
        w, stake = sim.init_state()
        w, stake, _, _ = sim.round_step(w, stake, 0)  # warm
        torch.cuda.synchronize()
        per_round, ms = [], []
        for it in range(1, 4):
            before = kern.launches
            t0 = time.perf_counter()
            w, stake, mask, err = sim.round_step(w, stake, it)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            per_round.append(kern.launches - before)
        launches += sum(per_round)
        want = 1 if d in (Defense.KRUM, Defense.MULTIKRUM) else 0
        row = {"round_ms": ms, "round_ms_median": statistics.median(ms),
               "b1_launches_per_round": per_round, "accepted": int(mask.sum()),
               "error": float(err)}
        cpu = Simulator(cfg, device="cpu")
        row["card_vs_cpu"] = round_card_vs_cpu(sim, cpu, w, stake,
                                               sim.draw_round(sim.gen, 4))
        rows[d.value] = row
        del sim, cpu
        if per_round != [want] * 3:
            raise AssertionError(f"{d.value}: B1 launched {per_round} times in "
                                 f"3 rounds, not {want} a round")
    emit("defenses", nodes=MAIN["num_nodes"], defenses=rows, b1_launches=launches,
         seconds=time.perf_counter() - t_phase)
    return {"defenses": rows, "b1_launches": launches}


def cnn_phase(dev) -> dict:
    """The mnist CNN at the main configuration's scale (d = 164,266): 2 warm
    and 5 timed rounds with B1 once a round at (716, 164266), B1 against
    its plain version on one round's noised updates from flat_init
    weights, and a torch.profiler window (`device_trace`) over 3 rounds."""
    import tempfile

    import torch

    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.ops.krum import default_num_adversaries
    from biscotti_tpu_torch.parallel.sim import Simulator
    from biscotti_tpu_torch.utils.profiling import device_trace

    kern, plain = krum_cuda.krum_scores_kernel, krum_cuda.krum_scores_plain
    t_phase = time.perf_counter()
    cfg = BiscottiConfig(defense=Defense.KRUM, model_name="mnist_cnn", **MAIN)
    t0 = time.perf_counter()
    sim = Simulator(cfg)
    setup_s = time.perf_counter() - t0
    s, n = cfg.num_samples, sim.num_params
    f = default_num_adversaries(s)
    w, stake = sim.init_state()
    for it in range(2):
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
            raise AssertionError(f"cnn round {it} launched B1 "
                                 f"{kern.launches - before} times, not once")
    launches = kern.launches
    if not (w.shape == (n,) and bool(torch.isfinite(w).all())):
        raise AssertionError("cnn path: w is not finite or has the wrong shape")
    if int(mask.sum()) != s - f:
        raise AssertionError(f"cnn path: {int(mask.sum())} accepted, not {s - f}")

    # B1 against its plain version on one round's noised updates
    w0 = sim.model.flat_init(torch.Generator(device=dev).manual_seed(3))
    cidx, bidx, noise, _ = sim.draw_round(sim.gen, 7)
    deltas, noised = sim.local_updates(w0, cidx, bidx, noise)
    got, ref = kern(noised, f), plain(noised, f)
    torch.cuda.synchronize()
    err_rel = rel_err(got, ref)
    kernel = {"n": s, "d": n, "max_abs_err": float((got - ref).abs().max()),
              "max_rel_err": err_rel,
              "accept_set_identical": accept_set(got, s - f) == accept_set(ref, s - f),
              "boundary_rel_gap": boundary_rel_gap(ref, s - f),
              **krum_times(noised, f)}
    kernel["rel_err_over_half_gap"] = err_rel / (kernel["boundary_rel_gap"] / 2)
    if not err_rel < kernel["boundary_rel_gap"] / 2:
        truth = krum_scores_fp64(noised, f)
        kernel["kernel_vs_fp64_rel_err"] = rel_err(got.double(), truth)
        kernel["plain_vs_fp64_rel_err"] = rel_err(ref.double(), truth)
    # the ledger phase's plain-mode block: the first LEDGER_CNN_ROWS
    # accepted contributors of this round, their ids and updates
    accepted = sorted(accept_set(got, s - f))[:LEDGER_CNN_ROWS]
    ledger_rows = {"ids": cidx[accepted].tolist(),
                   "rows": deltas[accepted].double().cpu().numpy(),
                   "w": w.double().cpu().numpy()}
    del deltas, noised, noise

    # where a round's time goes
    prof_rounds = 3
    with tempfile.TemporaryDirectory() as log_dir:
        t0 = time.perf_counter()
        with device_trace(log_dir) as prof:
            pw, pstake = w, stake
            for it in range(7, 7 + prof_rounds):
                pw, pstake, _, _ = sim.round_step(pw, pstake, it)
        host_ms = 1e3 * (time.perf_counter() - t0) / prof_rounds
        trace_mb = os.path.getsize(os.path.join(log_dir, "trace.json")) / 2**20
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3 / prof_rounds
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]
    profile_row = {
        "rounds": prof_rounds, "device_ms_per_round": device_ms,
        "host_ms_per_round_profiled": host_ms,
        "device_idle_share": 1.0 - device_ms / statistics.median(round_ms),
        "kernels_per_round": sum(e.count for e in on_device) / prof_rounds,
        "trace_mb": trace_mb,
        "top": [{"name": e.key[:100],
                 "ms_per_round": e.self_device_time_total / 1e3 / prof_rounds,
                 "calls_per_round": e.count / prof_rounds} for e in top]}
    emit("cnn", model="mnist_cnn", nodes=cfg.num_nodes, contributors=s,
         params=n, update_gb=4.0 * s * n / 1e9, setup_s=setup_s,
         round_ms=round_ms, round_ms_median=statistics.median(round_ms),
         b1_launches=launches, accepted=int(mask.sum()), error=float(err),
         kernel=kernel, profile=profile_row,
         seconds=time.perf_counter() - t_phase)
    if not (err_rel < RTOL and kernel["accept_set_identical"]):
        raise AssertionError("B1 disagrees with plain at the mnist CNN width")
    # below half the boundary gap, or (where the plain version's own error
    # against float64 exceeds that) no less exact than plain
    if "kernel_vs_fp64_rel_err" in kernel and not (
            kernel["plain_vs_fp64_rel_err"] > kernel["boundary_rel_gap"] / 2
            and kernel["kernel_vs_fp64_rel_err"]
            <= EXACT_SLACK * kernel["plain_vs_fp64_rel_err"]):
        raise AssertionError(f"B1 error at the mnist CNN width: {kernel}")
    return {"kernel": kernel, "b1_launches": launches,
            "ledger_rows": ledger_rows}


def bench_phase(dev) -> dict:
    """The eight BASELINE rows through `biscotti_tpu_torch.bench`, then one
    round of each CNN row on the card and on the CPU port, on the same
    draws, from flat_init weights."""
    import torch

    from biscotti_tpu_torch import bench
    from biscotti_tpu_torch.parallel.sim import Simulator

    t_phase = time.perf_counter()
    out = bench.run(device=dev)
    parity = {}
    for name in ("cifar_lenet_100_krum_secagg", "mnist_cnn_100_krum_secagg",
                 "lfw_cnn_100_krum_secagg"):
        cfg = bench.config(name)
        card, cpu = Simulator(cfg), Simulator(cfg, device="cpu")
        w = card.model.flat_init(torch.Generator(device=dev).manual_seed(4))
        stake = card.init_state()[1]
        parity[name] = round_card_vs_cpu(card, cpu, w, stake,
                                         card.draw_round(card.gen, 0))
        del card, cpu
    emit("bench", **out, card_vs_cpu=parity, seconds=time.perf_counter() - t_phase)
    crypto_keys = ("worker_crypto_s", "miner_fold_s", "miner_crypto_s",
                   "miner_crypto_oneshot_s", "recovery_s", "round_total_s",
                   "round_total_pipelined_s")
    for name, row in out["rows"].items():
        if not (0 < row["wire_bytes_per_round_f32_zlib"]
                < row["wire_bytes_per_round"]
                and 0 < row["cross_host_bytes_per_round_overlay"]
                < row["cross_host_bytes_per_round"]
                and row["wire_compression_x"] >= 1.0
                and row["overlay_cross_host_saving_x"] >= 1.0):
            raise AssertionError(f"bench row {name}'s byte columns: {row}")
        if not (row["device_round_s"] > 0 and 0.0 <= row["final_error"] <= 1.0):
            raise AssertionError(f"bench row {name}: {row}")
        if not (row["share_pipeline_roundtrip_ok"] is True
                and all(row[k] > 0 for k in crypto_keys)):
            raise AssertionError(f"bench row {name}'s crypto half: {row}")
    if "miner_crypto_device_s" not in out["rows"]["creditcard_10"] \
            or out["headline"]["value"] <= 0 or not out["native_ec_plane"]:
        raise AssertionError("bench: no device settle on creditcard_10, no "
                             "headline, or not on the native EC plane")
    return out


def trainer_phase(dev) -> dict:
    """The per-peer Trainer on the card against the CPU port (mnist softmax
    and mnist_cnn, flat_init weights, the card's own batch rows fed to the
    CPU's pure step), one private_fun's time, and mcmc13 Trainers at
    d = 7,850 and 164,266: acceptance, mean row norm against 2d/ε, and the
    presample's time."""
    import torch

    from biscotti_tpu_torch.config import BiscottiConfig
    from biscotti_tpu_torch.models.trainer import Trainer
    from biscotti_tpu_torch.ops import dp_noise

    t_phase = time.perf_counter()
    api = {}
    for model_name, shard in (("", "mnist3"), ("mnist_cnn", "mnist1")):
        cfg = BiscottiConfig(dataset="mnist", model_name=model_name, seed=0)
        card = Trainer("mnist", shard, cfg=cfg)
        cpu = Trainer("mnist", shard, cfg=cfg, device="cpu")
        w = card.model.flat_init(torch.Generator().manual_seed(3)).numpy()
        delta = card.private_fun(w, 0)
        ref = cpu.private_fun_from_batch(w, card.batch_indices(0).cpu())
        times = []
        for it in range(6):
            t0 = time.perf_counter()
            card.private_fun(w, it)
            times.append(1e3 * (time.perf_counter() - t0))
        n_train, n_test = len(cpu.x_train), len(cpu.x_test)
        n_attack = len(cpu.x_attack)
        gaps = {"train_error": (card.train_error(w) - cpu.train_error(w)) * n_train,
                "test_error": (card.test_error(w) - cpu.test_error(w)) * n_test,
                "attack_rate": (card.attack_rate(w) - cpu.attack_rate(w)) * n_attack,
                "attack_success_rate": (card.attack_success_rate(w)
                                        - cpu.attack_success_rate(w)) * n_attack,
                "roni": (card.roni(w, delta) - cpu.roni(w, delta)) * n_train}
        row = {"model": card.model.name, "params": card.num_params,
               "private_fun_equal_within_rtol": close_to(
                   torch.from_numpy(delta), torch.from_numpy(ref)),
               "private_fun_max_abs_diff": float(np.abs(delta - ref).max()),
               "metric_gaps_in_samples": gaps,
               "private_fun_ms": statistics.median(times[1:]),
               "noise_finite": bool(np.isfinite(card.get_noise(3)).all())}
        api[row["model"]] = row
        if not row["private_fun_equal_within_rtol"] or not row["noise_finite"]:
            raise AssertionError(f"Trainer card vs CPU: {row}")
        if max(abs(g) for g in gaps.values()) > 2.0 + 1e-3:
            raise AssertionError(f"Trainer metrics differ by more than a "
                                 f"sample or two: {gaps}")
    mcmc = {}
    for model_name in ("", "mnist_cnn"):
        cfg = BiscottiConfig(dataset="mnist", model_name=model_name,
                             dp_mechanism="mcmc13", noise_presample_iters=100,
                             epsilon=1.0, seed=0)
        t0 = time.perf_counter()
        tr = Trainer("mnist", "mnist0", cfg=cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        d = tr.num_params
        gen = torch.Generator(device=dev).manual_seed(1)
        presample_s, _ = host_s(lambda: (dp_noise.mcmc_presample(gen, 1.0, 100, d),
                                         torch.cuda.synchronize()))
        norms = torch.linalg.vector_norm(tr.noise_samples.double(), dim=1)
        want = 2.0 * d / cfg.epsilon
        row = {"d": d, "rows": int(tr.noise_samples.shape[0]),
               "walkers": dp_noise.mcmc_walkers(100),
               "accept_rate": tr.noise_accept_rate,
               "mean_row_norm": float(norms.mean()), "law_mean": want,
               "mean_rel_dev": float(norms.mean()) / want - 1.0,
               "trainer_build_s": build_s, "presample_s": presample_s}
        mcmc[str(d)] = row
        if abs(row["mean_rel_dev"]) > 0.01 or not 0.15 < row["accept_rate"] < 0.35:
            raise AssertionError(f"mcmc13 presample off its law: {row}")
    emit("trainer", api=api, mcmc13=mcmc, seconds=time.perf_counter() - t_phase)
    return {"api": api, "mcmc13": mcmc}


def _chunk_frames(frame: bytes) -> int:
    """Frames on the wire in one encoded message: 1, or its chunk run."""
    import struct

    off, n = 0, 0
    while off < len(frame):
        (ln,) = struct.unpack(">I", frame[off:off + 4])
        off, n = off + 4 + ln, n + 1
    return n


def _reassembled(frame: bytes) -> bytes:
    """The payload of one encoded message, its chunk run reassembled."""
    import struct

    from biscotti_tpu_torch.runtime import messages as msgs

    if frame[4:8] != msgs.CHUNK_MAGIC:
        return frame[4:]
    out, off = [], 0
    while off < len(frame):
        (ln,) = struct.unpack(">I", frame[off:off + 4])
        out.append(frame[off + 4 + msgs.CHUNK_OVERHEAD:off + 4 + ln])
        off += 4 + ln
    return b"".join(out)


def ledger_phase(dev, sim, w, stake, cnn_rows: dict, first_round: int) -> dict:
    """The ledger and wire plane on the card's own outputs: LEDGER_ROUNDS
    rounds of `sim` (the main configuration) sealed into secure-agg blocks
    on a Blockchain of its nodes, one plain-mode mnist_cnn block of
    `cnn_rows` on a chain of its own, every block sent through the port's
    Pool to the port's RPCServer under each of LEDGER_CODECS, a checkpoint
    round trip, and the bench's byte columns for the configuration.
    Returns the phase's row (with B1's launches in its rounds)."""
    import asyncio
    import hashlib
    import tempfile

    import torch

    from biscotti_tpu_torch import bench
    from biscotti_tpu_torch.ledger.block import Block, BlockData, Update
    from biscotti_tpu_torch.ledger.chain import Blockchain, ChainInvariantError
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.runtime import codecs as wcodecs
    from biscotti_tpu_torch.runtime import messages as msgs
    from biscotti_tpu_torch.runtime import rpc
    from biscotti_tpu_torch.runtime import wire
    from biscotti_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    cfg = sim.cfg
    f32 = wcodecs.get("f32+zlib")

    # the card's rounds, each sealed and appended
    main_chain = Blockchain(sim.num_params, cfg.num_nodes, cfg.default_stake)
    kern = krum_cuda.krum_scores_kernel
    kern.launches = 0
    seal_s, accepted = [], 0
    for it in range(first_round, first_round + LEDGER_ROUNDS):
        draws = sim.draw_round(sim.gen, it)
        deltas, _ = sim.local_updates(w, *draws[:3])
        w, stake, mask, _ = sim.round_step_from_draws(w, stake, *draws)
        ids = draws[0][mask].tolist()
        rows = deltas[mask].cpu().numpy()
        t0 = time.perf_counter()
        blk = Block(
            data=BlockData(iteration=main_chain.next_iteration,
                           global_w=f32.transform_dense(w.double().cpu().numpy()),
                           deltas=[Update(source_id=int(c), iteration=it,
                                          delta=np.zeros(0, np.float64),
                                          commitment=hashlib.sha256(
                                              r.tobytes()).digest(),
                                          accepted=True)
                                   for c, r in zip(ids, rows)]),
            prev_hash=main_chain.latest_hash(),
            stake_map={i: int(v) for i, v in enumerate(stake.tolist())}).seal()
        if not main_chain.consider_block(blk):
            raise AssertionError(f"the card's round {it} did not append")
        seal_s.append(time.perf_counter() - t0)
        accepted = len(ids)
    b1_launches = kern.launches
    w64 = w.double().cpu().numpy()

    # the plain-mode mnist_cnn block, on a chain of its own
    d_cnn = cnn_rows["rows"].shape[1]
    cnn_chain = Blockchain(d_cnn, cfg.num_nodes, cfg.default_stake)
    cnn_blk = Block(
        data=BlockData(iteration=0, global_w=f32.transform_dense(cnn_rows["w"]),
                       deltas=[Update(source_id=int(c), iteration=0, delta=r,
                                      commitment=hashlib.sha256(
                                          r.tobytes()).digest(), accepted=True)
                               for c, r in zip(cnn_rows["ids"],
                                               cnn_rows["rows"])]),
        prev_hash=cnn_chain.latest_hash(),
        stake_map=cnn_chain.latest_stake_map()).seal()
    if not cnn_chain.consider_block(cnn_blk):
        raise AssertionError("the mnist_cnn block did not append")
    sources = {"main": main_chain, "mnist_cnn": cnn_chain}

    # encode and decode each block kind once, timed
    kinds = {}
    for kind, chain in sources.items():
        blk = chain.latest
        row = {"blocks": len(chain) - 1, "deltas": len(blk.data.deltas),
               "params": int(blk.data.global_w.size)}
        for codec in LEDGER_CODECS:
            meta, arrays = wire.pack_block(blk)
            t0 = time.perf_counter()
            frame = msgs.encode("RegisterBlock", meta, arrays,
                                codec=None if codec == wcodecs.RAW else codec,
                                chunk_bytes=cfg.wire_chunk_bytes)
            enc_s = time.perf_counter() - t0
            payload = _reassembled(frame)
            t0 = time.perf_counter()
            _, dmeta, darrays = msgs.decode(payload)
            back = wire.unpack_block(dmeta, darrays)
            dec_s = time.perf_counter() - t0
            if back.hash != blk.hash or back.compute_hash() != blk.hash:
                raise AssertionError(f"{kind} block under {codec} decodes to "
                                     "another hash")
            row[codec] = {"frame_bytes": len(frame),
                          "frames": _chunk_frames(frame),
                          "encode_s": enc_s, "decode_s": dec_s}
        row["codec_ratio"] = (row["raw64"]["frame_bytes"]
                              / row["f32+zlib"]["frame_bytes"])
        kinds[kind] = row

    # the RPC hop: every block to a port RPCServer, appended on its side
    received = {(kind, codec): Blockchain(chain.blocks[0].data.global_w.size,
                                          cfg.num_nodes, cfg.default_stake)
                for kind, chain in sources.items() for codec in LEDGER_CODECS}

    async def handle(msg_type, meta, arrays):
        if msg_type != "RegisterBlock":
            raise rpc.RPCError(f"unexpected {msg_type}")
        blk = wire.unpack_block(meta, arrays)
        chain = received[(meta["chain"], meta["codec"])]
        return {"appended": chain.consider_block(blk),
                "hash": blk.hash.hex()}, {}

    async def hop():
        server = rpc.RPCServer("127.0.0.1", 0, handle)
        server.caps = wcodecs.FULL_CAPS
        await server.start()
        port = server._server.sockets[0].getsockname()[1]
        pool = rpc.Pool()
        sent = []
        try:
            for kind, chain in sources.items():
                for codec in LEDGER_CODECS:
                    for blk in chain.blocks[1:]:
                        meta, arrays = wire.pack_block(blk)
                        meta.update(chain=kind, codec=codec)
                        t0 = time.perf_counter()
                        reply, _ = await pool.call(
                            "127.0.0.1", port, "RegisterBlock", meta, arrays,
                            timeout=300.0, codec=codec,
                            chunk_bytes=cfg.wire_chunk_bytes)
                        sent.append((kind, codec, time.perf_counter() - t0,
                                     reply["appended"],
                                     reply["hash"] == blk.hash.hex()))
        finally:
            pool.close()
            await server.stop()
        return sent

    sent = asyncio.run(hop())
    for kind, row in kinds.items():
        for codec in LEDGER_CODECS:
            mine = [x for x in sent if x[:2] == (kind, codec)]
            rx = received[(kind, codec)]
            row[codec].update(
                send_s=[x[2] for x in mine],
                all_appended=all(x[3] for x in mine),
                hashes_equal=all(x[4] for x in mine),
                dump_equal=rx.dump() == sources[kind].dump())
            try:
                rx.verify()
                row[codec]["verify"] = True
            except ChainInvariantError as e:  # reported, then raised below
                row[codec]["verify"] = str(e)

    # checkpoint save/load round trip
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ckpt = {}
        for kind, chain in sources.items():
            t0 = time.perf_counter()
            checkpoint.save(chain, os.path.join(ckpt_dir, kind))
            loaded = checkpoint.load(os.path.join(ckpt_dir, kind))
            ckpt[kind] = {"dump_equal": loaded.dump() == chain.dump(),
                          "save_load_s": time.perf_counter() - t0}

    out = {"rounds": LEDGER_ROUNDS, "nodes": cfg.num_nodes,
           "accepted_last_round": accepted, "seal_s": seal_s,
           "b1_launches": b1_launches, "blocks": kinds, "checkpoint": ckpt,
           "bench_byte_columns": bench.byte_columns(cfg, w64, accepted),
           "chunk_bytes": cfg.wire_chunk_bytes,
           "nvidia_smi": bench.card_line(),
           "seconds": time.perf_counter() - t_phase}
    emit("ledger", **out)
    if b1_launches != LEDGER_ROUNDS:
        raise AssertionError(f"ledger rounds launched B1 {b1_launches} times")
    for kind, row in kinds.items():
        for codec in LEDGER_CODECS:
            r = row[codec]
            if not (r["all_appended"] and r["hashes_equal"] and r["dump_equal"]
                    and r["verify"] is True):
                raise AssertionError(f"ledger: the {kind} chain under {codec} "
                                     f"differs after the RPC hop: {r}")
        if not ckpt[kind]["dump_equal"]:
            raise AssertionError(f"ledger: the {kind} checkpoint round trip "
                                 "differs")
    if kinds["mnist_cnn"]["raw64"]["frames"] < 2:
        raise AssertionError("ledger: the mnist_cnn block was not chunked")
    return out


def live_cluster(name: str, port: int, timeouts: dict, peers: int,
                 **kw) -> dict:
    """`peers` port PeerAgents on the card (device None: the GPU) in one
    event loop over loopback TCP, run to the end; the cluster's row, with
    the chain-equality oracle checked. Round wall times are the gaps
    between peer 0's per-round log stamps, the first from the run's
    start. `verdicts` lists each verifier decision as [round, pool,
    accepted]; under KRUM with a pool of 5 or more, Krum must have
    rejected an update in some round (a pool under 5 scores on no
    neighbour, and one of 2 or less is accepted whole)."""
    import asyncio

    from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts

    base = dict(num_nodes=peers, base_port=port, num_verifiers=1,
                num_miners=1, num_noisers=1, sample_percent=1.0,
                convergence_error=0.0, seed=0, defense=Defense.KRUM,
                timeouts=Timeouts(**timeouts))
    base.update(kw)
    cfgs = [BiscottiConfig(node_id=i, **base) for i in range(peers)]

    async def go():
        from biscotti_tpu_torch.runtime.peer import PeerAgent

        agents = [PeerAgent(c) for c in cfgs]
        t0 = time.time()
        results = await asyncio.gather(*(a.run() for a in agents))
        return agents, t0, time.time() - t0, results

    t_setup = time.perf_counter()
    agents, t0, run_s, results = asyncio.run(go())
    dumps = [r["chain_dump"] for r in results]
    blocks = dumps[0].splitlines()[1:]
    stamps = [float(line.split(",")[2]) for line in results[0]["logs"]]
    phases: dict = {}
    for r in results:
        for ph, v in r["phases"].items():
            phases[ph] = phases.get(ph, 0.0) + v["total_s"]
    verdicts = sorted([v["it"], len(v["src"]), sum(v["accept"])]
                      for r in results
                      for v in r["telemetry"].get("trust", {}).get("stream", []))
    row = {"cluster": name, "peers": peers, "dataset": cfgs[0].dataset,
           "model": cfgs[0].model_name or "default",
           "params": agents[0].trainer.num_params,
           "devices": sorted({str(a.trainer.x_test.device) for a in agents}),
           "secure_agg": cfgs[0].secure_agg,
           "device_crypto": cfgs[0].device_crypto,
           "chains_equal": all(d == dumps[0] for d in dumps),
           "rounds": len(blocks), "rounds_wanted": cfgs[0].max_iterations,
           "nonempty_blocks": sum("ndeltas=0" not in b for b in blocks),
           "verdicts": verdicts,
           "round_wall_s": [b - a for a, b in zip([t0] + stamps, stamps)],
           "run_s": run_s, "setup_and_run_s": time.perf_counter() - t_setup,
           "final_error": results[0]["final_error"],
           "phases_total_s": {k: round(v, 4) for k, v in sorted(phases.items())},
           "chain": blocks}
    if not (row["chains_equal"] and row["rounds"] == row["rounds_wanted"]
            and row["nonempty_blocks"] >= 1
            and row["devices"] == ["cuda:0"]):
        raise AssertionError(f"live cluster {name} failed the oracle: {row}")
    krum_pools = cfgs[0].verification and cfgs[0].defense == Defense.KRUM \
        and peers - 2 >= 5
    if krum_pools and not any(pool >= 5 and acc < pool
                              for _, pool, acc in verdicts):
        raise AssertionError(f"live cluster {name}: no live round ran Krum "
                             f"on a pool of 5 or more: {verdicts}")
    return row


def live_seam() -> dict:
    """The verifier seam on the card: an unstarted card PeerAgent and an
    unstarted CPU one (the CPU tests' oracle) give the same accept masks
    for every device defense on a seeded pool at d = 7,850, and the same
    Krum, Multi-Krum and ENSEMBLE masks on C2's x1e-20 rows."""
    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.runtime.peer import PeerAgent

    cfg = BiscottiConfig(node_id=0, num_nodes=4, dataset="mnist",
                         base_port=LIVE_BASE_PORT + 90, defense=Defense.ENSEMBLE)
    card, cpu = PeerAgent(cfg), PeerAgent(cfg, device="cpu")
    d = card.trainer.num_params
    rng = np.random.default_rng(17)
    pools = {"random_12": rng.normal(0.0, 0.01, (12, d)),
             "c2_1e-20": np.random.default_rng(0).normal(size=(6, d)) * 1e-20}
    # C2's rows only under the Krum rules: at w = 0 RONI and FoolsGold
    # read 1e-20-sized logits and cosines, whose ties no rule fixes
    defenses = {"random_12": (Defense.KRUM, Defense.MULTIKRUM,
                              Defense.FOOLSGOLD, Defense.RONI),
                "c2_1e-20": (Defense.KRUM, Defense.MULTIKRUM)}
    rows = {}
    for pname, vecs in pools.items():
        for defense in defenses[pname]:
            masks = []
            for agent in (card, cpu):
                agent.cfg = agent.cfg.replace(defense=defense)
                masks.append(agent._defense_mask(vecs).tolist())
            rows[f"{pname}/{defense.value}"] = masks[0]
            if masks[0] != masks[1]:
                raise AssertionError(f"live seam: {defense.value} on {pname} "
                                     f"differs card vs CPU: {masks}")
        ens = [agent._ensemble_mask(0, [type("U", (), {"source_id": i})()
                                        for i in range(len(vecs))], vecs)[0]
               for agent in (card, cpu)]
        rows[f"{pname}/ENSEMBLE"] = [bool(b) for b in ens[0]]
        if [bool(b) for b in ens[0]] != [bool(b) for b in ens[1]]:
            raise AssertionError(f"live seam: ENSEMBLE on {pname} differs "
                                 f"card vs CPU")
    keep = 6 - 3
    if rows["c2_1e-20/KRUM"] != [True] * keep + [False] * (6 - keep):
        raise AssertionError(f"live seam: C2's pool is not the reference's "
                             f"accept set: {rows['c2_1e-20/KRUM']}")
    return {"params": d, "masks": rows}


def live_phase() -> dict:
    """The live peer on the card: clusters (a), (b) with its witness and
    (c) of the module docstring and the verifier seam; returns the phase's row with B2's
    launches in (b)."""
    import torch

    from biscotti_tpu_torch.crypto import kernels
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv

    t_phase = time.perf_counter()
    fast = dict(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
                rpc_s=20.0)
    secagg = dict(dataset="mnist", secure_agg=True, noising=True,
                  verification=True, epsilon=1.0)
    a = live_cluster("a_secagg_native", LIVE_BASE_PORT, fast, LIVE_PEERS,
                     max_iterations=3, **secagg)
    emit("live", **a)
    # (b)'s witness: its round on the native host plane. Every peer of
    # both draws from seed 0, and the plane decides only which commitments
    # and grids pass, so the chains must agree hash for hash; a plane that
    # refused a valid grid, or passed everything, would part them
    w = live_cluster("b_witness_native", LIVE_BASE_PORT + 30, fast,
                     LIVE_ARMED_PEERS, max_iterations=1, batch_intake=True,
                     **secagg)
    emit("live", **w)
    # (b): the armed plane settles a 7,850-point intake in ~4-5 s on the
    # card (PERF.md §5), and each peer's prewarm runs the ladders once
    # more, so its deadlines are several of those
    armed = dict(update_s=40.0, block_s=120.0, krum_s=40.0, share_s=40.0,
                 rpc_s=40.0)
    os.environ["BISCOTTI_PALLAS_CRYPTO"] = "1"
    kernels.reset_counters()
    cv.oncurve_mask.launches = 0
    try:
        b = live_cluster("b_secagg_device_crypto", LIVE_BASE_PORT + 10, armed,
                         LIVE_ARMED_PEERS, max_iterations=1,
                         device_crypto=True, batch_intake=True, **secagg)
        b["b2_launches"] = cv.oncurve_mask.launches
        b["device_crypto_calls"] = kernels.device_calls()
        b["device_crypto_seconds"] = kernels.device_seconds()
        b["armed_device"] = kernels.armed_device().type
    finally:
        kernels.set_enabled(False)
        os.environ.pop("BISCOTTI_PALLAS_CRYPTO")
    # every grid_validate_sum call of a miner's fold launches B2 once
    # (prewarm's launches are on top: it runs under the same switch)
    b["b2_fold_launches"] = b["device_crypto_calls"].get("grid_validate", 0)
    b["chain_equals_witness"] = b["chain"] == w["chain"]
    emit("live", **b)
    if not (b["b2_fold_launches"] >= 1
            and b["b2_launches"] >= b["b2_fold_launches"]
            and b["armed_device"] == "cuda"):
        raise AssertionError(f"live cluster (b) did not run B2 in its "
                             f"miners' folds on the card: {b}")
    if not b["chain_equals_witness"]:
        raise AssertionError(f"live cluster (b)'s chain is not its native "
                             f"witness's: {b['chain']} vs {w['chain']}")
    c = live_cluster("c_cnn_plain", LIVE_BASE_PORT + 20, fast, LIVE_PEERS,
                     max_iterations=2, dataset="mnist", model_name="mnist_cnn",
                     secure_agg=False, noising=False, verification=True)
    emit("live", **c)
    seam = live_seam()
    emit("live", cluster="verifier_seam", **seam)
    torch.cuda.synchronize()
    return {"b2_launches": b["b2_launches"],
            "seconds": time.perf_counter() - t_phase}


def hive_cell(name: str, cfg, pool_hook: bool = False):
    """A port `Hive` of every peer of `cfg` on the card (device None: the
    GPU), run to the end: (row, hive, results, the verifier pools of 512 or
    more rows that `_defense_mask` was handed). The row holds the chain-
    equality oracle, each round's wall time (peer 0's log stamps, the
    first from the run's start), the verifier decisions [round, pool,
    accepted], the stepper's batches and the hive's readout."""
    import asyncio

    from biscotti_tpu_torch.runtime import hive as phive

    rss_before = phive.rss_bytes()
    t_setup = time.perf_counter()
    hive = phive.Hive(cfg, hive_id=name)
    setup_s = time.perf_counter() - t_setup
    pools = []
    if pool_hook:
        for agent in hive.agents:
            def seen(vecs, _mask=agent._defense_mask):
                if len(vecs) >= 512:
                    pools.append(np.array(vecs, np.float32))
                return _mask(vecs)

            agent._defense_mask = seen
    t0 = time.time()
    results = asyncio.run(hive.run())
    run_s = time.time() - t0
    summary = phive.summarize(hive, results, run_s, cfg.max_iterations)
    blocks = results[0]["chain_dump"].splitlines()[1:]
    stamps = [float(line.split(",")[2]) for line in results[0]["logs"]]
    verdicts = sorted([v["it"], len(v["src"]), sum(v["accept"])]
                      for r in results
                      for v in r["telemetry"].get("trust", {}).get("stream", []))
    phases: dict = {}
    for r in results:
        for ph, v in r["phases"].items():
            phases[ph] = phases.get(ph, 0.0) + v["total_s"]
    row = {"cell": name, "peers": cfg.num_nodes, "dataset": cfg.dataset,
           "model": cfg.model_name or "default",
           "params": hive.agents[0].trainer.num_params,
           "device": str(hive.device),
           "chains_equal": summary["chains_equal_local"],
           "rounds": len(blocks), "rounds_wanted": cfg.max_iterations,
           "nonempty_blocks": sum("ndeltas=0" not in b for b in blocks),
           "verdicts": verdicts, "setup_s": setup_s, "run_s": run_s,
           "round_wall_s": [b - a for a, b in zip([t0] + stamps, stamps)],
           "sgd_batches": summary["sgd_batches"],
           "evals": hive.stepper.evals if hive.stepper else None,
           # the process's RSS before the hive and at the monitor's last
           # sample of its run: this process has run every earlier phase,
           # so its peak is theirs too, and the growth is the hive's
           "rss_before_bytes": rss_before,
           "rss_in_run_bytes": hive.info["rss_bytes"],
           "rss_growth_per_peer_bytes":
               (hive.info["rss_bytes"] - rss_before) // cfg.num_nodes,
           "rss_sampled_max_bytes": summary["rss_sampled_max_bytes"],
           "loop_lag_s": summary["loop_lag_s"],
           "loopback_avoided_bytes_per_round":
               summary["loopback_avoided_bytes_per_round"],
           "final_error": summary["final_error"],
           "phases_total_s": {k: round(v, 4) for k, v in sorted(
               phases.items(), key=lambda kv: -kv[1])},
           "anchor_phases_s": {k: round(v["total_s"], 4) for k, v in sorted(
               results[0]["phases"].items(), key=lambda kv: -kv[1]["total_s"])},
           "chain": blocks}
    if not (row["chains_equal"] and row["rounds"] == row["rounds_wanted"]
            and row["nonempty_blocks"] == row["rounds"]
            and row["device"] == "cuda" and summary["batch_device"]):
        raise AssertionError(f"hive cell {name} failed the oracle: {row}")
    return row, hive, results, pools


def hive_phase(dev) -> dict:
    """The hive on the card, cells (a)-(d) of the module docstring; returns
    the phase's row with B1's launches in (c)'s live round."""
    import asyncio

    import torch
    from torch.profiler import ProfilerActivity, profile

    from biscotti_tpu_torch import bench
    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.data import datasets as ds
    from biscotti_tpu_torch.models.trainer import Trainer
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.ops.krum import default_num_adversaries
    from biscotti_tpu_torch.runtime.device_cluster import run_cluster

    t_phase = time.perf_counter()
    # (a) the reference's density entry, through the port's hive CLI
    t0 = time.perf_counter()
    density = bench.bench_peer_density(sizes=(HIVE_DENSITY_N,), iterations=2,
                                       budget_s=300.0, platform="cuda")
    a = density[f"n{HIVE_DENSITY_N}"]
    emit("hive", cell="a_density_n100", seconds=time.perf_counter() - t0, **a)
    if "error" in a or not (a["chains_equal"] and a["blocks"] == 2):
        raise AssertionError(f"hive (a): the density entry failed: {a}")

    def cell_cfg(n: int, port: int, rounds: int, **kw):
        cfg = BiscottiConfig(num_nodes=n, dataset="mnist", base_port=port,
                             num_verifiers=1, num_miners=1, num_noisers=1,
                             secure_agg=False, noising=False,
                             verification=True, defense=Defense.KRUM,
                             max_iterations=rounds, convergence_error=0.0,
                             sample_percent=1.0, seed=0, **kw)
        # the hive CLI's deadlines (hive.py main): the reference's scaling
        return cfg.replace(timeouts=cfg.timeouts.scaled(
            n, 1, 1, random_sampling=False, defense_is_krum=True))

    # (b) 100 mnist_cnn peers; one batch profiled and held to the peers'
    # standalone Trainers on the card
    cfg_b = cell_cfg(HIVE_CNN_N, HIVE_BASE_PORT, 2, model_name="mnist_cnn")
    b, hive_b, _, _ = hive_cell("b_cnn_n100", cfg_b)
    st = hive_b.stepper
    w = np.asarray(hive_b.agents[0].chain.latest_gradient())
    wt = torch.from_numpy(w.astype(np.float32)).to(dev)
    it = cfg_b.max_iterations
    draws_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = st.draw_batches(it)
        torch.cuda.synchronize()
        draws_ms.append(1e3 * (time.perf_counter() - t0))
    batch_ms = time_ms(lambda: st.deltas_from_draws(wt, idx), reps=5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        deltas = st.deltas_from_draws(wt, idx)
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    worst = 0.0
    for slot, pid in enumerate(st.local_ids):
        t = Trainer(cfg_b.dataset, ds.shard_name(cfg_b.dataset, pid, False),
                    cfg=cfg_b.replace(node_id=pid), seed=pid)
        want = torch.from_numpy(t.private_fun(w, it))
        got = deltas[slot].double().cpu()
        diff = float((got - want).abs().max())
        worst = max(worst, diff)
        if not torch.allclose(got, want, rtol=RTOL,
                              atol=RTOL * float(want.abs().max())):
            raise AssertionError(f"hive (b): peer {pid}'s batched delta is "
                                 f"not its standalone Trainer's: {diff}")
    b.update(batch_peers=len(st.local_ids), batch_ms=batch_ms,
             batch_device_ms=sum(e.self_device_time_total
                                 for e in on_device) / 1e3,
             batch_kernels=sum(e.count for e in on_device),
             draws_host_ms=draws_ms, trainer_max_abs_diff=worst,
             top=[{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                   "calls": e.count} for e in sorted(
                       on_device, key=lambda e: -e.self_device_time_total)[:6]])
    emit("hive", **b)
    if b["sgd_batches"] != cfg_b.max_iterations:
        raise AssertionError(f"hive (b): {b['sgd_batches']} batches, not one "
                             f"a round")
    del hive_b, st, deltas
    torch.cuda.empty_cache()

    # (c) N = 528: the verifier's live pool in B1's window
    cfg_c = cell_cfg(HIVE_POOL_N, HIVE_BASE_PORT + 1000, HIVE_POOL_ROUNDS)
    krum_cuda.krum_scores_kernel.launches = 0
    c, _, _, pools = hive_cell("c_pool_n528", cfg_c, pool_hook=True)
    c["b1_launches"] = krum_cuda.krum_scores_kernel.launches
    c["pool_sizes"] = [len(p) for p in pools]
    # the round's verifier scores its pool of N - 2 on B1, once a pool
    if not (len(pools) >= HIVE_POOL_ROUNDS
            and all(len(p) >= 512 for p in pools)
            and c["b1_launches"] == len(pools)):
        raise AssertionError(f"hive (c): B1 scored no live pool of 512 or "
                             f"more: {c}")
    x = torch.from_numpy(pools[0]).to(dev)
    f = default_num_adversaries(x.shape[0])
    got, ref = krum_cuda.krum_scores_kernel(x, f), krum_cuda.krum_scores_plain(x, f)
    keep = x.shape[0] - f
    c["b1_on_the_live_pool"] = {
        "n": x.shape[0], "d": x.shape[1], "max_abs_err": float((got - ref).abs().max()),
        "max_rel_err": rel_err(got, ref),
        "accept_set_identical": accept_set(got, keep) == accept_set(ref, keep),
        **krum_times(x, f)}
    emit("hive", **{k: v for k, v in c.items() if k != "chain"},
         chain=c["chain"])
    if not (c["b1_on_the_live_pool"]["accept_set_identical"]
            and c["b1_on_the_live_pool"]["max_rel_err"] < RTOL):
        raise AssertionError(f"hive (c): B1 on the live pool disagrees with "
                             f"plain: {c['b1_on_the_live_pool']}")

    # (d) the single-device BatchStepper cluster
    cfg_d = cell_cfg(HIVE_CLUSTER_N, HIVE_BASE_PORT - 300, 2)
    t0 = time.perf_counter()
    stepper, agents, results = asyncio.run(run_cluster(cfg_d, None, 2))
    dumps = [r["chain_dump"] for r in results]
    blocks = dumps[0].splitlines()[1:]
    d = {"cell": "d_batch_stepper_n8", "peers": HIVE_CLUSTER_N,
         "device": str(stepper.device), "seconds": time.perf_counter() - t0,
         "chains_equal": all(x == dumps[0] for x in dumps),
         "rounds": len(blocks),
         "nonempty_blocks": sum("ndeltas=0" not in x for x in blocks),
         "batches": stepper.batches, "evals": stepper.evals, "chain": blocks}
    emit("hive", **d)
    if not (d["chains_equal"] and d["rounds"] == 2 and d["nonempty_blocks"] == 2
            and d["device"] == "cuda" and 1 <= d["batches"] <= 3):
        raise AssertionError(f"hive (d): the BatchStepper cluster failed: {d}")
    torch.cuda.synchronize()
    return {"b1_launches": c["b1_launches"],
            "live_pool_kernel": c["b1_on_the_live_pool"],
            "seconds": time.perf_counter() - t_phase}


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
    with ThreadPoolExecutor(len(_build.KERNELS)) as pool:  # one nvcc each
        logs = dict(zip(_build.KERNELS, pool.map(_build.build, _build.KERNELS)))
    oncurve_sass = sass_mix(_build.library_path("oncurve"), "oncurve_kernel")
    krum_sass = sass_mix(_build.library_path("krum_scores"), "krum_gram_kernel")
    emit("build", seconds=time.perf_counter() - t0,
         sources=[str(_build.source(k).relative_to(_build.PKG.parent))
                  for k in _build.KERNELS],
         ptxas={k: [l.strip() for l in log.splitlines()
                    if "registers" in l or "spill" in l]
                for k, log in logs.items()},
         oncurve_sass=oncurve_sass, krum_gram_sass=krum_sass,
         krum_gram_pipes={op: sum(c for o, c in krum_sass.items()
                                  if o.split(".")[0] == op)
                          for op in ("FFMA", "HMMA")}
         if isinstance(krum_sass, dict) else krum_sass)

    # 3. kernel vs plain --------------------------------------------------
    kern, plain = krum_cuda.krum_scores_kernel, krum_cuda.krum_scores_plain
    gen = torch.Generator(device=dev).manual_seed(0)

    def compare(case: str, x, check_accept: bool = False,
                check_exact: bool = False):
        n, d = x.shape
        f = default_num_adversaries(n)
        got, ref = kern(x, f), plain(x, f)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        row = {"case": case, "n": n, "d": d, "max_rel_err": err,
               "max_abs_err": float((got - ref).abs().max()),
               "boundary_rel_gap": boundary_rel_gap(ref, n - f),
               **krum_times(x, f)}
        if check_accept:
            same = accept_set(got, n - f) == accept_set(ref, n - f)
            row["accept_set_identical"] = same
        if check_exact:  # each version against float64 throughout
            truth = krum_scores_fp64(x, f)
            row["kernel_vs_fp64_rel_err"] = rel_err(got.double(), truth)
            row["plain_vs_fp64_rel_err"] = rel_err(ref.double(), truth)
            row["rel_err_over_half_gap"] = err / (row["boundary_rel_gap"] / 2)
        emit("kernel", **row)
        if not err < RTOL:
            raise AssertionError(f"krum kernel disagrees at {case}: {err}")
        if check_accept and not row["accept_set_identical"]:
            raise AssertionError(f"krum kernel accept set differs at {case}")
        # where fp32 itself cannot resolve the boundary (the plain
        # version's own error exceeds half the gap), the kernel must be as
        # exact as the plain version: 10 % covers their two summation
        # orders
        if check_exact and not (row["kernel_vs_fp64_rel_err"]
                                <= EXACT_SLACK * row["plain_vs_fp64_rel_err"]):
            raise AssertionError(f"krum kernel is less exact than its plain "
                                 f"version at {case}")
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
    # rows that share one large mean: D ~ 39 next to |x|^2 ~ 7850, so
    # sq_i + sq_j - 2G cancels most of its digits
    x = 0.05 * torch.randn(716, 7850, generator=gen, device=dev) \
        + torch.randn(1, 7850, generator=gen, device=dev)
    compare("cancellation_716x7850", x, check_accept=True, check_exact=True)
    # ROADMAP C1: non-finite rows at the main path's n
    for case, (row, value) in {"overflow_2e19": (2, 2e19),
                               "plus_inf": (2, float("inf")),
                               "minus_inf": (300, float("-inf")),
                               "nan_input": (9, float("nan"))}.items():
        x = torch.randn(716, 7850, generator=gen, device=dev)
        x[row, 5] = value
        emit("kernel", **nonfinite_case(case, x, default_num_adversaries(716)))
    # ROADMAP C2: x1e-20 rows, every product subnormal. The reference
    # flushes subnormals, so its distances are all 0 and it accepts the
    # n - f lowest indices; B1, the plain path on the card and on the CPU
    # must all give exactly that
    x = 1e-20 * torch.randn(716, 7850, generator=gen, device=dev)
    sub = nonfinite_case("subnormal_1e-20", x, default_num_adversaries(716))
    keep = 716 - default_num_adversaries(716)
    sub["accept_set_is_reference"] = accept_set(
        kern(x, default_num_adversaries(716)), keep) == set(range(keep))
    emit("kernel", **sub)
    if not sub["accept_set_is_reference"]:
        raise AssertionError(f"B1 on x1e-20 rows is not the reference's "
                             f"accept set: {sub}")

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
    main_kernel = {
        "max_abs_err": float((got - ref).abs().max()),
        "max_rel_err": rel_err(got, ref),
        "accept_set_identical": accept_set(got, s - f) == accept_set(ref, s - f),
        "boundary_rel_gap": boundary_rel_gap(ref, s - f),
        **krum_times(noised, f)}
    c1 = {}
    for case, cells in (("overflow_2e19", [(2, 5, 2e19)]),
                        ("plus_and_minus_inf", [(3, 7, float("inf")),
                                                (9, 1, float("-inf"))])):
        x = noised.clone()
        for r, c, v in cells:
            x[r, c] = v
        c1[case] = nonfinite_case(case, x, f)
    main_kernel["nonfinite"] = c1
    # ROADMAP C2 on main-path inputs: the round's updates scaled to a
    # largest |x| of 1e-20, so every product is subnormal (B1 = plain = the
    # reference's accept set, the s - f lowest ids)
    tiny = noised * (1e-20 / float(noised.abs().max()))
    c2 = nonfinite_case("subnormal_1e-20", tiny, f)
    c2["accept_set_is_reference"] = accept_set(kern(tiny, f), s - f) \
        == set(range(s - f))
    main_kernel["subnormal"] = c2
    if not c2["accept_set_is_reference"]:
        raise AssertionError(f"B1 on main-path updates x1e-20 is not the "
                             f"reference's accept set: {c2}")
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

    # crypto_kernel, crypto: the device crypto plane and kernel B2 --------
    grid, a, b = valid_grid(seed=0)
    b2 = crypto_kernel_phase(dev, grid, oncurve_sass)
    crypto = crypto_phase(dev, grid, a, b)
    secagg = secagg_phase(dev)

    # models, defenses, cnn, bench, trainer: slice 3 ------------------------
    models_phase(dev)
    defenses = defenses_phase(dev)
    cnn = cnn_phase(dev)
    bench_phase(dev)
    trainer_phase(dev)
    cnn_kernel = cnn["kernel"]

    # ledger: slice 5, the card's rounds sealed and sent --------------------
    ledger = ledger_phase(dev, sim, w, stake, cnn.pop("ledger_rows"),
                          first_round=7 + prof_rounds)

    # live: slice 6, clusters of port peers on the card --------------------
    live = live_phase()

    # hive: slice 7, co-hosted port peers on the card -----------------------
    hive = hive_phase(dev)

    # 6. kernels ----------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "krum_scores", "route": "cuda",
        "source": "biscotti_tpu_torch/csrc/krum_scores.cu",
        "replaces": "biscotti_tpu/ops/krum_pallas.py:72",
        "launches": (main_launches + defenses["b1_launches"]
                     + cnn["b1_launches"] + ledger["b1_launches"]
                     + hive["b1_launches"]),
        "launches_by_phase": {"main": main_launches,
                              "defenses": defenses["b1_launches"],
                              "cnn": cnn["b1_launches"],
                              "ledger": ledger["b1_launches"],
                              "hive": hive["b1_launches"]},
        "max_abs_err": main_kernel["max_abs_err"],
        "ms": main_kernel["ms"], "plain_ms": main_kernel["plain_ms"],
        "bound_ms": main_kernel["bound_ms"], "bound_by": main_kernel["bound_by"],
        "library_ms": None, "bound_pipe": main_kernel["bound_pipe"],
        "kernel_only_ms": main_kernel["kernel_only_ms"],
        "gram_cublas_ms": main_kernel["gram_cublas_ms"],
        "at_716x164266": {k: cnn_kernel[k] for k in (
            "max_abs_err", "ms", "kernel_only_ms", "plain_ms", "gram_cublas_ms",
            "bound_ms", "bound_by", "accept_set_identical")},
        "at_the_hive_live_pool": {k: hive["live_pool_kernel"][k] for k in (
            "n", "d", "max_abs_err", "ms", "kernel_only_ms", "plain_ms",
            "gram_cublas_ms", "bound_ms", "bound_by",
            "accept_set_identical")}}, {
        "name": "oncurve_validate", "route": "cuda",
        "source": "biscotti_tpu_torch/csrc/oncurve.cu",
        "replaces": "biscotti_tpu/crypto/kernels/pallas_validate.py:34",
        "launches": (crypto["oncurve_launches"] + secagg["b2_launches"]
                     + live["b2_launches"]),
        "launches_by_phase": {"crypto": crypto["oncurve_launches"],
                              "secagg": secagg["b2_launches"],
                              "live": live["b2_launches"]},
        "max_abs_err": b2["max_abs_err"],
        "ms": b2["ms"], "plain_ms": b2["plain_ms"],
        "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)  # the card's name and power limit, verbatim
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
