"""Readings that the comparison's limits are set from (not part of a run).

    python3 benchmark/calibrate.py --workload <name> [--seeds 12]
        [--control-seeds 3] [--fault-seeds 3] [--out FILE]

In one process, at the cell's own size: the program's numbers on a dozen
seeds or more (the lower readings), the control's (the reference computed
with TF32 matrix products, put in the program's place) and those of the
program with a fault planted (the upper readings):

  unchanged   a round returns its state unchanged
  half_batch  each contributor's step leaves out half its minibatch and
              takes the mean over the rest
  answer      the committee's accept mask has one decision flipped where
              it is produced

Each run here replays rounds 0..2 and the last of three window rounds, as
a benchmark run does. One JSON line a reading goes to --out.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import cells, harness  # noqa: E402
from benchmark.check import FIRST_ROUNDS, Judge, Observed, Rows, Step  # noqa: E402
from benchmark.reference.nets import TF32  # noqa: E402

WINDOW_ROUNDS = 3


def program_observed(sim, cell, seed: int) -> Observed:
    w0, stake0, first, state = harness.first_rounds(sim, cell, seed)
    it = len(first) + harness.WARM_ROUNDS
    for _ in range(WINDOW_ROUNDS):
        before = Step(*state)
        state = sim.round_step(state[0], state[1], it, seed)
        it += 1
    return Observed(w0, stake0, first, it - 1, before, Step(*state))


def control_observed(cell, seed: int, device, rows: Rows) -> Observed:
    """The reference in TF32 in the program's place, on its own decisions."""
    j = Judge(cell, seed, device, TF32, rows)
    w0 = cells.initial_weights(cell, seed, device)
    stake0 = torch.full((cell.settings["num_nodes"],), 10, dtype=torch.int32,
                        device=device)
    w, stake, steps = w0, stake0, []
    total = FIRST_ROUNDS + harness.WARM_ROUNDS + WINDOW_ROUNDS
    for it in range(total):
        out = j.round(it, w, stake)
        err = torch.tensor(out.wrong / j.test_rows)
        steps.append(Step(out.w.float(), out.stake, out.mask, err))
        w, stake = steps[-1].w, steps[-1].stake
    return Observed(w0, stake0, steps[:FIRST_ROUNDS], total - 1, steps[-2], steps[-1])


@contextlib.contextmanager
def unchanged(sim, seed: int):
    """Each round returns its state unchanged."""
    step = sim.round_step_from_draws

    def same(w, stake, *draws):
        _, _, mask, err = step(w, stake, *draws)
        return w, stake, mask, err

    sim.round_step_from_draws = same
    try:
        yield
    finally:
        del sim.round_step_from_draws


@contextlib.contextmanager
def half_batch(sim, seed: int):
    """Each contributor's step on the first half of its minibatch."""
    step = sim._batched_step

    def half(w, x, y):
        b = x.shape[1] // 2
        return step(w, x[:, :b], y[:, :b])

    sim._batched_step = half
    try:
        yield
    finally:
        sim._batched_step = step


@contextlib.contextmanager
def answer(sim, seed: int):
    """One accept decision flipped where the committee produces it."""
    from biscotti_tpu_torch.parallel import sim as simmod

    decide = simmod.defense_mask

    def flipped(*args, **kwargs):
        mask = decide(*args, **kwargs).clone()
        j = seed % mask.shape[0]
        mask[j] = ~mask[j]
        return mask

    simmod.defense_mask = flipped
    try:
        yield
    finally:
        simmod.defense_mask = decide


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "answer": answer}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=6)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--nodes", type=int, default=0,
                    help="a smaller N, for a rehearsal on the CPU")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    over = {"num_nodes": args.nodes, "reference_block": 8} if args.nodes else {}
    cell = cells.load(args.workload, **over)
    device = torch.device(args.device)
    out = open(args.out, "a") if args.out else sys.stdout
    t = time.perf_counter()
    rows = Rows(cell, range(cell.settings["num_nodes"]))
    print(f"reference shards {time.perf_counter() - t:.2f} s", file=sys.stderr)
    seeds = [args.first_seed + 7919 * k for k in range(
        max(args.seeds, args.control_seeds, args.fault_seeds))]

    def emit(kind: str, seed: int, obs: Observed) -> None:
        t = time.perf_counter()
        judge = Judge(cell, seed, device, rows=rows)
        numbers = judge.numbers(obs)
        rec = {"workload": args.workload, "kind": kind, "seed": seed,
               "numbers": numbers, "judge_s": time.perf_counter() - t,
               "leaves": judge.detail}
        print(json.dumps(rec), file=out, flush=True)
        print(json.dumps(rec), file=sys.stderr, flush=True)

    sim = harness.build(cell, seeds[0], device)
    for seed in seeds[:args.seeds]:
        emit("program", seed, program_observed(sim, cell, seed))
    for name, plant in FAULTS.items():
        for seed in seeds[:args.fault_seeds]:
            with plant(sim, seed):
                emit(name, seed, program_observed(sim, cell, seed))
    del sim
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for seed in seeds[:args.control_seeds]:
        emit("control", seed, control_observed(cell, seed, device, rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
