"""round_mfu: the FLOPs a round needs (every contributor's forward and
backward on its minibatch, the defense's pairwise products, the test
error's forward over the test split; counts/) over the measured window's
wall time a round (host clock, the window that `round_ms` reads, which
no profiler slows), as a share of the card's TF32 dense peak."""

import importlib

from benchmark.peaks import TF32_FLOPS

UNIT = "%"
LAYER = "round"
MOVES = "round_ms"


def round_flops(cell) -> int:
    c, s, t = cell.config, cell.settings, cell.traffic
    m = importlib.import_module(f"benchmark.counts.{cell.model}")
    n = cell.num_samples
    flops = n * s["batch_size"] * m.step_flops() + c["test_rows"] * m.forward_flops()
    if t.get("defense_counts"):
        flops += importlib.import_module(
            f"benchmark.counts.{t['defense_counts']}").flops(n, c["num_params"])
    return flops


def read(run):
    if not run.rounds:
        return None
    return 100.0 * round_flops(run.cell) * run.rounds / run.window_s / TF32_FLOPS
