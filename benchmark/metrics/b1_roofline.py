"""b1_roofline: kernel B1's least time at (S, d), the larger of its FLOPs
over the TF32 dense peak and its bytes over HBM's peak (counts/krum_b1),
over its device time a launch in the traced stretch (its three kernels,
from the profiler; launches from `krum_scores_kernel.launches`)."""

from benchmark.counts import krum_b1
from benchmark.peaks import HBM_BYTES_PER_S, TF32_FLOPS

UNIT = "%"
LAYER = "kernel B1"
MOVES = "round_ms"


def read(run):
    tr = run.trace
    if not tr or not tr["b1_launches"] or not tr["b1_s"]:
        return None
    n, d = run.cell.num_samples, run.cell.config["num_params"]
    bound = max(krum_b1.flops(n, d) / TF32_FLOPS,
                krum_b1.bytes_moved(n, d) / HBM_BYTES_PER_S)
    return 100.0 * bound / (tr["b1_s"] / tr["b1_launches"])
