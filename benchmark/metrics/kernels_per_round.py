"""kernels_per_round: device kernels (copies and fills left out) in the
traced stretch, over its rounds."""

UNIT = "kernels"
LAYER = "round"
MOVES = "round_ms"


def read(run):
    return run.trace["kernels"] / run.trace["rounds"] if run.trace else None
