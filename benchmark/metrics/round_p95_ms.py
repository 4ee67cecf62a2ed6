"""round_p95_ms: the 95th percentile, over every round of the window, of
the interval between consecutive rounds' end events on the device (the
first from the window's start event)."""

from benchmark.harness import p95

UNIT = "ms"


def read(run):
    return p95(run.intervals_ms) if len(run.intervals_ms) >= 20 else None
