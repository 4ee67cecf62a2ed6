"""round_ms: the window's wall time, from its first dispatch to the
synchronise that ends it, over the rounds it completed (host clock)."""

UNIT = "ms"


def read(run):
    return 1e3 * run.window_s / run.rounds
