"""host_local_step_ms: the host ms of the program's `sim.local_step` span (its
`dur_s`: the time to enqueue the layer, and any wait for room in the
launch queue), the median over the spanned stretch's rounds dispatched
ahead (benchmark/spans.py)."""

from benchmark import spans

UNIT = "ms"
LAYER = "local step"
MOVES = "round_ms"
NAME = __name__.rsplit(".", 1)[-1]


def probe(run):
    return spans.median_ms(spans.events(run), "sim.local_step", "dur_s")


def read(run):
    return run.probes.get(NAME)
