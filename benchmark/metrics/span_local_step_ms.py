"""span_local_step_ms: the device ms of the program's `sim.local_step` span (its
`dev_s`, entry event to exit event), the median over the spanned
stretch's rounds dispatched ahead (benchmark/spans.py)."""

from benchmark import spans

UNIT = "ms"
LAYER = "local step"
MOVES = "round_ms"
NAME = __name__.rsplit(".", 1)[-1]


def probe(run):
    return spans.median_ms(spans.events(run), "sim.local_step", "dev_s")


def read(run):
    return run.probes.get(NAME)
