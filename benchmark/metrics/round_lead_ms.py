"""round_lead_ms: how far the host runs ahead of the card, the program's
`sim.round` span's `lead_s` in ms: its entry event's device time less the
host's entry time, the wait of the round's first operation in the
stream's queue; near 0 the card waits on the host. The median over the
spanned stretch's rounds dispatched ahead (benchmark/spans.py). Listed
only in cells whose round the host paces: where the card paces, the lead
is the depth of the launch queue in rounds times the round, and falls
when the card gets faster."""

from benchmark import spans

UNIT = "ms"
LAYER = "host"
MOVES = "round_ms"
NAME = __name__.rsplit(".", 1)[-1]


def probe(run):
    return spans.median_ms(spans.events(run), "sim.round", "lead_s")


def read(run):
    return run.probes.get(NAME)
