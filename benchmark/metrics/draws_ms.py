"""draws_ms: device ms of `Simulator.draw_round` (contributors, minibatch
rows, DP noise), by CUDA events around repeated calls."""

UNIT = "ms"
LAYER = "draws"
MOVES = "round_ms"
NAME = __name__.rsplit(".", 1)[-1]


def probe(run):
    sim = run.sim
    return run.time_ms(lambda: sim.draw_round(sim.gen, run.it, run.seed))


def read(run):
    return run.probes.get(NAME)
