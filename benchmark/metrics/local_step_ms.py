"""local_step_ms: device ms of `Simulator.local_updates` (the vmapped
`local_step_fn` over the round's contributors) on one round's draws, by
CUDA events around repeated calls."""

UNIT = "ms"
LAYER = "local step"
MOVES = "round_ms"
NAME = __name__.rsplit(".", 1)[-1]


def probe(run):
    i = run.inputs()
    return run.time_ms(lambda: run.sim.local_updates(i["w"], i["cidx"],
                                                     i["bidx"], i["noise"]))


def read(run):
    return run.probes.get(NAME)
