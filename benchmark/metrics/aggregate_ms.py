"""aggregate_ms: device ms of `masked_aggregate` (the masked sum, or the
coordinate-wise trimmed mean) on one round's updates and mask, by CUDA
events around repeated calls."""

UNIT = "ms"
LAYER = "aggregation"
MOVES = "round_ms"
NAME = __name__.rsplit(".", 1)[-1]


def probe(run):
    from biscotti_tpu_torch.models.base import fp32_math
    from biscotti_tpu_torch.parallel.sim import masked_aggregate

    sim, i = run.sim, run.inputs()

    def call():
        with fp32_math():
            masked_aggregate(i["mask"], i["deltas"], i["noised"],
                             sim.cfg.dp_in_model, sim.defense,
                             sim.cfg.trim_fraction)

    return run.time_ms(call)


def read(run):
    return run.probes.get(NAME)
