"""defense_ms: device ms of `defense_mask` on one round's noised updates,
by CUDA events around repeated calls."""

UNIT = "ms"
LAYER = "defense"
MOVES = "round_ms"
NAME = __name__.rsplit(".", 1)[-1]


def probe(run):
    from biscotti_tpu_torch.models.base import fp32_math
    from biscotti_tpu_torch.ops.krum import default_num_adversaries
    from biscotti_tpu_torch.parallel.sim import defense_mask

    sim, i = run.sim, run.inputs()
    f = default_num_adversaries(i["cidx"].shape[0])

    def call():
        with fp32_math():
            defense_mask(sim.defense, sim.model, i["w"], i["noised"], sim.x_val,
                         sim.y_val, sim.cfg.roni_threshold, f)

    return run.time_ms(call)


def read(run):
    return run.probes.get(NAME)
