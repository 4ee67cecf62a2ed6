"""The port's admission plane (`biscotti_tpu_torch/runtime/admission.py`)
against the reference's: one seeded arrival sequence on a fake clock gives
the same admit/shed decisions, parking evictions, snapshots, exported
state and Prometheus text (exact)."""

import random

import pytest

from biscotti_tpu.runtime import admission as ja
from biscotti_tpu.telemetry.registry import MetricsRegistry as JRegistry
from biscotti_tpu_torch.runtime import admission as pa
from biscotti_tpu_torch.telemetry.registry import MetricsRegistry as PRegistry

TYPES = ["RegisterUpdate", "RegisterSecret", "VerifyUpdate", "RegisterBlock",
         "GetBlock", "GetChain", "RegisterPeer", "Metrics", "Bogus"]


def _arrivals(mod, registry, plan_kw):
    now = [0.0]
    ctl = mod.AdmissionController(mod.AdmissionPlan(**plan_kw),
                                  metrics=registry, clock=lambda: now[0])
    rng = random.Random(31)
    held, parked, trail = [], [], []
    for _ in range(600):
        op = rng.random()
        if op < 0.6:
            peer = rng.randrange(6)
            msg = rng.choice(TYPES)
            verdict = ctl.try_admit(peer, msg)
            trail.append((peer, msg, verdict))
            if verdict is None:
                held.append(peer)
        elif op < 0.8 and held:
            ctl.release(held.pop(rng.randrange(len(held))))
        elif op < 0.9:
            tok = ctl.park(rng.choice(("block", "round")))
            parked.append(tok)
            trail.append(("park", tok.seq, [t.shed for t in parked]))
        elif parked:
            ctl.unpark(parked.pop(0))
        now[0] += rng.choice((0.0, 0.001, 0.01, 0.2))
    state = ctl.export_state()
    fresh = mod.AdmissionController(mod.AdmissionPlan(**plan_kw),
                                    clock=lambda: now[0])
    fresh.restore_state(state)
    return trail, ctl.snapshot(), state, fresh.snapshot(), registry.render()


@pytest.mark.parametrize("plan_kw", [
    {},
    dict(enabled=True, update_rate=20.0, bulk_rate=5.0, control_rate=40.0,
         burst_factor=1.5, peer_inflight=3, global_inflight=8, max_parked=4),
    dict(enabled=True, update_rate=200.0, peer_inflight=2, max_parked=2),
], ids=["disabled", "tight", "inflight_bound"])
def test_admission_decisions_equal_reference(plan_kw):
    assert _arrivals(pa, PRegistry(), plan_kw) == \
        _arrivals(ja, JRegistry(), plan_kw)


def test_message_classes_and_plan_checks_equal_reference():
    assert [pa.msg_class(t) for t in TYPES] == [ja.msg_class(t) for t in TYPES]
    for cls in (pa.UPDATE, pa.BULK, pa.CONTROL, "other"):
        assert pa.AdmissionPlan().class_rate(cls) == \
            ja.AdmissionPlan().class_rate(cls)
    for bad in (dict(update_rate=0.0), dict(burst_factor=-1.0),
                dict(peer_inflight=0), dict(max_parked=0)):
        errs = []
        for mod in (pa, ja):
            with pytest.raises(ValueError) as e:
                mod.AdmissionPlan(enabled=True, **bad).validate()
            errs.append(str(e.value))
        assert errs[0] == errs[1]
