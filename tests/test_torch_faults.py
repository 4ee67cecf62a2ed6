"""The port's fault and straggler planes (`biscotti_tpu_torch/runtime/
faults.py`, `stragglers.py`) against the reference's copies: the same
seeded plans and the same event sequences give equal outputs, compared as
the dataclass reprs and plain values both packages produce (exact)."""

import random

import pytest

from biscotti_tpu.runtime import faults as jf
from biscotti_tpu.runtime import stragglers as js
from biscotti_tpu_torch.runtime import faults as pf
from biscotti_tpu_torch.runtime import stragglers as ps

PLANS = [
    dict(seed=3, drop=0.2, delay=0.3, delay_s=0.04, duplicate=0.1, reset=0.05),
    dict(seed=11, drop=0.05, flood=3),
    dict(seed=7, churn=0.3, churn_period=5, churn_down=2),
    dict(seed=7, churn=0.25, churn_period=4, churn_down=1, churn_seed=19),
    dict(seed=5, slow=0.4, slow_factor=3.0, slow_service_s=0.01),
    dict(seed=5, slow=0.5, slow_preset="tee"),
    dict(seed=9, slow=0.6, slow_preset="bimodal"),
    dict(seed=2, slow=0.7, slow_preset="longtail", slow_node=0),
]


def _schedules(mod, kw):
    plan = mod.FaultPlan(**kw)
    acts = [repr(plan.action(s, d, m, a, q))
            for s in range(4) for d in range(4)
            for m in ("RegisterBlock", "VerifyUpdate", "RegisterSecret")
            for a in range(2) for q in range(3)]
    return {"enabled": plan.enabled, "churn_enabled": plan.churn_enabled,
            "slow_enabled": plan.slow_enabled, "actions": acts,
            "churn": [repr(e) for e in plan.churn_schedule(12, 30)],
            "slow": {n: repr(p) for n, p in plan.slow_table(16).items()},
            "profiles": [repr(plan.slow_profile(n, 16)) for n in range(-1, 17)]}


@pytest.mark.parametrize("kw", PLANS, ids=range(len(PLANS)))
def test_fault_churn_and_slow_schedules_equal_reference(kw):
    assert _schedules(pf, kw) == _schedules(jf, kw)


def test_plan_constants_and_unknown_preset_equal_reference():
    assert pf.SLOW_PRESETS == jf.SLOW_PRESETS
    assert (pf.KILL, pf.RESTART, pf.JOIN, pf.MIGRATE) == \
        (jf.KILL, jf.RESTART, jf.JOIN, jf.MIGRATE)
    assert (pf.CLOSED, pf.OPEN, pf.HALF_OPEN) == (jf.CLOSED, jf.OPEN, jf.HALF_OPEN)
    for mod in (pf, jf):
        with pytest.raises(ValueError, match="unknown slow_preset"):
            mod.FaultPlan(slow=1.0, slow_preset="warp").slow_profile(1, 4)


def _injector_log(mod, campaign_factory=None):
    addr = {("127.0.0.1", 9000 + i): i for i in range(5)}
    inj = mod.FaultInjector(mod.FaultPlan(**PLANS[0], flood=1), src=1,
                            peer_of=lambda h, p: addr.get((h, p)), record=True)
    if campaign_factory is not None:
        inj.campaign = campaign_factory()
    for k in range(60):
        dst = 9000 + (k * 7) % 6  # 9005 is no peer: never perturbed
        inj.action("127.0.0.1", dst, ("RegisterBlock", "VerifyUpdate")[k % 2],
                   attempt=k % 3)
    return inj.log, inj.counts


def test_injector_frame_log_equals_reference():
    assert _injector_log(pf) == _injector_log(jf)


def test_backoff_schedule_equals_reference():
    for base, cap in ((0.05, 2.0), (0.5, 0.6), (1.0, 30.0)):
        a, b = (mod.backoff_schedule(random.Random(4), base, cap)
                for mod in (pf, jf))
        assert [next(a) for _ in range(40)] == [next(b) for _ in range(40)]


def _breaker(mod):
    now = [0.0]
    led = mod.HealthLedger(threshold=2, cooldown_s=1.5, clock=lambda: now[0])
    rng = random.Random(8)
    trail = []
    for step in range(200):
        pid = rng.randrange(4)
        op = rng.choice(("fail", "fail", "ok", "allow", "probe", "inbound",
                         "tick"))
        if op == "fail":
            trail.append(led.record_failure(pid))
        elif op == "ok":
            trail.append(led.record_success(pid))
        elif op == "allow":
            trail.append(led.allow(pid))
        elif op == "probe":
            led.release_probe(pid)
        elif op == "inbound":
            led.note_inbound(pid)
        else:
            now[0] += rng.choice((0.3, 1.0, 2.0))
        trail.append((pid, led.state(pid), led.available(pid)))
    state = led.export_state()
    fresh = mod.HealthLedger(threshold=2, cooldown_s=1.5, clock=lambda: now[0])
    fresh.restore_state(state)
    return trail, led.snapshot(), state, fresh.snapshot()


def test_health_ledger_transitions_equal_reference():
    assert _breaker(pf) == _breaker(jf)
    for mod in (pf, jf):
        assert issubclass(mod.CircuitOpenError, ConnectionError)


# ------------------------------------------------------------ stragglers


def _deadlines(mod, enabled):
    now = [100.0]
    dc = mod.DeadlineController(enabled=enabled, margin=1.5, floor_s=0.5,
                                window=16, min_samples=3, alpha=0.3,
                                clock=lambda: now[0])
    rng = random.Random(21)
    out = []
    for step in range(120):
        phase = rng.choice((mod.UPDATE, mod.KRUM, mod.SHARE, mod.BLOCK,
                            mod.NOISE, mod.VERIFY))
        dc.observe(phase, rng.expovariate(2.0) * (4.0 if step % 17 == 0 else 1.0))
        now[0] += 0.25
        out.append((phase, dc.p95(phase), dc.estimate(phase),
                    dc.deadline(phase, legacy=4.0)))
    return out, dc.snapshot(), list(dc.history)


@pytest.mark.parametrize("enabled", [False, True])
def test_straggler_deadlines_equal_reference(enabled):
    assert _deadlines(ps, enabled) == _deadlines(js, enabled)


def _ledger(mod):
    led = mod.StragglerLedger()
    led.waiting(mod.UPDATE, [3, 1, 2])
    n1 = led.exclude(mod.UPDATE, [2, 5])
    led.stall(mod.BLOCK, [4, 1], height=7)
    led.waiting(mod.SHARE, [6])
    led.clear(mod.UPDATE)
    n2 = led.exclude(mod.SHARE, [6])
    return n1, n2, led.snapshot()


def test_straggler_ledger_equals_reference():
    assert _ledger(ps) == _ledger(js)
