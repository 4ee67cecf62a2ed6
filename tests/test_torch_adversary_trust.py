"""The port's adversary campaign plane (`runtime/adversary.py`) and
adaptive-defense ledger (`ops/trust.py`) against the reference's: the same
seeded plans, election streams and score streams give equal campaign
outputs and equal `TrustLedger` decisions, votes and snapshots (exact)."""

import random

import numpy as np
import pytest

from biscotti_tpu.ops import trust as jt
from biscotti_tpu.runtime import adversary as jadv
from biscotti_tpu_torch.ops import trust as pt
from biscotti_tpu_torch.runtime import adversary as padv

CAMPAIGN_PLANS = [
    dict(campaign="roleflood", attackers=0.3, flood=7),
    dict(campaign="roleflood", attackers=0.0, attacker_node=3, flood=2),
    dict(campaign="sybil", attackers=0.25, recycle_period=4, recycle_down=1,
         seed=17),
    dict(campaign="sybil", attackers=0.4, recycle_period=3, recycle_down=2),
    dict(campaign="hug", attackers=0.3, hug_start=0.5, hug_jitter=0.1),
    dict(campaign="hug", attackers=0.2, attacker_node=1, seed=5),
]


def _campaign_run(mod, kw, n=12, rounds=20, protocol_seed=4):
    plan = mod.CampaignPlan(**kw)
    plan.validate()
    rng = random.Random(9)
    out = {"ids": sorted(plan.attacker_ids(n)),
           "recycle": [repr(e) for e in plan.recycle_schedule(n, rounds,
                                                              protocol_seed)]}
    for node in range(n):
        c = mod.build(plan, node, n, protocol_seed)
        if c is None:
            out[node] = None
            continue
        trail = [sorted(c.kill_rounds(rounds))]
        for it in range(rounds):
            miners = rng.sample(range(n), 3)
            verifiers = rng.sample(range(n), 3)
            trail.append(c.observe_round(it, miners, verifiers,
                                         rng.choice((True, False, None))))
            c.observe_noisers(it, rng.sample(range(n), 2))
            for dst in range(n):
                f = c.flood_factor(dst, "RegisterUpdate")
                if f:
                    c.record_flood(dst)
                trail.append(f)
            trail.append(c.shape(it))
        out[node] = (trail, c.snapshot())
    return out


@pytest.mark.parametrize("kw", CAMPAIGN_PLANS, ids=range(len(CAMPAIGN_PLANS)))
def test_campaign_outputs_equal_reference(kw):
    assert _campaign_run(padv, kw) == _campaign_run(jadv, kw)


def test_campaign_constants_and_checks_equal_reference():
    assert padv.CAMPAIGNS == jadv.CAMPAIGNS
    assert (padv.CAMPAIGN_METRIC, padv.CAMPAIGN_HELP) == \
        (jadv.CAMPAIGN_METRIC, jadv.CAMPAIGN_HELP)
    assert padv.build(padv.CampaignPlan(), 3, 10, 0) is None
    for bad in (dict(campaign="warp"), dict(campaign="hug", attackers=1.5),
                dict(campaign="roleflood", attackers=0.2, flood=-1),
                dict(campaign="hug", attackers=0.2, hug_up=0.5)):
        errs = []
        for mod in (padv, jadv):
            try:
                mod.CampaignPlan(**bad).validate()
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]


# ------------------------------------------------------------------ trust


def _pool_stream(rounds=24, n=12, d=16, seed=3):
    """A verifier's pools: honest rows around a drifting mean, a sybil
    pair of near-duplicates, a large-norm poisoner, and a hugger whose
    residual walks up while it is accepted."""
    rng = np.random.default_rng(seed)
    ids_all = list(range(1, n + 1))
    hug = 1.0
    for it in range(rounds):
        ids = sorted(rng.choice(ids_all, size=9, replace=False).tolist())
        mean = rng.normal(size=d)
        rows = mean + 0.3 * rng.normal(size=(len(ids), d))
        for k, pid in enumerate(ids):
            if pid in (11, 12):
                rows[k] = mean + 2.0 + 0.01 * rng.normal(size=d)
            if pid == 10:
                rows[k] *= 6.0
            if pid == 9:
                rows[k] = mean + hug * np.ones(d) * 0.2
        hug *= 1.3
        norms = np.linalg.norm(rows, axis=1)
        unit = rows / np.maximum(norms, 1e-12)[:, None]
        cos = unit @ unit.T
        np.fill_diagonal(cos, -1.0)
        dist = ((rows[:, None, :] - rows[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(dist, np.inf)
        f = len(ids) // 2
        scores = np.sort(dist, axis=1)[:, :len(ids) - f - 2].sum(1)
        keep = np.zeros(len(ids), bool)
        keep[np.argsort(scores, kind="stable")[:len(ids) - f]] = True
        centroid = rows[keep].mean(0)
        residuals = np.linalg.norm(rows - centroid, axis=1)
        records = {pid: bool(rng.random() < 0.8) for pid in ids}
        committee = set(rng.choice(ids_all, size=3, replace=False).tolist()) \
            if it % 5 else None
        yield (it, ids, [float(v) for v in norms], [float(v) for v in residuals],
               [float(v) for v in scores], [bool(v) for v in keep],
               cos.tolist(), records, committee)


def _ledger_run(mod, plan_kw):
    led = mod.TrustLedger(mod.TrustPlan(**plan_kw), 13)
    trail = []
    for it, ids, norms, res, scores, keep, cos, records, committee in \
            _pool_stream():
        if it % 3 == 0:
            led.seed_fresh([ids[0]])
        trail.append(led.decide(it, ids, norms, res, scores, keep, cos))
        led.sync_block(it, records, committee)
        trail.append([(led.weight(p), led.proven(p), led.committee_clean(p))
                      for p in range(13)])
    return trail, led.trust_scores(), led.snapshot()


@pytest.mark.parametrize("plan_kw", [
    {}, dict(hold_rounds=0, ramp_rounds=0), dict(geo_ratio=1.5, mag_band=1.8,
                                                 sim_margin=0.05, drift_min_obs=3)],
    ids=["defaults", "no_hold_no_ramp", "tight"])
def test_trust_ledger_decisions_equal_reference(plan_kw):
    assert _ledger_run(pt, plan_kw) == _ledger_run(jt, plan_kw)


def test_trust_helpers_and_checks_equal_reference():
    rng = random.Random(1)
    xs = [rng.random() for _ in range(9)]
    ys = [x * 2 + rng.random() for x in xs]
    assert pt.pearson(xs, ys) == jt.pearson(xs, ys)
    assert pt.pearson([1.0, 1.0], [2.0, 3.0]) == jt.pearson([1.0, 1.0], [2.0, 3.0])
    assert pt._median(xs) == jt._median(xs)
    for name in ("TRUST_METRIC", "TRUST_HELP", "VOTES_METRIC", "VOTES_HELP",
                 "SCORERS", "CREDIT_CAP"):
        assert getattr(pt, name) == getattr(jt, name)
    for bad in (dict(geo_ratio=1.0), dict(sim_margin=1.0), dict(drift_lo=0.7),
                dict(ramp_floor=0.0), dict(stream_cap=0)):
        errs = []
        for mod in (pt, jt):
            with pytest.raises(ValueError) as e:
                mod.TrustPlan(**bad).validate()
            errs.append(str(e.value))
        assert errs[0] == errs[1]
