"""The port's overlay, placement and membership planes
(`biscotti_tpu_torch/runtime/{overlay,placement,membership}.py`) against
the reference's: overlay trees and routing plans, host layouts, pressure
scores, placement decisions and the churn oracle's verdicts are equal
(exact) on the same seeded inputs."""

import random

import numpy as np
import pytest

from biscotti_tpu.runtime import membership as jm
from biscotti_tpu.runtime import overlay as jo
from biscotti_tpu.runtime import placement as jp
from biscotti_tpu_torch.runtime import membership as pm
from biscotti_tpu_torch.runtime import overlay as po
from biscotti_tpu_torch.runtime import placement as pp


def _tree(mod, overlay, group, n, seed):
    r = mod.Router(overlay, group, n, seed)
    rng = random.Random(seed)
    plans = []
    for it in range(6):
        for me in range(0, n, 3):
            targets = sorted(rng.sample(range(n), min(n, 9)))
            plans.append(r.plan(targets, it, me))
    return (r.enabled, r.depth,
            [r.gid_of(p) for p in range(n)],
            [r.members(g) for g in range(-(-n // max(1, group)))],
            [[r.relay(g, it) for g in range(-(-n // max(1, group)))]
             for it in range(8)] if r.group else [],
            [r.my_relay(p, 3) for p in range(n)] if r.group else [],
            plans)


@pytest.mark.parametrize("overlay,group,n,seed", [
    (False, 0, 10, 0), (True, 1, 10, 0), (True, 2, 9, 1), (True, 4, 22, 7),
    (True, 5, 40, 13)])
def test_overlay_trees_and_plans_equal_reference(overlay, group, n, seed):
    assert _tree(po, overlay, group, n, seed) == _tree(jo, overlay, group, n, seed)


def test_overlay_frame_estimate_and_metric_names_equal_reference():
    rng = np.random.default_rng(2)
    for meta, arrays in (({}, {}), ({"it": 3, "s": "x" * 40},
                                    {"a": rng.normal(size=17),
                                     "b": np.zeros((3, 4), np.int64)}),
                         ({"bad": {1, 2}}, None)):
        assert po.frame_estimate(meta, arrays) == jo.frame_estimate(meta, arrays)
    for name in ("DEPTH_GAUGE", "DEPTH_HELP", "FRAMES_HELP", "FRAMES_METRIC",
                 "SAVED_HELP", "SAVED_METRIC", "SUBTREE_GAUGE", "SUBTREE_HELP"):
        assert getattr(po, name) == getattr(jo, name)


@pytest.mark.parametrize("n,hosts,per_host", [(10, 3, 0), (16, 4, 0), (7, 7, 0),
                                              (0, 3, 5), (20, 6, 0)])
def test_host_layout_equals_reference(n, hosts, per_host):
    lay = pp.hive_layout(n, hosts, per_host)
    assert lay == jp.hive_layout(n, hosts, per_host)
    assert pp.aligned_overlay_group(lay) == jp.aligned_overlay_group(lay)


def _signals(mod, rng, hosts, peers_each):
    out, node = [], 0
    for h in range(hosts):
        peers = tuple(range(node, node + peers_each))
        node += peers_each
        out.append(mod.HostSignals(
            hive_id=f"h{h}", peers=peers,
            rss_bytes=rng.choice((0, 1 << 28, 3 << 28)),
            rss_drift_bytes=rng.choice((0, 1 << 20, 1 << 24)),
            loop_lag_s=rng.choice((0.0, 0.01, 0.2)),
            shed_rate=rng.choice((0.0, 0.1, 0.6)),
            slow_factors={p: rng.choice((1.0, 2.0, 8.0)) for p in peers
                          if rng.random() < 0.3}))
    return out


def _decisions(mod, plan_kw, seed):
    plan = mod.PlacementPlan(**plan_kw)
    rng = random.Random(seed)
    out = []
    for rnd in range(12):
        sigs = _signals(mod, rng, hosts=rng.randint(1, 4), peers_each=3)
        out.append(([mod.host_pressure(plan, s) for s in sigs],
                    [repr(m) for m in mod.decide(plan, sigs, rnd)]))
    return out


@pytest.mark.parametrize("plan_kw", [
    {},
    dict(enabled=True, seed=4, max_moves=2, rss_hot_bytes=1 << 28,
         rss_drift_hot_bytes=1 << 22, lag_hot_s=0.05, shed_hot=0.25,
         slow_hot=1.5),
    dict(enabled=True, seed=9, max_moves=3, lag_hot_s=0.0, shed_hot=0.0,
         slow_hot=1.5, min_hive_peers=2),
], ids=["disabled", "all_signals", "slow_only"])
def test_placement_decisions_equal_reference(plan_kw):
    assert _decisions(pp, plan_kw, 5) == _decisions(jp, plan_kw, 5)


def test_placement_plan_checks_equal_reference():
    for bad in (dict(interval=0), dict(max_moves=0), dict(min_hive_peers=0),
                dict(lag_hot_s=-1.0)):
        errs = []
        for mod in (pp, jp):
            with pytest.raises(ValueError) as e:
                mod.PlacementPlan(enabled=True, **bad).validate()
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def _dump(heights, tag=""):
    lines = ["iter=-1 ndeltas=0 hash=genesis prev=0 |w|=0.000000"]
    for h in heights:
        nd = 0 if h % 4 == 3 else 2
        lines.append(f"iter={h} ndeltas={nd} hash={tag}{h:04x} prev=p |w|=0.1")
    return "\n".join(lines)


@pytest.mark.parametrize("case", ["equal", "split", "killed_short", "churned",
                                  "all_empty"])
def test_surviving_prefix_oracle_equals_reference(case):
    results = {
        "equal": [{"chain_dump": _dump(range(6))} for _ in range(3)],
        "split": [{"chain_dump": _dump(range(6))},
                  {"chain_dump": _dump(range(6), tag="x")}],
        "killed_short": [{"chain_dump": _dump(range(8))},
                         {"chain_dump": _dump(range(2)), "killed": True},
                         {"chain_dump": _dump(range(7))}],
        "churned": [{"chain_dump": _dump(range(5))},
                    {"chain_dump": _dump(range(1)), "churned": True}],
        "all_empty": [{"chain_dump": _dump([3, 7])}, {"chain_dump": _dump([3, 7])}],
    }[case]
    assert pm.surviving_prefix_oracle(results) == \
        jm.surviving_prefix_oracle(results)
    assert pm._dump_heights(results[0]["chain_dump"]) == \
        jm._dump_heights(results[0]["chain_dump"])
