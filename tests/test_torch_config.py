"""The port's full configuration (`biscotti_tpu_torch/config.py`) against
the reference's: one dict builds both packages' configs, and every field,
derived property, plan and CLI parse is equal; every construction check
raises alike, with the same message."""

import argparse

import pytest

from biscotti_tpu import config as jc
from biscotti_tpu.ops import trust as jtrust
from biscotti_tpu.runtime import adversary as jadv
from biscotti_tpu.runtime import admission as jadm
from biscotti_tpu.runtime import faults as jfaults
from biscotti_tpu.runtime import placement as jplace
from biscotti_tpu_torch import config as pc
from biscotti_tpu_torch.ops import trust as ptrust
from biscotti_tpu_torch.runtime import adversary as padv
from biscotti_tpu_torch.runtime import admission as padm
from biscotti_tpu_torch.runtime import faults as pfaults
from biscotti_tpu_torch.runtime import placement as pplace

PLANS = {"fault_plan": "FaultPlan", "admission_plan": "AdmissionPlan",
         "campaign_plan": "CampaignPlan", "placement_plan": "PlacementPlan",
         "trust_plan": "TrustPlan", "timeouts": "Timeouts"}
MODS = {"port": (pc, pfaults, padm, padv, pplace, ptrust),
        "ref": (jc, jfaults, jadm, jadv, jplace, jtrust)}


def build(side: str, kw: dict):
    """The config of package `side` from one plain dict: nested plans as
    dicts, the defense by name."""
    mods = MODS[side]
    kw = dict(kw)
    for key, cls in PLANS.items():
        if key in kw:
            owner = next(m for m in mods if hasattr(m, cls))
            kw[key] = getattr(owner, cls)(**kw[key])
    if "defense" in kw:
        kw["defense"] = mods[0].Defense(kw["defense"])
    return mods[0].BiscottiConfig(**kw)


def _view(cfg):
    return (repr(cfg), cfg.num_samples, cfg.krum_update_thresh,
            cfg.total_shares, cfg.shares_per_miner, cfg.collusion_probability,
            cfg.collusion_threshold, cfg.quant_scale,
            [cfg.port_of(i) for i in range(3)])


GOOD = [
    {},
    dict(num_nodes=100, num_miners=11, num_verifiers=12, defense="MULTIKRUM",
         share_redundancy=2.0),
    dict(defense="TRIMMED_MEAN", secure_agg=False, trim_fraction=0.2),
    dict(defense="ENSEMBLE", trust_plan=dict(geo_ratio=2.0, hold_rounds=1)),
    dict(fault_plan=dict(seed=3, drop=0.1, churn=0.2, slow=0.3,
                         slow_preset="tee")),
    dict(admission_plan=dict(enabled=True, update_rate=10.0)),
    dict(campaign_plan=dict(campaign="hug", attackers=0.2), poison_fraction=0.2),
    dict(placement_plan=dict(enabled=True, interval=3)),
    dict(overlay=True, overlay_group=4, wire_codec="f32+zlib", trace=True),
    dict(pipeline=True, pipeline_depth=2, speculation=True),
    dict(device_crypto=True, timeouts=dict(update_s=4.0, block_s=20.0,
                                           krum_s=4.0, share_s=4.0, rpc_s=6.0)),
]

BAD = [
    dict(defense="TRIMMED_MEAN"),
    dict(defense="TRIMMED_MEAN", secure_agg=False, trim_fraction=0.5),
    dict(wire_codec="gzip"),
    dict(wire_topk=0.0),
    dict(wire_chunk_bytes=-1),
    dict(pipeline_depth=0),
    dict(speculation=True),
    dict(admission_plan=dict(enabled=True, bulk_rate=0.0)),
    dict(campaign_plan=dict(campaign="nope")),
    dict(campaign_plan=dict(campaign="roleflood", attacker_node=40)),
    dict(campaign_plan=dict(campaign="sybil", attackers=0.2), fedsys=True),
    dict(placement_plan=dict(enabled=True, max_moves=0)),
    dict(trust_plan=dict(sim_margin=0.0)),
    dict(defense="ENSEMBLE", fedsys=True),
    dict(fg_min_cluster=0),
    dict(fault_plan=dict(churn=1.0)),
    dict(fault_plan=dict(slow=0.2, slow_preset="warp")),
    dict(fault_plan=dict(slow=1.5)),
    dict(fault_plan=dict(slow=0.2, slow_factor=0.5)),
    dict(deadline_margin=0.9),
    dict(deadline_floor_s=0.0),
    dict(snapshot_tail=0),
    dict(trace=True, telemetry=False),
    dict(protocol_version=99),
    dict(overlay=True, overlay_group=1),
    dict(overlay_group=-2),
]


@pytest.mark.parametrize("kw", GOOD, ids=range(len(GOOD)))
def test_one_dict_builds_equal_configs(kw):
    assert _view(build("port", kw)) == _view(build("ref", kw))


@pytest.mark.parametrize("kw", BAD, ids=range(len(BAD)))
def test_every_check_raises_alike(kw):
    errs = []
    for side in ("port", "ref"):
        with pytest.raises(ValueError) as e:
            build(side, kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_share_layout_checks_raise_alike():
    for kw in (dict(share_redundancy=0.5), dict(share_redundancy=1.9,
                                                num_miners=2, poly_size=10)):
        errs = []
        for side in ("port", "ref"):
            with pytest.raises(ValueError) as e:
                build(side, kw).total_shares
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("argv", [
    [],
    ["-i", "2", "-t", "12", "-d", "mnist", "--model", "mnist_cnn", "-na", "2",
     "-nv", "4", "-sa", "0", "--defense", "TRIMMED_MEAN", "-ns", "50",
     "--device-crypto", "1", "--fault-drop", "0.1", "--fault-seed", "4"],
    ["--overlay", "1", "--overlay-group", "3", "--wire-codec", "f32+zlib",
     "--trace", "1", "--protocol-version", "0", "--metrics-port", "26600"],
], ids=["defaults", "peer_flags", "wire_flags"])
def test_cli_parses_to_equal_configs(argv):
    cfgs = []
    for mod in (pc, jc):
        ap = argparse.ArgumentParser()
        mod.BiscottiConfig.add_args(ap)
        cfgs.append(mod.BiscottiConfig.from_args(ap.parse_args(argv)))
    assert _view(cfgs[0]) == _view(cfgs[1])
    assert repr(cfgs[0].replace(seed=9)) == repr(cfgs[1].replace(seed=9))


@pytest.mark.parametrize("n,v,m,rs,krum", [(10, 3, 3, False, True),
                                           (100, 11, 12, True, True),
                                           (250, 3, 3, True, False)])
def test_timeouts_scaling_equals_reference(n, v, m, rs, krum):
    assert repr(pc.Timeouts().scaled(n, v, m, rs, krum)) == \
        repr(jc.Timeouts().scaled(n, v, m, rs, krum))
