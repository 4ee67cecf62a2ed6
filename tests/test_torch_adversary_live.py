"""Twins of `tests/test_adversary.py`'s live campaign clusters on the
port: `runtime/adversary.py`, `FaultInjector.campaign` and
`runtime/membership.py::ChurnRunner`.

Each scenario runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords and makes the reference test's own assertions on the
port's run. The port is held to the reference on what no timing
decides: the recycle schedule, round 0's committee and flood target,
the rejected ids, round 0's plain-mode block (ROADMAP C10) and the
stake rule. The layout case runs the port on both layouts, TCP and a
hive on the loopback hub: the two must mint one chain and log one
campaign schedule. Under secure aggregation that schedule and chain are
the reference's; in plain mode round 0's are, and later committees
follow the blocks' last bits (ROADMAP C10).

Ports are 20500-20699, which no other test file uses."""

import asyncio

import pytest

from conftest import wait_until
from torch_twins import (PORT, REF, agent, assert_first_block_parity, cfg,
                         each_package, inject_reference_draws, outcome,
                         reference_draws, run_cluster, tight_admission, twin,
                         warm)

pytestmark = pytest.mark.campaign

# the reference file's windows (test_adversary.py:43)
FAST = dict(update_s=5.0, block_s=15.0, krum_s=3.0, share_s=5.0, rpc_s=4.0)


def _cfg(pkg, i, n, port, **kw):
    return cfg(pkg, i, n, port, FAST, **dict(dict(max_iterations=3), **kw))


# ------------------------------------------------------------ defaults off


def _defaults_off(pkg, port, draws):
    n = 3
    runs, schemas = [], []
    for k, plan in enumerate((
            pkg.adversary.CampaignPlan(),
            # an armed plan whose attacker draw is empty is as inert
            pkg.adversary.CampaignPlan(campaign="roleflood",
                                       attackers=0.0))):
        results, agents = run_cluster(
            pkg, [_cfg(pkg, i, n, port + 5 * k, campaign_plan=plan)
                  for i in range(n)], draws=draws)
        for a in agents:
            assert a.campaign is None
            assert a.pool.faults is None
        for r in results:
            snap = r["telemetry"]
            assert "campaign" not in snap
            assert pkg.adversary.CAMPAIGN_METRIC not in snap["metrics"]
            assert not any(k.startswith("campaign")
                           for k in snap["counters"])
        eq, _, real = pkg.chaos.chain_oracle(results)
        assert eq and real >= 1
        runs.append(agents)
        schemas.append([sorted(r["telemetry"]) for r in results])
    return results, agents, runs, schemas


def test_defaults_off_bit_identity_and_zero_counters():
    """Which workers round 0's block carries follows load timing: a
    worker's update can miss the 5 s window on a loaded host, in either
    package (the reference's own test compares no two runs for that
    reason; ROADMAP C18). Each run's snapshot keys must be the
    reference's; round 0's weights are compared where both runs' round 0
    carried the same workers, and the rejected ids and the stake rule
    always."""
    got = twin(_defaults_off, 20500)
    assert got["port"][3] == got["reference"][3], "the snapshot keys"
    for ref, port in zip(got["reference"][2], got["port"][2]):
        same = outcome(ref[0])["blocks"][:1] == outcome(port[0])["blocks"][:1]
        assert_first_block_parity(ref[0], port[0], first_block=same)


# ------------------------------------------------- role-aware flood campaign


def _elected_miners_per_round(pkg, anchor):
    """Each settled round's miner committee, re-derived from the anchor's
    chain by the election every peer runs."""
    c, chain, out = anchor.cfg, anchor.chain, {}
    for blk in chain.blocks[1:]:
        it = blk.iteration
        prev = chain.get_block(it - 1)
        if prev is None:
            continue
        try:
            _, miners = pkg.roles.elect_committees(
                dict(prev.stake_map), prev.hash, c.num_verifiers,
                c.num_miners, c.num_nodes)
        except ValueError:
            miners = []
        out[it] = sorted(miners)
    return out


def _roleflood(pkg, port, draws):
    n, attacker = 4, 3
    plan = pkg.adversary.CampaignPlan(campaign="roleflood",
                                      attacker_node=attacker, flood=30)
    results, agents = run_cluster(pkg, [
        _cfg(pkg, i, n, port, max_iterations=4, campaign_plan=plan,
             admission_plan=tight_admission(pkg)) for i in range(n)],
        draws=draws)
    eq, _, real = pkg.chaos.chain_oracle(results)
    assert eq and real >= 1, [r["chain_dump"] for r in results]
    for r in results:  # honest <-> honest breakers stay closed
        if r["node"] == attacker:
            continue
        for pid, h in r["telemetry"]["health"].items():
            if int(pid) != attacker:
                assert h["state"] == "closed", (r["node"], pid, h)
                assert h["opens"] == 0, (r["node"], pid, h)
    snap = results[attacker]["telemetry"]["campaign"]
    assert snap["campaign"] == "roleflood"
    assert snap["actions"]["flood_frame"] > 0
    # the flood targets are the committee the chain re-derives
    elected = _elected_miners_per_round(pkg, agents[0])
    logged = {e[0]: e[2] for e in snap["schedule"] if e[1] == "target"}
    checked = 0
    for it, miners in elected.items():
        if it in logged and attacker not in miners:
            assert logged[it] == miners, (it, logged[it], miners)
            checked += 1
    assert checked >= 2, (elected, logged)
    all_targets = {t for ts in logged.values() for t in ts}
    assert set(map(int, snap["targets_hit"])) <= all_targets
    fam = results[attacker]["telemetry"]["metrics"].get(
        pkg.adversary.CAMPAIGN_METRIC)
    assert fam is not None
    assert any(row["labels"].get("action") == "flood_frame"
               and row["value"] > 0 for row in fam["series"])
    return results, agents, logged


def test_roleflood_live_flood_follows_the_election():
    got = twin(_roleflood, 20520, stride=10)
    # round 0's committee comes from genesis alone: the same target
    ref, port = got["reference"][2], got["port"][2]
    assert 0 in ref and port.get(0) == ref[0], (port, ref)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0])


# ---------------------------------------------------- identity recycling


def _sybil_recycle(pkg, port, draws):
    n, attacker, rounds = 4, 2, 7
    plan = pkg.adversary.CampaignPlan(campaign="sybil",
                                      attacker_node=attacker,
                                      recycle_period=3, recycle_down=1)
    schedule = plan.recycle_schedule(n, rounds, protocol_seed=3)
    assert schedule, "operating point produced no recycles"
    made = {}

    def make(i):
        made[i] = agent(pkg, _cfg(
            pkg, i, n, port, max_iterations=rounds, campaign_plan=plan,
            admission_plan=tight_admission(pkg), breaker_threshold=1,
            breaker_cooldown_s=60.0), draws=draws)
        return made[i]

    async def go():
        runner = pkg.membership.ChurnRunner(make, n, schedule)
        return await runner.run(), runner.events_applied

    results, applied = asyncio.run(go())
    restarts = {(e.round, e.node, e.kind) for e in schedule
                if e.kind == pkg.faults.RESTART}
    assert {(r, nd, k) for r, nd, k in applied} >= restarts, applied
    eq, _, real = pkg.membership.surviving_prefix_oracle(results)
    assert eq and real >= 1
    opened = 0
    for r in results:
        if r["node"] == attacker or r.get("killed"):
            continue
        h = r["telemetry"]["health"].get(str(attacker))
        if not h:
            continue
        opened += h["opens"]
        if h["state"] == "closed" and h["opens"] > 0:
            assert h["successes"] > 0, h  # closed only through a probe
    assert opened >= 1, "attacker death never tripped a breaker"
    # the stake follows the node id across incarnations
    att_head = made[attacker].chain.latest.iteration
    anchor_blk = made[0].chain.get_block(att_head)
    assert anchor_blk is not None, (att_head, made[0].chain.dump())
    assert made[attacker].chain.latest_stake_map()[attacker] \
        == dict(anchor_blk.stake_map)[attacker]
    return (results, [made[i] for i in range(n)],
            [(e.round, e.node, e.kind) for e in schedule], sorted(restarts))


def test_sybil_recycle_cannot_escape_breaker_or_stake():
    got = twin(_sybil_recycle, 20540, stride=10)
    assert got["port"][2] == got["reference"][2], "the recycle schedules"
    assert got["port"][3] == got["reference"][3]
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0],
                              first_block=False)


class _SpinClient:
    """A connection-spinning sybil: each spin dials the victim from a
    fresh ephemeral port and slams update-class frames until the
    admission plane answers busy."""

    def __init__(self, pkg, host, port):
        self.rpc, self.host, self.port = pkg.rpc, host, port

    async def spin(self, frames=24):
        pool = self.rpc.Pool()
        accepted = 0
        try:
            for _ in range(frames):
                try:
                    await pool.call(self.host, self.port, "RegisterUpdate",
                                    {"iteration": 10 ** 9}, timeout=2.0)
                except self.rpc.BusyError:
                    break
                except self.rpc.RPCError:
                    accepted += 1  # admitted, refused by the handler
                except Exception:
                    break
        finally:
            pool.close()
        return accepted


def _spin_plan(pkg):
    """The reference test's spin window: a 1 token/s update refill against
    a 16-token burst."""
    return pkg.admission.AdmissionPlan(
        enabled=True, update_rate=1.0, bulk_rate=6.0, control_rate=16.0,
        burst_factor=16.0)


def _spun(pkg, port, draws):
    n, cap = 3, 8
    spin_plan = _spin_plan(pkg)
    ctl = pkg.admission.AdmissionController
    old_cap = ctl.BUCKET_CAP
    ctl.BUCKET_CAP = cap
    try:
        async def go():
            agents = [agent(pkg, _cfg(pkg, i, n, port, max_iterations=4,
                                      admission_plan=spin_plan), draws=draws)
                      for i in range(n)]
            tasks = [asyncio.ensure_future(a.run()) for a in agents]
            victim = agents[0]
            await wait_until(lambda: victim.server.serving, 10.0)
            spinner = _SpinClient(pkg, "127.0.0.1", port)
            got = [await spinner.spin() for _ in range(cap + 6)]
            return await asyncio.gather(*tasks), agents, got

        results, agents, got = asyncio.run(go())
    finally:
        ctl.BUCKET_CAP = old_cap
    victim = agents[0]
    eq, _, real = pkg.chaos.chain_oracle(results)
    assert eq and real >= 1
    burst = int(spin_plan.update_rate * spin_plan.burst_factor)
    assert got[0] >= burst // 2, got
    assert ("overflow", "update") in victim.admission._buckets, \
        sorted(victim.admission._buckets)
    tail = got[-6:]
    assert sum(tail) <= burst + 2, got
    assert sum(1 for g in tail if g <= 2) >= len(tail) - 1, got
    assert len(victim.admission._buckets) <= cap + 3
    assert victim.admission.shed_counts.get("rate", 0) > 0
    return results, agents, sorted(k for k in victim.admission._buckets
                                   if k[0] == "overflow")


def _table_at_cap(pkg):
    """The admission plane's bucket table at its cap, on a fake clock: 8
    spun identities drain their update buckets and pin the table, then an
    honest peer's first control frame and a later spun identity each get
    their class's overflow bucket; a second on, the refilled control
    overflow is reaped and one more identity takes the update overflow's
    one new token. Returns each identity's admitted frames, the table's
    keys at both moments and the shed tallies."""
    now = [50.0]
    ctl = pkg.admission.AdmissionController(_spin_plan(pkg),
                                            clock=lambda: now[0])
    ctl.BUCKET_CAP = 8

    def slam(peer, msg_type="RegisterUpdate", frames=24):
        admitted = 0
        for _ in range(frames):
            if ctl.try_admit(peer, msg_type) is not None:
                break
            ctl.release(peer)
            admitted += 1
        return admitted

    got = [slam(("127.0.0.1", 40000 + k)) for k in range(8)]
    got.append(slam(("127.0.0.1", 30001), "AdvertiseBlock", frames=1))
    got.append(slam(("127.0.0.1", 40008)))
    keys = [sorted(map(repr, ctl._buckets))]
    now[0] += 1.0
    got.append(slam(("127.0.0.1", 40009)))
    keys.append(sorted(map(repr, ctl._buckets)))
    return got, keys, ctl.shed_counts


def test_sybil_spun_identities_collapse_into_overflow_bucket():
    """Whether an honest peer's control frame reaches the victim while the
    spun buckets pin its table, and so lands in the control class's
    overflow bucket, follows timing, in either package (ROADMAP C17): each
    run's overflow keys are held to the classes, and the table's routing
    at its cap to the reference's on a fake clock."""
    got = twin(_spun, 20560, stride=10)
    for _, _, overflow in got.values():
        assert ("overflow", "update") in overflow, overflow
        assert set(overflow) <= {("overflow", c) for c in (
            REF.admission.BULK, REF.admission.UPDATE,
            REF.admission.CONTROL)}, overflow
    each_package(_table_at_cap)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0],
                              first_block=False)


# -------------------------------------------------------- layout invariance


def _layout_plan(pkg):
    return pkg.adversary.CampaignPlan(campaign="roleflood", attacker_node=3,
                                      flood=10)


def _tcp_layout(pkg, port, draws, **kw):
    n = 4
    return run_cluster(pkg, [_cfg(pkg, i, n, port,
                                  campaign_plan=_layout_plan(pkg), **kw)
                             for i in range(n)], draws=draws)


def _hive_layout(pkg, port, draws, **kw):
    c = _cfg(pkg, 0, 4, port, campaign_plan=_layout_plan(pkg), **kw)
    warm(pkg, c)
    hive = pkg.hive.Hive(c, hive_id="camp", batch_device=False,
                         **pkg.agent_kw)
    if pkg is PORT:
        for a in hive.agents:
            inject_reference_draws(a, draws[a.id])
    return asyncio.run(hive.run()), hive.agents


@pytest.mark.parametrize("secure,port", [(False, 20580), (True, 20640)],
                         ids=["plain", "secure"])
def test_campaign_schedule_identical_across_tcp_and_hive_loopback(secure,
                                                                  port):
    """The reference's plain-mode case, and the same cluster under secure
    aggregation. A plain-mode block differs from the reference's in the
    last bits (ROADMAP C10) and its hash seeds the next committees, so
    there the port's schedule is the reference's through round 0's
    target; a secure-aggregation chain is the reference's bit for bit,
    and so is its whole schedule."""
    kw = dict(secure_agg=True) if secure else {}
    tcp, hive, draws = {}, {}, None
    for k, pkg in enumerate((REF, PORT)):
        tcp[pkg.name] = _tcp_layout(pkg, port + 20 * k, draws, **kw)
        if pkg is REF:
            draws = reference_draws(tcp[pkg.name][1])
        hive[pkg.name] = _hive_layout(pkg, port + 20 * k + 10, draws, **kw)
    sched = {}
    for name in tcp:
        t_res, h_res = tcp[name][0], hive[name][0]
        assert t_res[0]["chain_dump"] == h_res[0]["chain_dump"], name
        sched[name] = t_res[3]["telemetry"]["campaign"]["schedule"]
        assert sched[name] == h_res[3]["telemetry"]["campaign"]["schedule"]
        assert any(e[1] == "target" for e in sched[name])
    if secure:
        assert sched["port"] == sched["reference"]
        assert tcp["port"][0][0]["chain_dump"] == \
            tcp["reference"][0][0]["chain_dump"]
    else:
        assert sched["port"][:1] == sched["reference"][:1], sched
        assert_first_block_parity(tcp["reference"][1][0], tcp["port"][1][0])


# ------------------------------------------------------------ hug campaign


def _hug_rule(pkg, plan, anchor, attacker, rounds):
    """The walk that the hug rule gives on a chain's own records: after a
    round in which the attacker was a worker, up if its update rides the
    round's block accepted and down if not; held after a round in which
    it sat on a committee."""
    c, chain = anchor.cfg, anchor.chain
    scale, walk = plan.hug_start, []
    for it in range(rounds):
        last = chain.get_block(it - 1) if it else None
        if last is not None:
            before = chain.get_block(it - 2)
            v, m = pkg.roles.elect_committees(
                dict(before.stake_map), before.hash, c.num_verifiers,
                c.num_miners, c.num_nodes)
            if attacker not in set(v) | set(m):
                ok = any(u.source_id == attacker and u.accepted
                         for u in last.data.deltas)
                scale = (min(plan.hug_max, scale * plan.hug_up) if ok
                         else max(plan.hug_min, scale * plan.hug_down))
        walk.append(round(scale, 6))
    return walk


def _hug(pkg, port, draws):
    n, rounds = 4, 5
    plan = pkg.adversary.CampaignPlan(campaign="hug", attacker_node=3,
                                      hug_start=0.5, hug_up=2.0,
                                      hug_max=4.0)
    results, agents = run_cluster(pkg, [
        _cfg(pkg, i, n, port, max_iterations=rounds, campaign_plan=plan)
        for i in range(n)], draws=draws)
    eq, _, real = pkg.chaos.chain_oracle(results)
    assert eq and real >= 1
    att = results[3]["telemetry"]
    assert att["counters"].get("campaign_poison", 0) >= 2
    walk = [e[2] for e in att["campaign"]["schedule"] if e[1] == "hug"]
    assert len(walk) >= 3
    # every submission accepted: a monotone, capped walk
    assert walk == sorted(walk) and walk[-1] > walk[0]
    assert walk[-1] <= 4.0
    assert att["campaign"]["hug_scale"] == walk[-1]
    assert walk == _hug_rule(pkg, plan, agents[0], 3, len(walk)), walk
    return results, agents, walk


def test_hug_live_modulation_trace():
    """Each package's walk is the hug rule on its own chain. Rounds 0 and
    1 follow from genesis and round 0's block alone, so there the walks
    are one; later committees follow the plain-mode blocks' hashes
    (ROADMAP C10), which decide the rounds in which the attacker is a
    worker."""
    got = twin(_hug, 20620, stride=10)
    assert got["port"][2][:2] == got["reference"][2][:2], \
        (got["port"][2], got["reference"][2])
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0])
