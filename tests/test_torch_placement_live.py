"""Twins of `tests/test_placement.py`'s live migration cases on the port:
`runtime/placement.py` and the ticket's restore in `PeerAgent`.

Each scenario runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords and makes the reference test's own assertions on the
port's run. A ticket is pure in its donor: the port's ticket carries the
reference's keys, crosses the wire in the reference's layout, and a
ticket of either package restores a fresh agent of the other with the
donor's chain. The controller's moves are pure in its plan and signals,
so the port's moves, assignment and migration metrics must be the
reference's; the runs are also held to the reference's rejected ids,
round 0's plain-mode block (ROADMAP C10) where no move cuts it, and the
stake rule.

Ports are 20900-21099, which no other test file uses."""

import asyncio

import numpy as np
import pytest

from torch_twins import (PACKAGES, PORT, REF, assert_first_block_parity, cfg,
                         inject_reference_draws, outcome, reference_draws,
                         run_cluster, twin, warm)

pytestmark = pytest.mark.placement

# the reference file's windows (test_placement.py:37)
FAST = dict(update_s=5.0, block_s=20.0, krum_s=4.0, share_s=5.0, rpc_s=6.0)


def _cfg(pkg, i, n, port, **kw):
    return cfg(pkg, i, n, port, FAST, **kw)


def _defaults_off(pkg, port, draws):
    n = 3
    cfgs = [_cfg(pkg, i, n, port) for i in range(n)]
    assert not cfgs[0].placement_plan.enabled
    with pytest.raises(ValueError, match="requires an enabled"):
        pkg.placement.PlacementController(lambda *a: None, {},
                                          pkg.placement.PlacementPlan())
    results, agents = run_cluster(pkg, cfgs, draws=draws)
    assert len({r["chain_dump"] for r in results}) == 1
    for r in results:
        snap = r["telemetry"]
        assert not any(k.startswith("biscotti_migration_")
                       or k.startswith("biscotti_dkg_")
                       for k in snap["metrics"])
        assert not any(k.startswith("migration_") or k.startswith("dkg_")
                       for k in snap["counters"])
    assert all(a._drain_token is None for a in agents)
    return results, agents


def test_defaults_off_bit_identity_and_zero_metrics():
    got = twin(_defaults_off, 20900, stride=10)
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0])


# ------------------------------------------- tickets via controller seams


def _donor(pkg, port, draws, secure):
    results, agents = run_cluster(
        pkg, [_cfg(pkg, i, 3, port, secure_agg=secure, noising=secure)
              for i in range(3)], draws=draws)
    assert len({r["chain_dump"] for r in results}) == 1
    donor = agents[1]
    assert donor.chain.latest.iteration >= 1
    # non-trivial ledger state, to prove it survives the move
    donor.health.record_failure(2)
    donor.health.record_failure(2)
    donor.admission.restore_state({"shed_counts": {"update_rate": 5},
                                   "inflight_peak": 7, "buckets": {}})
    donor.membership_epoch = 4
    donor._ef_residual = np.arange(donor.trainer.num_params,
                                   dtype=np.float64)
    return results, agents


def _restore(pkg, port, secure, donor, ticket):
    """A fresh agent of `pkg` from `ticket`; the reference test's checks
    against `donor` (an agent of either package)."""
    fresh = pkg.PeerAgent(_cfg(pkg, 1, 3, port, secure_agg=secure,
                               noising=secure), ticket=ticket,
                          **pkg.agent_kw)
    try:
        assert fresh.chain.dump() == donor.chain.dump()
        assert fresh.chain.latest_stake_map() \
            == donor.chain.latest_stake_map()
        assert fresh.iteration == donor.iteration
        assert fresh.health.export_state()["2"]["failures"] == 2
        adm = fresh.admission.export_state()
        assert adm["shed_counts"].get("update_rate", 0) >= 5
        assert adm["inflight_peak"] >= 7
        # the donor's own tallies, whatever its run shed before the move
        was = donor.admission.export_state()
        assert adm["shed_counts"] == was["shed_counts"]
        assert adm["inflight_peak"] == was["inflight_peak"]
        assert fresh.membership_epoch == 4
        assert np.array_equal(fresh._ef_residual, donor._ef_residual)
        assert fresh.counters.get("migration_restored") == 1
    finally:
        fresh.pool.close()
        fresh.server.close_now()


def _roundtrip(pkg, port, draws, secure):
    results, agents = _donor(pkg, port, draws, secure)
    donor = agents[1]
    pl = pkg.placement
    ticket = pl.ticket_from_agent(donor)
    assert ticket["node"] == 1
    assert pl.ticket_nbytes(ticket) > 0
    assert not any("seed" in k or "key" in k for k in ticket)
    meta, arrays = pl.ticket_wire(ticket)
    assert "chain_arrays" not in meta and "ef_residual" not in meta
    wired = pl.ticket_unwire(meta, arrays)
    assert np.array_equal(wired["ef_residual"], donor._ef_residual)
    _restore(pkg, port, secure, donor, wired)
    return results, agents, (meta, arrays)


@pytest.mark.parametrize("secure,port", [(False, 20920), (True, 20940)],
                         ids=["plain", "secure"])
def test_ticket_roundtrip_state_survives_move(secure, port):
    got = twin(lambda pkg, p, d: _roundtrip(pkg, p, d, secure), port,
               stride=10)
    (ref_meta, ref_arrays), (meta, arrays) = (got[k][2]
                                              for k in ("reference", "port"))
    assert sorted(meta) == sorted(ref_meta)
    # the arrays name each record of the donor's chain (`b<h>.d<j>.delta`),
    # so each package's keys are what the other's chain codec gives for
    # that donor's own chain; the two runs' key sets are equal where their
    # chains carry the same records (a plain-mode run parts after round 0,
    # ROADMAP C10, and a worker that misses a window parts either mode,
    # C14)
    for (m, a), other in (((meta, arrays), REF), ((ref_meta, ref_arrays),
                                                  PORT)):
        chain_keys = {k for k in a if k != "__ef_residual__"}
        blocks = other.wire.unpack_chain(m["chain_meta"],
                                         {k: a[k] for k in chain_keys})
        assert set(other.wire.pack_chain(blocks)[1]) == chain_keys
        assert set(a) - chain_keys == {"__ef_residual__"}
    if outcome(got["reference"][1][1]) == outcome(got["port"][1][1]):
        assert sorted(arrays) == sorted(ref_arrays)
    # a ticket of either package restores an agent of the other
    for src, dst, wire in (("port", REF, (meta, arrays)),
                           ("reference", PORT, (ref_meta, ref_arrays))):
        donor = got[src][1][1]
        _restore(dst, port + 5, secure, donor,
                 dst.placement.ticket_unwire(*wire))
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0],
                              first_block=not secure)


def _forged(pkg, port, draws):
    results, agents = run_cluster(
        pkg, [_cfg(pkg, i, 3, port) for i in range(3)], draws=draws)
    donor = agents[0]
    ticket = pkg.placement.ticket_from_agent(donor)
    for key, arr in ticket["chain_arrays"].items():
        if np.issubdtype(np.asarray(arr).dtype, np.floating):
            ticket["chain_arrays"][key] = np.asarray(arr) + 1.0
    forged = pkg.PeerAgent(_cfg(pkg, 0, 3, port), ticket=ticket,
                           **pkg.agent_kw)
    try:
        # adoption refused: the chain never left genesis
        assert forged.chain.latest.iteration == -1
        assert len(forged.chain.blocks) == 1
        assert forged.chain.latest.iteration < donor.chain.latest.iteration
        refused = forged.chain.dump()
    finally:
        forged.pool.close()
        forged.server.close_now()
    return results, agents, refused


def test_forged_ticket_refused_like_forged_snapshot():
    got = twin(_forged, 20960, stride=10)
    assert got["port"][2] == got["reference"][2]
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0])


# ------------------------------------------------- live migration runs


def _controller(pkg, n, port, plan, victim, draws, made, iterations=3,
                **kw):
    """The reference's two-hive fixture: host0 carries every peer and
    reads hot through the victim's slow factor, host1 starts empty."""
    pl = pkg.placement
    c = _cfg(pkg, 0, n, port, max_iterations=iterations,
             placement_plan=plan, **kw)
    c = c.replace(timeouts=c.timeouts.scaled(n, c.num_verifiers,
                                             c.num_miners))
    warm(pkg, c)
    hubs = {"host0": pkg.hive.LoopbackHub(), "host1": pkg.hive.LoopbackHub()}

    def make_agent(node, hive_id, ticket):
        a = pkg.PeerAgent(c.replace(node_id=node), hive=hubs[hive_id],
                          ticket=ticket, **pkg.agent_kw)
        if pkg is PORT and draws:
            inject_reference_draws(a, draws[node])
        made.setdefault(node, []).append(a)
        return a

    def signals(assignment, agents):
        by = {"host0": [], "host1": []}
        for node, hid in sorted(assignment.items()):
            by[hid].append(node)
        return [pl.HostSignals(hive_id=hid, peers=tuple(nodes),
                               slow_factors=({victim: 9.0}
                                             if victim in nodes else {}))
                for hid, nodes in sorted(by.items())]

    return pl.PlacementController(make_agent, {i: "host0" for i in range(n)},
                                  plan, signals_fn=signals)


def _first_incarnations(made):
    return {node: agents[0] for node, agents in made.items()}


def _mid_intake(pkg, port, draws):
    plan = pkg.placement.PlacementPlan(enabled=True, seed=5, interval=1,
                                       max_moves=1, lag_hot_s=0.0,
                                       slow_hot=1.5, min_hive_peers=1)
    made = {}
    ctl = _controller(pkg, 4, port, plan, 3, draws, made, iterations=3,
                      overlay_group=2)
    results = asyncio.run(asyncio.wait_for(ctl.run(), 180))
    equal, _, real = pkg.membership.surviving_prefix_oracle(results)
    assert equal, "migration forked the chain"
    assert real >= 2, "the mint stalled"
    assert [n for _, n, _, _ in ctl.moves_applied] == [3]
    moved = next(r for r in results if r["node"] == 3)
    assert moved["hive"] == "host1" and moved["migrations"] == 1
    assert moved["counters"].get("migration_restored") == 1
    anchor = next(r for r in results if r["node"] == 0)
    assert anchor["iterations"] >= 3, "anchor never finished its rounds"
    s = ctl.summary()
    assert s["moves"] and s["downtime_s"] and s["ticket_bytes"]
    assert s["assignment"]["3"] == "host1"
    agents = [made[i][-1] for i in range(4)]
    return results, agents, (s["assignment"], ctl.moves_applied), \
        _first_incarnations(made)


def test_mid_intake_migration_degrades_not_stalls():
    got = _twin_controller(_mid_intake, 20980)
    assert got["port"][2] == got["reference"][2]
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0],
                              first_block=False)


def _metrics(pkg, port, draws):
    plan = pkg.placement.PlacementPlan(enabled=True, seed=5, interval=1,
                                       max_moves=1, lag_hot_s=0.0,
                                       slow_hot=1.5)
    made = {}
    ctl = _controller(pkg, 3, port, plan, 2, draws, made, iterations=2)
    reg = pkg.registry.MetricsRegistry()
    ctl.registry = reg
    results = asyncio.run(asyncio.wait_for(ctl.run(), 180))
    equal, _, _ = pkg.membership.surviving_prefix_oracle(results)
    assert equal
    assert len(ctl.moves_applied) == 1
    snap = reg.snapshot()
    pl = pkg.placement
    moves = [(r["labels"]["reason"], r["value"])
             for r in snap[pl.MOVES_METRIC]["series"]]
    assert moves == [("slow", 1.0)]
    assert snap[pl.DOWNTIME_METRIC]["series"][0]["count"] == 1
    assert snap[pl.TICKET_BYTES_METRIC]["series"][0]["sum"] > 0
    agents = [made[i][-1] for i in range(3)]
    return results, agents, (moves, ctl.moves_applied), \
        _first_incarnations(made)


def _twin_controller(scenario, port):
    """`twin` for a controller run: the port takes the draws of the
    reference's first incarnations."""
    out, draws = {}, None
    for k, pkg in enumerate(PACKAGES):
        out[pkg.name] = got = scenario(pkg, port + 10 * k, draws)
        if pkg is REF:
            draws = reference_draws(got[3].values())
    return out


def test_migration_metrics_emitted_when_registry_attached():
    got = _twin_controller(_metrics, 21000)
    assert got["port"][2] == got["reference"][2]
    assert_first_block_parity(got["reference"][1][0], got["port"][1][0],
                              first_block=False)
