"""The hierarchical aggregation overlay live, on the port
(`biscotti_tpu_torch/runtime/{overlay,peer}.py`): the four live cases of
the reference's tests/test_overlay.py, run with all-port `PeerAgent`s on
the CPU, with the reference's configuration (creditcard, n = 7, 1
verifier, 2 miners, 1 noiser, seed 3, overlay group 3) and its
assertions.

  * secure aggregation, overlay on vs off: every chain equal, on == off,
    and the miners registered a subtree's aggregate;
  * plain mode: the update fan-out and the block broadcast ride the
    relays, and the chains equal the flat run's;
  * a corrupted subtree: a Byzantine leaf's share rows poison its
    subtree's aggregate, the miners refuse it, the relay falls back to
    per-member frames, and only the offender is rejected;
  * seeded poison: the Krum verdicts sealed into the chain are the same
    with the overlay on and off.

Windows are test_torch_peer.py's WINDOWS (20/60/20/20/20 s): deadlines
bound only the unhappy path, so they cost nothing when no deadline is
reached. Ports are 18500-18599, which no other test file uses."""

import asyncio

import numpy as np
import pytest

from biscotti_tpu_torch.config import BiscottiConfig, Timeouts
from biscotti_tpu_torch.runtime.peer import PeerAgent
from test_torch_peer import WINDOWS

pytestmark = pytest.mark.overlay

N = 7
GROUP = 3


def _cfg(i, port, **kw):
    base = dict(
        node_id=i, num_nodes=N, dataset="creditcard", base_port=port,
        num_verifiers=1, num_miners=2, num_noisers=1,
        secure_agg=True, noising=False, verification=True,
        max_iterations=2, convergence_error=0.0, sample_percent=1.0,
        batch_size=8, timeouts=Timeouts(**WINDOWS), seed=3)
    base.update(kw)
    return BiscottiConfig(**base)


def _run_cluster(port, agent_cls=PeerAgent, byzantine=(), **kw):
    async def go():
        agents = [(agent_cls if i in byzantine else PeerAgent)(
            _cfg(i, port, **kw), device="cpu") for i in range(N)]
        return await asyncio.gather(*(a.run() for a in agents))

    return asyncio.run(go())


def _overlay(port, **kw):
    return _run_cluster(port, overlay=True, overlay_group=GROUP, **kw)


def _overlay_counters(results):
    out = {}
    for r in results:
        for k, v in r["counters"].items():
            if k.startswith("overlay"):
                out[k] = out.get(k, 0) + v
    return out


def test_secure_agg_overlay_chains_equal_flat_run():
    """Same seed, overlay on vs off: identical chains, with the overlay
    run aggregating subtrees (round 1 groups workers 0 and 2 under relay
    2, ROADMAP C6)."""
    off = _run_cluster(18500)
    on = _overlay(18520)
    assert all(r["chain_dump"] == off[0]["chain_dump"] for r in off)
    assert all(r["chain_dump"] == on[0]["chain_dump"] for r in on)
    assert on[0]["chain_dump"] == off[0]["chain_dump"]
    lines = on[0]["chain_dump"].splitlines()
    assert len(lines) >= 3 and "ndeltas=0" not in lines[1]
    c_on = _overlay_counters(on)
    assert c_on.get("overlay_aggregate_registered", 0) > 0
    assert c_on.get("overlay_offer_sent", 0) > 0
    assert _overlay_counters(off) == {}
    snap = on[0]["telemetry"]["overlay"]
    assert snap["enabled"] and snap["depth"] == 3 \
        and snap["group_size"] == GROUP


def test_plain_mode_overlay_relays_and_chains_equal():
    """Plain mode: the update fan-out and the block broadcast ride the
    relay, content untouched, so the chains equal the flat run's."""
    kw = dict(secure_agg=False, verification=False)
    off = _run_cluster(18540, **kw)
    on = _overlay(18550, **kw)
    assert all(r["chain_dump"] == on[0]["chain_dump"] for r in on)
    assert on[0]["chain_dump"] == off[0]["chain_dump"]
    c = _overlay_counters(on)
    assert c.get("overlay_relayed_sent", 0) > 0
    assert c.get("overlay_relay_forwarded", 0) > 0


def test_corrupted_subtree_falls_back_to_exact_evidence():
    """A Byzantine leaf poisons its subtree's aggregate: the miners refuse
    it, the relay falls back to per-member frames, and the per-update
    checks reject exactly the offender. The leaf is worker 0, which
    shares round 1's subtree with worker 2 (relay 2) in the port's own
    rounds, so the case is not vacuous."""
    bad = 0

    class Corrupt(PeerAgent):
        async def _overlay_submit_secret(self, it, commitment, u, shares,
                                         blind_rows, comms):
            shares = np.array(shares, np.int64)
            shares[:, 0] += 1  # breaks share-vs-commitment consistency
            return await super()._overlay_submit_secret(
                it, commitment, u, shares, blind_rows, comms)

    results = _overlay(18570, agent_cls=Corrupt, byzantine={bad})
    c = _overlay_counters(results)
    rejected = sum(r["counters"].get("submission_rejected", 0)
                   for r in results)
    offered = results[bad]["counters"].get("overlay_offer_sent", 0) \
        + results[bad]["counters"].get("overlay_offer_local", 0)
    assert offered > 0
    assert c.get("overlay_aggregate_refused", 0) > 0
    assert c.get("overlay_fallback_forwarded", 0) > 0
    assert rejected > 0
    dumps = [r["chain_dump"] for r in results]
    assert all(d == dumps[0] for d in dumps)
    assert "ndeltas=0" not in dumps[0].splitlines()[1]


def test_seeded_poison_verdicts_identical_with_overlay():
    """Seeded poison: defense traffic is point-to-point, so the Krum
    verdicts and the records sealed into the chain are the same with the
    overlay on and off."""
    kw = dict(poison_fraction=0.3, max_iterations=1)
    off = _run_cluster(18580, **kw)
    on = _overlay(18590, **kw)
    assert all(r["chain_dump"] == on[0]["chain_dump"] for r in on)
    assert on[0]["chain_dump"] == off[0]["chain_dump"]
    for key in ("update_rejected", "submission_rejected"):
        assert sum(r["counters"].get(key, 0) for r in on) \
            == sum(r["counters"].get(key, 0) for r in off)
