"""Twin of `tests/test_crypto_kernels.py::test_device_cluster_bit_identity_guard`
(:618-700) on the port's live peer: one seeded secure-aggregation cluster
of 5 creditcard peers with a share-corrupting Byzantine peer (the highest
id off round 0's committees, drawn as the reference test draws it),
pipelined rounds with batched intake and no defense, one round.

The reference's own cluster runs as written on its CPU path. The port's
runs twice, on its native host plane and with the device crypto plane
armed on the CPU (`kernels.set_enabled(True, device="cpu")`, every wrapper
computing its plain version on CPU tensors), each training on the
reference run's batch rows (`torch_twins.inject_reference_draws`). All
three runs must agree on what the reference test compares between its
two planes: each run's honest chains equal and the three chains equal
bit for bit, the honest peers' `submission_rejected` evidence (id,
source, reason) equal and not empty, and the stake maps equal with the
corrupter debited below its genesis stake. Round 0's committees pool
every worker (3 workers, 3 samples), so no arrival order decides the
block (ROADMAP C8).

The armed case takes ~2 min on the CPU (the plain ladders) and is marked
`slow`; on the card the same drill runs armed at the mnist width in
`chip_smoke.py`'s `acceptance` (a).

Ports are 22500-22599, which no other test file uses."""

import pytest

import test_byzantine as jb
from biscotti_tpu_torch.crypto import kernels
from torch_twins import (PORT, REF, cfg, reference_draws, round0_vanilla,
                         run_cluster)

pytestmark = pytest.mark.cryptokernel

# the reference test's windows (test_crypto_kernels.py:653)
WIDE = dict(update_s=25.0, block_s=90.0, krum_s=20.0, share_s=25.0,
            rpc_s=25.0)
# armed on the CPU, every commitment and settle runs the plain ladders
# (~1e5 small int64 ops an msm; a worker's commitment takes seconds), and
# each peer's prewarm runs before its server starts, so one peer can
# serve tens of seconds after another first calls it. That run takes the
# windows `chip_smoke.py` gives an armed cluster and a retry budget that
# rides out the skew (`test_torch_peer_armed.py`'s); an honest round
# mints once its workers are accounted for, so neither changes what the
# round decides, only whether a deadline is reached first
ARMED_CPU = dict(update_s=120.0, block_s=300.0, krum_s=120.0, share_s=120.0,
                 rpc_s=120.0)
RETRIES = dict(rpc_retries=10, rpc_backoff_base_s=0.5, rpc_backoff_cap_s=5.0,
               breaker_threshold=12)
N = 5


class CorruptSharePeer(PORT.PeerAgent):
    """Commits honestly, then ships garbage share rows."""

    def _secret_arrays(self, shares, blind_rows, comms, sl):
        arrays = super()._secret_arrays(shares, blind_rows, comms, sl)
        arrays["share_rows"] = arrays["share_rows"] + 12345
        return arrays


def _guard_run(pkg, port, draws=None, device_crypto=False):
    """The reference test's `run(port, device)` on `pkg`: (results,
    agents, the corrupter, the honest chain dump, the sorted rejection
    evidence, the stake map)."""
    cfgs = [cfg(pkg, i, N, port, ARMED_CPU if device_crypto else WIDE,
                secure_agg=True, noising=False, verification=True,
                defense="NONE", max_iterations=1, sample_percent=1.0,
                batch_size=8, seed=3, pipeline=True, batch_intake=True,
                device_crypto=device_crypto,
                **(RETRIES if device_crypto else {}))
            for i in range(N)]
    byz = round0_vanilla(pkg, N)
    cls = jb.CorruptSharePeer if pkg is REF else CorruptSharePeer
    try:
        results, agents = run_cluster(pkg, cfgs, classes={byz: cls},
                                      draws=draws)
    finally:
        kernels.set_enabled(False)
    honest = [(r, a) for r, a in zip(results, agents) if a.id != byz]
    dumps = [r["chain_dump"] for r, _ in honest]
    assert all(d == dumps[0] for d in dumps), "chain-equality oracle violated"
    evidence = sorted(
        (a.id, ev.get("source"), ev.get("reason"))
        for _, a in honest
        for ev in a.tele.recorder.tail(100000)
        if ev.get("event") == "submission_rejected")
    stake = honest[0][1].chain.latest_stake_map()
    return results, agents, byz, dumps[0], evidence, stake


@pytest.fixture(scope="module")
def reference_run():
    """The reference's cluster on its CPU path, once for both planes."""
    return _guard_run(REF, 22500)


# the armed plane's plain ladders on the CPU take ~2 min for this round
# (one msm ~1e5 small int64 ops), so that case sits outside tier-1
@pytest.mark.parametrize("plane", [
    "native", pytest.param("armed_cpu", marks=pytest.mark.slow)])
def test_device_cluster_bit_identity_guard(reference_run, plane):
    """The port's native plane, and its device plane armed on the CPU,
    each give the reference's chain, rejection evidence (reason included)
    and stake debits."""
    _, ref_agents, byz, ref_dump, ref_ev, ref_stake = reference_run
    armed = plane == "armed_cpu"
    if armed:
        kernels.reset_counters()
        kernels.set_enabled(True, device="cpu")
    results, _, port_byz, dump, evidence, stake = _guard_run(
        PORT, 22520 + 20 * armed, reference_draws(ref_agents),
        device_crypto=armed)
    assert port_byz == byz
    assert ref_ev, "the Byzantine peer was never rejected"
    assert ref_stake[byz] < 10, "the cheat went undebited"
    assert dump == ref_dump, "the port's chain diverged from the reference's"
    assert evidence == ref_ev, "rejection evidence diverged"
    assert stake == ref_stake, "stake debits diverged"
    if armed:
        # the miners' folds and settles ran on the armed plane
        calls = kernels.device_calls()
        assert calls.get("grid_validate", 0) >= 1 \
            and calls.get("msm", 0) >= 1, calls
        assert all(r["telemetry"]["device_crypto"]["active"] for r in results)
