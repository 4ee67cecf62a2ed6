"""The port's live peer with the device crypto plane armed on the CPU
(`kernels.set_enabled(True, device="cpu")`, process-wide as in the
reference): an all-port cluster whose miners fold their VSS intake on the
plane, with the on-curve check through kernel B2's wrapper, and the
plain-mode intake's refusal to finish on the host after a device fault.
Helpers and ports (17100-17299) are `test_torch_peer.py`'s; the armed
cluster sits in its own file because the plane's eager ladders make it
the slowest of the peer tests."""

import asyncio

import numpy as np
import pytest

from biscotti_tpu_torch.crypto import kernels
from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
from biscotti_tpu_torch.ledger.block import Update
from biscotti_tpu_torch.runtime.peer import PeerAgent, RoundState
from test_torch_peer import SECAGG, _assert_chains_equal, _cluster, _kw, _port_cfg

# the armed plane's ladders run eagerly, ~1e5 small int64 ops an MSM, so
# on the CPU one round's intake settle and commitment batches take ~10 s
ARMED = dict(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
             rpc_s=20.0)
# each armed peer runs its prewarm (the ladders, seconds each, four threads
# on one GIL) before its server starts, so under load one peer can start
# serving tens of seconds after another sends it round 0's update; the
# default budget (2 retries from 0.05 s, a breaker after 3 failures)
# gives up in well under a second and the round mints an empty block. A
# budget of ~30 s of retries rides out that startup skew.
RETRIES = dict(rpc_retries=10, rpc_backoff_base_s=0.5, rpc_backoff_cap_s=5.0,
               breaker_threshold=12)


def test_all_port_device_crypto_armed_on_the_cpu(monkeypatch):
    """The device crypto plane armed on the CPU for the whole cluster
    (process-wide, as in the reference): the miners' VSS intake folds run
    on it (batch_intake), with the on-curve check through B2's wrapper,
    which computes its plain version on a CPU tensor."""
    monkeypatch.setenv("BISCOTTI_PALLAS_CRYPTO", "1")
    before = cv.oncurve_mask.launches
    kernels.reset_counters()
    try:
        results = _cluster(4, 17150, timeouts=ARMED, defense="KRUM",
                           device_crypto=True, batch_intake=True,
                           max_iterations=1, **SECAGG, **RETRIES)
        calls = kernels.device_calls()
    finally:
        kernels.set_enabled(False)
    _assert_chains_equal(results, 1)
    assert calls.get("grid_validate", 0) >= 1, calls
    assert cv.oncurve_mask.launches == before  # a CPU tensor never launches
    assert all(r["telemetry"]["device_crypto"]["active"] for r in results)


def test_plain_intake_raises_on_a_device_fault_when_armed(tmp_path,
                                                          monkeypatch):
    """Plain mode, batch_intake, a dealer commit key and the device plane
    armed: a fault in the plane's MSM raises out of the intake drainer
    and refuses the parked updates. The host's per-update recompute never
    runs in its place; it stays for malformed submissions only."""
    from biscotti_tpu_torch.crypto import commitments as pcm
    from biscotti_tpu_torch.models.zoo import model_for_dataset
    from biscotti_tpu_torch.runtime.rpc import RPCError
    from biscotti_tpu_torch.tools import keygen

    keygen.generate(dims=model_for_dataset("creditcard", "").num_params,
                    nodes=3, out_dir=str(tmp_path), base_port=17195)
    kw = _kw(0, 3, 17195, device_crypto=True, batch_intake=True)

    def fault(*a, **k):
        raise RuntimeError("planted device fault")

    host_recomputes = []
    monkeypatch.setattr(pcm, "verify_commitment",
                        lambda *a: host_recomputes.append(a) or True)

    async def go():
        agent = PeerAgent(_port_cfg(kw), key_dir=str(tmp_path), device="cpu")
        st = RoundState(iteration=0)
        futs = []
        for sid in (1, 2):
            delta = np.random.default_rng(sid).normal(
                size=agent.trainer.num_params)
            u = Update(source_id=sid, iteration=0, delta=delta,
                       commitment=agent._commit(agent._quantize_np(delta)))
            futs.append(asyncio.get_running_loop().create_future())
            st.plain_pending.append((u, futs[-1]))
        monkeypatch.setattr(kernels, "msm", fault)
        with pytest.raises(RuntimeError, match="planted device fault"):
            await agent._drain_plain_batch(st)
        return [f.exception() for f in futs]

    try:
        errors = asyncio.run(go())
    finally:
        kernels.set_enabled(False)
    assert all(isinstance(e, RPCError) for e in errors), errors
    assert host_recomputes == []
