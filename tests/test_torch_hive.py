"""The port's hive (`biscotti_tpu_torch/runtime/hive.py`) on the CPU,
against the reference's.

  * the batched device plane: `HiveStepper.deltas_from_draws` and
    `noise_from_draws` fed the reference `HiveStepper`'s own inputs (its
    batch indices from `sample_batch` over its `fold_in` keys, its normals
    over its noise keys), held to the reference's deltas and noise: rtol
    1e-5, atol 1e-6 for creditcard's logreg ("sgd") and mnist softmax,
    rtol 1e-4, atol 1e-4 for mnist_cnn (test_torch_sim.py's CNN
    tolerance); the noise within one float32 rounding;
  * the port stepper against the port's standalone Trainers (one batch
    and one evaluation serve every peer), `UnequalShardsError` and the
    Hive's fallback, the one-device rule for a mesh;
  * the reference's loopback tests (tests/test_hive.py) against the
    port's hub: read-only views, admission shedding, faults, lifecycle,
    byte accounting;
  * live hives over loopback: a 5-peer port hive, a reference hive and a
    port hive of 3 peers each over TCP on one seed (chains equal hash for
    hash), and an all-port TCP cluster against an all-port hive under
    ENSEMBLE (the port twin of test_trust.py's layout test).

Timeouts are the reference's FAST set; ports are 17300-17399, which no
other test file uses."""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biscotti_tpu.config import BiscottiConfig as JConfig
from biscotti_tpu.config import Timeouts as JTimeouts
from biscotti_tpu.models.trainer import sample_batch as jsample_batch
from biscotti_tpu.runtime import hive as jhive
from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts
from biscotti_tpu_torch.data import datasets as ds
from biscotti_tpu_torch.models.trainer import Trainer
from biscotti_tpu_torch.runtime import codecs as wcodecs
from biscotti_tpu_torch.runtime import hive as phive
from biscotti_tpu_torch.runtime.admission import AdmissionController, AdmissionPlan
from biscotti_tpu_torch.runtime.faults import FaultAction
from biscotti_tpu_torch.runtime.hive import (LOOPBACK, LOOPBACK_RPCS_METRIC, Hive,
                                             HiveStepper, LoopbackHub,
                                             UnequalShardsError, _frame_estimate)
from biscotti_tpu_torch.runtime.rpc import BusyError, RPCError
from biscotti_tpu_torch.telemetry.registry import MetricsRegistry

FAST = dict(update_s=4.0, block_s=20.0, krum_s=4.0, share_s=4.0, rpc_s=6.0)


def _kw(i, n, port, **extra):
    base = dict(node_id=i, num_nodes=n, dataset="creditcard", base_port=port,
                num_verifiers=1, num_miners=1, num_noisers=1,
                secure_agg=False, noising=False, verification=False,
                max_iterations=2, convergence_error=0.0, sample_percent=1.0,
                batch_size=8, seed=3)
    base.update(extra)
    return base


def _cfg(i, n, port, **extra):
    kw = _kw(i, n, port, **extra)
    if "defense" in kw:
        kw["defense"] = Defense(kw["defense"])
    return BiscottiConfig(timeouts=Timeouts(**FAST), **kw)


def _jcfg(i, n, port, **extra):
    from biscotti_tpu.config import Defense as JDefense

    kw = _kw(i, n, port, **extra)
    if "defense" in kw:
        kw["defense"] = JDefense(kw["defense"])
    return JConfig(timeouts=JTimeouts(**FAST), **kw)


# ------------------------------------------- the pure step on the reference's draws


def _reference_draws(ref, it):
    """The reference stepper's batch rows [H, B] and standard normals
    [H, d] for round `it` (hive.py:437-440, :494-500)."""
    rows = int(ref._x.shape[1])
    batch = min(ref.cfg.batch_size, rows)
    idx = np.stack([np.asarray(jsample_batch(jax.random.fold_in(k, it), rows,
                                             batch))
                    for k in ref._batch_keys])
    z = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, it),
                                               (ref.num_params,), jnp.float32))
                  for k in ref._noise_keys])
    return idx, z


@pytest.mark.parametrize("dataset,model,ids,tol", [
    ("creditcard", "", (0, 1, 2, 5), 1e-5),
    ("mnist", "", (0, 3, 4), 1e-5),
    ("mnist", "mnist_cnn", (1, 2), 1e-4),
], ids=["creditcard_logreg", "mnist_softmax", "mnist_cnn"])
def test_deltas_and_noise_from_the_reference_draws(dataset, model, ids, tol):
    extra = dict(dataset=dataset, model_name=model, num_nodes=6, noising=True,
                 epsilon=1.0, batch_size=10 if model else 8)
    ref = jhive.HiveStepper(_jcfg(0, 6, 17300, **extra), ids)
    port = HiveStepper(_cfg(0, 6, 17300, **extra), ids, device="cpu")
    assert port.num_params == ref.num_params and port.rows == ref._x.shape[1]
    d = port.num_params
    w = np.random.default_rng(5).normal(0.0, 0.05, d)
    w32 = torch.from_numpy(w.astype(np.float32))
    for it in (0, 3):
        idx, z = _reference_draws(ref, it)
        want = np.asarray(ref._deltas(jnp.asarray(w, jnp.float32),
                                      ref._batch_keys, ref._x, ref._y, it),
                          np.float64)
        got = port.deltas_from_draws(w32, torch.from_numpy(idx)).numpy()
        assert got.shape == (len(ids), d)
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=1e-6 if tol == 1e-5 else tol)

        async def ref_noise():
            return await asyncio.gather(*(ref.noise(pid, it) for pid in ids))

        want = np.stack(asyncio.run(ref_noise()))
        got = port.noise_from_draws(torch.from_numpy(z)).numpy()
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


def test_stepper_matches_standalone_port_trainers():
    """A hive-hosted peer's delta is the one its standalone port Trainer
    computes on the same device (the same batch generator), and one
    batch and one evaluation serve every co-hosted peer."""
    n = 3
    cfg = _cfg(0, n, 17310, noising=True, epsilon=1.0)
    stepper = HiveStepper(cfg, range(n), device="cpu")
    w = np.random.default_rng(2).normal(0.0, 0.05, stepper.num_params)

    async def go():
        outs = await asyncio.gather(*(stepper.step(pid, w, 4)
                                      for pid in range(n)))
        noises = await asyncio.gather(*(stepper.noise(pid, 4)
                                        for pid in range(n)))
        again = await asyncio.gather(*(stepper.noise(pid, 4)
                                       for pid in range(n)))
        errs = await asyncio.gather(*(stepper.test_error(w, 4)
                                      for _ in range(n)))
        return outs, noises, again, errs

    outs, noises, again, errs = asyncio.run(go())
    assert (stepper.batches, stepper.evals, stepper.noise_batches) == (1, 1, 1)
    for pid in range(n):
        t = Trainer(cfg.dataset, ds.shard_name(cfg.dataset, pid, False),
                    cfg=cfg, seed=pid, device="cpu")
        np.testing.assert_allclose(outs[pid], t.private_fun(w, 4),
                                   rtol=1e-5, atol=1e-6)
        assert errs[pid] == t.test_error(w)
        assert outs[pid].dtype == noises[pid].dtype == np.float64
        assert np.array_equal(noises[pid], again[pid])
    assert not np.allclose(outs[0], outs[1])
    assert not np.allclose(noises[0], noises[1])
    # the noise law: (−α/b)·σ·√b·N(0, 1), σ from ε = 1 and δ = 1e-5
    sd = np.std(np.concatenate(noises))
    want = cfg.logreg_alpha / np.sqrt(cfg.batch_size) * np.sqrt(
        2 * np.log(1.25 / cfg.delta))
    assert abs(sd / want - 1.0) < 0.2


def test_noise_is_zero_without_dp_and_mcmc13_serves_none():
    stepper = HiveStepper(_cfg(0, 3, 17311), range(3), device="cpu")
    assert not asyncio.run(stepper.noise(1, 0)).any()
    assert stepper.noise_batches == 0 and stepper.serves_noise
    mc = HiveStepper(_cfg(0, 3, 17311, dp_mechanism="mcmc13", noising=True),
                     range(3), device="cpu")
    assert not mc.serves_noise


def test_unequal_shards_refuse_and_the_hive_falls_back(monkeypatch):
    real = ds.load_shard

    def uneven(dataset, shard):
        out = dict(real(dataset, shard))
        if shard.endswith("1"):  # one peer's shard is short
            out = {k: (v[:-5] if k in ("x_train", "y_train") else v)
                   for k, v in out.items()}
        return out

    monkeypatch.setattr(ds, "load_shard", uneven)
    cfg = _cfg(0, 3, 17312)
    with pytest.raises(UnequalShardsError, match="unequal"):
        HiveStepper(cfg, range(3), device="cpu")
    h = Hive(cfg, range(3), hive_id="fb", device="cpu")
    assert h.stepper is None and "unequal" in h.stepper_fallback
    assert all(not a.trainer.light for a in h.agents)
    assert {str(a.device) for a in h.agents} == {"cpu"}


def test_a_mesh_names_one_device():
    cfg = _cfg(0, 3, 17313)
    with pytest.raises(NotImplementedError, match="one device"):
        HiveStepper(cfg, range(3), mesh=["cpu", "cpu"])
    assert HiveStepper(cfg, range(3), mesh=["cpu"]).device.type == "cpu"


def test_the_hive_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HiveStepper(_cfg(0, 3, 17314), range(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        phive.main(["-t", "3", "-d", "creditcard", "-p", "17314",
                    "--iterations", "1"])


# ------------------------------------------------------- loopback endpoint


class _FakeAgent:
    """The slice of PeerAgent a LoopbackEndpoint touches (as in
    tests/test_hive.py), on the port's admission plane."""

    def __init__(self, pid, port, metrics=None, plan=None, handler=None):
        self.id = pid
        self.peers = {pid: ("127.0.0.1", port)}
        self.server = SimpleNamespace(serving=True, metrics=metrics,
                                      service_delay_s=0.0)
        self.admission = AdmissionController(plan or AdmissionPlan())
        self._handler = handler
        self.handled = []

    async def _handle(self, msg_type, meta, arrays):
        self.handled.append((msg_type, meta, arrays))
        if self._handler is not None:
            return await self._handler(msg_type, meta, arrays)
        return {"ok": True}, {"echo": np.asarray(arrays["a"]) * 2.0}


def test_frame_estimate_and_drift_equal_the_reference():
    cases = [({"x": 5}, {"a": np.ones(4)}), (None, None),
             ({"k": [1, 2, {"z": "s"}]}, {"a": np.zeros((3, 5), np.int64),
                                           "b": np.ones(7, np.float32)}),
             ({"bad": object()}, {})]
    for meta, arrays in cases:
        assert _frame_estimate(meta, arrays) == jhive._frame_estimate(meta,
                                                                       arrays)
    series = [[], [5.0, 6.0, 7.0], [0.0, 1.0, 2.0, 3.0], list(range(8)),
              [100.0, 104.0] * 12 + [400.0], [100.0] * 10 + [164.0] * 10]
    for s in series:
        assert phive.drift(s) == jhive.drift(s)
    assert phive.DRIFT_WINDOW_S == jhive.DRIFT_WINDOW_S
    assert (LOOPBACK, LOOPBACK_RPCS_METRIC, phive.LOOPBACK_SECONDS_METRIC) == (
        jhive.LOOPBACK, jhive.LOOPBACK_RPCS_METRIC, jhive.LOOPBACK_SECONDS_METRIC)
    assert phive.rss_bytes() > 0


def test_rss_peak_is_the_launched_process_own():
    """ROADMAP C5: a hive launched from a process holding 600 MB reports
    its own peak RSS; the reference's ru_maxrss reports its launcher's."""
    import subprocess
    import sys

    held = np.ones(600 * 2**20 // 8)
    code = ("from biscotti_tpu.runtime.hive import rss_peak_bytes as j\n"
            "from biscotti_tpu_torch.runtime.hive import rss_peak_bytes as p\n"
            "print(j(), p())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(
                             __import__("pathlib").Path(__file__).parents[1]))
    ref, port = (int(x) for x in out.stdout.split())
    assert ref >= held.nbytes > port > 0, (ref, port)
    assert phive.rss_peak_bytes() >= held.nbytes


def test_loopback_call_roundtrip_readonly_views_and_accounting():
    async def scenario():
        hub = LoopbackHub()
        callee_reg, caller_reg = MetricsRegistry(), MetricsRegistry()
        agent = _FakeAgent(1, 17320, metrics=callee_reg)
        ep = hub.register(agent)
        assert hub.lookup("127.0.0.1", 17320) is ep
        assert hub.lookup("127.0.0.1", 17321) is None  # remote: TCP
        assert hub.local_ids == frozenset({1})
        sent = np.ones(4)
        meta, arrays = await ep.call("Echo", {"x": 5}, {"a": sent},
                                     timeout=5, src=0, metrics=caller_reg)
        assert meta == {"ok": True}
        assert np.array_equal(arrays["echo"], np.full(4, 2.0))
        assert not arrays["echo"].flags.writeable
        _, hmeta, harrays = agent.handled[0]
        assert hmeta == {"x": 5}
        assert not harrays["a"].flags.writeable
        assert harrays["a"].base is sent  # aliased, never copied
        with pytest.raises(ValueError):
            harrays["a"][0] = 99.0
        want = _frame_estimate({"x": 5}, {"a": sent})
        got = caller_reg.counter(wcodecs.WIRE_BYTES_METRIC).value(
            msg_type="Echo", direction=LOOPBACK, codec=wcodecs.RAW)
        assert got == want > sent.nbytes
        reply = callee_reg.counter(wcodecs.WIRE_BYTES_METRIC).value(
            msg_type="Echo.reply", direction=LOOPBACK, codec=wcodecs.RAW)
        assert reply > 0
        assert caller_reg.counter(LOOPBACK_RPCS_METRIC).value(
            msg_type="Echo", kind="call") == 1
        assert agent.admission.inflight_total == 0

    asyncio.run(scenario())


def test_loopback_admission_still_sheds_on_fast_path():
    async def scenario():
        hub = LoopbackHub()
        plan = AdmissionPlan(enabled=True, update_rate=0.001,
                             burst_factor=0.001)
        agent = _FakeAgent(2, 17322, plan=plan)
        ep = hub.register(agent)
        with pytest.raises(BusyError):
            await ep.call("RegisterUpdate", {}, {"a": np.ones(2)},
                          timeout=2, src=0)
        assert not agent.handled
        assert agent.admission.shed_counts.get("rate", 0) >= 1
        assert agent.admission.inflight_total == 0

    asyncio.run(scenario())


def test_loopback_fault_injection_still_applies():
    async def scenario():
        hub = LoopbackHub()
        agent = _FakeAgent(3, 17323)
        ep = hub.register(agent)
        ones = np.ones(2)
        with pytest.raises(ConnectionError):
            await ep.call("Echo", {}, {"a": ones}, timeout=2, src=0,
                          fault=FaultAction(reset=True))
        assert not agent.handled
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        with pytest.raises(asyncio.TimeoutError):
            await ep.call("Echo", {}, {"a": ones}, timeout=0.08, src=0,
                          fault=FaultAction(drop=True))
        assert loop.time() - t0 >= 0.08
        assert not agent.handled
        t0 = loop.time()
        meta, _ = await ep.call("Echo", {}, {"a": ones}, timeout=2, src=0,
                                fault=FaultAction(delay_s=0.05))
        assert meta == {"ok": True} and loop.time() - t0 >= 0.05
        agent.handled.clear()
        await ep.call("Echo", {}, {"a": ones}, timeout=2, src=0,
                      fault=FaultAction(duplicate=True))
        for _ in range(50):
            if len(agent.handled) >= 2:
                break
            await asyncio.sleep(0.01)
        assert len(agent.handled) == 2
        agent.handled.clear()
        await ep.post("Echo", {}, {"a": ones}, timeout=1, src=0,
                      fault=FaultAction(drop=True))
        await asyncio.sleep(0.05)
        assert not agent.handled

    asyncio.run(scenario())


def test_loopback_lifecycle_and_error_mapping():
    async def scenario():
        hub = LoopbackHub()

        async def boom(msg_type, meta, arrays):
            raise KeyError("handler bug")

        agent = _FakeAgent(4, 17324, handler=boom)
        ep = hub.register(agent)
        with pytest.raises(RPCError, match="internal"):
            await ep.call("Echo", {}, {"a": np.ones(1)}, timeout=2, src=0)
        agent.server.serving = False
        assert hub.lookup("127.0.0.1", 17324) is None
        with pytest.raises(ConnectionError):
            await ep._dispatch("Echo", {}, {}, src=0)

    asyncio.run(scenario())


# ------------------------------------------------------- live hives


def _loopback_rpcs(agents):
    total = 0.0
    for a in agents:
        fam = a.pool.metrics.snapshot().get(LOOPBACK_RPCS_METRIC) \
            if a.pool.metrics is not None else None
        total += sum(row["value"] for row in fam["series"]) if fam else 0.0
    return total


def _blocks(results):
    dumps = {r["chain_dump"] for r in results}
    assert len(dumps) == 1, "chains diverged"
    lines = results[0]["chain_dump"].splitlines()
    assert any("ndeltas=0" not in ln for ln in lines[1:]), lines
    return lines


def test_port_hive_small_cluster_chains_equal():
    n = 5
    hive = Hive(_cfg(0, n, 17330), hive_id="t1", device="cpu")
    results = asyncio.run(hive.run())
    assert len(_blocks(results)) == 3
    assert hive.stepper.batches == 2 and hive.stepper.evals == 2
    assert _loopback_rpcs(hive.agents) > 0
    snap = hive.agents[0].telemetry_snapshot()
    assert snap["hive"]["id"] == "t1" and snap["hive"]["peers"] == n
    summary = phive.summarize(hive, results, 1.0, 2)
    assert summary["chains_equal_local"] and summary["blocks"] == 2
    assert summary["sgd_batches"] == 2 and summary["device"] == "cpu"
    assert summary["loopback_avoided_bytes_per_round"] > 0
    assert summary["rss_peak_source"] == "VmHWM"
    assert 0 < summary["rss_sampled_max_bytes"] <= summary["rss_peak_bytes"]


def test_reference_and_port_hives_over_tcp_agree():
    """A reference hive of peers 0-2 and a port hive of peers 3-5, on one
    seed: loopback inside each, TCP between them; every chain equal hash
    for hash, with real blocks."""
    n = 6
    jh = jhive.Hive(_jcfg(0, n, 17340), range(0, 3), hive_id="ref")
    ph = Hive(_cfg(0, n, 17340), range(3, 6), hive_id="port", device="cpu")

    async def go():
        return await asyncio.gather(jh.run(), ph.run())

    r1, r2 = asyncio.run(go())
    assert len(_blocks(r1 + r2)) == 3
    assert _loopback_rpcs(ph.agents) > 0
    assert ph.stepper.batches >= 1


def test_trust_state_identical_across_port_tcp_and_port_hive():
    """The port twin of test_trust.py's layout test: an all-port TCP
    cluster and an all-port hive (per-agent trainers, loopback transport)
    on one seed under ENSEMBLE give one chain and one verdict stream."""
    n = 6
    extra = dict(defense="ENSEMBLE", verification=True, max_iterations=3)

    async def tcp():
        from biscotti_tpu_torch.runtime.peer import PeerAgent

        agents = [PeerAgent(_cfg(i, n, 17350, **extra), device="cpu")
                  for i in range(n)]
        return await asyncio.gather(*(a.run() for a in agents))

    tcp_results = asyncio.run(tcp())
    hive = Hive(_cfg(0, n, 17360, **extra), hive_id="trust",
                batch_device=False, device="cpu")
    hive_results = asyncio.run(hive.run())
    assert tcp_results[0]["chain_dump"] == hive_results[0]["chain_dump"]
    _blocks(tcp_results)
    assert any(r["telemetry"].get("trust", {}).get("stream")
               for r in tcp_results)
    for i in range(n):
        t = tcp_results[i]["telemetry"].get("trust")
        h = hive_results[i]["telemetry"].get("trust")
        assert (t is None) == (h is None)
        if t is not None:
            assert t["stream"] == h["stream"]
            assert t.get("ledger") == h.get("ledger")
