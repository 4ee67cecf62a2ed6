"""The port's peers-as-devices cluster
(`biscotti_tpu_torch/runtime/device_cluster.py`) on the CPU: the pure
batched step held to the reference `BatchStepper` on the reference's own
draws (its `fold_in(fold_in(root, it), gid)` minibatch rows; rtol 1e-5,
atol 1e-6), the shared metric's memo, the single-flight memo, and port
clusters on one `BatchStepper` minting real blocks.

Timeouts are the reference's FAST set; ports are 17400-17449, which no
other test file uses."""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biscotti_tpu.config import BiscottiConfig as JConfig
from biscotti_tpu.models.trainer import sample_batch as jsample_batch
from biscotti_tpu.runtime import device_cluster as jdc
from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts
from biscotti_tpu_torch.runtime import device_cluster as pdc
from biscotti_tpu_torch.runtime.device_cluster import (BatchStepper, run_cluster,
                                                       single_flight_memo)

FAST = Timeouts(update_s=4.0, block_s=20.0, krum_s=4.0, share_s=4.0, rpc_s=6.0)


def _kw(n, port, **extra):
    base = dict(num_nodes=n, dataset="creditcard", base_port=port,
                num_verifiers=1, num_miners=1, num_noisers=1,
                secure_agg=False, noising=False, verification=True,
                convergence_error=0.0, sample_percent=1.0, batch_size=8,
                seed=3)
    base.update(extra)
    return base


@pytest.mark.parametrize("dataset", ["creditcard", "mnist"])
def test_deltas_from_the_reference_draws(dataset):
    n = 8
    kw = _kw(n, 17400, dataset=dataset)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("peers",))
    ref = jdc.BatchStepper(JConfig(**kw), mesh)
    port = BatchStepper(BiscottiConfig(**kw), device="cpu")
    rows = port.rows
    assert rows == ref._x.shape[1] and port.num_params == ref.num_params
    w = np.random.default_rng(1).normal(0.0, 0.05, port.num_params)
    root = jax.random.PRNGKey(kw["seed"])
    for it in (0, 2):
        bkey = jax.random.fold_in(root, it)
        idx = np.stack([np.asarray(jsample_batch(jax.random.fold_in(bkey, gid),
                                                 rows, port.batch))
                        for gid in range(n)])
        want = np.asarray(ref._step(jnp.asarray(w, jnp.float32), ref._x,
                                    ref._y, it), np.float64)
        got = port.deltas_from_draws(torch.from_numpy(w.astype(np.float32)),
                                     torch.from_numpy(idx)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the port's own draws: pure in (seed, it, gid), distinct across peers
    a, b = port.draw_batches(5), port.draw_batches(5)
    assert torch.equal(a, b) and a.shape == (n, port.batch)
    assert not torch.equal(a[0], a[1]) and not torch.equal(a, port.draw_batches(6))


def test_rows_are_cut_to_the_shortest_shard(monkeypatch):
    from biscotti_tpu_torch.data import datasets as ds

    real = ds.load_shard

    def uneven(dataset, shard):
        out = dict(real(dataset, shard))
        if shard.endswith("2"):
            out = {k: (v[:-7] if k in ("x_train", "y_train") else v)
                   for k, v in out.items()}
        return out

    monkeypatch.setattr(ds, "load_shard", uneven)
    port = BatchStepper(BiscottiConfig(**_kw(4, 17401)), device="cpu")
    assert port.rows == 320 - 7 and tuple(port._x.shape[:2]) == (4, 313)


def test_stepper_shared_metric_memoizes():
    stepper = BatchStepper(BiscottiConfig(**_kw(4, 17402)), device="cpu")
    w = np.zeros(stepper.num_params, np.float64)
    w2 = np.ones(stepper.num_params, np.float64)

    async def drive():
        a = await asyncio.gather(*(stepper.test_error(w, 0) for _ in range(4)))
        b = await stepper.test_error(w2, 0)
        c = await stepper.test_error(w, 1)
        d = await asyncio.gather(*(stepper.step(i, w, 0) for i in range(4)))
        return a, b, c, d

    a, b, c, d = asyncio.run(drive())
    assert len(set(a)) == 1 and a[0] == c
    assert stepper.evals == 3 and stepper.batches == 1
    assert all(x.dtype == np.float64 for x in d) and not np.allclose(d[0], d[1])


def test_single_flight_memo_equals_the_reference():
    """One compute for concurrent callers of a key, and a failure raised
    in every caller, in both packages."""
    for memo in (single_flight_memo, jdc.single_flight_memo):
        calls = []

        def compute():
            calls.append(1)
            return 7

        def fail():
            raise KeyError("boom")

        async def go():
            cache, pending = {}, {}
            got = await asyncio.gather(*(memo(cache, pending, "k", compute)
                                         for _ in range(5)))
            errs = await asyncio.gather(*(memo(cache, pending, "x", fail)
                                          for _ in range(3)),
                                        return_exceptions=True)
            return got, errs, cache, pending

        got, errs, cache, pending = asyncio.run(go())
        assert sorted(got) == [(7, False)] * 4 + [(7, True)] and calls == [1]
        assert all(isinstance(e, KeyError) for e in errs)
        assert cache == {"k": 7} and pending == {}


@pytest.mark.parametrize("mesh", ["one-entry list", "list of two",
                                  "one-rank DeviceMesh"])
def test_a_mesh_names_one_device(mesh, tmp_path):
    """A one-entry device list names that device; a list of several is
    refused, pointing at the DeviceMesh route; a one-rank DeviceMesh puts
    the stepper on its rank's device (the multi-rank branch:
    tests/test_torch_mesh_steppers.py)."""
    cfg = BiscottiConfig(**_kw(4, 17403))
    if mesh == "one-entry list":
        assert BatchStepper(cfg, ["cpu"]).device == torch.device("cpu")
    elif mesh == "list of two":
        with pytest.raises(ValueError, match="as a torch.distributed DeviceMesh"):
            BatchStepper(cfg, ["cpu", "cpu"])
    else:
        from biscotti_tpu_torch.parallel.mesh import open_mesh

        with open_mesh("peers", "cpu", rank=0, world_size=1,
                       init_method=f"file://{tmp_path}/rendezvous") as m:
            stepper = BatchStepper(cfg, m)
            assert stepper.device == torch.device("cpu")
            assert list(stepper.gids) == [0, 1, 2, 3]


@pytest.mark.parametrize("secure_agg", [False, True], ids=["plain", "secure_agg"])
def test_device_peers_mint_real_blocks(secure_agg):
    port = 17410 if not secure_agg else 17420
    cfg = BiscottiConfig(timeouts=FAST, **_kw(
        4, port, secure_agg=secure_agg, noising=secure_agg,
        defense=Defense.NONE))
    stepper, agents, results = asyncio.run(run_cluster(cfg, None, 2,
                                                       device="cpu"))
    dumps = [r["chain_dump"] for r in results]
    assert all(d == dumps[0] for d in dumps), "chain-equality oracle violated"
    lines = dumps[0].splitlines()
    assert len(lines) == 3 and "ndeltas=0" not in lines[1], dumps[0]
    assert 1 <= stepper.batches <= 3
    assert {str(a.device) for a in agents} == {"cpu"}


def test_cli_prints_the_summary(capsys):
    rc = pdc.main(["-t", "4", "-d", "creditcard", "-p", "17430", "-na", "1",
                   "-nv", "1", "-nn", "1", "-sa", "0", "-np", "0",
                   "-ns", "100", "--iterations", "1", "--platform", "cpu"])
    import json

    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["chains_equal"] and out["blocks"] == 1
    assert out["device"] == "cpu" and out["sharded_batches"] >= 1
