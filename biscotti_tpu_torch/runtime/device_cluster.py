# The port's own copy of biscotti_tpu/runtime/device_cluster.py; it imports nothing of biscotti_tpu.
"""Peers-as-devices deployment mode — the data plane on the device, the
control plane in the runtime (counterpart of
`biscotti_tpu/runtime/device_cluster.py`).

The plain in-process cluster runs N peer agents whose SGD steps each
dispatch their own device call. Here ONE batched call computes EVERY
peer's delta a round — `torch.func.vmap` of `local_step_fn` over the peer
axis — while the agents keep speaking the full protocol (verifier
committees, VSS shares, block gossip, stake). Device peers therefore mint
REAL blocks through the runtime.

    stepper = BatchStepper(cfg)                  # one per host process
    agents  = [PeerAgent(cfg_i, stepper=stepper) for i in range(n)]

The stepper computes all N deltas at a round's FIRST request and serves
every other agent from that batch — peers advance in protocol lockstep, so
the batch hit rate is the worker count.

Round `it`'s minibatch of peer `gid` is drawn from a generator seeded with
`stream_seed(cfg.seed, "cluster", it, gid)` (the reference's
`fold_in(fold_in(root, it), gid)`); `deltas_from_draws` is the pure step
on those rows, which the tests feed the reference's own draws. Every
peer's shard is cut to the shortest one's rows, as in the reference.

The reference shards the batch over a device mesh; the port runs it on
one device, and a mesh of more than one device raises.

Launcher CLI (`--platform`: the torch device, `cuda` by default, or `cpu`):
    python -m biscotti_tpu_torch.runtime.device_cluster -t 8 -d mnist \\
        --iterations 3
"""

from __future__ import annotations

import asyncio
import hashlib
import threading
from typing import Dict, Optional, Union

import numpy as np
import torch

from biscotti_tpu_torch.data import datasets as ds
from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.models.base import fp32_math
from biscotti_tpu_torch.models.trainer import (_shared_eval_tensors,
                                               local_step_fn, sample_batch,
                                               stream_seed)
from biscotti_tpu_torch.models.zoo import model_for_dataset
from biscotti_tpu_torch.tools.verdicts import poisoned_ids


async def single_flight_memo(cache: Dict, pending: Dict, key, compute):
    """Single-flight async memo shared by the batched device planes
    (BatchStepper here, hive.HiveStepper): the first caller computes
    off-loop, every concurrent waiter receives the VALUE from the future
    itself (never a post-await cache re-read — another peer far enough
    ahead may evict the key between set_result and a waiter resuming),
    and a failed compute raises in every caller. Returns
    (value, computed_here)."""
    if key in cache:
        return cache[key], False
    if key in pending:
        return await pending[key], False
    fut = asyncio.get_running_loop().create_future()
    pending[key] = fut
    try:
        val = await asyncio.to_thread(compute)
    except BaseException as e:
        fut.set_exception(e)
        fut.exception()  # mark retrieved if nobody is waiting
        del pending[key]
        raise
    cache[key] = val
    fut.set_result(val)
    del pending[key]
    return val, True


def single_device(mesh=None,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> torch.device:
    """The one device a batched stepper runs on: `device` (None: the GPU,
    which must exist), or the only device of `mesh`, a sequence of torch
    devices. A mesh of more than one device raises: the peers-across-
    devices step of the reference is not ported."""
    if mesh is None:
        return resolve_device(device)
    devices = [torch.device(d) for d in mesh]
    if len(devices) != 1:
        raise NotImplementedError(
            f"a mesh of {len(devices)} devices: the port's batched steppers "
            "run on one device (the multi-device step is not ported)")
    if device is not None and torch.device(device) != devices[0]:
        raise ValueError(f"device {device} is not the mesh's {devices[0]}")
    return resolve_device(devices[0])


def vmapped_step(cfg):
    """(model, the step vmapped over peers with w shared, mode)."""
    model = model_for_dataset(cfg.dataset, cfg.model_name)
    mode = "sgd" if model.name == "logreg" else "grad"
    step = local_step_fn(model, mode, clip=cfg.grad_clip,
                         alpha=cfg.logreg_alpha)
    return model, torch.func.vmap(step, in_dims=(None, 0, 0)), mode


def host_f32(w: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host weight vector as float32 on `device` (the bridge's cast)."""
    return torch.from_numpy(np.asarray(w, np.float32)).to(device)


def shared_test_error(model, device: torch.device, cfg, w: np.ndarray) -> float:
    """Global-test-split error of `w` on `device`, from the process-wide
    copy of the split that every Trainer on that device shares."""
    x_test, y_test, _, _ = _shared_eval_tensors(cfg.dataset, device)
    with fp32_math():
        return float(model.error_flat(host_f32(w, device), x_test, y_test))


class BatchStepper:
    """Round-batched SGD: all peers' deltas in one vmapped device call.

    Thread-compatible with the asyncio agents: `step()` is async and the
    batched call runs in a worker thread. Per-iteration batches are cached
    (keyed by iteration) and evicted once consumed, so memory stays at
    O(batches_in_flight · N · d)."""

    def __init__(self, cfg, mesh=None, axis: str = "peers",
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.axis = axis
        self.mesh = mesh
        self.device = single_device(mesh, device)
        n = cfg.num_nodes
        self.model, self._batched_step, _ = vmapped_step(cfg)
        self.num_params = self.model.num_params

        poisoned = poisoned_ids(n, cfg.poison_fraction)
        xs, ys = [], []
        for i in range(n):
            shard = ds.load_shard(cfg.dataset,
                                  ds.shard_name(cfg.dataset, i, i in poisoned))
            xs.append(shard["x_train"])
            ys.append(shard["y_train"])
        self.rows = min(len(x) for x in xs)
        self._x = torch.from_numpy(
            np.stack([x[:self.rows] for x in xs])).to(self.device)
        self._y = torch.from_numpy(
            np.stack([y[:self.rows] for y in ys])).to(self.device)
        self.batch = min(cfg.batch_size, self.rows)
        self._gen = torch.Generator(device=self.device)
        self._gen_lock = threading.Lock()

        self._cache: Dict[int, np.ndarray] = {}
        self._pending: Dict[int, asyncio.Future] = {}
        self._served: Dict[int, int] = {}
        self.batches = 0  # batched dispatch count (observability/tests)

        # shared convergence metric: every peer scores the SAME model on the
        # SAME global test split each round (peer.py's uniform-convergence
        # requirement), so one evaluation serves the whole cluster. Keyed on
        # (iteration, weight digest) — transiently divergent chains compute
        # their own value, identical chains share one.
        self._eval_cache: Dict[tuple, float] = {}
        self._eval_pending: Dict[tuple, asyncio.Future] = {}
        self.evals = 0  # distinct metric computations (observability/tests)

    def draw_batches(self, it: int) -> torch.Tensor:
        """Round `it`'s minibatch rows [N, B] of every peer, peer `gid`'s
        pure in (cfg.seed, it, gid)."""
        idx = []
        with self._gen_lock:
            for gid in range(self.cfg.num_nodes):
                self._gen.manual_seed(stream_seed(self.cfg.seed, "cluster",
                                                  it, gid))
                idx.append(sample_batch(self._gen, self.rows, self.batch, 1)[0])
        return torch.stack(idx)

    def deltas_from_draws(self, w: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
        """Every peer's step [N, d] on its rows idx[N, B]: pure in (w, idx)."""
        idx = idx.to(self.device)
        peers = torch.arange(idx.shape[0], device=self.device)[:, None]
        with fp32_math():
            return self._batched_step(w.to(self.device, torch.float32),
                                      self._x[peers, idx], self._y[peers, idx])

    async def _memo(self, cache: Dict, pending: Dict, key, compute):
        return await single_flight_memo(cache, pending, key, compute)

    async def step(self, peer_id: int, w: np.ndarray, it: int) -> np.ndarray:
        """This peer's delta for iteration `it`; the first caller computes
        the whole batch."""

        def compute():
            deltas = self.deltas_from_draws(host_f32(w, self.device),
                                            self.draw_batches(it))
            return deltas.cpu().numpy().astype(np.float64)

        deltas, computed = await self._memo(self._cache, self._pending, it,
                                            compute)
        if computed:
            self.batches += 1
        delta = deltas[peer_id]
        self._served[it] = self._served.get(it, 0) + 1
        if self._served[it] >= self.cfg.num_nodes:
            self._cache.pop(it, None)  # everyone served: evict
        # keep at most a few rounds resident regardless of stragglers
        for old in [k for k in self._cache if k < it - 3]:
            self._cache.pop(old, None)
        return delta

    async def test_error(self, w: np.ndarray, it: int) -> float:
        """Global-test-split error of `w` — computed once per distinct
        (iteration, weights) across the cluster; all other peers are served
        from the memo (they evaluate identical inputs, see __init__)."""
        wb = np.ascontiguousarray(w)
        key = (it, hashlib.sha1(wb.tobytes()).hexdigest())

        def compute():
            return shared_test_error(self.model, self.device, self.cfg, wb)

        err, computed = await self._memo(self._eval_cache,
                                         self._eval_pending, key, compute)
        if computed:
            self.evals += 1
        for old in [k for k in self._eval_cache if k[0] < it - 3]:
            self._eval_cache.pop(old, None)
        return err


async def run_cluster(cfg_base, mesh, iterations: int, log_dir: str = "",
                      device: Optional[Union[str, torch.device]] = None):
    """Boot N agents sharing one BatchStepper, every agent on the
    stepper's device; returns (stepper, agents, results)."""
    import os

    from biscotti_tpu_torch.runtime.peer import PeerAgent

    stepper = BatchStepper(cfg_base, mesh, device=device)
    agents = []
    for i in range(cfg_base.num_nodes):
        cfg = cfg_base.replace(node_id=i, max_iterations=iterations)
        agents.append(PeerAgent(
            cfg, stepper=stepper,
            log_path=os.path.join(log_dir, f"events_{i}.jsonl")
            if log_dir else "", device=stepper.device))
    results = await asyncio.gather(*(a.run() for a in agents))
    return stepper, agents, results


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="peers-as-devices cluster launcher (one device)")
    from biscotti_tpu_torch.config import BiscottiConfig

    BiscottiConfig.add_args(ap)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--platform", default="cuda",
                    help="torch device of the batch and the peers: 'cuda' "
                         "(the default; raises without a GPU) or 'cpu'")
    ns = ap.parse_args(argv)
    cfg = BiscottiConfig.from_args(ns)

    stepper, agents, results = asyncio.run(
        run_cluster(cfg, None, ns.iterations, device=ns.platform))
    dumps = [r["chain_dump"] for r in results]
    summary = {
        "mode": "peers-as-devices",
        "devices": 1,
        "device": str(stepper.device),
        "nodes": cfg.num_nodes,
        "sharded_batches": stepper.batches,
        "chains_equal": all(d == dumps[0] for d in dumps),
        "blocks": len(dumps[0].splitlines()) - 1,
    }
    print(json.dumps(summary))
    return 0 if summary["chains_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
