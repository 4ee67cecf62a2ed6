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

On a `torch.distributed` mesh (`parallel/mesh.py`, one rank a device) the
batch is sharded over the peer axis, as the reference's `shard_map` shards
it: rank 0 hosts the agents and `step()`, every rank computes its own
peers' deltas (rows from the same per-peer streams, so the batch is the
one-device stepper's), and rank 0 gathers the [N, d] batch
(`mesh.Controller`); the other ranks `serve()` until rank 0 closes the
stepper. `run_cluster` runs on every rank: the followers serve and return.

Launcher CLI (`--platform`: the torch device, `cuda` by default, or `cpu`):
    python -m biscotti_tpu_torch.runtime.device_cluster -t 8 -d mnist \\
        --iterations 3
    torchrun --nproc-per-node 4 -m biscotti_tpu_torch.runtime.device_cluster \\
        -t 32 -d mnist --iterations 3       # one rank a GPU
"""

from __future__ import annotations

import asyncio
import hashlib
import threading
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from biscotti_tpu_torch.data import datasets as ds
from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.models.base import fp32_math
from biscotti_tpu_torch.models.trainer import (_shared_eval_tensors,
                                               local_step_fn, sample_batch,
                                               stream_seed)
from biscotti_tpu_torch.models.zoo import model_for_dataset
from biscotti_tpu_torch.parallel.mesh import (Controller, local_slice,
                                             mesh_device)
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


def stepper_device(mesh=None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device a batched stepper runs on in this process: `device`
    (None: the GPU, which must exist) without a mesh; this rank's device
    on a `DeviceMesh`; the only device of a one-entry list. A list of
    several devices raises: one process drives one device, and several
    devices are a `DeviceMesh` of one rank each."""
    if mesh is None:
        return resolve_device(device)
    if isinstance(mesh, DeviceMesh):
        dev = mesh_device(mesh)
    else:
        devices = [torch.device(d) for d in mesh]
        if len(devices) != 1:
            raise ValueError(
                f"a list of {len(devices)} devices: a batched stepper spans "
                "devices as a torch.distributed DeviceMesh, one rank a device "
                "(biscotti_tpu_torch.parallel.mesh.open_mesh or spawn)")
        dev = devices[0]
    if device is not None and torch.device(device) not in (
            dev, torch.device(dev.type)):
        raise ValueError(f"device {device} is not the mesh's {dev}")
    return resolve_device(dev)


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


class MeshBatches:
    """The batch plane the two batched steppers share: round `it`'s deltas
    of every peer at weights w, computed here, or by every rank of a mesh
    for its own peers (`_mesh`, a `parallel.mesh.Controller`, None off a
    mesh) and gathered on rank 0. A stepper supplies `device`,
    `draw_batches(it)` and `deltas_from_draws(w, idx)` for its own peers."""

    _mesh: Optional[Controller] = None

    def _local(self, it: int, w: torch.Tensor) -> torch.Tensor:
        return self.deltas_from_draws(w, self.draw_batches(it))

    def deltas(self, it: int, w: np.ndarray) -> torch.Tensor:
        """Round `it`'s deltas of every peer at weights w, float32 on this
        device: one device call, or one a rank gathered on rank 0."""
        w = host_f32(w, self.device)
        if self._mesh is not None:
            return self._mesh.dispatch(it, w)
        return self._local(it, w)

    def serve(self) -> int:
        """A follower rank's loop: compute this rank's peers' slice of
        every batch rank 0 issues, until rank 0 closes the stepper.
        Returns the number of batches served (0 off a mesh)."""
        return self._mesh.serve() if self._mesh is not None else 0

    def close(self) -> None:
        """Rank 0: release the follower ranks (once; nothing to do off a
        mesh)."""
        if self._mesh is not None:
            self._mesh.close()


class BatchStepper(MeshBatches):
    """Round-batched SGD: all peers' deltas in one vmapped device call, or
    one a rank across a `DeviceMesh`.

    Thread-compatible with the asyncio agents: `step()` is async and the
    batched call runs in a worker thread. Per-iteration batches are cached
    (keyed by iteration) and evicted once consumed, so memory stays at
    O(batches_in_flight · N · d). On a mesh, rank 0 calls `step()` and
    `close()`, the other ranks `serve()`; each rank holds only its own
    peers' shards (`gids`)."""

    def __init__(self, cfg, mesh=None, axis: str = "peers",
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.axis = axis
        self.mesh = mesh
        self.device = stepper_device(mesh, device)
        n = cfg.num_nodes
        sharded = isinstance(mesh, DeviceMesh)
        self.gids = range(n)
        if sharded:
            if axis not in (mesh.mesh_dim_names or ()):
                raise ValueError(f"the mesh has no axis {axis!r}")
            mine = local_slice(mesh, n)
            self.gids = range(mine.start, mine.stop)
        self.model, self._batched_step, _ = vmapped_step(cfg)
        self.num_params = self.model.num_params

        poisoned = poisoned_ids(n, cfg.poison_fraction)
        xs, ys = [], []
        for i in range(n):
            shard = ds.load_shard(cfg.dataset,
                                  ds.shard_name(cfg.dataset, i, i in poisoned))
            xs.append(shard["x_train"])
            ys.append(shard["y_train"])
        # every shard cut to the shortest one's rows, over ALL peers
        self.rows = min(len(x) for x in xs)
        self._x = torch.from_numpy(
            np.stack([xs[g][:self.rows] for g in self.gids])).to(self.device)
        self._y = torch.from_numpy(
            np.stack([ys[g][:self.rows] for g in self.gids])).to(self.device)
        self._mesh = (Controller(mesh, self.num_params, self._local)
                      if sharded else None)
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
        """Round `it`'s minibatch rows [len(gids), B] of this process's
        peers, peer `gid`'s pure in (cfg.seed, it, gid)."""
        idx = []
        with self._gen_lock:
            for gid in self.gids:
                self._gen.manual_seed(stream_seed(self.cfg.seed, "cluster",
                                                  it, gid))
                idx.append(sample_batch(self._gen, self.rows, self.batch, 1)[0])
        return torch.stack(idx)

    def deltas_from_draws(self, w: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
        """The step [len(gids), d] of this process's peers on their rows
        idx[len(gids), B]: pure in (w, idx)."""
        idx = idx.to(self.device)
        peers = torch.arange(idx.shape[0], device=self.device)[:, None]
        with fp32_math():
            return self._batched_step(w.to(self.device, torch.float32),
                                      self._x[peers, idx], self._y[peers, idx])

    @property
    def trained(self) -> Dict[int, int]:
        """The workers served a delta, by iteration."""
        return dict(self._served)

    async def _memo(self, cache: Dict, pending: Dict, key, compute):
        return await single_flight_memo(cache, pending, key, compute)

    async def step(self, peer_id: int, w: np.ndarray, it: int) -> np.ndarray:
        """This peer's delta for iteration `it`; the first caller computes
        the whole batch."""

        def compute():
            return self.deltas(it, w).cpu().numpy().astype(np.float64)

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
    stepper's device; returns (stepper, agents, results). On a
    `DeviceMesh` every rank calls it: rank 0 runs the agents and then
    releases the others, which serve the batches and return
    (stepper, [], [])."""
    import os

    from biscotti_tpu_torch.runtime.peer import PeerAgent

    stepper = BatchStepper(cfg_base, mesh, device=device)
    if isinstance(mesh, DeviceMesh) and mesh.get_local_rank() != 0:
        await asyncio.to_thread(stepper.serve)
        return stepper, [], []
    try:
        agents = []
        for i in range(cfg_base.num_nodes):
            cfg = cfg_base.replace(node_id=i, max_iterations=iterations)
            agents.append(PeerAgent(
                cfg, stepper=stepper,
                log_path=os.path.join(log_dir, f"events_{i}.jsonl")
                if log_dir else "", device=stepper.device))
        results = await asyncio.gather(*(a.run() for a in agents))
    finally:
        stepper.close()
    return stepper, agents, results


def main(argv=None) -> int:
    """One-device run, or, under torchrun (its RANK in the environment),
    one rank of a mesh over every rank's device; rank 0 prints the
    summary."""
    import argparse
    import contextlib
    import json
    import os

    from biscotti_tpu_torch.parallel.mesh import open_mesh

    ap = argparse.ArgumentParser(
        description="peers-as-devices cluster launcher")
    from biscotti_tpu_torch.config import BiscottiConfig

    BiscottiConfig.add_args(ap)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--platform", default="cuda",
                    help="torch device of the batch and the peers: 'cuda' "
                         "(the default; raises without a GPU) or 'cpu'")
    ns = ap.parse_args(argv)
    cfg = BiscottiConfig.from_args(ns)

    under_torchrun = "RANK" in os.environ
    with (open_mesh("peers", ns.platform) if under_torchrun
          else contextlib.nullcontext()) as mesh:
        stepper, agents, results = asyncio.run(
            run_cluster(cfg, mesh, ns.iterations, device=ns.platform))
        ranks = mesh.size() if mesh is not None else 1
    if not results:  # a follower rank
        return 0
    dumps = [r["chain_dump"] for r in results]
    summary = {
        "mode": "peers-as-devices",
        "devices": ranks,
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
