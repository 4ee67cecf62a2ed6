"""A 1-D device mesh on `torch.distributed` — the port's stand-in for the
reference's `jax.sharding.Mesh` and `utils/compat.py::shard_map`, holding
only what its four multi-device call sites share
(`parallel/sim.py::make_sharded_round_step`,
`ops/secretshare.py::make_sharded_share_fns` and the mesh branches of
`runtime/device_cluster.py::BatchStepper` and
`runtime/hive.py::HiveStepper`).

One process a device, one rank a process: NCCL on GPUs (rank r on
`cuda:LOCAL_RANK`), gloo on the CPU. The mesh is a
`torch.distributed.device_mesh.DeviceMesh` with one named axis ("peers" or
"chunks") over the whole process group:

    with open_mesh("peers") as mesh:            # under torchrun
        ...
    with open_mesh("peers", "cpu", rank=r, world_size=k,
                   init_method="file:///tmp/x/init") as mesh:
        ...
    spawn(fn, k, "cpu")                          # k ranks, fn(mesh, *args)

An axis of length n is cut into contiguous slices, rank r holding
`local_slice(mesh, n)` = [r·n/k, (r+1)·n/k), as the reference's
`pid * n_loc + arange(n_loc)`; n must divide by k, as `shard_map` demands.
`all_gather` is the reference's `all_gather(..., tiled=True)` and `psum`
its `psum`.

The batched steppers run their mesh as a controller and followers
(`Controller`): rank 0 hosts the agents and issues each batch, every rank
computes its slice of it, and rank 0 gathers the whole batch; between
batches rank 0 keeps the followers' wait alive. The
reference runs its mesh from one process, which torch's one-process-a-
device model cannot.

A multi-rank mesh on `cuda` needs a GPU a rank on each host and raises
otherwise; nothing maps it onto the CPU or another backend. Only an
explicit `backend="gloo"` puts several ranks of a `cuda` mesh on one GPU
(rank r on `cuda:r % GPUs`): gloo takes CUDA tensors, NCCL refuses two
ranks on one GPU.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue
import tempfile
import threading
import traceback
from typing import Any, Callable, Iterator, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from biscotti_tpu_torch.device import resolve_device

# a process group's timeout: the longest a collective waits for a rank
TIMEOUT_S = 300.0

# the controller's header ops
STOP, STEP, KEEPALIVE = 0, 1, 2


def rank_device(device: Optional[Union[str, torch.device]], local_rank: int,
                local_world: int, backend: Optional[str] = None) -> torch.device:
    """The device of the rank `local_rank` of the `local_world` ranks on
    this host: the CPU, or `cuda:local_rank` (None means the GPU). A
    `cuda` mesh with more ranks on a host than GPUs raises, unless its
    backend is gloo by the caller's choice."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    count = torch.cuda.device_count()
    if backend == "gloo":
        return torch.device("cuda", local_rank % count)
    if local_world > count:
        raise RuntimeError(
            f"a {local_world}-rank mesh on cuda needs a GPU a rank; this host "
            f"has {count}")
    return torch.device("cuda", local_rank)


def device_mesh(axis: str, device_type: str) -> DeviceMesh:
    """A 1-D DeviceMesh named `axis` over the whole (initialized) process
    group, its tensors on `device_type` ("cuda" or "cpu")."""
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


@contextlib.contextmanager
def open_mesh(axis: str = "peers",
              device: Optional[Union[str, torch.device]] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              init_method: Optional[str] = None,
              timeout_s: float = TIMEOUT_S,
              backend: Optional[str] = None) -> Iterator[DeviceMesh]:
    """Set up the process group (NCCL on `cuda`, gloo on the CPU, unless
    `backend` says otherwise) and yield a 1-D mesh named `axis` over it;
    the group is destroyed on exit.
    Without `rank`, the rank, world size and rendezvous come from
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT)."""
    if rank is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        init_method = init_method or "env://"
    else:
        if world_size is None or init_method is None:
            raise ValueError("an explicit rank needs world_size and init_method")
        local_rank, local_world = rank, world_size
    dev = rank_device(device, local_rank, local_world, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield device_mesh(axis, dev.type)
    finally:
        dist.destroy_process_group()


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_slice(mesh: DeviceMesh, n: int) -> slice:
    """This rank's contiguous slice of an axis of length n; n must divide
    over the mesh (the reference's shard_map raises likewise)."""
    k = mesh.size()
    if n % k != 0:
        raise ValueError(f"an axis of length {n} does not divide over a "
                         f"{k}-rank mesh")
    n_loc = n // k
    r = mesh.get_local_rank()
    return slice(r * n_loc, (r + 1) * n_loc)


def all_gather(mesh: DeviceMesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's `t`, concatenated in rank order along `dim` (the
    reference's `all_gather(..., tiled=True)`)."""
    parts = [torch.empty_like(t) for _ in range(mesh.size())]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group())
    return torch.cat(parts, dim=dim)


def psum(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's `t` (the reference's `psum`)."""
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return out


def on_device(dev: torch.device):
    """The calling thread's current CUDA device set to `dev` (a worker
    thread starts on cuda:0), or nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class Controller:
    """A batched step run across a mesh from rank 0. `local(it, w)` computes
    this rank's rows of round `it`'s batch at weights w[d]; rank 0's
    `dispatch(it, w)` sends every rank the header (STEP, it) and w, and
    returns the batch gathered to it in rank order; the others `serve()`
    until rank 0's `close()` sends STOP. Every rank of the mesh builds its
    Controller at the same point: the controller opens a process group of
    its own (timeout `timeout_s`), so its headers never meet another
    collective of the mesh.

    Between batches a follower waits in a broadcast for rank 0's next
    header, and the protocol round in between may last longer than any
    group timeout; so rank 0 also sends a KEEPALIVE header every quarter
    of `timeout_s`, and a follower never waits longer than that unless
    rank 0 is gone.

    Rank 0's dispatches may come from several threads at once (the
    steppers' memo computes each key in a worker thread, and a straggler's
    round can be in flight beside the next); one lock keeps each header's
    collectives whole and in one order on every rank."""

    def __init__(self, mesh: DeviceMesh, d: int,
                 local: Callable[[int, torch.Tensor], torch.Tensor],
                 timeout_s: float = TIMEOUT_S):
        self.mesh, self.d, self.local = mesh, d, local
        self.device = mesh_device(mesh)
        self.lead = mesh.get_local_rank() == 0
        ranks = dist.get_process_group_ranks(mesh.get_group())
        self.src = ranks[0]
        self.group = dist.new_group(
            ranks, timeout=datetime.timedelta(seconds=timeout_s))
        self._lock = threading.Lock()
        self.closed = False
        self._stopped = threading.Event()
        if self.lead and len(ranks) > 1:
            threading.Thread(target=self._keepalive, args=(timeout_s / 4,),
                             name="mesh-keepalive", daemon=True).start()

    def _header(self, op: int = STOP, it: int = 0) -> tuple:
        h = torch.tensor([op, it], dtype=torch.int64, device=self.device)
        dist.broadcast(h, src=self.src, group=self.group)
        op, it = h.tolist()
        return op, it

    def _round(self, it: int, w: torch.Tensor) -> Optional[torch.Tensor]:
        dist.broadcast(w, src=self.src, group=self.group)
        rows = self.local(it, w).contiguous()
        parts = ([torch.empty_like(rows) for _ in range(self.mesh.size())]
                 if self.lead else None)
        dist.gather(rows, parts, dst=self.src, group=self.group)
        return torch.cat(parts) if self.lead else None

    def _lead_only(self, what: str) -> None:
        if not self.lead:
            raise RuntimeError(f"{what} runs on the mesh's rank 0; rank "
                               f"{self.mesh.get_local_rank()} serves")

    def dispatch(self, it: int, w: torch.Tensor) -> torch.Tensor:
        self._lead_only("dispatch")
        w = w.to(self.device, torch.float32).contiguous()
        with self._lock, on_device(self.device):
            if self.closed:
                raise RuntimeError("the mesh controller is closed")
            self._header(STEP, it)
            return self._round(it, w)

    def _keepalive(self, period_s: float) -> None:
        while not self._stopped.wait(period_s):
            with self._lock, on_device(self.device):
                if self.closed:
                    return
                self._header(KEEPALIVE)

    def serve(self) -> int:
        """The followers' loop; returns the number of batches served."""
        if self.lead:
            raise RuntimeError("rank 0 dispatches; serve() is the followers'")
        served = 0
        with on_device(self.device):
            while True:
                op, it = self._header()
                if op == STOP:
                    return served
                if op == STEP:
                    self._round(it, torch.empty(self.d, device=self.device))
                    served += 1

    def close(self) -> None:
        """Rank 0: release the followers (once)."""
        self._lead_only("close")
        self._stopped.set()
        with self._lock, on_device(self.device):
            if not self.closed:
                self.closed = True
                self._header(STOP)


# ------------------------------------------------------------------ spawn


def _rank_main(rank: int, world_size: int, device, init_method: str,
               axis: str, timeout_s: float, backend: Optional[str],
               fn: Callable, args: Sequence, results) -> None:
    try:
        if resolve_device(device).type == "cpu":
            torch.set_num_threads(1)  # several ranks share the host's cores
        with open_mesh(axis, device, rank=rank, world_size=world_size,
                       init_method=init_method, timeout_s=timeout_s,
                       backend=backend) as mesh:
            out = fn(mesh, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world_size: int,
          device: Optional[Union[str, torch.device]] = None,
          args: Sequence = (), axis: str = "peers",
          timeout_s: float = TIMEOUT_S,
          backend: Optional[str] = None) -> List[Any]:
    """Run `fn(mesh, *args)` on `world_size` fresh processes (the `spawn`
    start method), one rank each, over a `file://` rendezvous in a
    temporary directory (so concurrent callers never share a port), gloo
    on the CPU and NCCL on `cuda` (None: the GPU) unless `backend` says
    otherwise. `fn` and its arguments and results must pickle. Returns the
    results in rank order; raises with every failed rank's traceback, or
    if a rank outlives `timeout_s`."""
    rank_device(device, 0, world_size, backend)  # refuse before spawning
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="biscotti-mesh-") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world_size, device, init_method, axis, timeout_s, backend,
            fn, args, results)) for r in range(world_size)]
        for p in procs:
            p.start()
        got, errors, wait = {}, [], timeout_s
        try:
            # drain before joining: a child blocks on exit until its
            # queued result is read
            for _ in procs:
                try:
                    rank, ok, out = results.get(timeout=wait)
                except queue.Empty:
                    errors.append(f"no result within {wait} s from ranks "
                                  f"{sorted(set(range(world_size)) - set(got))}")
                    break
                if ok:
                    got[rank] = out
                else:  # the others may wait on it in a collective
                    errors.append(f"rank {rank}:\n{out}")
                    wait = min(wait, 10.0)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("mesh ranks failed:\n" + "\n".join(errors))
    return [got[r] for r in range(world_size)]
