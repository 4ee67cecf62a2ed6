# The port's own copy of biscotti_tpu/runtime/hive.py; it imports nothing of biscotti_tpu.
# Its HiveStepper is torch's, and `rss_peak_bytes` reads the process's own peak.
"""Hive runtime: one process hosts H (hundreds of) lightweight co-hosted
peers that share one torch device (counterpart of
`biscotti_tpu/runtime/hive.py`; docs/HIVE.md).

The hive keeps the agents — the full protocol state machine, committees,
chain, crypto — but shares everything an honest co-hosted deployment can
share:

  * **Batched device plane** (`HiveStepper`): within a round, all
    co-hosted workers' local SGD steps run as ONE `torch.func.vmap` of
    `models/trainer.py::local_step_fn` on the stepper's device (the
    simulator's round-step math), and DP noise is one [H, d] draw a
    round instead of H presample banks of [iters, d]. The random draws
    (`draw_batches`, `draw_noise`) are split from the pure step
    (`deltas_from_draws`, `noise_from_draws`), so the tests feed the
    pure half the reference's own draws.
  * **Loopback transport fast path** (`LoopbackHub`), verbatim from the
    reference: RPC between two peers of one hive skips TCP framing and
    serialization (the handler gets read-only numpy views of the
    caller's arrays); admission, the seeded fault plane and byte
    accounting still apply, the bytes under a `loopback` direction.
  * **Shared memory**: light trainers (`Trainer(light=True)`) hold no
    train shard and no noise bank; the eval splits are one copy a
    device.

Cross-hive traffic rides the ordinary TCP wire plane, so hives of the
port and of the reference interoperate frame for frame.

The reference's peers-across-devices step (a `shard_map` over a mesh) is
not ported: a mesh of more than one device raises.

Launcher CLI (one hive = one process; tools/pod_launch.py spreads many);
`--platform` names the torch device, `cuda` (the default) or `cpu`:

    python -m biscotti_tpu_torch.runtime.hive -t 1000 --local 0:1000 \
        -d mnist --iterations 3 -sa 0 -np 0 -vp 1

Prints one JSON line: local chain digests (the cross-hive equality
oracle compares anchors across processes), s/iter, and the honest
per-peer memory account (peak RSS / peers).
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from biscotti_tpu_torch.data import datasets as ds
from biscotti_tpu_torch.models.base import fp32_math
from biscotti_tpu_torch.models.trainer import sample_batch, stream_seed
from biscotti_tpu_torch.ops import dp_noise
from biscotti_tpu_torch.runtime import codecs as wcodecs
from biscotti_tpu_torch.runtime.device_cluster import (host_f32,
                                                       shared_test_error,
                                                       single_device,
                                                       single_flight_memo,
                                                       vmapped_step)
from biscotti_tpu_torch.runtime.rpc import BusyError, RPCError, StaleError
from biscotti_tpu_torch.tools.verdicts import poisoned_ids

LOOPBACK = "loopback"  # wire-plane direction label for in-process frames

LOOPBACK_RPCS_METRIC = "biscotti_loopback_rpcs_total"
LOOPBACK_RPCS_HELP = "RPCs delivered over the in-process loopback fast path"
LOOPBACK_SECONDS_METRIC = "biscotti_loopback_rpc_seconds"
LOOPBACK_SECONDS_HELP = "loopback reply-bearing RPC latency"


def _ro_view(a) -> np.ndarray:
    """Read-only ndarray view — loopback delivery must preserve the TCP
    path's invariant that a receiver cannot mutate what it was handed
    (frames decode to non-writable frombuffer views); here the arrays
    ALIAS the sender's memory, so the invariant is load-bearing."""
    arr = np.asarray(a)
    v = arr.view()
    v.flags.writeable = False
    return v


def _frame_estimate(meta, arrays) -> int:
    """Bytes this RPC WOULD have cost on the wire (raw64 frame: JSON
    header + raw array payloads + framing) — the loopback direction's
    byte accounting counts avoided traffic honestly rather than zero,
    so bytes/round comparisons between co-hosted and remote layouts
    stay meaningful."""
    n = 64
    try:
        n += len(json.dumps(meta or {}, separators=(",", ":"),
                            default=str))
    except (TypeError, ValueError):
        n += 256
    for a in (arrays or {}).values():
        n += np.asarray(a).nbytes
    return n


def rss_bytes() -> int:
    """Current resident set size of this process (Linux /proc; 0 when
    unavailable)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def vm_hwm_bytes() -> Optional[int]:
    """This process's own peak RSS, Linux's VmHWM (/proc/self/status, KiB),
    or None where the kernel does not report it."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def rss_peak_bytes() -> int:
    """Peak resident set size: VmHWM (`vm_hwm_bytes`), else ru_maxrss (KiB
    on Linux). The reference reads ru_maxrss, which Linux carries across
    fork and exec, so a hive launched from a large process (the density
    bench's subprocess) reports its launcher's peak as its own (ROADMAP
    C5); VmHWM starts anew with the process's image."""
    hwm = vm_hwm_bytes()
    if hwm is not None:
        return hwm
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return 0


# Monitor samples retained for the drift window (seconds). Long enough
# that allocator sawtooth averages out, short enough that a genuine leak
# moves the gauge within one soak sampling interval (tools/soak.py).
DRIFT_WINDOW_S = 120.0


def drift(values: Sequence[float]) -> float:
    """Windowed drift: median of the newest quarter of ``values`` minus
    median of the oldest quarter.

    A plain last-minus-first delta aliases on GC/allocator sawtooth and
    on a single slow event-loop tick; quarter-medians keep a monotone
    leak visible while one outlier sample stays invisible.  Returns 0
    until there are at least 4 samples (one per quarter)."""
    if len(values) < 4:
        return 0.0
    q = max(1, len(values) // 4)
    import statistics

    return float(statistics.median(values[-q:])
                 - statistics.median(values[:q]))


# --------------------------------------------------------------- transport


class LoopbackEndpoint:
    """One co-hosted peer's in-process RPC surface. Alive exactly while
    the peer's TCP server would accept a connection (same lifecycle —
    a closed peer's loopback callers fall back to TCP and get the
    connection-refused the protocol already handles)."""

    def __init__(self, hub: "LoopbackHub", agent):
        self.hub = hub
        self.agent = agent

    @property
    def alive(self) -> bool:
        return self.agent.server.serving

    # -------------------------------------------------------- delivery

    async def _dispatch(self, msg_type: str, meta, arrays, src):
        """One delivered frame: admission-budgeted, handler-dispatched,
        typed-error mapped exactly as rpc.RPCServer._dispatch would
        surface it to a TCP caller."""
        agent = self.agent
        if not self.alive:
            raise ConnectionError("loopback endpoint closed")
        # budget key parity with RPCServer._admit_key: the TCP path keys
        # on the connection peername (unspoofable); in-process the
        # caller's identity is the pool that delivered the frame — just
        # as unspoofable, and per-peer like an honest pooled connection
        key = ("loop", src)
        reason = agent.admission.try_admit(key, msg_type)
        if reason is not None:
            raise BusyError(f"admission shed: {reason}")
        try:
            if agent.server.service_delay_s > 0.0:
                # slow-peer service emulation, mirrored from
                # RPCServer._dispatch: a co-hosted slow peer serves its
                # loopback callers exactly as slowly as its TCP callers —
                # the layout-invariance the straggler plane promises
                # (docs/STRAGGLERS.md)
                await asyncio.sleep(agent.server.service_delay_s)
            meta2 = dict(meta or {})
            arrays2 = {k: _ro_view(v) for k, v in (arrays or {}).items()}
            # distributed tracing: the loopback dispatch is a transport
            # seam like RPCServer._dispatch — the same receiver-side
            # child span off the frame's wire context, so co-hosted hops
            # appear in the causal tree exactly as TCP hops do (getattr:
            # harness stubs duck-type the server without the hook)
            tele = getattr(agent.server, "telemetry", None)
            span = (tele.rpc_span(msg_type, meta2) if tele is not None
                    else contextlib.nullcontext())
            try:
                with span:
                    return await agent._handle(msg_type, meta2, arrays2)
            except (StaleError, BusyError, RPCError):
                raise
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # handler bug: report, don't kill the caller — the TCP
                # server wraps this identically
                raise RPCError(
                    f"internal: {type(e).__name__}: {e}") from e
        finally:
            agent.admission.release(key)

    def _deliver_bg(self, msg_type, meta, arrays, src,
                    budget: float) -> None:
        """Background delivery for fire-and-forget posts and injected
        duplicate/flood copies: result and errors are discarded, exactly
        like a TCP frame whose reply nobody awaits."""

        async def go():
            try:
                await asyncio.wait_for(
                    self._dispatch(msg_type, meta, arrays, src),
                    max(0.001, budget))
            except asyncio.CancelledError:
                raise
            except Exception:
                pass

        self.hub.track(asyncio.get_running_loop().create_task(go()))

    def _account(self, metrics, msg_type: str, kind: str, meta,
                 arrays) -> None:
        if metrics is None:
            return
        metrics.counter(wcodecs.WIRE_BYTES_METRIC,
                        wcodecs.WIRE_BYTES_HELP).inc(
            _frame_estimate(meta, arrays), msg_type=msg_type,
            direction=LOOPBACK, codec=wcodecs.RAW)
        metrics.counter(LOOPBACK_RPCS_METRIC, LOOPBACK_RPCS_HELP).inc(
            msg_type=msg_type, kind=kind)

    # ------------------------------------------------------ public API

    async def call(self, msg_type: str, meta, arrays, timeout: float,
                   fault=None, src=None, metrics=None):
        """Reply-bearing RPC over the fast path. Fault semantics mirror
        the _Conn boundary: reset → ConnectionError, delay → sleep,
        drop → the caller's deadline expires (the handler never runs),
        duplicate/flood → extra deliveries whose replies are dropped."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        # counted regardless of an injected drop — the TCP path counts
        # outbound bytes once the transport accepted the frame, and an
        # injected drop still paid the send
        self._account(metrics, msg_type, "call", meta, arrays)
        if fault is not None and not fault.benign:
            if fault.reset:
                raise ConnectionError("fault injection: connection reset")
            if fault.delay_s > 0.0:
                await asyncio.sleep(min(fault.delay_s, timeout))
            if fault.drop:
                # frame lost before delivery: the caller waits out its
                # budget exactly as a TCP timeout would
                await asyncio.sleep(max(0.001, deadline - loop.time()))
                raise asyncio.TimeoutError(
                    "fault injection: frame dropped")
            extra = (1 if fault.duplicate else 0) + max(0, fault.flood)
            for _ in range(extra):
                self._deliver_bg(msg_type, meta, arrays, src,
                                 deadline - loop.time())
        t0 = loop.time()
        task = loop.create_task(self._dispatch(msg_type, meta, arrays,
                                               src))
        self.hub.track(task)
        try:
            rmeta, rarrays = await asyncio.wait_for(
                asyncio.shield(task), max(0.001, deadline - loop.time()))
        except asyncio.TimeoutError:
            # the handler keeps running, like an abandoned TCP reply —
            # its state transitions (a registered update, a parked wait)
            # must not be lost to the caller's impatience
            raise
        if metrics is not None:
            metrics.histogram(LOOPBACK_SECONDS_METRIC,
                              LOOPBACK_SECONDS_HELP).observe(
                loop.time() - t0, msg_type=msg_type)
        # reply accounting on the CALLEE's registry (the TCP server
        # counts its outbound reply the same way); arrays go back as
        # read-only views too — the caller must not be able to mutate
        # the callee's chain through an aliased GetBlock body
        self._account(self.agent.server.metrics, msg_type + ".reply",
                      "reply", rmeta, rarrays)
        return dict(rmeta), {k: _ro_view(v)
                             for k, v in (rarrays or {}).items()}

    async def post(self, msg_type: str, meta, arrays, timeout: float,
                   fault=None, src=None, metrics=None) -> None:
        """Fire-and-forget over the fast path (rid-0 semantics: replies
        and handler errors are dropped)."""
        loop = asyncio.get_running_loop()
        self._account(metrics, msg_type, "post", meta, arrays)
        if fault is not None and not fault.benign:
            if fault.reset:
                raise ConnectionError("fault injection: connection reset")
            if fault.delay_s > 0.0:
                await asyncio.sleep(min(fault.delay_s, timeout))
            if fault.drop:
                return  # frame lost before delivery (still counted)
            extra = (1 if fault.duplicate else 0) + max(0, fault.flood)
            for _ in range(extra):
                self._deliver_bg(msg_type, meta, arrays, src, timeout)
        self._deliver_bg(msg_type, meta, arrays, src, timeout)


class LoopbackHub:
    """Per-process registry of co-hosted peers, attached to each member
    agent's `rpc.Pool` (`pool.loopback`). Lookup is by the (host, port)
    the CLUSTER addresses the peer with, so remote peers simply miss and
    ride TCP; a registered peer whose server is not (yet / anymore)
    serving also misses, so startup races and teardown degrade to the
    exact connection-refused behavior the retry/breaker plane already
    handles. Re-registering an id (a relaunched incarnation) replaces
    the endpoint."""

    def __init__(self):
        self._by_addr: Dict[Tuple[str, int], LoopbackEndpoint] = {}
        self._tasks: set = set()

    def register(self, agent) -> LoopbackEndpoint:
        ep = LoopbackEndpoint(self, agent)
        self._by_addr[tuple(agent.peers[agent.id])] = ep
        return ep

    def lookup(self, host: str, port: int) -> Optional[LoopbackEndpoint]:
        ep = self._by_addr.get((host, port))
        return ep if ep is not None and ep.alive else None

    @property
    def local_ids(self) -> frozenset:
        return frozenset(ep.agent.id for ep in self._by_addr.values())

    def track(self, task: asyncio.Task) -> None:
        """Strong ref for background deliveries (the loop only keeps
        weak ones) + exception retrieval on completion."""
        self._tasks.add(task)
        task.add_done_callback(self._done)

    def _done(self, task: asyncio.Task) -> None:
        self._tasks.discard(task)
        if not task.cancelled():
            task.exception()  # mark retrieved


# ------------------------------------------------------------ device plane


class UnequalShardsError(ValueError):
    """Co-hosted peers' train shards disagree on row count, so one
    batched minibatch draw cannot reproduce each standalone Trainer's
    `batch_indices(it)` stream. Hive catches this and falls back to
    per-agent trainers (slower, exact)."""


class HiveStepper:
    """Batched device plane for a hive's LOCAL peer subset: all co-hosted
    workers' SGD deltas in one vmapped device call per (iteration,
    weights), DP noise as one [H, d] draw per iteration, and the shared
    convergence metric — the `device_cluster.BatchStepper` executor
    pattern generalized to host a SLICE of the cluster (multi-host hives)
    with Trainer-parity randomness.

    Peer `pid`'s minibatch rows for round `it` are the rows its
    standalone port `Trainer` draws: a generator on the same device,
    seeded with `stream_seed("trainer", cfg.seed, pid, "batch", it)`, so
    a hive-hosted peer's SGD stream is its standalone agent's (deltas
    agree to float tolerance; the vmapped reduction order is the only
    difference). That is H small generator draws a round, before one
    batched step. Noise is drawn fresh each round from a per-peer
    generator keyed on the iteration instead of indexed from a presample
    bank: distribution-identical to the bank, O(H·d) resident instead of
    O(H·iters·d).

    Tensors live on the stepper's one device (`device`; None: the GPU,
    which must exist); results come back to the host as float64 numpy,
    and the compute runs in `asyncio.to_thread`."""

    def __init__(self, cfg, local_ids: Sequence[int], mesh=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = single_device(mesh, device)
        self.local_ids = sorted(int(i) for i in local_ids)
        self._slot = {pid: i for i, pid in enumerate(self.local_ids)}

        self.model, self._batched_step, mode = vmapped_step(cfg)
        self.num_params = self.model.num_params

        poisoned = poisoned_ids(cfg.num_nodes, cfg.poison_fraction)
        xs, ys = [], []
        for pid in self.local_ids:
            shard = ds.load_shard(
                cfg.dataset, ds.shard_name(cfg.dataset, pid,
                                           pid in poisoned))
            xs.append(shard["x_train"])
            ys.append(shard["y_train"])
        sizes = {len(x) for x in xs}
        if len(sizes) > 1:
            # truncating to a common row count would change which rows
            # sample_batch can draw vs the peer's standalone Trainer —
            # the parity this class promises. Hive falls back to
            # per-agent trainers when it catches this.
            raise UnequalShardsError(
                f"co-hosted shards have unequal row counts {sorted(sizes)}; "
                "batched stepping would break Trainer-parity sampling")
        self.rows = sizes.pop()
        self._x = torch.from_numpy(np.stack(xs)).to(self.device)
        self._y = torch.from_numpy(np.stack(ys)).to(self.device)
        self.batch = min(cfg.batch_size, self.rows)
        self._gen = torch.Generator(device=self.device)
        self._gen_lock = threading.Lock()

        # DP noise: fresh per-round draw, Σ_batch σ·N(0,1) scaled by
        # −α/batch like Trainer.get_noise / the simulator's round noise.
        # mcmc13 peers keep their per-agent trainer banks (the chain draw
        # doesn't batch trivially) — serves_noise gates that.
        eps_live = cfg.epsilon if (cfg.noising or cfg.dp_in_model) else 0.0
        self._sigma = dp_noise.sigma_for(eps_live, cfg.delta)
        self._noise_alpha = cfg.logreg_alpha if mode == "sgd" else 1.0
        # UNCLAMPED batch size, matching Trainer exactly: presample's
        # sqrt scale and noise_at's 1/batch denominator both use
        # cfg.batch_size even when the shard is smaller than a batch
        self._noise_batch = cfg.batch_size
        self.serves_noise = cfg.dp_mechanism != "mcmc13"

        self._caches: Dict[str, Dict] = {"step": {}, "noise": {},
                                         "eval": {}}
        self._pending: Dict[str, Dict] = {"step": {}, "noise": {},
                                          "eval": {}}
        self.batches = 0  # batched delta dispatches (observability)
        self.noise_batches = 0
        self.evals = 0
        # wall-clock of the last batched SGD dispatch: the straggler
        # plane's compute pad bases a co-hosted slow peer's padding on
        # the batch's REAL cost — a memo-hit caller measures ~0 for its
        # own await, which would otherwise make hive layouts immune to
        # the slowdown TCP layouts emulate (docs/STRAGGLERS.md)
        self.step_cost_s = 0.0

    # ------------------------------------------------ draws and pure step

    def draw_batches(self, it: int) -> torch.Tensor:
        """Round `it`'s minibatch rows [H, B] of every co-hosted peer, in
        `local_ids` order: each the rows its standalone Trainer draws."""
        idx = []
        with self._gen_lock:
            for pid in self.local_ids:
                self._gen.manual_seed(stream_seed("trainer", self.cfg.seed,
                                                  pid, "batch", it))
                idx.append(sample_batch(self._gen, self.rows, self.batch,
                                        1)[0])
        return torch.stack(idx)

    def deltas_from_draws(self, w: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
        """Every co-hosted peer's step [H, d] on its rows idx[H, B]: pure
        in (w, idx), float32 on the stepper's device."""
        idx = idx.to(self.device)
        peers = torch.arange(idx.shape[0], device=self.device)[:, None]
        with fp32_math():
            return self._batched_step(w.to(self.device, torch.float32),
                                      self._x[peers, idx], self._y[peers, idx])

    def draw_noise(self, it: int) -> torch.Tensor:
        """Round `it`'s standard normals [H, d], peer `pid`'s row pure in
        (cfg.seed, pid, it)."""
        z = torch.empty(len(self.local_ids), self.num_params,
                        device=self.device)
        with self._gen_lock:
            for slot, pid in enumerate(self.local_ids):
                self._gen.manual_seed(stream_seed("hive", self.cfg.seed, pid,
                                                  "noise", it))
                torch.randn(self.num_params, generator=self._gen,
                            device=self.device, out=z[slot])
        return z

    def noise_from_draws(self, z: torch.Tensor) -> torch.Tensor:
        """Noise [H, d] float64 from normals z: (−α/batch)·(σ·√batch·z),
        the product in float32 and the scale in float64, as the reference
        rounds them (ref hive.py:491-502, :572)."""
        scale = self._sigma * (self._noise_batch ** 0.5)
        draw = (scale * z.to(self.device, torch.float32)).double()
        return (-self._noise_alpha / self._noise_batch) * draw

    # ------------------------------------------------------- async plane

    async def _memo(self, kind: str, key, compute):
        return await single_flight_memo(self._caches[kind],
                                        self._pending[kind], key, compute)

    def _evict(self, kind: str, it: int) -> None:
        cache = self._caches[kind]
        for old in [k for k in cache
                    if (k[0] if isinstance(k, tuple) else k) < it - 3]:
            cache.pop(old, None)

    async def step(self, peer_id: int, w: np.ndarray,
                   it: int) -> np.ndarray:
        """This peer's SGD delta for iteration `it`; the first co-hosted
        caller computes the WHOLE hive's batch. Keyed on (it, weight
        digest): transiently forked chains compute their own batch,
        identical chains — the lockstep case — share one."""
        wb = np.ascontiguousarray(np.asarray(w))
        key = (it, hashlib.sha1(wb.tobytes()).hexdigest())

        def compute():
            t0 = time.perf_counter()
            out = self.deltas_from_draws(host_f32(wb, self.device),
                                         self.draw_batches(it))
            out = out.cpu().numpy().astype(np.float64)
            self.step_cost_s = time.perf_counter() - t0
            return out

        deltas, computed = await self._memo("step", key, compute)
        if computed:
            self.batches += 1
        self._evict("step", it)
        return deltas[self._slot[peer_id]]

    async def noise(self, peer_id: int, it: int) -> np.ndarray:
        """This peer's DP noise vector for iteration `it` — one [H, d]
        device draw per round, shared by every co-hosted noiser."""
        if self._sigma == 0.0:
            return np.zeros(self.num_params, np.float64)

        def compute():
            return self.noise_from_draws(self.draw_noise(it)).cpu().numpy()

        bank, computed = await self._memo("noise", (it,), compute)
        if computed:
            self.noise_batches += 1
        self._evict("noise", it)
        return bank[self._slot[peer_id]]

    async def test_error(self, w: np.ndarray, it: int) -> float:
        """Global-test-split error, computed once per distinct
        (iteration, weights) across the hive."""
        wb = np.ascontiguousarray(np.asarray(w))
        key = (it, hashlib.sha1(wb.tobytes()).hexdigest())

        def compute():
            return shared_test_error(self.model, self.device, self.cfg, wb)

        err, computed = await self._memo("eval", key, compute)
        if computed:
            self.evals += 1
        self._evict("eval", it)
        return err


# ----------------------------------------------------------------- launcher


class Hive:
    """One hive: H co-hosted `PeerAgent`s sharing a LoopbackHub, a
    HiveStepper, one event loop and one torch device (`device`; None: the
    GPU). `local_ids` names the slice of the cluster this process hosts
    (default: all of it — the single-box density configuration); the
    peers file / base-port arithmetic in `cfg_base` must describe the
    WHOLE cluster so cross-hive addresses resolve.

    Co-hosted peers are made mutually known at construction (caps +
    liveness), so a genesis hive launch skips the O(H²) intra-hive
    hello storm; hellos toward REMOTE peers still run, which is how a
    late-started hive adopts the cluster's chain."""

    def __init__(self, cfg_base, local_ids: Optional[Sequence[int]] = None,
                 mesh=None, key_dir: str = "", log_dir: str = "",
                 hive_id: str = "", batch_device: bool = True,
                 loopback: bool = True, skip_local_announce: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        from biscotti_tpu_torch.runtime.peer import PeerAgent

        self.cfg = cfg_base
        self.device = single_device(mesh, device)
        self.local_ids = sorted(local_ids if local_ids is not None
                                else range(cfg_base.num_nodes))
        # loopback=False / batch_device=False are the ablation knobs the
        # density bench A/Bs against: full agents talking real TCP in one
        # process — exactly the pre-hive one-agent-per-peer runtime
        self.hub = LoopbackHub() if loopback else None
        self.stepper = None
        self.stepper_fallback = ""
        if batch_device:
            try:
                self.stepper = HiveStepper(cfg_base, self.local_ids,
                                           device=self.device)
            except UnequalShardsError as e:
                # exactness beats batching: per-agent trainers keep the
                # standalone sampling streams when shards are unequal
                self.stepper_fallback = str(e)
        light = self.stepper is not None and self.stepper.serves_noise
        # shared mutable per-hive readout: the monitor task updates it,
        # every member's telemetry_snapshot()["hive"] reads it, the obs
        # CLI groups the cluster table by its id (docs/OBSERVABILITY.md)
        self.info: Dict = {
            "id": hive_id or f"pid{os.getpid()}",
            "peers": len(self.local_ids),
            "rss_bytes": 0, "rss_peak_bytes": 0, "loop_lag_s": 0.0,
            # the largest RSS the monitor sampled (every `period`): the
            # hive's own peak, to within a sample, on any kernel
            "rss_sampled_max_bytes": 0,
            # windowed deltas over DRIFT_WINDOW_S of monitor samples: a
            # leak or creeping starvation shows as sustained positive
            # drift long before the absolute gauges look alarming
            # (tools/soak.py gates on these; docs/SOAK.md)
            "rss_drift_bytes": 0, "loop_lag_drift_s": 0.0,
        }
        self.agents: List[PeerAgent] = []
        for pid in self.local_ids:
            cfg = cfg_base.replace(node_id=pid)
            self.agents.append(PeerAgent(
                cfg, key_dir=key_dir, stepper=self.stepper,
                hive=self.hub, light_trainer=light,
                log_path=os.path.join(log_dir, f"events_{pid}.jsonl")
                if log_dir else "", device=self.device))
        caps = sorted(self.agents[0].caps) if self.agents else []
        local_set = frozenset(self.local_ids)
        for a in self.agents:
            a.hive_info = self.info
            if skip_local_announce:
                a._announce_skip = local_set
            for pid in self.local_ids:
                if pid != a.id:
                    a._record_caps(pid, caps)

    async def _monitor(self, period: float = 0.25) -> None:
        """Event-loop lag + RSS sampler: co-hosting starvation must be
        VISIBLE (an overloaded hive's lag gauge climbs), not inferred
        from round-time anomalies."""
        loop = asyncio.get_running_loop()
        samples: List[Tuple[float, int, float]] = []
        while True:
            t0 = loop.time()
            await asyncio.sleep(period)
            now = loop.time()
            lag = round(max(0.0, now - t0 - period), 4)
            rss = rss_bytes()
            self.info["loop_lag_s"] = lag
            self.info["rss_bytes"] = rss
            self.info["rss_peak_bytes"] = rss_peak_bytes()
            self.info["rss_sampled_max_bytes"] = max(
                rss, self.info["rss_sampled_max_bytes"])
            samples.append((now, rss, lag))
            while samples and now - samples[0][0] > DRIFT_WINDOW_S:
                samples.pop(0)
            self.info["rss_drift_bytes"] = int(
                drift([r for _, r, _ in samples]))
            self.info["loop_lag_drift_s"] = round(
                drift([l for _, _, l in samples]), 4)

    async def run(self) -> List[Dict]:
        mon = asyncio.get_running_loop().create_task(self._monitor())
        try:
            return await asyncio.gather(*(a.run() for a in self.agents))
        finally:
            mon.cancel()


def summarize(hive: Hive, results: List[Dict], wall: float,
              iterations: int) -> Dict:
    """The launcher's one-line summary of a finished hive run (the JSON
    `main` prints; bench.py and tools/pod_launch.py parse it)."""
    # wire accounting over THIS hive's peers (obs.merge_wire — the one
    # definition): cross-host (TCP-crossing) vs loopback-avoided bytes,
    # so the overlay headline reads straight off the pod_launch artifact
    from biscotti_tpu_torch.tools import obs as _obs

    dumps = [r["chain_dump"] for r in results]
    digests = [hashlib.sha256(d.encode()).hexdigest() for d in dumps]
    anchor = results[0]
    wire = _obs.merge_wire([r.get("telemetry", {}) for r in results])
    rounds = max(1, len(dumps[0].splitlines()) - 1)
    overlay_tbl = _obs.merge_overlay([r.get("telemetry", {})
                                      for r in results])
    rows = [tuple(x.split(",")) for x in anchor["logs"]]
    if len(rows) >= 2:
        ts = [float(r[2]) for r in rows]
        s_per_iter = (ts[-1] - ts[0]) / (len(ts) - 1)
    else:
        s_per_iter = wall / max(1, iterations)
    peak = rss_peak_bytes()
    return {
        "hive": hive.info["id"],
        "nodes": [hive.local_ids[0], hive.local_ids[-1] + 1],
        "peers": len(hive.local_ids),
        "blocks": len(dumps[0].splitlines()) - 1,
        "chains_equal_local": all(d == digests[0] for d in digests),
        "chain_digest": digests[0],
        "wall_s": round(wall, 2),
        "s_per_iter": round(s_per_iter, 4),
        "rss_peak_bytes": peak,
        "rss_per_peer_bytes": int(peak / max(1, len(hive.local_ids))),
        "rss_peak_source": ("VmHWM" if vm_hwm_bytes() is not None
                            else "ru_maxrss"),
        "rss_sampled_max_bytes": hive.info["rss_sampled_max_bytes"],
        "loop_lag_s": hive.info["loop_lag_s"],
        # reflects reality, not the flag: unequal co-hosted shards fall
        # back to per-agent trainers (UnequalShardsError) and must not
        # masquerade as a batched run in the bench artifact
        "batch_device": hive.stepper is not None,
        "batch_fallback": hive.stepper_fallback or None,
        "loopback": hive.hub is not None,
        "overlay": bool(hive.cfg.overlay),
        "cross_host_bytes": wire["cross_host_bytes"],
        "cross_host_by_msg_type": dict(sorted(
            wire["out_by_msg_type"].items(), key=lambda kv: -kv[1])[:10]),
        "cross_host_bytes_per_round": round(
            wire["cross_host_bytes"] / rounds, 1),
        "loopback_avoided_bytes_per_round": round(
            wire["loopback_bytes"] / rounds, 1),
        "overlay_aggregated": overlay_tbl["aggregated"],
        "overlay_relayed": overlay_tbl["relayed"],
        "overlay_fallback": overlay_tbl["fallback"],
        "sgd_batches": hive.stepper.batches if hive.stepper else None,
        "final_error": anchor.get("final_error"),
        "device": str(hive.device),
    }


def main(argv=None) -> int:
    import argparse

    from biscotti_tpu_torch.config import BiscottiConfig, Defense

    ap = argparse.ArgumentParser(
        description="hive host: co-hosted lightweight peers, one process")
    BiscottiConfig.add_args(ap)
    ap.add_argument("--local", default="",
                    help="START:COUNT slice of node ids this hive hosts "
                         "(default: the whole cluster)")
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--key-dir", default="")
    ap.add_argument("--log-dir", default="")
    ap.add_argument("--hive-id", default="")
    ap.add_argument("--no-batch-device", action="store_true",
                    help="ablation: per-agent trainer dispatch instead of "
                         "the hive's batched device plane")
    ap.add_argument("--no-loopback", action="store_true",
                    help="ablation: co-hosted peers talk real TCP (the "
                         "pre-hive one-agent-per-peer runtime)")
    ap.add_argument("--platform", default="cuda",
                    help="torch device of the hive's batch and peers: "
                         "'cuda' (the default; raises without a GPU) or "
                         "'cpu'")
    ap.add_argument("--dump-chain", action="store_true",
                    help="also print the anchor agent's full chain dump")
    ns = ap.parse_args(argv)

    if getattr(ns, "overlay", 0) and not getattr(ns, "overlay_group", 0):
        # default the aggregation subtree to this hive's co-hosted span —
        # the intra-hive pre-aggregation seam (docs/OVERLAY.md): one
        # interior node per host, leaf->relay offers ride loopback
        ns.overlay_group = (int(ns.local.split(":")[1]) if ns.local
                            else ns.num_nodes)
    cfg = BiscottiConfig.from_args(ns)
    cfg = cfg.replace(
        max_iterations=ns.iterations, convergence_error=0.0,
        timeouts=cfg.timeouts.scaled(
            cfg.num_nodes, cfg.num_verifiers, cfg.num_miners,
            random_sampling=cfg.random_sampling,
            defense_is_krum=cfg.defense == Defense.KRUM))
    local = None
    if ns.local:
        start, count = (int(x) for x in ns.local.split(":"))
        local = range(start, start + count)

    try:  # large hives need many sockets: lift the soft fd limit
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < hard:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except Exception:
        pass

    hive = Hive(cfg, local, key_dir=ns.key_dir, log_dir=ns.log_dir,
                hive_id=ns.hive_id, batch_device=not ns.no_batch_device,
                loopback=not ns.no_loopback, device=ns.platform)
    t0 = time.time()
    results = asyncio.run(hive.run())
    summary = summarize(hive, results, time.time() - t0, ns.iterations)
    if ns.dump_chain:
        print("=== CHAIN DUMP ===")
        print(results[0]["chain_dump"])
        print("=== LOGS ===")
    print(json.dumps(summary))
    return 0 if summary["chains_equal_local"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
