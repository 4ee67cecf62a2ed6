"""The port's copy of `biscotti_tpu/runtime/rpc.py`: the same framing,
pool and server over asyncio TCP, so port and reference endpoints talk
to each other.

Asyncio RPC layer: pooled multiplexed connections, per-call timeouts,
typed errors.

Mirrors the reference's transport semantics (SURVEY.md §2.1 row 2, §5.8):
  * per-call `select{reply, timeout}` guard (ref: DistSys/main.go:1447-1489)
    — every call wraps its roundtrip in `asyncio.wait_for`
  * the callee can reply with a *stale* error that callers treat as a
    signal, not a failure (ref: DistSys/main.go:140,380-383 staleError)
  * dead peers surface as TimeoutError/ConnectionError so the membership
    layer can evict them (ref: main.go:1468-1487)

Design departure from the reference, on purpose: the reference dials a
fresh TCP connection for every RPC (`rpc.Dial` per call) — at N=100 full
mesh that is thousands of handshakes per round and was a scale bottleneck.
Here each peer keeps ONE persistent connection per (host, port), and
concurrent calls multiplex over it with request-id correlation (`rid`);
a timed-out call abandons its future while the connection stays usable
(late replies to abandoned rids are dropped). Connection failure fails all
in-flight calls on it and redials lazily on next use.

Chaos plane: `Pool.faults` optionally holds a `faults.FaultInjector`; every
outbound frame (calls AND fire-and-forget posts) then gets a deterministic
drop/delay/duplicate/reset decision keyed on (src, dst, msg_type, attempt),
applied at the `_Conn` boundary so real TCP traffic is perturbed (see
faults.py and docs/FAULT_PLANE.md).

Server side: one asyncio task per connection, frames dispatched to a single
handler coroutine `handle(msg_type, meta, arrays) -> (meta, arrays)`.
Handlers may block (e.g. a verifier parking a caller until the round's Krum
resolves, ref: DistSys/krum.go:330-336) — each request runs as its own task
so a parked call never stalls the connection's other requests, and replies
carry the request's rid so out-of-order completion is fine.
"""

from __future__ import annotations

import asyncio
import contextlib
import errno
import struct
import time
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

import numpy as np

from biscotti_tpu_torch.runtime import codecs as wcodecs
from biscotti_tpu_torch.runtime import messages as msgs

_U32 = struct.Struct(">I").unpack

Handler = Callable[
    [str, Dict[str, Any], Dict[str, np.ndarray]],
    Awaitable[Tuple[Dict[str, Any], Dict[str, np.ndarray]]],
]


class RPCError(RuntimeError):
    """Remote handler returned an error (meta carries the reason)."""

    def __init__(self, reason: str, stale: bool = False):
        super().__init__(reason)
        self.reason = reason
        self.stale = stale


class StaleError(RPCError):
    """The callee is past this message's iteration (ref: main.go:380-383)."""

    def __init__(self, reason: str = "stale iteration"):
        super().__init__(reason, stale=True)


class BusyError(RPCError):
    """Retryable overload signal (wire meta: {"error": ..., "busy": true}):
    the callee SHED this request under its admission plan rather than
    queue it without bound (runtime/admission.py, docs/ADMISSION.md).
    Unlike a transport failure it proves the peer alive and healthy —
    clients retry with backoff and must NOT advance the circuit breaker
    (a busy honest peer must never get quarantined)."""

    def __init__(self, reason: str = "server busy"):
        super().__init__(reason)
        self.busy = True


class FrameStream(asyncio.BufferedProtocol):
    """Framed connection over asyncio's zero-copy receive path.

    StreamReader's readexactly accumulates every incoming chunk into its
    internal bytearray and then slices the frame back out — at CNN dims
    (10.5 MB commitment grids × W workers × M miners per round) that
    buffer churn profiled as the single largest non-crypto cost of a
    round (~10 s per 3 rounds at N=30). BufferedProtocol instead asks US
    for the receive buffer: once a frame's length prefix is parsed, the
    payload bytes land directly in that frame's own preallocated
    bytearray (one copy, kernel→frame), which the codec then wraps
    zero-copy. Header bytes and small frames assemble through a bounded
    scratch (≤64 KiB extra copy per frame).

    Back-pressure both ways: ≥8 parsed-but-unconsumed frames pauses the
    transport's reading; writes respect pause_writing via `drain()`.

    Chunked streaming (docs/WIRE_PLANE.md): a payload beginning with
    messages.CHUNK_MAGIC is a continuation chunk — its body is appended
    to the in-progress reassembly buffer instead of being queued, and
    the final chunk (flags bit 0) releases the whole reassembled payload
    as ONE frame. MAX_FRAME is enforced on the REASSEMBLED size, and the
    buffer grows with the bytes actually received, so peak allocation
    tracks real traffic instead of a hostile length prefix.
    """

    _SCRATCH = 65536
    _QUEUE_HIGH = 8
    _CLOSED = object()  # queue sentinel

    def __init__(self, on_connected=None, read_deadline: float = 0.0):
        self.transport: Optional[asyncio.Transport] = None
        self._on_connected = on_connected
        self._acc = bytearray()
        self._scratch = bytearray(self._SCRATCH)
        self._payload: Optional[bytearray] = None
        self._got = 0
        self._need = 0
        self._reasm: Optional[bytearray] = None  # chunk reassembly buffer
        self._frames: asyncio.Queue = asyncio.Queue()
        self._exc: Optional[Exception] = None
        self._closed = False
        self._read_paused = False
        self._w_waiters: list = []
        self._w_paused = False
        # read/header deadline (admission plane, docs/ADMISSION.md):
        # once a frame STARTS — a header byte, a partial payload, an
        # unfinished chunk-reassembly run — it must COMPLETE within this
        # many seconds or the connection is dropped. Progress-per-byte
        # deliberately does NOT reset the clock (a slow-loris dribbling
        # one header byte per tick would otherwise pin the connection
        # and its reassembly buffer forever), but each COMPLETED frame —
        # including every continuation chunk of a reassembly run — does:
        # a legitimate chunked multi-MB transfer only needs one chunk
        # per window, while a dribbler must pay a full frame per window.
        # Time spent with reading PAUSED by our own backpressure also
        # counts as progress — the peer must not be blamed for our
        # queue. 0 disables (client default).
        self._read_deadline = float(read_deadline)
        self._frame_t0: Optional[float] = None
        self._deadline_handle = None
        self._progress_seq = 0  # bumped per completed frame/chunk

    # ------------------------------------------------ protocol callbacks

    def connection_made(self, transport) -> None:
        self.transport = transport
        if self._read_deadline > 0:
            loop = asyncio.get_running_loop()
            self._deadline_handle = loop.call_later(
                self._read_deadline / 2, self._deadline_tick)
        if self._on_connected is not None:
            asyncio.get_running_loop().create_task(self._on_connected(self))

    def _mid_frame(self) -> bool:
        return (self._payload is not None or len(self._acc) > 0
                or self._reasm is not None)

    def _mark_frame_progress(self, completed: bool) -> None:
        """Called after every receive/parse step: start the per-frame
        deadline clock when partial state appears, restart it whenever a
        frame or continuation chunk COMPLETED, clear it when the stream
        is back at a frame boundary."""
        if self._read_deadline <= 0:
            return
        if not self._mid_frame():
            self._frame_t0 = None
        elif completed or self._frame_t0 is None:
            self._frame_t0 = asyncio.get_running_loop().time()

    def _deadline_tick(self) -> None:
        if self._closed or self.transport is None:
            return
        loop = asyncio.get_running_loop()
        if self._read_paused and self._frame_t0 is not None:
            # WE paused reading (queue backpressure): the peer cannot
            # make progress — don't bill it for our slowness
            self._frame_t0 = loop.time()
        if (self._frame_t0 is not None
                and loop.time() - self._frame_t0 >= self._read_deadline):
            self._protocol_error(ConnectionError(
                "read deadline: frame incomplete after "
                f"{self._read_deadline:.1f}s"))
            return
        self._deadline_handle = loop.call_later(
            self._read_deadline / 2, self._deadline_tick)

    def get_buffer(self, sizehint: int) -> memoryview:
        if self._payload is not None:
            return memoryview(self._payload)[self._got:]
        return memoryview(self._scratch)

    def buffer_updated(self, nbytes: int) -> None:
        seq0 = self._progress_seq
        if self._payload is not None:
            self._got += nbytes
            if self._got >= self._need:
                payload = self._payload
                self._payload = None
                self._got = self._need = 0
                self._enqueue(payload)
            self._mark_frame_progress(self._progress_seq != seq0)
            return
        self._acc += memoryview(self._scratch)[:nbytes]
        self._drain_acc()
        self._mark_frame_progress(self._progress_seq != seq0)

    def _drain_acc(self) -> None:
        while True:
            if len(self._acc) < 4:
                return
            (n,) = _U32(self._acc[:4])
            if n > msgs.MAX_FRAME:
                self._protocol_error(
                    ConnectionError("frame length exceeds cap"))
                return
            if len(self._acc) - 4 >= n:
                frame = bytes(self._acc[4: 4 + n])
                del self._acc[: 4 + n]
                self._enqueue(frame)
                continue
            # large frame: preallocate and let the transport fill it
            self._need = n
            self._payload = bytearray(n)
            body = memoryview(self._acc)[4:]
            self._payload[: len(body)] = body
            self._got = len(body)
            self._acc = bytearray()
            return

    def _enqueue(self, frame) -> None:
        self._progress_seq += 1  # a complete frame payload (or chunk)
        if (len(frame) >= msgs.CHUNK_OVERHEAD
                and bytes(memoryview(frame)[:4]) == msgs.CHUNK_MAGIC):
            # continuation chunk: accumulate; only the final chunk of the
            # run surfaces as a frame (cap checked on the reassembled size)
            buf = self._reasm if self._reasm is not None else bytearray()
            body = memoryview(frame)[msgs.CHUNK_OVERHEAD:]
            if len(buf) + len(body) > msgs.MAX_FRAME:
                self._reasm = None
                self._protocol_error(
                    ConnectionError("reassembled frame exceeds cap"))
                return
            buf += body
            if not (frame[4] & msgs.CHUNK_LAST):
                self._reasm = buf
                return
            self._reasm = None
            frame = buf
        self._frames.put_nowait(frame)
        if (not self._read_paused
                and self._frames.qsize() >= self._QUEUE_HIGH
                and self.transport is not None):
            try:
                self.transport.pause_reading()
                self._read_paused = True
            except RuntimeError:
                pass

    def _protocol_error(self, exc: Exception) -> None:
        self._exc = exc
        if self.transport is not None:
            self.transport.close()

    def connection_lost(self, exc) -> None:
        self._closed = True
        if self._deadline_handle is not None:
            self._deadline_handle.cancel()
            self._deadline_handle = None
        if self._exc is None:
            self._exc = exc or ConnectionError("connection closed")
        self._frames.put_nowait(self._CLOSED)
        for w in self._w_waiters:
            if not w.done():
                w.set_exception(self._exc)
                w.exception()  # mark retrieved
        self._w_waiters.clear()

    def pause_writing(self) -> None:
        self._w_paused = True

    def resume_writing(self) -> None:
        self._w_paused = False
        for w in self._w_waiters:
            if not w.done():
                w.set_result(None)
        self._w_waiters.clear()

    # ------------------------------------------------------- public API

    @property
    def alive(self) -> bool:
        return (self.transport is not None and not self._closed
                and not self.transport.is_closing())

    async def next_frame(self):
        """One frame payload (bytes for small frames, bytearray for
        direct-filled large ones); raises on EOF/protocol error."""
        if self._read_paused and self._frames.qsize() < self._QUEUE_HIGH:
            try:
                self.transport.resume_reading()
                self._read_paused = False
            except RuntimeError:
                pass
        frame = await self._frames.get()
        if frame is self._CLOSED:
            self._frames.put_nowait(self._CLOSED)  # keep EOF sticky
            raise (self._exc
                   if self._exc is not None
                   else ConnectionError("connection closed"))
        return frame

    def write_parts(self, parts) -> None:
        if self.transport is None or self.transport.is_closing():
            raise ConnectionError("connection closed")
        for p in parts:
            self.transport.write(p)

    async def drain(self) -> None:
        if not self._w_paused or self._closed:
            return
        w = asyncio.get_running_loop().create_future()
        self._w_waiters.append(w)
        await w

    def close(self) -> None:
        if self.transport is not None:
            self.transport.close()


async def open_frame_stream(host: str, port: int,
                            avoid_local_ports=frozenset()) -> FrameStream:
    """Dial a peer. `avoid_local_ports` lists LISTEN ports of the local
    cluster: on hosts whose ephemeral range covers the protocol ports
    (an ip_local_port_range of 16000-65535, say), the kernel can hand an
    outbound socket the very source port a co-hosted peer needs to bind
    — and a pooled connection then squats on it for the whole run. When
    the assigned source port is one of those, redial; the doomed sockets
    are held until a clean one lands so the kernel cannot re-deal the
    same port, then closed."""
    loop = asyncio.get_running_loop()
    doomed = []
    try:
        for attempt in range(16):
            tr, proto = await loop.create_connection(lambda: FrameStream(),
                                                     host, port)
            sockname = tr.get_extra_info("sockname")
            if (not avoid_local_ports or sockname is None
                    or sockname[1] not in avoid_local_ports
                    or attempt == 15):  # budget spent: squat over failure
                return proto
            doomed.append(tr)
        raise AssertionError("unreachable")
    finally:
        for tr in doomed:
            tr.close()


class RPCServer:
    def __init__(self, host: str, port: int, handler: Handler):
        self.host = host
        self.port = port
        self.handler = handler
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()
        # wire-plane knobs, set by the owning peer: `caps` bounds which
        # reply codecs a caller's `acodec` request may select (defaults
        # to legacy raw64-only so a bare RPCServer behaves like the
        # seed); `metrics` ticks inbound/outbound byte counters
        self.caps = wcodecs.RAW_CAPS
        self.metrics = None
        # protocol plane (runtime/protocol.py): whether shed replies
        # carry the structured retryable `busy` status. True by default
        # (bare harness servers keep today's behavior); the owning peer
        # clears it when a --protocol-version pin predates the busy
        # feature, emulating the old build's plain-error shed reply.
        self.busy_status = True
        # overload-governance knobs (runtime/admission.py), set by the
        # owning peer when its AdmissionPlan is enabled: `admission` is
        # the AdmissionController consulted per decoded frame (None =
        # admit everything, the seed behavior); `read_deadline` arms
        # FrameStream's mid-frame deadline on inbound connections
        self.admission = None
        self.read_deadline = 0.0
        # distributed tracing (telemetry/tracectx.py, docs/OBSERVABILITY.md
        # §Distributed tracing): when the owning peer armed tracing, this
        # holds its Telemetry and every dispatched RPC runs inside a
        # child span adopted from the frame's wire context — the
        # receiver half of the cross-peer causal link. None (default) =
        # the seed dispatch path, span-free.
        self.telemetry = None
        # straggler plane (runtime/stragglers.py, docs/STRAGGLERS.md):
        # extra per-RPC service delay charged before every handler
        # dispatch when this peer carries a slow speed profile. Owned by
        # the TRANSPORT seam (here and mirrored by the hive loopback
        # dispatch) so TCP and co-hosted layouts serve identically slow.
        self.service_delay_s = 0.0

    async def start(self, bind_budget_s: float = 10.0) -> None:
        """Bind the listen socket, retrying transient EADDRINUSE.

        On hosts whose ephemeral range covers the protocol ports (an
        ip_local_port_range of 16000-65535 against protocol ports
        8000+/25xxx in harnesses), any peer's OUTBOUND connection can be randomly
        assigned the very source port another peer is about to LISTEN
        on; SO_REUSEADDR does not help against an active socket. The
        collision is transient — the client socket moves on within the
        connection's lifetime — so a brief retry turns a startup crash
        into a short delay. A port genuinely held by another server
        still fails, after `bind_budget_s`."""
        loop = asyncio.get_running_loop()
        deadline = time.monotonic() + bind_budget_s
        while True:
            try:
                self._server = await loop.create_server(
                    lambda: FrameStream(on_connected=self._on_conn,
                                        read_deadline=self.read_deadline),
                    self.host, self.port)
                return
            except OSError as e:
                if e.errno != errno.EADDRINUSE \
                        or time.monotonic() >= deadline:
                    raise
                await asyncio.sleep(0.2)

    @property
    def serving(self) -> bool:
        """True while the listen socket would accept a connection — the
        hive's loopback endpoints share this lifecycle (a closed peer's
        co-hosted callers must get connection-refused, not delivery)."""
        return self._server is not None and self._server.is_serving()

    def close_now(self) -> None:
        """Synchronous teardown: release the LISTENING socket immediately
        and cancel live handlers, without awaiting wait_closed(). For
        exception/cancellation paths that cannot await — leaving the
        listen fd to garbage collection keeps the port bound for an
        unbounded grace period (observed as address-already-in-use
        flakes when back-to-back harness clusters reuse a port)."""
        if self._server is not None:
            self._server.close()
        for t in list(self._conn_tasks):
            t.cancel()

    async def stop(self) -> None:
        # cancel live connection handlers BEFORE wait_closed(): since 3.12
        # wait_closed waits for every handler to finish, and handlers on
        # persistent pooled connections run until the remote side closes —
        # waiting first would deadlock two peers stopping simultaneously
        self.close_now()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                pass

    @staticmethod
    def _admit_key(stream: FrameStream):
        """Budget key for one inbound frame: the CONNECTION identity
        (transport peername), never the frame's claimed `source_id` —
        meta is unauthenticated, so keying on the claimed id would let a
        Byzantine peer spoof a victim's id and drain the victim's
        buckets, starving its legitimate traffic. The peername is
        TCP-level and unspoofable; honest peers multiplex everything
        over ONE pooled connection, so per-connection IS per-peer for
        them, while a Byzantine peer fanning out connections is bounded
        by the controller's bucket-table cap and the global inflight
        cap."""
        peername = (stream.transport.get_extra_info("peername")
                    if stream.transport is not None else None)
        return ("conn", peername if peername is not None else id(stream))

    def _shed_reply(self, msg_type, meta, reason, stream):
        """Busy reply for a shed reply-bearing call — small, encoded
        inline, and NOT drained: a flooder that refuses to read its own
        busy replies must not be able to park the read loop on its
        socket's backpressure. Once the transport signals pause_writing
        (the peer stopped draining), further notifications are DROPPED
        instead of buffered — otherwise the reply path itself would be
        the unbounded-memory vector this plane exists to close; the
        peer's calls simply time out, which under overload is truthful.
        Safe without the write lock: write_parts is synchronous, so
        frames never interleave — the lock only orders write+drain
        pairs for handler replies."""
        rid = meta.get("rid")
        if not rid:
            return  # fire-and-forget: nobody is waiting for a reply
        if stream._w_paused or not stream.alive:
            return  # peer not draining: drop the notification
        reply = {"error": f"admission shed: {reason}", "rid": rid}
        if self.busy_status:
            reply["busy"] = True
        parts = msgs.encode_parts(msg_type + ".reply", reply, {})
        try:
            stream.write_parts(parts)
        except (ConnectionError, OSError):
            pass

    async def _on_conn(self, stream: FrameStream) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        write_lock = asyncio.Lock()
        pending: set = set()
        try:
            while True:
                try:
                    payload = await stream.next_frame()
                except (ConnectionError, OSError):
                    break
                key = None
                if self.admission is not None:
                    # overload governance (docs/ADMISSION.md): the frame
                    # is budgeted on its PEEKED header alone — over-budget
                    # work is SHED with a retryable busy status BEFORE
                    # paying the full decode (array materialization, zlib
                    # inflate), so a flood's per-frame cost to this peer
                    # is one small JSON parse, not a decompression
                    peek = msgs.peek_header(payload)
                    if peek is None:
                        break  # malformed header: drop the connection
                    msg_type, pmeta = peek
                    if self.metrics is not None:
                        self.metrics.counter(
                            wcodecs.WIRE_BYTES_METRIC,
                            wcodecs.WIRE_BYTES_HELP).inc(
                            len(payload), msg_type=msg_type,
                            direction="in",
                            codec=pmeta.get("_wire_codec", wcodecs.RAW))
                    key = self._admit_key(stream)
                    reason = self.admission.try_admit(key, msg_type)
                    if reason is not None:
                        self._shed_reply(msg_type, pmeta, reason, stream)
                        continue
                try:
                    msg_type, meta, arrays = msgs.decode(payload)
                except msgs.CodecError:
                    if key is not None:
                        self.admission.release(key)
                    break  # hostile/garbled peer: drop the connection
                if self.admission is None and self.metrics is not None:
                    self.metrics.counter(
                        wcodecs.WIRE_BYTES_METRIC,
                        wcodecs.WIRE_BYTES_HELP).inc(
                        len(payload), msg_type=msg_type, direction="in",
                        codec=meta.get("_wire_codec", wcodecs.RAW))
                t = asyncio.create_task(self._dispatch(
                    msg_type, meta, arrays, stream, write_lock))
                if key is not None:
                    t.add_done_callback(
                        lambda _t, k=key: self.admission.release(k))
                pending.add(t)
                t.add_done_callback(pending.discard)
        finally:
            for t in pending:
                t.cancel()
            stream.close()
            self._conn_tasks.discard(task)

    async def _dispatch(self, msg_type, meta, arrays, stream, write_lock):
        rid = meta.get("rid")
        try:
            if self.service_delay_s > 0.0:
                # slow-peer service emulation (docs/STRAGGLERS.md): a
                # confidential-compute / overloaded host takes longer to
                # SERVE each request — charged here, after admission
                # (shedding stays cheap) and before the handler, so the
                # caller's observed latency grows exactly like a genuinely
                # slow service's would
                await asyncio.sleep(self.service_delay_s)
            span = (self.telemetry.rpc_span(msg_type, meta)
                    if self.telemetry is not None
                    else contextlib.nullcontext())
            with span:
                rmeta, rarrays = await self.handler(msg_type, meta, arrays)
        except StaleError as e:
            rmeta, rarrays = {"error": e.reason, "stale": True}, {}
        except BusyError as e:
            # a handler shed mid-flight (e.g. its parked wait was evicted
            # by the parking cap): same retryable wire status as a
            # boundary shed
            rmeta, rarrays = {"error": e.reason, "busy": True}, {}
        except RPCError as e:
            rmeta, rarrays = {"error": e.reason}, {}
        except asyncio.CancelledError:
            raise
        except Exception as e:  # handler bug: report, don't kill the peer
            rmeta, rarrays = {"error": f"internal: {type(e).__name__}: {e}"}, {}
        rmeta = dict(rmeta)
        rmeta["rid"] = rid
        # reply codec: honour the caller's `acodec`/`achunk` request iff
        # every stage sits inside OUR advertised capability set (a
        # raw64-configured peer ignores both — legacy emulation), with a
        # hard floor on chunk size so a hostile achunk cannot shatter a
        # reply into per-byte frames
        codec = wcodecs.negotiate(str(meta.get("acodec") or ""), self.caps)
        achunk = 0
        if wcodecs.CHUNK_CAP in self.caps:
            try:
                achunk = int(meta.get("achunk", 0) or 0)
            except (TypeError, ValueError):
                achunk = 0
            achunk = 0 if achunk <= 0 else max(achunk, msgs.MIN_CHUNK)
        stats: Optional[dict] = {} if self.metrics is not None else None
        try:
            parts = msgs.encode_parts(
                msg_type + ".reply", rmeta, rarrays,
                codec=None if codec == wcodecs.RAW else codec,
                chunk_bytes=achunk, stats=stats)
        except msgs.CodecError:
            # a coded reply that fails to encode must not eat the reply:
            # fall back to the legacy raw frame
            parts = msgs.encode_parts(msg_type + ".reply", rmeta, rarrays,
                                      stats=stats)
            codec = wcodecs.RAW
        if self.metrics is not None:
            eff = stats.get("codec", wcodecs.RAW)
            self.metrics.counter(wcodecs.WIRE_BYTES_METRIC,
                                 wcodecs.WIRE_BYTES_HELP).inc(
                stats["wire_bytes"], msg_type=msg_type + ".reply",
                direction="out", codec=eff)
            wcodecs.observe_ratio(self.metrics, eff,
                                  stats["raw_bytes"], stats["wire_bytes"])
        async with write_lock:
            try:
                stream.write_parts(parts)
                await stream.drain()
            except (ConnectionError, OSError):
                pass


class _Conn:
    """One persistent multiplexed client connection."""

    def __init__(self, stream: FrameStream):
        self.stream = stream
        self.pending: Dict[int, asyncio.Future] = {}
        self.next_rid = 1
        self.write_lock = asyncio.Lock()
        self.sending = 0  # in-flight fire-and-forget writes (see _send)
        self.metrics = None  # set by Pool: inbound reply byte accounting
        self.reader_task = asyncio.create_task(self._read_loop())

    async def _read_loop(self) -> None:
        try:
            while True:
                payload = await self.stream.next_frame()
                try:
                    mtype, rmeta, rarrays = msgs.decode(payload)
                except msgs.CodecError:
                    break  # garbled peer: tear the connection down
                if self.metrics is not None:
                    self.metrics.counter(
                        wcodecs.WIRE_BYTES_METRIC,
                        wcodecs.WIRE_BYTES_HELP).inc(
                        len(payload), msg_type=mtype, direction="in",
                        codec=rmeta.get("_wire_codec", wcodecs.RAW))
                fut = self.pending.pop(rmeta.get("rid"), None)
                if fut is not None and not fut.done():
                    fut.set_result((rmeta, rarrays))
                # unknown rid: reply to an abandoned (timed-out) call — drop
        except (ConnectionError, OSError, asyncio.CancelledError):
            pass
        finally:
            self._fail_all(ConnectionError("connection lost"))
            self.stream.close()

    def _fail_all(self, exc: Exception) -> None:
        for fut in self.pending.values():
            if not fut.done():
                fut.set_exception(exc)
                fut.exception()  # mark retrieved: abandoned callers are fine
        self.pending.clear()

    @property
    def alive(self) -> bool:
        return not self.reader_task.done() and self.stream.alive

    async def _send_parts(self, parts, timeout: float, fault=None) -> None:
        """Part-wise bounded write (see _send): each buffer goes to the
        transport as-is — large array payloads ride their memoryviews
        straight from the codec with no event-loop flattening copy.

        `fault` (a faults.FaultAction, None when the fault plane is off)
        perturbs THIS frame at the connection boundary: a reset tears the
        shared multiplexed connection down mid-flight (all in-flight calls
        fail, next use redials), a delay holds the frame before the write,
        a drop consumes it before the socket (the caller's await then times
        out, exactly as if the network ate it), a duplicate writes the same
        bytes twice back-to-back (receiver-idempotency exercise)."""
        self.sending += 1
        try:
            if fault is not None and not fault.benign:
                if fault.reset:
                    self.close()
                    raise ConnectionError("fault injection: connection reset")
                if fault.delay_s > 0.0:
                    await asyncio.sleep(fault.delay_s)
                if fault.drop:
                    return  # frame lost before the wire
            async with self.write_lock:
                t0 = asyncio.get_running_loop().time()
                self.stream.write_parts(parts)
                await asyncio.wait_for(self.stream.drain(), timeout)
                if fault is not None and fault.duplicate:
                    # the duplicate rides the SAME budget as the original:
                    # a fresh full timeout here would let one faulted frame
                    # hold the shared write_lock ~2x the bound and push
                    # every queued sender past its own deadline
                    left = max(0.001, timeout - (
                        asyncio.get_running_loop().time() - t0))
                    self.stream.write_parts(parts)
                    await asyncio.wait_for(self.stream.drain(), left)
                if fault is not None and fault.flood > 0:
                    # frame storm: replay the same bytes `flood` more
                    # times back-to-back — this peer becomes a seeded
                    # flooder sustaining (1+flood)x the honest frame rate
                    # on this link. The storm shares the ORIGINAL frame's
                    # timeout budget; replays that outrun it (a receiver
                    # exerting backpressure) are abandoned, exactly like
                    # a real flooder hitting a full socket.
                    for _ in range(fault.flood):
                        left = max(0.001, timeout - (
                            asyncio.get_running_loop().time() - t0))
                        self.stream.write_parts(parts)
                        await asyncio.wait_for(self.stream.drain(), left)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            self.close()
            raise
        finally:
            self.sending -= 1

    async def _send(self, frame: bytes, timeout: float, fault=None) -> None:
        """Bounded write: a peer that stops draining (full receive buffer,
        long GIL hold) must not wedge the write lock forever — on timeout
        the connection is torn down so queued callers fail fast and the
        next use redials. `sending` marks the conn busy for the pool's LRU
        eviction: fire-and-forget posts (rid 0) never register in
        `pending`, so without it a broadcast fanning out past the pool cap
        evicts its own conns MID-DRAIN and silently drops frames — at
        N=100 that lost the minted block for every peer beyond the cap."""
        await self._send_parts([frame], timeout, fault=fault)

    async def roundtrip(self, msg_type, meta, arrays, timeout, fault=None,
                        codec=None, chunk_bytes=0, account=None):
        rid = self.next_rid
        self.next_rid += 1
        fut = asyncio.get_running_loop().create_future()
        self.pending[rid] = fut
        meta2 = dict(meta or {})
        meta2["rid"] = rid
        stats: Optional[dict] = {} if account is not None else None
        parts = msgs.encode_parts(msg_type, meta2, arrays, codec=codec,
                                  chunk_bytes=chunk_bytes, stats=stats)
        deadline = asyncio.get_running_loop().time() + timeout
        try:
            await self._send_parts(parts, timeout, fault=fault)
            if account is not None:
                # counted once the transport accepted the frame (an
                # injected drop still counts: the peer DID spend the
                # encode and hand the bytes over)
                account(stats)
            remaining = max(0.001, deadline - asyncio.get_running_loop().time())
            return await asyncio.wait_for(fut, remaining)
        finally:
            self.pending.pop(rid, None)

    def close(self) -> None:
        self.reader_task.cancel()
        self.stream.close()


class Pool:
    """Per-agent connection pool: one persistent connection per (host,
    port), multiplexing concurrent calls (see module docstring).

    LRU-capped: a peer's working set is small (its committees, the
    leader, gossip targets), but the bootstrap announce dials EVERY peer
    once — without a cap the cluster holds O(N²) sockets and blows the
    file-descriptor limit around N≈100–120 (observed: 'Too many open
    files' at N=120 under the default 20k ulimit, ≈2·N² fds). Idle
    least-recently-used connections are closed beyond `max_conns`;
    in-flight ones are never evicted, and the next use simply redials."""

    def __init__(self, max_conns: int = 32,
                 latency: Optional[Callable[[str, int], float]] = None):
        from collections import OrderedDict

        self._conns: "OrderedDict[Tuple[str, int], _Conn]" = OrderedDict()
        self._dialing: Dict[Tuple[str, int], asyncio.Task] = {}
        self.max_conns = max_conns
        # Optional per-link latency model (host, port) -> seconds, applied
        # to every call/post toward that link: the WAN/geo harness runs
        # loopback clusters with the reference's multi-region operating
        # point (ref: global-deploy-eval, multi-DC Azure) by charging each
        # cross-"region" RPC its round-trip here. None = loopback (no-op).
        self.latency = latency
        # Optional deterministic fault plane (faults.FaultInjector): when
        # set, every outbound frame's fate — drop/delay/duplicate/reset —
        # is decided per (src, dst, msg_type, attempt) and applied at the
        # _Conn boundary so real TCP traffic is perturbed, not mocked.
        self.faults = None
        # Optional telemetry registry (telemetry.MetricsRegistry): when
        # set, every call/post ticks per-msg_type frame counters and
        # reply-bearing calls feed a client-side latency histogram —
        # round latency becomes attributable to transport vs. compute
        # per link (the Garfield-style breakdown, PAPERS.md).
        self.metrics = None
        # LISTEN ports of the local cluster (set by the peer agent):
        # outbound dials refuse a kernel-assigned source port from this
        # set — on hosts whose ephemeral range covers the protocol
        # ports, a persistent pooled connection could otherwise squat on
        # a port a co-hosted peer needs to bind (see open_frame_stream)
        self.avoid_local_ports: frozenset = frozenset()
        # Hive loopback fast path (runtime/hive.py, docs/HIVE.md): when a
        # LoopbackHub is attached, calls/posts toward a CO-HOSTED peer
        # skip TCP framing and serialization entirely — the hub delivers
        # (meta, arrays) straight into the destination's handler, still
        # flowing through this pool's fault-plane draw, the destination's
        # admission controller, and the wire byte counters (a `loopback`
        # direction). `loopback_src` is the owning peer's id (the hub
        # keys admission budgets and fault schedules on it).
        self.loopback = None
        self.loopback_src: Optional[int] = None

    def _evict(self, exempt: Optional[Tuple[str, int]] = None) -> None:
        # drop dead connections regardless of the cap, then close idle
        # LRU ones until within bounds (busy conns are skipped, as is the
        # freshly-dialed `exempt` conn: it looks idle only because its
        # first RPC has not registered in pending yet — with >max_conns
        # dials in flight, the N=100 announce fan-out, evicting it would
        # hand its caller a closed conn)
        for k in [k for k, c in self._conns.items() if not c.alive]:
            self._conns.pop(k).close()
        excess = len(self._conns) - self.max_conns
        if excess <= 0:
            return
        for k in list(self._conns.keys()):
            if excess <= 0:
                break
            if k == exempt:
                continue
            c = self._conns[k]
            if c.pending or c.sending:
                continue
            del self._conns[k]
            c.close()
            excess -= 1

    async def _dial(self, key: Tuple[str, int]) -> _Conn:
        conn = _Conn(await open_frame_stream(
            *key, avoid_local_ports=self.avoid_local_ports))
        conn.metrics = self.metrics
        self._conns[key] = conn
        self._conns.move_to_end(key)
        self._evict(exempt=key)
        return conn

    async def _get(self, host: str, port: int, timeout: float) -> _Conn:
        """Concurrent callers to one peer SHARE a single in-flight dial
        (shielded, so each caller's timeout cancels only its own wait) —
        holding a lock across the dial would serialize N callers into
        N × timeout worst-case latency against a dead peer."""
        key = (host, port)
        conn = self._conns.get(key)
        if conn is not None and conn.alive:
            self._conns.move_to_end(key)
            return conn
        task = self._dialing.get(key)
        if task is None or task.done():
            task = asyncio.ensure_future(self._dial(key))
            self._dialing[key] = task
        return await asyncio.wait_for(asyncio.shield(task), timeout)

    def _account_out(self, msg_type: str):
        """Outbound byte-accounting closure for one call (None when
        telemetry is off): wire bytes counter + compression ratio,
        labeled with the frame's EFFECTIVE codec from encode stats (a
        frame whose arrays all fell back to raw counts as raw64, so
        both directions and the ratio histogram agree)."""
        m = self.metrics
        if m is None:
            return None

        def account(stats: dict) -> None:
            eff = stats.get("codec", wcodecs.RAW)
            m.counter(wcodecs.WIRE_BYTES_METRIC,
                      wcodecs.WIRE_BYTES_HELP).inc(
                stats["wire_bytes"], msg_type=msg_type, direction="out",
                codec=eff)
            wcodecs.observe_ratio(m, eff, stats["raw_bytes"],
                                  stats["wire_bytes"])

        return account

    async def call(self, host: str, port: int, msg_type: str,
                   meta: Dict[str, Any] | None = None,
                   arrays: Dict[str, np.ndarray] | None = None,
                   timeout: float = 120.0, attempt: int = 0,
                   codec: str = wcodecs.RAW, chunk_bytes: int = 0):
        # one deadline covers dial + send + reply: dialing must not grant
        # the roundtrip a second full budget
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        if self.latency is not None:
            d = self.latency(host, port)
            if d > 0:  # request + reply each ride the link once
                await asyncio.sleep(d)
        fault = (self.faults.action(host, port, msg_type, attempt)
                 if self.faults is not None else None)
        if self.loopback is not None:
            # co-hosted destination: deliver in-process (the fault draw
            # above already consumed this frame's schedule slot, so a
            # chaos run's per-link fate sequence is identical either way)
            ep = self.loopback.lookup(host, port)
            if ep is not None:
                # remaining budget, not the full timeout: the latency
                # sleep above already spent part of the one deadline
                # that covers dial + send + reply (TCP-path contract)
                return await ep.call(msg_type, meta, arrays,
                                     max(0.001, deadline - loop.time()),
                                     fault=fault, src=self.loopback_src,
                                     metrics=self.metrics)
        m = self.metrics
        t0 = loop.time()
        try:
            conn = await self._get(host, port, timeout)
            if m is not None:
                # counted only once a connection exists: a refused dial
                # never put a frame on the wire and must not inflate the
                # outbound-traffic attribution
                m.counter("biscotti_rpc_frames_total",
                          "outbound RPC frames by method and kind").inc(
                    msg_type=msg_type, kind="call")
            remaining = max(0.001, deadline - loop.time())
            rmeta, rarrays = await conn.roundtrip(
                msg_type, meta, arrays, remaining, fault=fault,
                codec=None if codec == wcodecs.RAW else codec,
                chunk_bytes=chunk_bytes,
                account=self._account_out(msg_type))
        except BaseException as e:
            # cancellation is the CALLER giving up (shutdown, a superseding
            # deadline), not the transport failing — keep it out of the
            # failure counter the dashboards alert on
            if m is not None and not isinstance(e, asyncio.CancelledError):
                m.counter("biscotti_rpc_transport_failures_total",
                          "calls that died in transport (timeout/refused/"
                          "reset)").inc(msg_type=msg_type,
                                        kind=type(e).__name__)
            raise
        if m is not None:
            # any reply — including a protocol error — proves the
            # transport round-trip; the histogram measures the wire+peer
            # latency the retry/breaker plane acts on
            m.histogram("biscotti_rpc_client_seconds",
                        "reply-bearing RPC round-trip latency").observe(
                loop.time() - t0, msg_type=msg_type)
        if rmeta.get("error"):
            if rmeta.get("stale"):
                raise StaleError(rmeta["error"])
            if rmeta.get("busy"):
                raise BusyError(rmeta["error"])
            raise RPCError(rmeta["error"])
        return rmeta, rarrays

    async def post(self, host: str, port: int, frame: bytes,
                   timeout: float = 120.0, msg_type: str = "post",
                   attempt: int = 0, codec: str = wcodecs.RAW) -> None:
        """Fire-and-forget a PRE-ENCODED frame (rid 0: any reply is dropped
        by the reader). Lets a broadcast encode its payload once and write
        the same bytes to every peer — at N=100 the per-peer re-encode of a
        multi-MB block was the event loop's dominant cost. `msg_type` and
        `codec` only key the fault plane's draw and the byte accounting
        (the frame already carries both)."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        if self.latency is not None:
            d = self.latency(host, port)
            if d > 0:
                await asyncio.sleep(d / 2)  # one-way: no reply to wait for
        fault = (self.faults.action(host, port, msg_type, attempt)
                 if self.faults is not None else None)
        if self.loopback is not None:
            ep = self.loopback.lookup(host, port)
            if ep is not None:
                # pre-encoded frame toward a co-hosted peer (a caller
                # that didn't partition targets first): decode once and
                # deliver in-process — the encode is sunk, the TCP hop
                # and the receiver's decode/admission-peek copies aren't.
                # Broadcast paths avoid even the encode via post_direct.
                mt, dmeta, darrays = msgs.decode(frame)
                await ep.post(mt, dmeta, darrays,
                              max(0.001, deadline - loop.time()),
                              fault=fault, src=self.loopback_src,
                              metrics=self.metrics)
                return
        conn = await self._get(host, port, timeout)
        if self.metrics is not None:
            self.metrics.counter("biscotti_rpc_frames_total",
                                 "outbound RPC frames by method and kind"
                                 ).inc(msg_type=msg_type, kind="post")
            self.metrics.counter(wcodecs.WIRE_BYTES_METRIC,
                                 wcodecs.WIRE_BYTES_HELP).inc(
                len(frame), msg_type=msg_type, direction="out", codec=codec)
        await conn._send(frame, max(0.001, deadline - loop.time()),
                         fault=fault)

    def loopback_endpoint(self, host: str, port: int):
        """The co-hosted endpoint for (host, port), or None when the
        target is remote / not currently serving — broadcast paths use
        this to partition targets so co-hosted peers never pay the frame
        encode at all (runtime/hive.py)."""
        if self.loopback is None:
            return None
        return self.loopback.lookup(host, port)

    async def post_direct(self, host: str, port: int, msg_type: str,
                          meta: Dict[str, Any] | None = None,
                          arrays: Dict[str, np.ndarray] | None = None,
                          timeout: float = 120.0, attempt: int = 0) -> None:
        """Fire-and-forget toward a CO-HOSTED peer without any
        serialization: the hive broadcast fast path (gossip pushes the
        same block object to every local peer; remote peers get the
        encoded frame via `post`). Raises ConnectionError when the
        target is not loopback-local — callers partition targets with
        `loopback_endpoint` first, and a peer that died in between gets
        the same transport failure a closed TCP socket would raise."""
        ep = self.loopback_endpoint(host, port)
        if ep is None:
            raise ConnectionError(f"{host}:{port} is not loopback-local")
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        if self.latency is not None:
            d = self.latency(host, port)
            if d > 0:
                await asyncio.sleep(d / 2)
        fault = (self.faults.action(host, port, msg_type, attempt)
                 if self.faults is not None else None)
        await ep.post(msg_type, meta, arrays,
                      max(0.001, deadline - loop.time()), fault=fault,
                      src=self.loopback_src, metrics=self.metrics)

    def close(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()
        for task in self._dialing.values():
            task.cancel()
        self._dialing.clear()


def geo_latency(node_id: int, base_port: int, regions: int, n: int,
                rtt_s: float) -> Callable[[str, int], float]:
    """Per-link latency model for the WAN/geo operating point (assign the
    result to Pool.latency): peers split into `regions` contiguous blocks
    ("datacenters"); an RPC whose two ends sit in different regions pays
    the cross-region round trip, intra-region traffic stays
    loopback-fast. Mirrors the reference's multi-DC Azure deployment
    (ref: global-deploy-eval/biscottiParsedResults — 87.0 s/iter Biscotti
    @ 100 nodes multi-region, BASELINE.md rows 8-11)."""
    my_region = node_id * regions // n

    def lat(host: str, port: int) -> float:
        peer = port - base_port
        if not (0 <= peer < n):
            return 0.0
        return rtt_s if (peer * regions // n) != my_region else 0.0

    return lat


async def call(host: str, port: int, msg_type: str,
               meta: Dict[str, Any] | None = None,
               arrays: Dict[str, np.ndarray] | None = None,
               timeout: float = 120.0) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """One-shot convenience call (dial, request, close) for tools and
    tests; the runtime uses a persistent `Pool`."""

    async def _roundtrip():
        stream = await open_frame_stream(host, port)
        try:
            meta2 = dict(meta or {})
            meta2["rid"] = 0
            stream.write_parts([msgs.encode(msg_type, meta2, arrays)])
            await stream.drain()
            payload = await stream.next_frame()
            _, rmeta, rarrays = msgs.decode(payload)
            return rmeta, rarrays
        finally:
            stream.close()

    rmeta, rarrays = await asyncio.wait_for(_roundtrip(), timeout)
    if rmeta.get("error"):
        if rmeta.get("stale"):
            raise StaleError(rmeta["error"])
        if rmeta.get("busy"):
            raise BusyError(rmeta["error"])
        raise RPCError(rmeta["error"])
    return rmeta, rarrays
