# The port's own copy of biscotti_tpu/telemetry/core.py; it imports nothing of biscotti_tpu.
"""Telemetry facade: round-correlated spans + events over one registry
and one flight recorder, with an optional local HTTP exposition endpoint.

One `Telemetry` object per peer (or per tool run) ties the three pieces
together:

  * `span(name, it=...)` — times a phase and charges it three ways at
    once: the PhaseClock totals (the `run()` result's legacy `phases`
    key), a `biscotti_phase_seconds{phase=...}` histogram (per-phase
    p50/p99 for the cluster scraper), and a structured `span` event in
    the flight recorder carrying the blockchain iteration — so every
    timing is attributable to a round (the Garfield/NET-SA requirement:
    crypto vs transport vs compute per node per round).
  * `event(name, it=..., **kw)` — structured protocol event: counted in
    `biscotti_events_total{event=...}` and recorded in the ring.
  * `snapshot()/render()` — the structured / Prometheus-text readouts.

Disabled mode (`Telemetry(enabled=False)`, cfg.telemetry=0): the registry
and recorder are module-level null singletons whose methods do nothing
and allocate nothing, and `span` still feeds the PhaseClock — exactly the
pre-telemetry accounting cost, nothing more (asserted by the smoke test).
One carve-out: an explicitly configured spill path keeps a REAL recorder
even when disabled, because the event log predates this subsystem and
`--telemetry 0 --log-dir ...` must keep producing it.

Distributed tracing (`trace=True`, cfg.trace, docs/OBSERVABILITY.md
§Distributed tracing): spans additionally carry (`trace`, `span`,
`parent`) ids threaded through the telemetry/tracectx contextvar, events
inherit the enclosing span as their `parent`, and `rpc_span` opens the
receiver-side child span for one handled RPC off the frame's wire
context. With tracing off (the default) none of these fields exist and
every event is byte-identical to the pre-tracing schema.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

from biscotti_tpu_torch.telemetry import tracectx
from biscotti_tpu_torch.telemetry.recorder import FlightRecorder
from biscotti_tpu_torch.telemetry.registry import MetricsRegistry
from biscotti_tpu_torch.utils.profiling import PhaseClock


class _NullMetric:
    """Accepts any counter/gauge/histogram call and does nothing."""

    def inc(self, amount: float = 1.0, **labels) -> None:
        pass

    def set(self, value: float, **labels) -> None:
        pass

    def observe(self, value: float, **labels) -> None:
        pass

    def value(self, **labels) -> float:
        return 0.0


class NullRegistry:
    """Shape-compatible no-op registry (one shared metric object, zero
    per-call allocation)."""

    _METRIC = _NullMetric()

    def counter(self, name: str, help: str = "") -> _NullMetric:
        return self._METRIC

    def gauge(self, name: str, help: str = "") -> _NullMetric:
        return self._METRIC

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> _NullMetric:
        return self._METRIC

    def snapshot(self) -> Dict:
        return {}

    def render(self) -> str:
        return ""


class NullRecorder:
    """Shape-compatible no-op flight recorder."""

    pending = 0
    wrapped = 0

    def record(self, event: str, **fields) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def tail(self, n: int = 50):
        return []

    def tail_since(self, since_seq: int = 0, limit: int = 1000):
        return []

    @property
    def seq(self) -> int:
        return 0

    def crash_dump(self, path: str, reason: str = "") -> None:
        return None


NULL_REGISTRY = NullRegistry()
NULL_RECORDER = NullRecorder()


class Telemetry:
    def __init__(self, node: int = 0, enabled: bool = True,
                 ring: int = 4096, spill_path: str = "",
                 spill_batch: int = 256,
                 registry: Optional[MetricsRegistry] = None,
                 max_label_sets: int = 256, trace: bool = False):
        self.node = node
        self.enabled = bool(enabled)
        # distributed tracing rides the recorder, so it needs the full
        # telemetry plane on; off (the default) = the pre-tracing event
        # schema and zero per-span id work
        self.trace = bool(trace) and self.enabled
        # PhaseClock runs in BOTH modes: its totals are the run() result's
        # back-compat `phases` key and predate this subsystem (its cost is
        # the pre-PR baseline, not telemetry overhead)
        self.phases = PhaseClock()
        if self.enabled:
            self.registry: MetricsRegistry = registry or MetricsRegistry(
                max_label_sets=max_label_sets)
            self._span_hist = self.registry.histogram(
                "biscotti_phase_seconds",
                "per-phase wall-clock, attributable to one iteration")
            self._event_ctr = self.registry.counter(
                "biscotti_events_total", "structured protocol events")
        else:
            self.registry = NULL_REGISTRY  # type: ignore[assignment]
            self._span_hist = NullRegistry._METRIC
            self._event_ctr = NullRegistry._METRIC
        # an explicitly-requested event log (spill_path) is honoured even
        # with the metrics plane disabled: pre-telemetry, `log_path`
        # always produced per-event JSONL, and --telemetry 0 must not
        # silently discard it. Fully off = disabled AND no spill path.
        if self.enabled or spill_path:
            self.recorder = FlightRecorder(node=node, capacity=ring,
                                           spill_path=spill_path,
                                           batch=spill_batch)
        else:
            self.recorder = NULL_RECORDER  # type: ignore[assignment]
        self._crash_path = spill_path + ".crash" if spill_path else ""

    # -------------------------------------------------------------- spans

    @contextlib.contextmanager
    def span(self, name: str, it: Optional[int] = None,
             ctx: Optional[tracectx.SpanCtx] = None, **fields):
        """Round-correlated timing context (see module docstring).

        Yields the span's trace context (None unless tracing is on).
        With tracing on, the span gets an id, adopts the current context
        as its parent, and IS the current context for its body — so
        nested spans, events, and outbound RPCs inside it all link to
        it. `ctx` lets a caller pre-create the context (the client RPC
        path must stamp the span's id on the frame before entering);
        `fields` ride the recorder event verbatim."""
        token = None
        if self.trace:
            if ctx is None:
                ctx = tracectx.child(self.node)
            token = tracectx.activate(ctx)
        t0 = time.perf_counter()
        try:
            yield ctx
        finally:
            dt = time.perf_counter() - t0
            if token is not None:
                tracectx.restore(token)
            self.phases.add(name, dt)
            self._span_hist.observe(dt, phase=name)
            if ctx is not None:
                fields = dict(fields, trace=ctx.trace_id, span=ctx.span_id,
                              parent=ctx.parent)
                if it is None:
                    it = ctx.round
            self.recorder.record("span", iter=it, phase=name,
                                 dur_s=round(dt, 6), **fields)

    @contextlib.contextmanager
    def rpc_span(self, msg_type: str, meta: Optional[Dict]):
        """Receiver-side child span for one handled RPC (the server and
        loopback dispatch seams): adopt the frame's wire context — the
        SENDER's span — as parent, so the handler's own spans, events,
        and forwarded calls all hang off the remote cause. A frame
        WITHOUT context (a legacy/untraced sender, a scraper's one-shot
        Metrics call) gets no dispatch span — an unparented root would
        only be ring noise — but the current context is still DETACHED
        for the handler's duration, so its work cannot mis-attach to
        whatever span the accept loop happened to run under. Only
        called when tracing is on."""
        wctx = tracectx.from_meta(meta)
        token = tracectx.activate(wctx)  # None detaches — see docstring
        try:
            if wctx is None:
                yield None
                return
            with self.span("rpc." + msg_type, it=wctx.round) as ctx:
                yield ctx
        finally:
            tracectx.restore(token)

    def trace_span(self, name: str, it: Optional[int] = None, **fields):
        """A span that exists ONLY under tracing — for timeline coverage
        of long waits (block/intake parking) and composite phases (the
        mint) that the pre-tracing phase accounting never timed. With
        tracing off this is a free nullcontext: the PhaseClock totals,
        the phase histogram, and the recorder stream stay exactly the
        seed's (the bit-identity guard tests this)."""
        if not self.trace:
            return contextlib.nullcontext()
        return self.span(name, it=it, **fields)

    def new_ctx(self) -> tracectx.SpanCtx:
        """A fresh child context of the current span (for callers that
        must know the span id before opening the span — the client RPC
        path stamps it on the outbound frame)."""
        return tracectx.child(self.node)

    def round_root(self, trace_id: str, it: int) -> tracectx.SpanCtx:
        """Install a parentless round-root context for the calling task:
        everything the round's task tree does — worker/miner flows,
        gossip pushes, watchdogs — inherits it via create_task's context
        copy. Returns the root ctx (already activated)."""
        ctx = tracectx.root(trace_id, self.node, it)
        tracectx.activate(ctx)
        return ctx

    def event(self, name: str, it: Optional[int] = None, **kw) -> None:
        # both sinks are null singletons when their half is off: metrics
        # need enabled=True, the recorder additionally honours a
        # configured spill path (see __init__)
        self._event_ctr.inc(event=name)
        if self.trace:
            # point events link into the causal tree as children of the
            # enclosing span — with tracing off the schema is untouched
            cur = tracectx.current()
            if cur is not None and "parent" not in kw:
                kw = dict(kw, trace=cur.trace_id, parent=cur.span_id)
        self.recorder.record(name, iter=it, **kw)

    # ------------------------------------------------------------ readout

    def phase_summary(self) -> Dict[str, Dict[str, float]]:
        return self.phases.summary()

    def render(self) -> str:
        return self.registry.render()

    def flush(self) -> None:
        self.recorder.flush()

    def crash_dump(self, reason: str = "") -> Optional[str]:
        """Dump the event ring next to the spill file (no-op when no
        spill path is configured — there is nowhere agreed to write)."""
        return self.recorder.crash_dump(self._crash_path, reason=reason)

    def close(self) -> None:
        self.recorder.close()


# ----------------------------------------------------------- exposition


async def serve_metrics(render_fn, host: str, port: int):
    """Minimal asyncio HTTP/1.0 endpoint serving `render_fn()` as a
    Prometheus text page on every GET (path ignored: /metrics and / are
    the same page). Returns the asyncio server; caller closes it.

    stdlib-only by design — the point is `curl host:port/metrics` and
    stock Prometheus scraping against a live peer with zero extra deps.
    """
    import asyncio

    async def handle(reader, writer):
        try:
            # consume request line + headers (bounded: hostile clients
            # must not pin the handler)
            for _ in range(64):
                line = await asyncio.wait_for(reader.readline(), 5.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            body = render_fn().encode()
            writer.write(
                b"HTTP/1.0 200 OK\r\n"
                b"Content-Type: text/plain; version=0.0.4\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n"
                + body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    return await asyncio.start_server(handle, host, port)
