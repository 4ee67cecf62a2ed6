# The port's own copy of biscotti_tpu/telemetry/tracectx.py; it imports nothing of biscotti_tpu.
"""Distributed trace context: the causal thread stitching N per-peer
flight-recorder rings into one cross-peer round timeline.

The telemetry plane stamps every event with (ts, mono, seq) — enough
to order events WITHIN a peer, but nothing links the RPC a worker sent
to the handler span it triggered on the miner. This module is that link:

  * a `SpanCtx` names one span — `trace_id` (the round's tree: every
    peer derives the same `{seed:08x}-r{iteration}` id, so one round is
    one trace cluster-wide), `span_id` (unique per process:
    `{node:x}.{counter:x}`), `parent` (the causing span), `round`.
  * the CURRENT span rides an asyncio-aware `contextvars.ContextVar`:
    `asyncio.create_task` copies the context at creation, so a handler
    task, a background gossip push, or a relay forward all inherit the
    span that caused them with no explicit plumbing.
  * on the wire, the context is one compact meta entry
    `meta["_tr"] = [trace_id, span_id, round]` — the parent pointer the
    receiver's dispatch span adopts. It is only attached toward peers
    that advertised the `trace` capability in their RegisterPeer hello
    (negotiated exactly like wire codecs), so legacy/untraced peers get
    byte-identical frames and `--trace 0` (the default) leaves every
    frame bit-identical to the seed format. Chunked payloads need no
    special casing: the context lives in the frame header, which rides
    the head of the chunk run.

Trust model: the context is observability metadata, never protocol
input — a Byzantine peer fabricating trace ids can at worst draw a
wrong picture in the trace viewer (and `from_meta` bounds what it can
inject: three scalar fields, length-capped). No handler branches on it.

stdlib only, like the rest of the telemetry plane.
"""

from __future__ import annotations

import contextvars
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional

# wire meta key carrying [trace_id, span_id, round]; never attached
# unless BOTH ends opted in (sender traces, receiver advertised the cap)
KEY = "_tr"

# RegisterPeer capability token (negotiated beside the wire-codec caps):
# "I understand — and want — trace context on frames you send me"
TRACE_CAP = "trace"

_MAX_ID = 64  # defensive length cap on ids parsed off the wire


@dataclass(frozen=True)
class SpanCtx:
    """One span's identity. `parent` is None for roots (a round's local
    root, or an inbound frame whose sender's span is unknown)."""

    trace_id: str
    span_id: str
    parent: Optional[str] = None
    round: Optional[int] = None

    def wire(self) -> List:
        """The compact meta entry: the RECEIVER treats `span_id` as its
        parent pointer (this ctx is the sender's current span)."""
        return [self.trace_id, self.span_id, self.round]


_CTX: contextvars.ContextVar[Optional[SpanCtx]] = contextvars.ContextVar(
    "biscotti_trace_ctx", default=None)

# process-wide span ordinal: unique across co-hosted agents (hive mode
# runs hundreds of peers in one process; the node prefix keeps ids
# readable, the shared counter keeps them collision-free)
_COUNTER = itertools.count(1)


def new_span_id(node: int) -> str:
    return f"{node:x}.{next(_COUNTER):x}"


def trace_id_for(seed: int, iteration: int) -> str:
    """The round's cluster-wide trace id — pure function of (protocol
    seed, iteration), so every peer roots its round in the same trace
    without any coordination."""
    return f"{seed & 0xFFFFFFFF:08x}-r{iteration}"


def current() -> Optional[SpanCtx]:
    return _CTX.get()


def activate(ctx: Optional[SpanCtx]) -> contextvars.Token:
    return _CTX.set(ctx)


def restore(token: contextvars.Token) -> None:
    _CTX.reset(token)


def root(trace_id: str, node: int, iteration: Optional[int]) -> SpanCtx:
    """A parentless round root for this peer."""
    return SpanCtx(trace_id=trace_id, span_id=new_span_id(node),
                   parent=None, round=iteration)


def child(node: int) -> SpanCtx:
    """A child of the current context (a fresh root when there is none —
    e.g. a span opened outside any round/rpc scope)."""
    cur = _CTX.get()
    if cur is None:
        return SpanCtx(trace_id=f"detached-{node:x}",
                       span_id=new_span_id(node), parent=None, round=None)
    return SpanCtx(trace_id=cur.trace_id, span_id=new_span_id(node),
                   parent=cur.span_id, round=cur.round)


def from_meta(meta: Optional[Dict]) -> Optional[SpanCtx]:
    """Parse — defensively — the wire context off a frame's meta. The
    returned ctx names the SENDER's span (parent=None): activating it
    and opening a child span re-parents the local work under the remote
    cause. Returns None on anything malformed (hostile meta must never
    raise out of the telemetry path)."""
    try:
        v = (meta or {}).get(KEY)
        if not isinstance(v, (list, tuple)) or len(v) != 3 \
                or not isinstance(v[0], str) or not isinstance(v[1], str):
            return None
        tid, sid, rnd = v[0][:_MAX_ID], v[1][:_MAX_ID], v[2]
        if not tid or not sid:
            return None
        rnd = int(rnd) if rnd is not None else None
        return SpanCtx(trace_id=tid, span_id=sid, parent=None, round=rnd)
    except (TypeError, ValueError):
        return None


def stamp(meta: Optional[Dict], ctx: Optional[SpanCtx]) -> Dict:
    """A copy of `meta` carrying `ctx` on the wire key (or `meta`
    unchanged when ctx is None — the untraced path allocates nothing)."""
    if ctx is None:
        return meta if meta is not None else {}
    out = dict(meta or {})
    out[KEY] = ctx.wire()
    return out
