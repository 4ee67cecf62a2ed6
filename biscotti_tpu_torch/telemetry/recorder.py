# The port's own copy of biscotti_tpu/telemetry/recorder.py; it imports nothing of biscotti_tpu.
"""Flight recorder: bounded in-memory ring of structured events with
batched JSONL spill and crash dump.

Replaces PeerAgent._trace's write()+flush() per event — measured as a
syscall pair on the hot path for EVERY protocol event (gossip receipt,
share intake, breaker transition …) — with an in-memory ring plus a
spill buffer that hits the file only every `batch` events, and an
explicit `flush()` the runtime calls at round boundaries and on
shutdown/crash. A tail of recent events is therefore always inspectable
live (the `Metrics` RPC's `tail` option / `tools.obs --tail`) even when
no spill file is configured at all.

Every event carries a (wall, monotonic) clock pair plus a per-recorder
sequence number: `ts` keeps human logs and cross-host correlation,
`mono` + `seq` give replay-friendly intra-process ordering that survives
NTP steps (the old `_trace` stamped `time.time()` only, so a clock step
could reorder — or alias — events inside a round).

stdlib only, like the rest of the telemetry plane.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List, Optional


class FlightRecorder:
    def __init__(self, node: int = 0, capacity: int = 4096,
                 spill_path: str = "", batch: int = 256):
        self.node = node
        self.ring: deque = deque(maxlen=max(1, int(capacity)))
        self.batch = max(1, int(batch))
        self.spill_path = spill_path
        self._file = open(spill_path, "a") if spill_path else None
        self._buf: List[str] = []
        self._seq = 0
        self.wrapped = 0  # ring evictions (oldest event overwritten)

    # ------------------------------------------------------------- record

    def record(self, event: str, **fields) -> Dict:
        """Append one structured event; returns the record. Never raises
        on unserializable field values (default=str) — a telemetry call
        must not be able to kill a protocol handler."""
        self._seq += 1
        rec = {"seq": self._seq, "ts": time.time(),
               "mono": time.monotonic(), "node": self.node,
               "event": event, **fields}
        if len(self.ring) == self.ring.maxlen:
            self.wrapped += 1
        self.ring.append(rec)
        if self._file is not None:
            self._buf.append(json.dumps(rec, default=str))
            if len(self._buf) >= self.batch:
                self._write()
        return rec

    @property
    def pending(self) -> int:
        """Spill lines buffered but not yet written (test/inspection)."""
        return len(self._buf)

    # -------------------------------------------------------------- spill

    def _write(self) -> None:
        """Batched write — one write() for the whole buffer, NO flush:
        the OS/libc buffer absorbs it off the critical path. flush() is
        the durability point (round end, shutdown, crash)."""
        if self._file is not None and self._buf:
            self._file.write("\n".join(self._buf) + "\n")
            self._buf.clear()

    def flush(self) -> None:
        self._write()
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None

    # ------------------------------------------------------------ readout

    @property
    def seq(self) -> int:
        """Sequence number of the newest event (0 = nothing recorded).
        Pollers use it as the cursor for `tail_since`."""
        return self._seq

    def tail(self, n: int = 50) -> List[Dict]:
        """The newest `n` events, oldest first."""
        if n <= 0:
            return []
        return list(self.ring)[-n:]

    def tail_since(self, since_seq: int = 0, limit: int = 1000) -> List[Dict]:
        """Cursor read: events with seq > `since_seq`, oldest first,
        at most `limit` of them — the incremental-poll primitive behind
        the Metrics RPC's `since_seq` option (tools/obs --watch,
        tools/trace_round), so a scraper stops re-fetching the whole
        ring every scrape. Sequence numbers are gapless, so a reply
        whose first event has seq > since_seq + 1 tells the poller the
        ring wrapped past its cursor (events were lost to eviction)."""
        if limit <= 0:
            return []
        ring = self.ring
        if not ring or since_seq >= self._seq:
            return []
        first = ring[0]["seq"]
        # seqs are contiguous in the ring: index straight to the cursor
        start = max(0, int(since_seq) - first + 1)
        out = list(ring)[start:start + limit]
        return out

    def crash_dump(self, path: str, reason: str = "") -> Optional[str]:
        """Dump the ENTIRE ring (plus a trailer naming the reason) to
        `path` as JSONL — called from the runtime's crash path so the
        last `capacity` events before an unhandled exception survive even
        when no spill file was configured. Returns the path written, or
        None if the dump itself failed (crash handling must not raise)."""
        if not path:
            return None
        try:
            with open(path, "w") as f:
                for rec in self.ring:
                    f.write(json.dumps(rec, default=str) + "\n")
                f.write(json.dumps({
                    "seq": self._seq + 1, "ts": time.time(),
                    "mono": time.monotonic(), "node": self.node,
                    "event": "crash_dump", "reason": reason,
                    "ring_events": len(self.ring), "wrapped": self.wrapped,
                }) + "\n")
            return path
        except OSError:
            return None
