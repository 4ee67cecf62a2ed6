"""Device-crypto instrumentation seam (stdlib-only, import-cheap).

The port's copy of `biscotti_tpu/crypto/kernels/instrument.py`. Each
public entry of the port's plane ends in a host copy of its result, so the
wall-clock that `timed` charges covers the device work.

Every public kernel entry wraps itself in `timed(kernel)`, which charges
three sinks at once:

  * a module-level seconds/calls accumulator (`device_seconds()` /
    `device_calls()`) — what bench.py and the chaos report read;
  * the `biscotti_crypto_device_seconds{kernel=}` histogram on whatever
    registry the runtime installed (`set_metrics_registry`, wired by
    PeerAgent when --device-crypto is armed with telemetry on);
  * an optional span hook (`set_span_hook`) the runtime points at
    `Telemetry.span("crypto_device", kernel=...)`, so the flight
    recorder / trace_round / profile_round see device work as its own
    `crypto_device` critical-path segment, tagged at the kernel call
    site.

Hooks are process-global by design (the arming switch is too): one
live cluster per process is the supported deployment, and in-process
test harnesses arm/disarm around each cluster.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Optional

_lock = threading.Lock()
_seconds: Dict[str, float] = {}
_calls: Dict[str, int] = {}
_metrics_registry = None
_span_hook: Optional[Callable] = None
# THREAD-local, not a module global: co-hosted peers prewarm
# concurrently from separate to_thread workers, and a global flag's
# unordered enter/restore pairs can race each other into leaving the
# whole process silenced (observed live: a 4-peer cluster reporting
# zero kernel calls). Each worker suppresses only its own calls.
_tls = threading.local()


@contextlib.contextmanager
def suppressed():
    """Silence ALL instrumentation (spans, metrics, accumulators) for
    the CALLING THREAD for the duration — prewarm compiles run under
    this so warm-up wall-clock never pollutes the round-work readouts
    (device_seconds, the histogram, crypto_device spans; profile_round's
    residency split relies on every emitted span being nested round
    work)."""
    prev = getattr(_tls, "suppress", False)
    _tls.suppress = True
    try:
        yield
    finally:
        _tls.suppress = prev


def set_metrics_registry(reg) -> None:
    """Install (or clear, with None) the MetricsRegistry receiving the
    `biscotti_crypto_device_seconds` histogram."""
    global _metrics_registry
    _metrics_registry = reg


def set_span_hook(hook: Optional[Callable]) -> None:
    """Install a callable `hook(kernel_name) -> context manager` opened
    around every kernel call — the runtime passes a `crypto_device`
    telemetry span factory. None disarms."""
    global _span_hook
    _span_hook = hook


def release_hooks(span_hook=None, registry=None) -> None:
    """Identity-guarded teardown: clear each hook only if it is STILL
    the one the caller installed. A shut-down peer must drop its hooks
    (the span closure pins the whole agent object graph, and a dead
    cluster's telemetry must stop receiving kernel events) without
    stripping a later live agent's installation."""
    global _span_hook, _metrics_registry
    if span_hook is not None and _span_hook is span_hook:
        _span_hook = None
    if registry is not None and _metrics_registry is registry:
        _metrics_registry = None


def device_seconds() -> Dict[str, float]:
    """Cumulative wall-clock per kernel since process start (or the last
    reset) — end-to-end: host marshalling + device execute."""
    with _lock:
        return dict(_seconds)


def device_calls() -> Dict[str, int]:
    with _lock:
        return dict(_calls)


def reset_counters() -> None:
    with _lock:
        _seconds.clear()
        _calls.clear()


@contextlib.contextmanager
def timed(kernel: str):
    if getattr(_tls, "suppress", False):
        yield
        return
    hook = _span_hook
    cm = hook(kernel) if hook is not None else contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with cm:
            yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _seconds[kernel] = _seconds.get(kernel, 0.0) + dt
            _calls[kernel] = _calls.get(kernel, 0) + 1
        reg = _metrics_registry
        if reg is not None:
            reg.histogram(
                "biscotti_crypto_device_seconds",
                "device-crypto kernel wall-clock, end-to-end "
                "(host marshalling + device execute)",
            ).observe(dt, kernel=kernel)
