"""The port's telemetry plane, the port's own copies of
`biscotti_tpu/telemetry/`:

  * `MetricsRegistry`: counters, gauges and histograms with labels and
    Prometheus text rendering (registry.py), which the simulator's
    `metrics=` hook, the CLI's `--metrics-out` and the peer feed;
  * `Telemetry.span`: round-correlated timing contexts feeding the phase
    histogram, the PhaseClock totals and the recorder (core.py);
  * `FlightRecorder`: a bounded event ring with batched JSONL spill
    (recorder.py);
  * `serve_metrics`: optional local HTTP exposition (core.py);
  * `tracectx`: the trace context the RPC frames carry.
"""

from biscotti_tpu_torch.telemetry import tracectx  # noqa: F401
from biscotti_tpu_torch.telemetry.core import (  # noqa: F401
    NULL_RECORDER,
    NULL_REGISTRY,
    NullRecorder,
    NullRegistry,
    Telemetry,
    serve_metrics,
)
from biscotti_tpu_torch.telemetry.recorder import FlightRecorder  # noqa: F401
from biscotti_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    quantile_from_buckets,
)
