"""The port's telemetry: the reference's stdlib-only `MetricsRegistry`
(registry.py), which the simulator's `metrics=` hook and the CLI's
`--metrics-out` feed."""

from biscotti_tpu_torch.telemetry.registry import MetricsRegistry  # noqa: F401
