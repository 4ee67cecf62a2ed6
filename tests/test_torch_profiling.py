"""The port's profiling and telemetry copies against the reference's:
`PhaseClock` and `MetricsRegistry` give the same summaries and the same
Prometheus page for the same calls; `device_trace` writes a Chrome trace on
the CPU (on the card it is driven by chip_smoke.py's `cnn` phase)."""

import json
import os

import torch

from biscotti_tpu.telemetry.registry import MetricsRegistry as JRegistry
from biscotti_tpu.utils.profiling import PhaseClock as JPhaseClock
from biscotti_tpu_torch.telemetry import MetricsRegistry
from biscotti_tpu_torch.utils.profiling import PhaseClock, device_trace


def test_phase_clock_matches_reference():
    ours, ref = PhaseClock(), JPhaseClock()
    for name, dt in (("sgd", 0.5), ("noise", 0.25), ("sgd", 0.125)):
        ours.add(name, dt)
        ref.add(name, dt)
    with ours.phase("krum"):
        pass
    assert ours.summary()["sgd"] == ref.summary()["sgd"]
    assert ours.summary()["noise"] == ref.summary()["noise"]
    assert ours.counts["krum"] == 1


def test_registry_renders_like_the_reference():
    pages = []
    for reg in (MetricsRegistry(), JRegistry()):
        reg.counter("biscotti_x_total", "x").inc(3)
        reg.gauge("biscotti_sim_round_height", "h").set(7)
        h = reg.histogram("biscotti_sim_round_seconds", "r")
        for v in (0.0002, 0.03, 4.0):
            h.observe(v)
        reg.counter("biscotti_y_total", "y").inc(1, peer="3")
        pages.append(reg.render())
    assert pages[0] == pages[1]


def test_device_trace_on_the_cpu(tmp_path):
    with device_trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
