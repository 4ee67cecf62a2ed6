"""Device-time and phase profiling (counterpart of
`biscotti_tpu/utils/profiling.py`).

* `device_trace(log_dir)`: a `torch.profiler` window around any run,
  exported as a Chrome trace (`trace.json`, viewable in Perfetto or
  chrome://tracing). On the card it records the CUDA kernels; a profiler
  that cannot start raises, where the reference's `jax.profiler` wrapper
  carries on without a trace.
* `PhaseClock`: cumulative wall-clock accounting by phase name, copied.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Union

import torch

from biscotti_tpu_torch.device import resolve_device


@contextlib.contextmanager
def device_trace(log_dir: str,
                 device: Optional[Union[str, torch.device]] = None):
    """Profile the block on `device` (the GPU unless the caller asks for
    the CPU) and write `log_dir/trace.json`; yields the profiler, whose
    `key_averages()` sums the kernels by name. On the GPU a window that
    recorded no device activity raises: the profiler could not trace the
    card (CUPTI only warns when it fails to start)."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if dev.type == "cuda" and not any(
            e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.key_averages()):
        raise RuntimeError("device_trace: the profiler recorded no CUDA "
                           "activity; it could not trace the card")
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseClock:
    """Cumulative per-phase wall-clock accounting."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, name: str, dt: float) -> None:
        """Charge `dt` seconds to `name`."""
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": round(self.totals[name], 4),
                   "calls": self.counts[name],
                   "mean_s": round(self.totals[name] / self.counts[name], 5)}
            for name in sorted(self.totals)
        }
