"""The traced stretch: a short run of `Simulator.round_step` under
torch.profiler, reduced to sums and to the trace's intervals. Nothing is
written to disk. The idle gaps come from a second, shorter stretch that
records the host's operations as well; under that profiler the host runs
slower, so its gaps are longer than the first stretch's."""

from __future__ import annotations

import time
from collections import defaultdict

import torch

B1_KERNELS = ("krum_pad_kernel", "krum_gram_kernel", "krum_select_kernel")


def _device_events(prof):
    dev = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == dev]


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_op_at(cpu, t: float) -> str:
    """The top-level host operation running at time t (us), or "python"
    where the host ran none."""
    best = None
    for e in cpu:
        if e.time_range.start <= t <= e.time_range.end and (
                best is None or e.time_range.start > best.time_range.start):
            best = e
    return best.name if best is not None else "python"


def _profile(sim, w, stake, it: int, seed: int, rounds: int, activities):
    from torch.profiler import profile

    torch.cuda.synchronize(sim.device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for k in range(rounds):
            w, stake, _, _ = sim.round_step(w, stake, it + k, seed)
        torch.cuda.synchronize(sim.device)
        window_s = time.perf_counter() - t0
    dev = _device_events(prof)
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    return prof, dev, window_s


def stretch(sim, w, stake, it: int, seed: int, rounds: int,
            named_rounds: int = 5) -> dict:
    """Profile `rounds` rounds from state (w, stake) at round `it`, the
    device alone (recording the host's operations too would slow a round
    that the host paces); then `named_rounds` more with the host's
    operations, which name the longest idle gaps."""
    from torch.profiler import ProfilerActivity

    from biscotti_tpu_torch.ops import krum_cuda

    kern = krum_cuda.krum_scores_kernel
    launches = kern.launches
    _, dev, window_s = _profile(sim, w, stake, it, seed, rounds,
                                [ProfilerActivity.CUDA])
    launches = kern.launches - launches
    merged = _union([(e.time_range.start, e.time_range.end) for e in dev])
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name] += e.time_range.end - e.time_range.start
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]

    prof, named, _ = _profile(sim, w, stake, it, seed, named_rounds,
                              [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    spans = _union([(e.time_range.start, e.time_range.end) for e in named])
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(spans, spans[1:])),
                  reverse=True)[:10]
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.cpu_parent is None]
    return {
        "rounds": rounds,
        "window_s": window_s,
        "busy_s": sum(b - a for a, b in merged) / 1e6,
        "kernels": len(kernels),
        "b1_launches": launches,
        "b1_s": sum(e.time_range.end - e.time_range.start for e in dev
                    if any(k in e.name for k in B1_KERNELS)) / 1e6,
        "device_ops": [[n, t / 1e6] for n, t in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[f"host: {_host_op_at(cpu, at)}", g / 1e6]
                      for g, at in gaps],
    }
