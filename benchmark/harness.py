"""One run of one cell: set-up, the measured window, the traced stretch,
then the comparison.

    set-up   the cell's `Simulator` on the device (host shard synthesis and
             the upload included), the weights drawn from the seed, the
             first three rounds (which the comparison replays) and two
             more, every one through `Simulator.round_step`
    window   `round_step` round after round for `seconds`, nothing read
             back: the host dispatches ahead of the card; a CUDA event
             after each round; the errors and accept counts are read back
             once at the end
    traced   (--trace 1) each per-layer metric's own probe, then a short
             stretch of rounds under torch.profiler
    check    the program's state is freed and the reference replays the
             checked rounds (check.py)
"""

from __future__ import annotations

import importlib
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from benchmark import cells
from benchmark.check import FIRST_ROUNDS, Judge, Observed, Step, verdict

WARM_ROUNDS = 2  # beyond the checked first rounds
TRACE_ROUNDS = 20


@dataclass
class Run:
    """Everything a metric's reader may read."""
    cell: cells.Cell
    seed: int
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    rounds: int = 0
    intervals_ms: List[float] = field(default_factory=list)
    failed: int = 0  # window rounds whose test error is not finite
    memory_peak_bytes: int = 0
    trace: Optional[dict] = None
    probes: Dict[str, object] = field(default_factory=dict)
    # live only while the traced probes run
    sim: object = None
    state: tuple = ()
    it: int = 0
    _inputs: Optional[dict] = None

    def inputs(self) -> dict:
        """One round's intermediate tensors from the program's public
        entries, for the layer probes: draws, updates, mask."""
        if self._inputs is None:
            from biscotti_tpu_torch.models.base import fp32_math
            from biscotti_tpu_torch.ops.krum import default_num_adversaries
            from biscotti_tpu_torch.parallel.sim import defense_mask

            sim, (w, _) = self.sim, self.state
            cidx, bidx, noise, keep = sim.draw_round(sim.gen, self.it, self.seed)
            deltas, noised = sim.local_updates(w, cidx, bidx, noise)
            with fp32_math():
                mask = defense_mask(sim.defense, sim.model, w, noised, sim.x_val,
                                    sim.y_val, sim.cfg.roni_threshold,
                                    default_num_adversaries(cidx.shape[0]))
            self._inputs = dict(w=w, cidx=cidx, bidx=bidx, noise=noise,
                                deltas=deltas, noised=noised, mask=mask & keep)
        return self._inputs

    def time_ms(self, fn: Callable, reps: int = 10) -> float:
        """Device ms a call of `fn`, by CUDA events around `reps` calls
        after one untimed call."""
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps


def sim_config(cell: cells.Cell, seed: int):
    """The program's `BiscottiConfig` from the cell's settings, each by its
    field's name (an enum's by its value), and the run's seed. A setting
    that names no field is refused, never dropped."""
    import dataclasses
    import enum

    from biscotti_tpu_torch.config import BiscottiConfig

    fields = {f.name: f for f in dataclasses.fields(BiscottiConfig)}
    settings = cell.settings
    unknown = sorted(k for k in settings if k not in fields or k == "seed")
    if unknown:
        raise KeyError(f"{cell.name}: no BiscottiConfig field for {unknown}")
    kw = {}
    for k, v in settings.items():
        default = fields[k].default
        kw[k] = type(default)(v) if isinstance(default, enum.Enum) else v
    return BiscottiConfig(**kw, seed=seed)


def p95(values: List[float]) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def metric_module(name: str):
    """`metrics/<name>.py`; a name with a suffix after a dot (the same
    reading in cells that report another end-to-end metric) reads by the
    module of the part before it."""
    return importlib.import_module(f"benchmark.metrics.{name.split('.')[0]}")


def build(cell: cells.Cell, seed: int, device, build_hook: Callable = None):
    """The cell's Simulator on `device`; `build_hook(sim)` may plant a
    fault in it (the tests' and the calibration's)."""
    from biscotti_tpu_torch.parallel.sim import Simulator

    sim = Simulator(sim_config(cell, seed), device=device)
    if build_hook is not None:
        build_hook(sim)
    return sim


def first_rounds(sim, cell: cells.Cell, seed: int):
    """(w0, stake0, the checked first rounds' Steps, the state after the
    warm-up rounds as (w, stake, mask, err)), every round through
    `round_step`."""
    w0 = cells.initial_weights(cell, seed, sim.device)
    stake0 = sim.init_state()[1]
    w, stake = w0, stake0
    first = []
    for it in range(FIRST_ROUNDS + WARM_ROUNDS):
        w, stake, mask, err = sim.round_step(w, stake, it, seed)
        if it < FIRST_ROUNDS:
            first.append(Step(w, stake, mask, err))
    return w0, stake0, first, (w, stake, mask, err)


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, metrics: List[str], build_hook: Callable = None,
        log=print) -> dict:
    """One run; returns the result line's fields (without `device`'s card
    name) and the comparison's numbers."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    sim = build(cell, seed, device, build_hook)
    w0, stake0, first, (w, stake, mask, err) = first_rounds(sim, cell, seed)
    if cuda:
        torch.cuda.synchronize(device)
    r = Run(cell, seed, device)
    r.setup_s = time.perf_counter() - t0
    log(f"set-up {r.setup_s:.3f} s")

    # the window: nothing read back until it closes
    it = FIRST_ROUNDS + WARM_ROUNDS
    errs, accepted, marks = [], [], []
    before = None
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds or not errs:
        before = Step(w, stake, mask, err)
        w, stake, mask, err = sim.round_step(w, stake, it, seed)
        errs.append(err)
        accepted.append(mask.sum())
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
        it += 1
    errs_h = torch.stack(errs).cpu()
    accepted_h = torch.stack(accepted).cpu()
    if cuda:
        torch.cuda.synchronize(device)
    r.window_s = time.perf_counter() - t_start
    r.rounds = len(errs)
    r.failed = int((~torch.isfinite(errs_h)).sum())
    if cuda:
        ends = [start.elapsed_time(e) for e in marks]
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    else:
        ends = [1e3 * (t - t_start) for t in marks]
    r.intervals_ms = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    log(f"window {r.window_s:.3f} s, {r.rounds} rounds, last error "
        f"{float(errs_h[-1]):.4f}, accepted {int(accepted_h[-1])}")
    last = Step(w, stake, mask, err)

    if trace:
        from benchmark import tracing

        # the probes first: after torch.profiler has run, each launch
        # costs the host more, which slows a step that the host paces
        r.sim, r.state, r.it = sim, (w, stake), it
        for name in metrics:
            base = name.split(".")[0]
            mod = metric_module(base)
            if hasattr(mod, "probe") and base not in r.probes:
                r.probes[base] = mod.probe(r)
        r.sim, r.state, r._inputs = None, (), None
        r.trace = tracing.stretch(sim, w, stake, it, seed, TRACE_ROUNDS)

    values = {}
    for name in metrics:
        v = metric_module(name).read(r)
        if v is not None:
            values[name] = v

    # the comparison, after the program's state is freed
    obs = Observed(w0.cpu(), stake0.cpu(), [s.to("cpu") for s in first],
                   it - 1, before.to("cpu"), last.to("cpu"))
    del sim, w, stake, mask, err, w0, stake0, first, before, last, errs, accepted
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = Judge(cell, seed, device).numbers(obs)
    numbers = {k: numbers[k] for k in cell.limits}
    log(f"check {time.perf_counter() - t_check:.3f} s")
    return {"values": values, "numbers": numbers,
            "correct": verdict(numbers, cell.limits), "run": r}
