"""The spanned stretch: rounds of `Simulator.round_step` dispatched ahead
with a device-timed `Telemetry` attached, synchronised once at the end,
and the readers of its layer spans.

The program's spans (`biscotti_tpu_torch/parallel/sim.py`): `sim.round`
and, inside it in order, `sim.draws`, `sim.local_step`, `sim.defense`,
`sim.aggregate` and `sim.eval`. A span event carries `dur_s` (host
clock) and, on a card, `dev_s` (entry event to exit event) and `lead_s`
(the entry event's device time less the host's entry time: how long the
span's first operation waited in the stream's queue). A program whose
`Simulator` takes no telemetry records no spans, and every reader then
returns None.

The stretch runs from the first reader's probe, after the layer probes
of the cells' older metrics and before the traced stretch, whose
profiler makes every later launch cost the host more; it detaches the
telemetry before it returns."""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import List, Optional

import torch

SPAN_ROUNDS = 50
KEY = "sim.spans"  # the stretch's span events, in Run.probes
LAYERS = ("sim.draws", "sim.local_step", "sim.defense", "sim.aggregate",
          "sim.eval")


def events(run) -> List[dict]:
    """The span events of the run's spanned stretch, which the first
    call runs."""
    if KEY not in run.probes:
        spans, round_s = stretch(run.sim, run.state, run.it, run.seed,
                                 run.device, SPAN_ROUNDS)
        run.probes[KEY] = spans
        if spans:
            out = summary(spans)
            out["stretch_round_ms"] = 1e3 * round_s
            out["window_round_ms"] = 1e3 * run.window_s / run.rounds
            print(json.dumps({"spanned_stretch": out}), file=sys.stderr,
                  flush=True)
    return run.probes[KEY]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stretch(sim, state, it: int, seed: int, device, rounds: int):
    """`rounds` rounds from `state` = (w, stake) at round `it`, nothing
    read back until the one synchronise after the last. Returns the span
    events in the order they closed and the stretch's wall seconds a
    round; no events where the program has no spans."""
    if not hasattr(sim, "telemetry"):
        return [], None
    from biscotti_tpu_torch.telemetry import Telemetry

    tel = Telemetry(device=device)
    w, stake = state
    _sync(device)
    sim.telemetry = tel
    try:
        t0 = time.perf_counter()
        for k in range(rounds):
            w, stake, _, _ = sim.round_step(w, stake, it + k, seed)
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        sim.telemetry = None
    tel.flush()
    spans = [e for e in tel.recorder.tail(tel.recorder.seq)
             if e["event"] == "span"]
    return spans, wall / rounds


def median_ms(spans: List[dict], phase: str, field: str) -> Optional[float]:
    """The median of `field` (seconds) over the spans named `phase`, in
    ms; None where no span has it (no spans, or no card for `dev_s`)."""
    vals = [e[field] for e in spans if e["phase"] == phase and field in e]
    return 1e3 * statistics.median(vals) if vals else None


def self_shares(spans: List[dict], field: str = "dev_s") -> List[float]:
    """Each round's share of `sim.round`'s `field` that its five children
    leave uncovered (the stake bookkeeping and the Python between them)."""
    children, out = 0.0, []
    for e in spans:
        if e["phase"] in LAYERS:
            children += e.get(field, 0.0)
        elif e["phase"] == "sim.round":
            if e.get(field):
                out.append((e[field] - children) / e[field])
            children = 0.0
    return out


def summary(spans: List[dict]) -> dict:
    """Each span's median host, device and lead ms, and the median share
    of `sim.round`'s device time that its children leave uncovered."""
    out = {}
    for phase in ("sim.round",) + LAYERS:
        out[phase] = {f: median_ms(spans, phase, f)
                      for f in ("dur_s", "dev_s", "lead_s")}
    shares = self_shares(spans)
    out["round_self_share"] = statistics.median(shares) if shares else None
    return out
