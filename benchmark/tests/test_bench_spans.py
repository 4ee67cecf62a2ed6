"""The readers of the program's layer spans (benchmark/spans.py and the
`span_*`, `host_*` and `round_lead_ms` metrics) on a synthetic spanned
stretch and on a small one run on the CPU, against a program without
spans."""

import importlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import cells, harness, spans  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
LAYERS = ["draws", "local_step", "defense", "aggregate", "eval"]
READERS = ([f"span_{l}_ms" for l in LAYERS] + [f"host_{l}_ms" for l in LAYERS]
           + ["round_lead_ms"])


def synthetic(rounds=3):
    """Rounds as the program records them: the five children as each
    closes, then `sim.round`; round k's layer i takes (i + 1 + k) ms on
    the device, 0.1 ms on the host, and the round 1 ms more than its
    children."""
    out = []
    for k in range(rounds):
        total = 0.0
        for i, phase in enumerate(spans.LAYERS):
            dev = (i + 1 + k) / 1e3
            total += dev
            out.append({"event": "span", "iter": k, "phase": phase,
                        "dur_s": 1e-4, "dev_s": dev, "lead_s": 0.0})
        out.append({"event": "span", "iter": k, "phase": "sim.round",
                    "dur_s": 6e-4, "dev_s": total + 1e-3,
                    "lead_s": (10.0 * k) / 1e3})
    return out


def _run(events, probes=None):
    return SimpleNamespace(probes={spans.KEY: events, **(probes or {})})


def test_the_readers_take_the_median_over_the_rounds():
    run = _run(synthetic())
    for i, layer in enumerate(LAYERS):
        span = importlib.import_module(f"benchmark.metrics.span_{layer}_ms")
        host = importlib.import_module(f"benchmark.metrics.host_{layer}_ms")
        # rounds read i + 1, i + 2, i + 3 ms: the median is round 1's
        assert span.probe(run) == pytest.approx(i + 2)
        assert host.probe(run) == pytest.approx(0.1)
    lead = importlib.import_module("benchmark.metrics.round_lead_ms")
    assert lead.probe(run) == pytest.approx(10.0)
    shares = spans.self_shares(synthetic())
    assert shares == pytest.approx([1 / 16, 1 / 21, 1 / 26])
    out = spans.summary(synthetic())
    assert out["round_self_share"] == pytest.approx(1 / 21)
    assert out["sim.eval"]["dev_s"] == pytest.approx(6.0)


@pytest.mark.parametrize("events", [[], [dict(e, phase="other")
                                         for e in synthetic()]])
def test_no_spans_read_as_nothing(events):
    run = _run(events)
    for name in READERS:
        mod = importlib.import_module(f"benchmark.metrics.{name}")
        assert mod.probe(run) is None
        run.probes[name] = mod.probe(run)
        assert mod.read(run) is None


def test_a_program_without_spans_reads_nothing_and_runs_nothing():
    """The parent's Simulator takes no telemetry: the stretch runs no
    round and every reader returns None."""
    sim = SimpleNamespace(round_step=None)  # would raise if called
    run = SimpleNamespace(sim=sim, state=(None, None), it=5, seed=1,
                          device=torch.device("cpu"), probes={},
                          window_s=1.0, rounds=10)
    for name in READERS:
        mod = importlib.import_module(f"benchmark.metrics.{name}")
        run.probes[name] = mod.probe(run)
        assert mod.read(run) is None
    assert run.probes[spans.KEY] == []


def test_a_small_stretch_on_the_cpu_reads_host_times_alone(capsys,
                                                          monkeypatch):
    """On the CPU the spans have host times only: the host readers read,
    the device readers (span_*, round_lead_ms) do not; the stretch leaves
    no telemetry attached and the stretch summary goes to stderr."""
    cell = cells.load("mnist_cnn_n1024.krum_dp", num_nodes=12)
    sim = harness.build(cell, 7, "cpu")
    w0 = cells.initial_weights(cell, 7, sim.device)
    run = SimpleNamespace(sim=sim, state=(w0, sim.init_state()[1]), it=0,
                          seed=7, device=sim.device, probes={}, window_s=1.0,
                          rounds=10)
    events, round_s = spans.stretch(sim, run.state, 0, 7, sim.device, 2)
    assert round_s > 0 and sim.telemetry is None
    assert [e["phase"] for e in events] == [*spans.LAYERS, "sim.round"] * 2
    monkeypatch.setattr(spans, "SPAN_ROUNDS", 3)
    for name in READERS:
        mod = importlib.import_module(f"benchmark.metrics.{name}")
        run.probes[name] = mod.probe(run)
        assert (mod.read(run) is not None) == name.startswith("host_"), name
    assert len(run.probes[spans.KEY]) == 6 * spans.SPAN_ROUNDS
    assert '"spanned_stretch"' in capsys.readouterr().err


def test_the_span_metrics_follow_the_family_rule():
    """Each span_*: a base entry on the card-paced cells, a .host_edge
    twin on krum_dp, a .host_paced twin on lfw; round_lead_ms and each
    host_* only the two twins, where the host sets the pace; every one
    moves its cells' round."""
    base = ["mnist_cnn_n1024.trimmed_mean_dp", "mnist_cnn_n1024.foolsgold_dp"]
    twins = {"": ("round_ms", base),
             ".host_edge": ("round_ms.host_edge", ["mnist_cnn_n1024.krum_dp"]),
             ".host_paced": ("round_ms.host_paced", ["lfw_cnn_n1024.krum"])}
    entries = {e["name"]: e for e in SPEC["per_layer"]}
    assert "round_lead_ms" not in entries
    want = set()
    for name in READERS:
        for suffix, (moves, cells_) in twins.items():
            if name.startswith(("host_", "round_lead")) and not suffix:
                continue
            e = entries[name + suffix]
            want.add(name + suffix)
            assert (e["moves"], e["workloads"]) == (moves, cells_)
            assert e["better"] == ("higher" if name == "round_lead_ms"
                                   else "lower")
    assert len(want) == 27
    assert [e["name"] for e in SPEC["per_layer"][-27:]] == sorted(
        want, key=[e["name"] for e in SPEC["per_layer"]].index)
