"""The simulator round's layer spans (`parallel/sim.py`, on the port's
`telemetry/core.py::Telemetry`): `sim.round` and its five children in
order, each carrying its round; the children's host intervals inside the
parent's; the round's tensors bit-identical with the spans on, off, and
against `round_step_from_draws` called directly; host-only events on the
CPU; the device clock's arithmetic on a stand-in card (events stamped on
the host clock with a fixed lag); `record_function` only under a
profiler; and `Simulator.run`'s round histogram fed from the spans. One
test, marked `cuda`, times the spans on the card."""

import itertools
import types

import pytest
import torch

from biscotti_tpu_torch.config import BiscottiConfig
from biscotti_tpu_torch.parallel.sim import Simulator
from biscotti_tpu_torch.telemetry import MetricsRegistry, Telemetry
from biscotti_tpu_torch.telemetry import core
from biscotti_tpu_torch.telemetry import recorder

CPU = "cpu"
ROUNDS = 3
LAYERS = ["sim.draws", "sim.local_step", "sim.defense", "sim.aggregate",
          "sim.eval"]
CASES = {
    "creditcard_krum": dict(dataset="creditcard", num_nodes=10, noising=True,
                            verification=True, seed=2),
    "mnist_cnn_krum_dp": dict(dataset="mnist", model_name="mnist_cnn",
                              num_nodes=10, poison_fraction=0.3, noising=True,
                              verification=True, seed=10),
    "mnist_trimmed_mean": dict(dataset="mnist", num_nodes=12,
                               poison_fraction=0.3, noising=True,
                               verification=True, defense="TRIMMED_MEAN",
                               secure_agg=False, seed=6),
}


def _spans(tel):
    return [e for e in tel.recorder.tail(tel.recorder.seq)
            if e["event"] == "span"]


def _rounds(sim, rounds=ROUNDS, start=None):
    w, stake = start or sim.init_state()
    out = []
    for it in range(rounds):
        w, stake, mask, err = sim.round_step(w, stake, it)
        out.append((w, stake, mask, err))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_round_records_the_layer_spans_in_order(case):
    tel = Telemetry()
    sim = Simulator(BiscottiConfig(**CASES[case]), device=CPU, telemetry=tel)
    _rounds(sim)
    tel.flush()
    spans = _spans(tel)
    # recorded as each closes: the five children in order, then the round
    assert [(e["phase"], e["iter"]) for e in spans] == [
        (p, it) for it in range(ROUNDS) for p in LAYERS + ["sim.round"]]
    assert all(set(e) == {"seq", "ts", "mono", "node", "event", "iter",
                          "phase", "dur_s"} for e in spans)


class SteppedClock:
    """perf_counter, monotonic and time as one counter that steps by 1.0
    a call, so that each span's host interval can be read back exactly:
    at a span's exit perf_counter reads E, then the recorder's time()
    E + 1 and monotonic() E + 2."""

    def __init__(self):
        self.n = itertools.count(1)

    def module(self):
        tick = lambda: float(next(self.n))  # noqa: E731
        return types.SimpleNamespace(time=tick, monotonic=tick,
                                     perf_counter=tick)


def test_each_childs_host_interval_lies_inside_its_parents(monkeypatch):
    clock = SteppedClock()
    monkeypatch.setattr(core, "time", clock.module())
    monkeypatch.setattr(recorder, "time", clock.module())
    tel = Telemetry()
    sim = Simulator(BiscottiConfig(**CASES["creditcard_krum"]), device=CPU,
                    telemetry=tel)
    _rounds(sim)
    spans = _spans(tel)
    ivals = [(e["mono"] - 2 - e["dur_s"], e["mono"] - 2) for e in spans]
    for r in range(ROUNDS):
        six = ivals[6 * r:6 * r + 6]
        (p0, p1), children = six[-1], six[:-1]
        assert all(p0 < a < b < p1 for a, b in children)
        # in order, none overlapping the next
        assert all(b < a2 for (_, b), (a2, _) in zip(children, children[1:]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_rounds_tensors_are_bit_identical_with_spans_on_and_off(case):
    cfg = BiscottiConfig(**CASES[case])
    off = Simulator(cfg, device=CPU)
    on = Simulator(cfg, device=CPU, telemetry=Telemetry())
    bare = Simulator(cfg, device=CPU)
    start = off.init_state()
    got_off, got_on = _rounds(off, start=start), _rounds(on, start=start)
    w, stake = start
    for it in range(ROUNDS):
        draws = bare.draw_round(bare.gen, it)
        w, stake, mask, err = bare.round_step_from_draws(w, stake, *draws)
        for a, b in ((got_off[it], got_on[it]),
                     (got_off[it], (w, stake, mask, err))):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flush_on_the_cpu_gives_host_only_events():
    for tel in (Telemetry(), Telemetry(device="cpu")):
        assert tel.clock is None
        with tel.span("sim.round", it=4):
            with tel.span("sim.draws", it=4):
                pass
        tel.flush()
        spans = _spans(tel)
        assert [e["phase"] for e in spans] == ["sim.draws", "sim.round"]
        assert not any({"dev_s", "lead_s"} & set(e) for e in spans)


class FakeCard:
    """A stand-in for torch.cuda: an event recorded at host time h runs
    at device time h + lag_ns + offset_ns; `passed` says whether the
    device has passed every event recorded so far."""

    def __init__(self, lag_ns=2_000, offset_ns=-5 * 10 ** 12):
        self.lag_ns, self.offset_ns, self.passed = lag_ns, offset_ns, True
        self.records = 0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                self.t = None

            def record(self, stream=None):
                card.records += 1
                self.t = (core.time.perf_counter_ns() + card.lag_ns
                          + card.offset_ns)

            def synchronize(self):
                pass

            def query(self):
                return card.passed

            def elapsed_time(self, other):
                return (other.t - self.t) / 1e6

        self.Event = Event

    def install(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "Event", self.Event)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: None)


def test_the_device_clock_puts_the_card_on_the_host_clock(monkeypatch):
    card = FakeCard()
    card.install(monkeypatch)
    tel = Telemetry(device="cuda:0")
    assert tel.clock is not None
    card.lag_ns = 3_000_000  # the host now runs 3 ms ahead of the card
    sim = Simulator(BiscottiConfig(**CASES["creditcard_krum"]), device=CPU,
                    telemetry=tel)
    _rounds(sim)
    assert _spans(tel) == []  # nothing recorded before flush
    pending = [(t0, fields) for t0, _, fields in tel.clock.pending]
    tel.flush()
    spans = _spans(tel)
    assert [(e["phase"], e["iter"]) for e in spans] == [
        (p, it) for it in range(ROUNDS) for p in LAYERS + ["sim.round"]]
    for t0, e in pending:
        assert e["dev_s"] >= 0.0 and e["dur_s"] >= 0.0
        assert abs(e["dev_s"] - e["dur_s"]) < 1e-3
        # the anchor's events waited ~2 us, these 3 ms
        assert 0.0029 < e["lead_s"] < 0.0031
    # the children's device intervals lie inside the round's
    dev = [(t0 / 1e9 + e["lead_s"], t0 / 1e9 + e["lead_s"] + e["dev_s"])
           for t0, e in pending]
    for r in range(ROUNDS):
        (p0, p1), children = dev[6 * r + 5], dev[6 * r:6 * r + 5]
        assert all(p0 <= a <= b <= p1 for a, b in children)


def test_the_device_clock_waits_for_nothing_and_keeps_its_bound(monkeypatch):
    card = FakeCard()
    card.install(monkeypatch)
    tel = Telemetry(device="cuda:0")
    tel.clock.bound = 2
    # a span whose entry ran sooner after the host's stamp than any
    # anchor's tightens the anchor: its lead reads 0, never below
    card.lag_ns = 0
    card.passed = False
    with tel.span("a", it=0):
        with tel.span("b", it=0):
            with tel.span("c", it=0):  # past the bound: host fields only
                pass
    assert [e["phase"] for e in _spans(tel)] == ["c"]
    tel.flush()  # the device has not passed them: still pending
    assert [e["phase"] for e in _spans(tel)] == ["c"]
    card.passed = True
    tel.flush()
    spans = _spans(tel)
    assert [e["phase"] for e in spans] == ["c", "b", "a"]
    assert "dev_s" not in spans[0]
    assert min(e["lead_s"] for e in spans[1:]) == 0.0
    # the pool refills: two more spans take no new events
    records = card.records
    for _ in range(2):
        with tel.span("d", it=1):
            pass
    assert card.records == records + 4
    assert len(tel.clock._free) == 0 and tel.clock._held == 2


def test_spans_open_a_profiler_range_only_while_one_records():
    from torch.profiler import ProfilerActivity, profile

    assert core._profiler_range("sim.round") is core._NO_RANGE
    tel = Telemetry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tel.span("sim.round", it=0):
            torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert "sim.round" in names
    assert core._profiler_range("sim.round") is core._NO_RANGE


def test_run_feeds_the_round_histogram_from_the_round_spans():
    cfg = BiscottiConfig(dataset="creditcard", num_nodes=10,
                         convergence_error=0.0)
    # a Telemetry of the run's own, detached after it
    reg = MetricsRegistry()
    sim = Simulator(cfg, device=CPU, metrics=reg)
    sim.run(4, log_every=3)
    assert sim.telemetry is None
    assert "biscotti_sim_round_seconds_count 4" in reg.render()
    # the caller's Telemetry: the histogram holds its sim.round spans
    tel, reg = Telemetry(), MetricsRegistry()
    sim = Simulator(cfg, device=CPU, metrics=reg, telemetry=tel)
    sim.run(3)
    rounds = [e["dur_s"] for e in _spans(tel) if e["phase"] == "sim.round"]
    assert len(rounds) == 3 and sim.telemetry is tel
    snap = reg.snapshot()["biscotti_sim_round_seconds"]
    assert snap["series"][0]["count"] == 3
    assert snap["series"][0]["sum"] == pytest.approx(sum(rounds))


def test_on_a_card_the_round_histogram_takes_device_time_alone(monkeypatch):
    card = FakeCard()
    card.install(monkeypatch)
    tel, reg = Telemetry(device="cuda:0"), MetricsRegistry()
    sim = Simulator(BiscottiConfig(**CASES["creditcard_krum"]), device=CPU,
                    metrics=reg, telemetry=tel)
    tel.clock.bound = 6  # one round's spans hold device events
    card.passed = False
    w, stake = sim.init_state()
    for it in range(2):  # round 1's spans: past the bound, host time alone
        w, stake, _, _ = sim.round_step(w, stake, it)
    assert [e["iter"] for e in _spans(tel)
            if e["phase"] == "sim.round"] == [1]
    assert sim._observe_rounds(reg, 0) == tel.recorder.seq
    assert reg.snapshot()["biscotti_sim_round_seconds"]["series"] == []
    card.passed = True
    seen = sim._observe_rounds(reg, 0)
    rounds = [e for e in _spans(tel) if e["phase"] == "sim.round"]
    assert [e["iter"] for e in rounds] == [1, 0]
    snap = reg.snapshot()["biscotti_sim_round_seconds"]["series"][0]
    assert snap["count"] == 1 and snap["sum"] == pytest.approx(
        rounds[1]["dev_s"])
    # read every round: later rounds add to the histogram, none twice
    sim.run(3, stop_at_convergence=False)
    snap = reg.snapshot()["biscotti_sim_round_seconds"]["series"][0]
    assert snap["count"] == 4 and tel.recorder.seq > seen


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_on_the_card_the_spans_time_the_device(card):
    tel = Telemetry(device=card)
    sim = Simulator(BiscottiConfig(**CASES["mnist_cnn_krum_dp"]), device=card,
                    telemetry=tel)
    _rounds(sim)
    pending = [(t0, fields) for t0, _, fields in tel.clock.pending]
    torch.cuda.synchronize(card)
    tel.flush()
    spans = _spans(tel)
    assert [(e["phase"], e["iter"]) for e in spans] == [
        (p, it) for it in range(ROUNDS) for p in LAYERS + ["sim.round"]]
    assert all(e["dev_s"] > 0.0 and e["lead_s"] >= 0.0 for _, e in pending)
    dev = [(t0 / 1e9 + e["lead_s"], t0 / 1e9 + e["lead_s"] + e["dev_s"])
           for t0, e in pending]
    # CUDA's elapsed times resolve to about half a microsecond
    for r in range(ROUNDS):
        (p0, p1), children = dev[6 * r + 5], dev[6 * r:6 * r + 5]
        assert all(p0 - 1e-6 <= a <= b <= p1 + 1e-6 for a, b in children)
