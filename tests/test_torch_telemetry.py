"""The port's telemetry plane (`biscotti_tpu_torch/telemetry/`: tracectx,
the flight recorder, `Telemetry`) against the reference's. One scripted
three-peer round, on one fake clock in both packages, gives the same
span and event records, the same trace-context propagation over frame
meta, the same JSONL spill bytes, crash dump and Prometheus page, and the
same reconstructed trace and critical path (`biscotti_tpu/tools/
trace_round.reconstruct`, a stdlib tool, read over both streams)."""

import itertools
import json
import types

import pytest

import biscotti_tpu.telemetry as jtel
from biscotti_tpu.telemetry import core as jcore
from biscotti_tpu.telemetry import recorder as jrec
from biscotti_tpu.telemetry import tracectx as jtc
from biscotti_tpu.tools import trace_round
import biscotti_tpu_torch.telemetry as ptel
from biscotti_tpu_torch.telemetry import core as pcore
from biscotti_tpu_torch.telemetry import recorder as prec
from biscotti_tpu_torch.telemetry import tracectx as ptc


class FakeClock:
    """time.time / monotonic / perf_counter as one stepped counter."""

    def __init__(self):
        self.t = 1000.0

    def _tick(self, dt):
        self.t += dt
        return self.t

    def module(self):
        return types.SimpleNamespace(time=lambda: self._tick(0.0005) + 1.7e9,
                                     monotonic=lambda: self._tick(0.0005),
                                     perf_counter=lambda: self._tick(0.003))


def _round(pkg, core, rec, tc, tmp_path, monkeypatch, tag):
    clock = FakeClock()
    monkeypatch.setattr(core, "time", clock.module())
    monkeypatch.setattr(rec, "time", clock.module())
    monkeypatch.setattr(tc, "_COUNTER", itertools.count(1))
    peers = [pkg.Telemetry(node=i, spill_path=str(tmp_path / f"{tag}{i}.jsonl"),
                           spill_batch=4, trace=True) for i in range(3)]
    wire = []
    token = tc.activate(None)
    try:
        for it in range(2):
            tid = tc.trace_id_for(seed=7, iteration=it)
            root = peers[0].round_root(tid, it)
            peers[0].event("round_start", it=it)
            with peers[0].span("sgd", it=it):
                peers[0].event("batch_drawn", it=it, size=10)
            for dst in (1, 2):
                ctx = peers[0].new_ctx()
                meta = tc.stamp({"iteration": it}, ctx)
                wire.append(meta)
                with peers[0].span("rpc_client.VerifyUpdate", ctx=ctx):
                    with peers[dst].rpc_span("VerifyUpdate", meta):
                        with peers[dst].span("krum", pool=3):
                            peers[dst].event("defense_decided", it=it,
                                             accepted=[0, 1])
                        with peers[dst].trace_span("verify_wait"):
                            pass
            with peers[1].rpc_span("Metrics", {"no": "ctx"}):
                peers[1].event("scrape")
            with peers[0].span("mint", it=it):
                peers[0].event("block_accepted", it=it, ndeltas=2)
            tc.activate(None)
            assert root.round == it
    finally:
        tc.restore(token)
    # hostile or partial contexts parse as the reference parses them
    parsed = [tc.from_meta(m) for m in (
        None, {}, {"_tr": "x"}, {"_tr": ["t", "s"]}, {"_tr": ["", "s", 1]},
        {"_tr": ["t" * 99, "s", "7"]}, {"_tr": ["t", "s", "x"]},
        {"_tr": ["t", "s", None]}, wire[0])]
    dumps = []
    for p in peers:
        p.flush()
        path = p.crash_dump(reason="scripted")
        dumps.append(open(path).read())
        p.close()
    spills = [open(tmp_path / f"{tag}{i}.jsonl").read() for i in range(3)]
    events = [json.loads(line) for s in spills for line in s.splitlines()]
    return {
        "wire": wire, "parsed": [repr(c) for c in parsed],
        "spills": spills, "dumps": dumps,
        "tails": [p.recorder.tail(7) for p in peers],
        "since": [p.recorder.tail_since(5, 4) for p in peers],
        "phases": [p.phase_summary() for p in peers],
        "render": [p.render() for p in peers],
        "trace": trace_round.reconstruct(events, min_nodes=3),
    }


def test_traced_round_equals_reference(tmp_path, monkeypatch):
    got = _round(ptel, pcore, prec, ptc, tmp_path, monkeypatch, "p")
    want = _round(jtel, jcore, jrec, jtc, tmp_path, monkeypatch, "j")
    assert got == want
    # the stream is a real traced round: every peer's spans hang off
    # node 0's root, and the reconstruction finds both rounds complete
    rounds = want["trace"]["rounds"]
    assert [r["round"] for r in rounds[:2]] == [0, 1]
    assert all(r["complete"] and r["nodes"] == [0, 1, 2] for r in rounds[:2])


@pytest.mark.parametrize("enabled,spill", [(False, False), (False, True),
                                           (True, False)])
def test_disabled_and_spill_modes_equal_reference(enabled, spill, tmp_path,
                                                  monkeypatch):
    out = []
    for pkg, core, rec, tag in ((ptel, pcore, prec, "p"), (jtel, jcore, jrec, "j")):
        clock = FakeClock()
        monkeypatch.setattr(core, "time", clock.module())
        monkeypatch.setattr(rec, "time", clock.module())
        path = str(tmp_path / f"{tag}.jsonl") if spill else ""
        t = pkg.Telemetry(node=4, enabled=enabled, spill_path=path, trace=True)
        with t.span("sgd", it=1):
            t.event("x", it=1, k=2)
        with t.trace_span("wait"):
            pass
        t.close()
        out.append((t.trace, t.phase_summary(), t.render(),
                    open(path).read() if spill else None,
                    type(t.recorder).__name__, type(t.registry).__name__))
    assert out[0] == out[1]


def test_exports_and_ids_equal_reference():
    names = ("NULL_RECORDER", "NULL_REGISTRY", "NullRecorder", "NullRegistry",
             "Telemetry", "serve_metrics", "FlightRecorder", "DEFAULT_BUCKETS",
             "Counter", "Gauge", "Histogram", "MetricsRegistry",
             "quantile_from_buckets", "tracectx")
    for n in names:
        assert hasattr(ptel, n), n
    assert ptel.DEFAULT_BUCKETS == jtel.DEFAULT_BUCKETS
    assert (ptc.KEY, ptc.TRACE_CAP) == (jtc.KEY, jtc.TRACE_CAP)
    assert [ptc.trace_id_for(s, i) for s in (0, -1, 2**40) for i in (0, 9)] == \
        [jtc.trace_id_for(s, i) for s in (0, -1, 2**40) for i in (0, 9)]
