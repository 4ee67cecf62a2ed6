"""Twin of `tests/test_tracing.py`'s acceptance run
(`test_acceptance_trace_round_live_overlay_chaos`, :532) on the port: 8
secure-aggregation peers with the aggregation overlay
(`runtime/overlay.py`) under a seeded FaultPlan, scraped mid-run through
the Metrics RPC's cursor (`telemetry/recorder.py`) by
`tools/trace_round.py`'s `poll_cluster`, then `reconstruct`,
`critical_path`, `chrome_trace` and `validate_chrome`.

The cluster runs on the reference's agents and on the port's
(`device="cpu"`, trained on the reference run's draws) from the same
config keywords and seed, each polled by its own package's poller, and
the reference test's assertions are made on the port's run. The two runs
are held to what no timing decides: the round trace ids their peers
record (pure in seed and round), and the reconstructed traces' shape. Each
package's `reconstruct` and `validate_chrome` must accept the other
package's polled events, and give the same traces, completeness, nodes
and critical-path nodes on them as the package that polled them (the
round label aside: the port labels a trace by the round its id names,
ROADMAP C4). Which round a poll catches complete, and the overlay's
relays under drops, follow arrival order.

The reference's scenario, at its own width (creditcard), is the `slow`
case: its plan's drops each cost a 10 s RPC window, so a run takes ~40 s
on the CPU. Tier-1 runs the same 3-round cluster and 2-round poll under
the plan's delays alone (~7 s a run), with a poll budget of 60 s. Ports
are 23200-23399, which no other test file uses."""

import asyncio
import re

import pytest

from torch_twins import PACKAGES, agent, cfg, twin

pytestmark = [pytest.mark.trace, pytest.mark.overlay]

# the reference file's windows (test_tracing.py:20)
FAST = dict(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
            rpc_s=10.0)
ROUND_TRACE = re.compile(r"^[0-9a-f]{8}-r\d+$")


# test_tracing.py:546
PLAN = dict(seed=11, drop=0.05, delay=0.2, delay_s=0.05)


def _traced_overlay(plan_kw, budget_s):
    def scenario(pkg, port, draws):
        n = 8
        plan = pkg.faults.FaultPlan(**plan_kw)
        cfgs = [cfg(pkg, i, n, port, FAST, num_miners=2, secure_agg=True,
                    verification=True, trace=True, overlay=True,
                    overlay_group=4, max_iterations=3, fault_plan=plan)
                for i in range(n)]

        async def go():
            agents = [agent(pkg, c, draws=draws) for c in cfgs]
            run = asyncio.ensure_future(
                asyncio.gather(*(a.run() for a in agents)))
            events = await pkg.trace_round.poll_cluster(
                "127.0.0.1", [port + i for i in range(n)], rounds=2,
                budget_s=budget_s, poll_s=0.5, min_nodes=3)
            return agents, await run, events

        agents, results, events = asyncio.run(go())
        tr = pkg.trace_round
        assert all(r["chain_dump"] == results[0]["chain_dump"]
                   for r in results)
        recon = tr.reconstruct(events, min_nodes=3)
        complete = [r for r in recon["rounds"] if r["complete"]]
        assert complete, "no complete round reconstructed from the live poll"
        best = max(complete, key=lambda r: r["critical"]["coverage"])
        cp = best["critical"]
        assert len(cp["nodes"]) >= 2 and len(best["nodes"]) >= 3
        assert cp["coverage"] >= 0.8, cp
        assert abs(sum(cp["segments"].values()) - cp["wall_s"]) < 1e-3
        obj = tr.chrome_trace(recon["traces"])
        tr.validate_chrome(obj)
        assert [e for e in obj["traceEvents"] if e["ph"] == "X"]
        return results, agents, events

    return scenario


def _shape(pkg, events):
    """What `pkg`'s tool makes of `events`: each trace's id, completeness,
    nodes and critical-path nodes; the chrome trace validated."""
    tr = pkg.trace_round
    recon = tr.reconstruct(events, min_nodes=3)
    tr.validate_chrome(tr.chrome_trace(recon["traces"]))
    return sorted((r["trace"], bool(r["complete"]), r["nodes"],
                   r["critical"]["nodes"] if "critical" in r else None)
                  for r in recon["rounds"])


def _round_traces(agents):
    """The round trace ids that the agents' recorders name."""
    return sorted({ev["trace"] for a in agents
                   for ev in a.tele.recorder.tail(100000)
                   if ROUND_TRACE.match(str(ev.get("trace") or ""))})


def _twin(port, plan_kw, budget_s):
    got = twin(_traced_overlay(plan_kw, budget_s), port, stride=10)
    assert _round_traces(got["port"][1]) == _round_traces(
        got["reference"][1])
    for _, _, events in got.values():
        ref_shape, port_shape = (_shape(pkg, events) for pkg in PACKAGES)
        assert port_shape == ref_shape


def test_trace_overlay_delays_two_round_poll():
    _twin(23200, dict(PLAN, drop=0.0), 60.0)


@pytest.mark.slow
def test_acceptance_trace_round_live_overlay_chaos():
    _twin(23220, PLAN, 240.0)
