"""The port's live peer (`biscotti_tpu_torch/runtime/peer.py::PeerAgent`)
on the CPU (`device="cpu"`): in-process clusters over loopback TCP, held
to the chain-equality oracle (every peer's chain dump equal, real
non-empty blocks), all-port and mixed with the reference's `PeerAgent`
on one seed (the packages share the wire format, quantization and
commitments, so any chain split in a mixed cluster is a port fault), and
the verifier seam held to the reference's accept sets pool by pool.

Every live cluster here, port and reference agents alike, runs on one set
of windows, WINDOWS: under a loaded test run a cold first `sgd` on the CPU
took ~3 s of the reference's FAST update window (4 s, tests/test_runtime.py)
and left round 0's block empty. WINDOWS leave every peer its round and
cost nothing when no deadline is reached. Ports are 17100-17299, which no
other test file uses."""

import asyncio

import numpy as np
import pytest

from biscotti_tpu.config import BiscottiConfig as JConfig
from biscotti_tpu.config import Defense as JDefense
from biscotti_tpu.config import Timeouts as JTimeouts
from biscotti_tpu.ledger.block import Update as JUpdate
from biscotti_tpu.runtime import placement as jplace
from biscotti_tpu.runtime.peer import PeerAgent as JPeer
from biscotti_tpu.runtime.peer import RoundState as JRoundState
from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts
from biscotti_tpu_torch.ledger.block import Update
from biscotti_tpu_torch.runtime import peer as ppeer
from biscotti_tpu_torch.runtime import placement as pplace
from biscotti_tpu_torch.runtime.peer import PeerAgent, RoundState

WINDOWS = dict(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
               rpc_s=20.0)
SECAGG = dict(secure_agg=True, noising=True, verification=True, epsilon=1.0)


def _kw(i, n, port, **extra):
    base = dict(node_id=i, num_nodes=n, dataset="creditcard", base_port=port,
                num_verifiers=1, num_miners=1, num_noisers=1,
                secure_agg=False, noising=False, verification=False,
                max_iterations=2, convergence_error=0.0, sample_percent=1.0,
                batch_size=8, seed=3)
    base.update(extra)
    return base


def _port_cfg(kw, timeouts=WINDOWS):
    kw = dict(kw)
    if "defense" in kw:
        kw["defense"] = Defense(kw["defense"])
    return BiscottiConfig(timeouts=Timeouts(**timeouts), **kw)


def _ref_cfg(kw):
    kw = dict(kw)
    if "defense" in kw:
        kw["defense"] = JDefense(kw["defense"])
    return JConfig(timeouts=JTimeouts(**WINDOWS), **kw)


def _cluster(n, port, ref_ids=(), timeouts=WINDOWS, **extra):
    """Run n peers to the end; ids in `ref_ids` are the reference's
    agents, the rest the port's on the CPU. Returns the run() results."""
    async def go():
        agents = [JPeer(_ref_cfg(_kw(i, n, port, **extra))) if i in ref_ids
                  else PeerAgent(_port_cfg(_kw(i, n, port, **extra), timeouts),
                                 device="cpu")
                  for i in range(n)]
        return await asyncio.gather(*(a.run() for a in agents))

    return asyncio.run(go())


def _assert_chains_equal(results, rounds):
    dumps = [r["chain_dump"] for r in results]
    assert all(d == dumps[0] for d in dumps), "chain-equality oracle violated"
    lines = dumps[0].splitlines()
    assert len(lines) == rounds + 1  # genesis + one block a round
    assert any("ndeltas=0" not in ln for ln in lines[1:]), dumps[0]
    return lines


def test_all_port_plain_aggregation():
    results = _cluster(4, 17100)
    lines = _assert_chains_equal(results, 2)
    assert "ndeltas=0" not in lines[1]
    assert all(r["phases"] for r in results)


def test_all_port_krum_noising_secure_agg():
    results = _cluster(5, 17110, defense="KRUM", **SECAGG)
    _assert_chains_equal(results, 2)


@pytest.mark.parametrize("defense,secagg", [("ENSEMBLE", True),
                                            ("TRIMMED_MEAN", False),
                                            ("MULTIKRUM", True)])
def test_all_port_live_robust_defenses(defense, secagg):
    port = {"ENSEMBLE": 17120, "TRIMMED_MEAN": 17130, "MULTIKRUM": 17140}[defense]
    results = _cluster(5, port, defense=defense, **dict(SECAGG, secure_agg=secagg))
    _assert_chains_equal(results, 2)


@pytest.mark.parametrize("extra", [{}, dict(defense="KRUM", **SECAGG)],
                         ids=["plain", "secure_agg"])
def test_mixed_reference_and_port_cluster(extra):
    port = 17160 if not extra else 17170
    results = _cluster(4, port, ref_ids=(0, 2), **extra)
    _assert_chains_equal(results, 2)


# --------------------------------------------------- the verifier seam


def _pools(d):
    """Verifier pools of the seam test: plain rows, a colluding cluster,
    ROADMAP C1's non-finite rows and C2's x1e-20 rows, n = 3..12."""
    rng = np.random.default_rng(11)
    out = [rng.normal(size=(n, d)) for n in (3, 5, 7, 12)]
    x = rng.normal(size=(9, d))
    x[5:] = x[5] + 0.01 * rng.normal(size=(4, d))  # near-duplicates
    out.append(x)
    for value in (2e19, np.inf, -np.inf, np.nan):
        x = np.random.default_rng(1).normal(size=(7, d))
        x[2, 5] = value
        out.append(x)
    out.append(np.random.default_rng(0).normal(size=(6, d)) * 1e-20)
    out.append(np.random.default_rng(4).normal(size=(11, d)) * 1e-20)
    return out


async def _decide(agent, state_cls, update_cls, vecs, it):
    st = state_cls(iteration=it)
    st.krum_decision = asyncio.get_running_loop().create_future()
    for sid, v in enumerate(vecs, start=1):
        st.verifier_pool.append(update_cls(source_id=sid, iteration=it,
                                           delta=np.asarray(v, np.float64)))
        st.verifier_sources.add(sid)
    agent.round = st
    agent._decide_round()
    return sorted(st.krum_decision.result())


@pytest.mark.parametrize("defense", [d.value for d in Defense])
def test_verifier_seam_accepts_the_reference_sets(defense):
    kw = _kw(0, 14, 17180, defense=defense, verification=True,
             secure_agg=defense != "TRIMMED_MEAN")

    async def go():
        ref, port = JPeer(_ref_cfg(kw)), PeerAgent(_port_cfg(kw), device="cpu")
        d = port.trainer.num_params
        out = []
        for it, vecs in enumerate(_pools(d)):
            out.append((await _decide(ref, JRoundState, JUpdate, vecs, it),
                        await _decide(port, RoundState, Update, vecs, it)))
        return out

    for got_ref, got_port in asyncio.run(go()):
        assert got_port == got_ref


def test_migration_ticket_of_an_unstarted_peer_equals_reference():
    kw = _kw(2, 4, 17195)
    ref, port = JPeer(_ref_cfg(kw)), PeerAgent(_port_cfg(kw), device="cpu")
    jt, pt = jplace.ticket_from_agent(ref), pplace.ticket_from_agent(port)
    jm, ja = jplace.ticket_wire(jt)
    pm, pa = pplace.ticket_wire(pt)
    assert pm == jm and pa.keys() == ja.keys()
    assert all(np.array_equal(pa[k], ja[k]) for k in pa)
    assert pplace.ticket_nbytes(pt) == jplace.ticket_nbytes(jt)
    fresh = PeerAgent(_port_cfg(kw), device="cpu")
    assert pplace.restore_agent(fresh, pplace.ticket_unwire(pm, pa)) == \
        jplace.restore_agent(JPeer(_ref_cfg(kw)), jplace.ticket_unwire(jm, ja))


def test_partial_batch_members_equals_reference():
    from biscotti_tpu.runtime.peer import partial_batch_members as jpbm

    batch_of = {1: frozenset({1, 2}), 2: frozenset({1, 2}), 3: frozenset({3}),
                4: frozenset({4, 5, 6})}
    for nodes in ([1, 2, 3], [1, 3], [4, 5], [7], []):
        assert ppeer.partial_batch_members(batch_of, nodes) == jpbm(batch_of, nodes)



def test_port_agent_survives_hostile_rpcs_and_still_serves():
    """tests/test_hostile_rpc.py's garbage (every method, missing fields,
    wrong types, absurd values, truncated tensors) against a port agent:
    every call resolves to a reply, some are refused, and the agent still
    serves an honest RegisterPeer afterwards."""
    from biscotti_tpu_torch.runtime import rpc
    from test_hostile_rpc import HOSTILE_ARRAYS, HOSTILE_METAS, METHODS

    port = 17197
    kw = _kw(0, 3, port, defense="KRUM", max_iterations=1, **SECAGG)

    async def go():
        agent = PeerAgent(_port_cfg(kw), device="cpu")
        await agent.server.start()
        try:
            async def one(method, meta, arrays):
                it = meta.get("iteration")
                parkable = isinstance(it, int) and 0 <= it <= 1
                for _ in range(6):
                    try:
                        await rpc.call("127.0.0.1", port, method, dict(meta),
                                       dict(arrays),
                                       timeout=2.0 if parkable else 20.0)
                        return "accepted"
                    except rpc.RPCError:
                        return "refused"
                    except asyncio.TimeoutError:
                        if parkable:
                            return "parked"
                raise AssertionError(f"{method} {meta} never resolved")

            outcomes = await asyncio.gather(*(
                one(m, meta, arrays) for m in METHODS
                for meta in HOSTILE_METAS for arrays in HOSTILE_ARRAYS))
            meta, _ = await rpc.call(
                "127.0.0.1", port, "RegisterPeer",
                {"source_id": 1, "host": "127.0.0.1", "port": port + 1},
                timeout=20.0)
            return outcomes, meta
        finally:
            await agent.server.stop()

    outcomes, meta = asyncio.run(go())
    assert outcomes.count("refused") > 0
    assert "blocks" in meta


def test_traced_port_cluster_reconstructs_complete_rounds(tmp_path):
    """trace=True on an all-port cluster with event logs: the JSONL
    spills of the port's flight recorders reconstruct, through the
    port's copy of the stdlib tool (tools/trace_round.py), into one
    complete trace a round spanning every peer, with a critical path."""
    import json

    from biscotti_tpu_torch.tools import trace_round

    n, port = 4, 17186

    async def go():
        agents = [PeerAgent(_port_cfg(_kw(i, n, port, trace=True)),
                            log_path=str(tmp_path / f"events_{i}.jsonl"),
                            device="cpu") for i in range(n)]
        return await asyncio.gather(*(a.run() for a in agents))

    results = asyncio.run(go())
    _assert_chains_equal(results, 2)
    events = [json.loads(line) for i in range(n)
              for line in open(tmp_path / f"events_{i}.jsonl")]
    rounds = [r for r in trace_round.reconstruct(events, min_nodes=n)["rounds"]
              if r["round"] in (0, 1)]
    assert [r["round"] for r in rounds] == [0, 1]
    assert all(r["complete"] and r["nodes"] == list(range(n))
               and r["critical"] for r in rounds)
