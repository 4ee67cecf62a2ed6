"""Shared harness of the live twins (`tests/test_torch_byzantine.py`,
`_pipeline_live`, `_fault_injection`, `_partition`, `_upgrade`,
`_membership_live`, `_late_joiner`, `_stragglers_live`, `_faults_live`,
`_admission_live`, `_adversary_live`, `_tracing_live`, `_placement_live`,
`_churn_live`, `_runtime_live`, `_dkg_live`, `_checkpoint_live`,
`_codecs_live`, `_telemetry_live`, `_defaults_live` and
`_pod_launch_live`): one scenario
of a reference live test runs twice on one seed, once on the reference's
`PeerAgent`s and once on the port's (`device="cpu"`), both built from
the same config keywords. Each test then makes the reference test's own
assertions on the port's run and holds the port's outcome to the
reference's: the accepted and rejected source ids, the final stake map,
and, where the protocol fixes them, each block's members.

`REF` and `PORT` name each package's modules under one set of names, so
a scenario is written once as a function of the package.

The port draws its own minibatches and noise (ROADMAP, "Own random
streams"), so a port agent given `draws` (the reference run's Trainers by
node id) trains on the reference Trainer's batch rows and noise bank
through its own step, as `tests/test_torch_trainer.py` does. Then a
secure-aggregation run, whose blocks carry quantized sums, mints the
reference's chain bit for bit wherever the reference's own run is
deterministic; a plain-mode block carries float deltas, which differ from
the reference's in the last bits (ROADMAP C10)."""

import asyncio
import importlib
from types import SimpleNamespace

import jax
import numpy as np
import torch

from biscotti_tpu.models import trainer as jtrainer

# module names of either package that the twins reach, by short name
MODULES = {
    "config": "config", "block": "ledger.block", "chain": "ledger.chain",
    "roles": "parallel.roles", "faults": "runtime.faults",
    "membership": "runtime.membership", "peer": "runtime.peer",
    "protocol": "runtime.protocol", "rpc": "runtime.rpc",
    "wire": "runtime.wire", "cm": "crypto.commitments",
    "ss": "ops.secretshare", "chaos": "tools.chaos", "obs": "tools.obs",
    "profile_round": "tools.profile_round", "trainer": "models.trainer",
    "admission": "runtime.admission", "adversary": "runtime.adversary",
    "placement": "runtime.placement", "hive": "runtime.hive",
    "messages": "runtime.messages", "telemetry": "telemetry",
    "tracectx": "telemetry.tracectx", "registry": "telemetry.registry",
    "trace_round": "tools.trace_round", "keygen": "tools.keygen",
    "codecs": "runtime.codecs", "checkpoint": "utils.checkpoint",
    "stragglers": "runtime.stragglers", "trust": "ops.trust",
}


def _package(name, root, agent_kw):
    mods = {k: importlib.import_module(f"{root}.{v}")
            for k, v in MODULES.items()}
    return SimpleNamespace(name=name, PeerAgent=mods["peer"].PeerAgent,
                           agent_kw=agent_kw, **mods)


REF = _package("reference", "biscotti_tpu", {})
PORT = _package("port", "biscotti_tpu_torch", {"device": "cpu"})
PACKAGES = (REF, PORT)


def cfg(pkg, i, n, port, t: dict, **kw):
    """The reference tests' `_cfg`: creditcard, one verifier, miner and
    noiser, every plane off, seed 3; `t` the Timeouts' fields, `defense`
    a Defense's name."""
    base = dict(node_id=i, num_nodes=n, dataset="creditcard", base_port=port,
                num_verifiers=1, num_miners=1, num_noisers=1,
                secure_agg=False, noising=False, verification=False,
                max_iterations=2, convergence_error=0.0, sample_percent=1.0,
                batch_size=8, seed=3)
    base.update(kw)
    if isinstance(base.get("defense"), str):
        base["defense"] = pkg.config.Defense(base["defense"])
    return pkg.config.BiscottiConfig(timeouts=pkg.config.Timeouts(**t), **base)


def reference_batch(jt, it) -> torch.Tensor:
    """The reference Trainer `jt`'s minibatch rows of round `it`."""
    k = jax.random.fold_in(jt._batch_key, it)
    rows = int(jt.x_train.shape[0])
    return torch.from_numpy(np.array(
        jtrainer.sample_batch(k, rows, min(jt.batch_size, rows))))


def inject_reference_draws(agent_, jt) -> None:
    """The port agent's Trainer takes the reference Trainer `jt`'s batch
    rows and noise vectors; its step and everything after stay the
    port's. The draws of the configured rounds are made here, before
    the run, so that no jax compile lands inside a round's deadline."""
    its = range(agent_.cfg.max_iterations + 1)
    rows = {it: reference_batch(jt, it) for it in its}
    noise = ({it: jt.get_noise(it) for it in its}
             if agent_.cfg.noising else {})
    agent_.trainer.batch_indices = \
        lambda it: rows[it] if it in rows else reference_batch(jt, it)
    agent_.trainer.get_noise = \
        lambda it: noise[it] if it in noise else jt.get_noise(it)


def reference_draws(agents) -> dict:
    return {a.id: a.trainer for a in agents}


_WARM = set()  # (package, dataset, model) whose step has run here, and
# (package, "vss") once its first commitment has


def warm(pkg, c) -> None:
    """One step and one test error of a throwaway Trainer of `c`'s
    dataset and model, once a process: the first step pays jax's compile
    or torch's first calls, which a live round's windows must not absorb
    in one package and not in the other. Where the peers commit (secure
    aggregation, verification), one commitment too: a process's first
    loads the native EC plane and its fixed-base tables (~1 s alone, more
    than a 6 s update window under a loaded test run)."""
    if (c.secure_agg or c.verification) and (pkg.name, "vss") not in _WARM:
        pkg.cm.vss_commit_chunks_bytes(np.zeros((1, c.poly_size), np.int64),
                                       bytes(32), b"warm")
        _WARM.add((pkg.name, "vss"))
    if (pkg.name, c.dataset, c.model_name) in _WARM:
        return
    t = pkg.trainer.Trainer(c.dataset, f"{c.dataset}0", cfg=c, seed=0,
                            **pkg.agent_kw)
    w = np.zeros(t.num_params)
    t.private_fun(w, 0)
    t.test_error(w)
    _WARM.add((pkg.name, c.dataset, c.model_name))


def agent(pkg, c, cls=None, draws=None, **kw):
    """One agent of `pkg` (the port's on the CPU), `cls` a subclass; a
    port agent takes the reference's draws where `draws` names its id."""
    warm(pkg, c)
    a = (cls or pkg.PeerAgent)(c, **dict(pkg.agent_kw, **kw))
    if pkg is PORT and draws and c.node_id in draws:
        inject_reference_draws(a, draws[c.node_id])
    return a


def run_cluster(pkg, cfgs, classes=None, draws=None, **kw):
    """Every agent to the end of its run(); `classes` maps a node id to
    the agent class it runs. Returns (results, agents)."""
    classes = classes or {}

    async def go():
        agents = [agent(pkg, c, classes.get(c.node_id), draws, **kw)
                  for c in cfgs]
        results = await asyncio.gather(*(a.run() for a in agents))
        return results, agents

    return asyncio.run(go())


async def hard_stop(agent_, task) -> None:
    """A crash: cancel the agent's run loop and release its port."""
    task.cancel()
    try:
        await task
    except (asyncio.CancelledError, Exception):
        pass
    agent_.pool.close()
    await agent_.server.stop()


async def wait_height(agent_, h: int, budget: float = 60.0) -> None:
    """Wait until `agent_` has reached chain height `h`."""
    deadline = asyncio.get_event_loop().time() + budget
    while agent_.iteration < h:
        assert asyncio.get_event_loop().time() < deadline, \
            f"cluster never reached height {h}"
        await asyncio.sleep(0.05)


def round0_vanilla(pkg, n, num_verifiers=1, num_miners=1, num_params=50):
    """The reference's `_round0_vanilla`: the highest id that is a plain
    worker in round 0 under the deterministic committee draw."""
    chain = pkg.chain.Blockchain(num_params, n, 10)
    verifiers, miners = pkg.roles.elect_committees(
        chain.latest_stake_map(), chain.latest_hash(), num_verifiers,
        num_miners, n)
    busy = set(verifiers) | set(miners)
    return max(i for i in range(n) if i not in busy)


def outcome(agent_):
    """What a run decided, read from one agent's chain: the accepted and
    rejected source ids (sorted, with repeats), the final stake map and
    each block's (iteration, sorted (source, accepted) pairs)."""
    blocks = agent_.chain.blocks
    deltas = [u for b in blocks for u in b.data.deltas]
    return {
        "accepted": sorted(u.source_id for u in deltas if u.accepted),
        "rejected": sorted(u.source_id for u in deltas if not u.accepted),
        "stake": dict(sorted(agent_.chain.latest_stake_map().items())),
        "blocks": [(b.data.iteration,
                    sorted((u.source_id, bool(u.accepted))
                           for u in b.data.deltas)) for b in blocks[1:]],
    }


def honest_outcome(agents, skip=()):
    return outcome(next(a for a in agents if a.id not in skip))


def assert_same_outcome(ref, port, keys=("accepted", "rejected", "stake")):
    for k in keys:
        assert port[k] == ref[k], f"{k}: port {port[k]} != reference {ref[k]}"


def each_package(scenario):
    """`scenario(pkg)` on the reference, then on the port, for a scenario
    pure in its inputs (a mocked transport, fixed frames): the port's
    record must be the reference's."""
    ref, port = (scenario(pkg) for pkg in PACKAGES)
    assert port == ref, f"port {port} != reference {ref}"
    return ref


def tight_admission(pkg):
    """The reference tests' TIGHT admission plan (test_admission.py:57):
    honest traffic stays ~10x under these rates while a flood overruns
    the bucket."""
    return pkg.admission.AdmissionPlan(enabled=True, update_rate=8.0,
                                       bulk_rate=6.0, control_rate=16.0)


def twin(scenario, port, stride=20):
    """`scenario(pkg, base_port, draws)` on the reference, then on the
    port with the reference run's draws; each returns (results, agents,
    ...). Returns {package name: what it returned}."""
    out, draws = {}, None
    for k, pkg in enumerate(PACKAGES):
        out[pkg.name] = got = scenario(pkg, port + stride * k, draws)
        if pkg is REF:
            draws = reference_draws(got[1])
    return out


def stake_from_records(agent_):
    """The stake map that the chain's own records give, block by block:
    +stake_unit an accepted record, -stake_unit (floored at 0) a rejected
    one (the minting rule, runtime/peer.py `_create_block`)."""
    unit = agent_.cfg.stake_unit
    stake = dict(agent_.chain.blocks[0].stake_map)
    for b in agent_.chain.blocks[1:]:
        for u in b.data.deltas:
            if u.accepted:
                stake[u.source_id] = stake.get(u.source_id, 0) + unit
            else:
                stake[u.source_id] = max(0, stake.get(u.source_id, 0) - unit)
    return dict(sorted(stake.items()))


def assert_first_block_parity(ref_agent, port_agent, first_block=True):
    """Parity for a run whose later blocks the two packages need not
    share: the same rejected ids, round 0's block with the same members
    and weights within the step's rtol 1e-5 (unless `first_block` is
    False, for a run
    whose round 0 a kill cuts), and in each run a final stake map that
    its own chain's records give.

    Two causes part such runs after round 0. A plain-mode block carries
    float deltas whose last bits differ between the packages, and its
    hash seeds the next round's committees (ROADMAP C10). A kill, a
    partition window or a late join lands at a moment that two runs of
    the reference do not repeat either."""
    ref, port = outcome(ref_agent), outcome(port_agent)
    assert_same_outcome(ref, port, ("rejected",))
    if first_block:
        assert port["blocks"][:1] == ref["blocks"][:1], (port, ref)
        np.testing.assert_allclose(
            port_agent.chain.blocks[1].data.global_w,
            ref_agent.chain.blocks[1].data.global_w, rtol=1e-5, atol=1e-6)
    for a, got in ((ref_agent, ref), (port_agent, port)):
        assert got["stake"] == stake_from_records(a), got


def dumps(results, agents, skip=()):
    return [r["chain_dump"] for r, a in zip(results, agents)
            if a.id not in skip]


def assert_same_dumps(ref, port):
    """The port's honest dumps equal each other and the reference's."""
    assert all(d == port[0] for d in port), "chain-equality oracle violated"
    assert port[0] == ref[0], \
        f"port chain\n{port[0]}\n!= reference chain\n{ref[0]}"


def round_pools(results, it: int = 0) -> list:
    """Round `it`'s verifier decisions of a run: each pool's sorted source
    ids, from the peers' verdict streams (recorded under every defense)."""
    return sorted(sorted(int(x) for x in v["src"]) for r in results
                  for v in r["telemetry"].get("trust", {}).get("stream", [])
                  if int(v["it"]) == it)


def declined_rounds(agents) -> set:
    """The rounds in which a worker of `agents` declined: every verifier it
    asked refused it or failed. Where a round has more workers than
    samples, a verifier pools the first to arrive and refuses the rest
    (ROADMAP C8), so which workers such a round carries follows arrival
    order."""
    return {e["iter"] for a in agents for e in a.tele.recorder.tail(4096)
            if e["event"] == "update_rejected"}


def assert_same_chain_where_pooled_alike(ref, port, min_rounds=1):
    """`ref` and `port` each (results, agents) of a secure-aggregation run:
    each run's chain dumps equal, and the two chains bit for bit, block by
    block, up to the first round whose members differ. A round may carry
    other members only where a worker declined in it, in either run (C8),
    and a block on the same members may part only by a quantum or so in a
    few coordinates (C10); the blocks after it follow another chain and
    are held to the stake rule. At least `min_rounds` blocks must be
    compared bit for bit."""
    ref_dumps, port_dumps = (dumps(*run) for run in (ref, port))
    for d in (ref_dumps, port_dumps):
        assert all(x == d[0] for x in d), "chain-equality oracle violated"
    ref_lines = ref_dumps[0].splitlines()[1:]
    port_lines = port_dumps[0].splitlines()[1:]
    ref_blocks = outcome(ref[1][0])["blocks"]
    port_blocks = outcome(port[1][0])["blocks"]
    raced = declined_rounds(ref[1]) | declined_rounds(port[1])
    compared = 0
    for r, (a, b) in enumerate(zip(ref_blocks, port_blocks)):
        if a != b:
            assert a[0] in raced, \
                f"round {a[0]} carried {b[1]}, the reference {a[1]}, and " \
                f"no worker declined in it"
            break
        if port_lines[r] != ref_lines[r]:
            # the same members, and a sum off by a quantum or so in a few
            # coordinates: a worker's delta sat within a float32 rounding
            # of a 10^-precision step, where the frameworks' products round
            # apart (ROADMAP C10); the chains part from here
            w_ref, w_port = (run[1][0].chain.blocks[r + 1].data.global_w
                             for run in (ref, port))
            quantum = 10.0 ** -ref[1][0].cfg.precision
            off = np.abs(np.asarray(w_port) - np.asarray(w_ref))
            assert off.max() <= len(a[1]) * quantum * (1 + 1e-6) \
                and np.count_nonzero(off) <= max(1, off.size // 1000), \
                f"round {a[0]}: port block {port_lines[r]} != reference " \
                f"{ref_lines[r]} on the same members, off by up to " \
                f"{off.max()} in {np.count_nonzero(off)} coordinates"
            break
        compared += 1
    assert compared >= min_rounds, (compared, ref_blocks, port_blocks)
    for run in (ref, port):
        assert outcome(run[1][0])["stake"] == stake_from_records(run[1][0])
