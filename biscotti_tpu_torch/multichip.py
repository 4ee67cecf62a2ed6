"""The port's multi-device dry run (counterpart of
`__graft_entry__.py::dryrun_multichip`): the three multi-device paths on a
`torch.distributed` mesh of `n_devices` ranks, one process a rank
(`parallel/mesh.py::spawn`; NCCL on GPUs, gloo on the CPU), at the
reference's sizes:

  1. one sharded round (`make_sharded_round_step`) on creditcard at 2 peers
     a rank, KRUM: w finite, N − N // 2 updates accepted;
  2. the chunk-sharded share pipeline (`make_sharded_share_fns`,
     20 shares) at d = 7,850 and 164,266: shares of q summed over 3 peers
     recover 3·q exactly;
  3. `run_cluster` on a `BatchStepper` mesh: 4 mnist peers a rank,
     8 iterations, 2 verifiers, 2 miners, 1 noiser, secure aggregation,
     KRUM: every chain dump equal, and the blocks agree with the rounds
     whose workers trained (one mesh batch each, `check_cluster_blocks`);
     with more peers than the 5 committee seats every round has a
     worker, so at least 7 blocks are non-empty, the reference's check.
     At one rank the 4 peers can all draw seats, and the rounds without a
     worker follow the chain's hashes (the reference's own run at one
     device: 7 of 8 blocks; the port's chain, from its own minibatch
     streams, leaves others empty).

    python -c "from biscotti_tpu_torch.multichip import dryrun_multichip; \\
               dryrun_multichip(1)"

`device=None` means the GPU, one rank each; `device="cpu"` runs the ranks
on the CPU.

`sharded_rounds` is the sharded round at full width (N = 1,024, mnist
softmax or mnist_cnn, `mesh_cfg`) on a mesh, timed round by round;
`chip_smoke.py`'s mesh phase runs it. `mesh_rounds` runs it on meshes of
several sizes, one after another, and holds every size's masks and
weights to the first's; on a host of k GPUs it is the port's measurement
of the path across cards:

    python -m biscotti_tpu_torch.multichip --ranks 1,4 [--model mnist_cnn]

`entry(device=None)` is the counterpart of `__graft_entry__.py::entry`: the
single-device whole-round step at the reference's configuration, with
example arguments on the card.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional, Union

import numpy as np
import torch

BASE_PORT = 24310  # the reference's cluster ports (__graft_entry__.py:117)


def entry(device: Optional[Union[str, torch.device]] = None):
    """The pure whole-round step and example arguments, `(fn, args)`, at
    the reference's configuration (`__graft_entry__.py:17-21`): mnist, 16
    peers, batch 10, DP ε = 1 noising, KRUM verification, every peer
    contributing, no verifier or miner committee. `device=None` means the
    GPU (raises without one); `device="cpu"` the CPU.

    `fn` is `Simulator.round_step_from_draws` and `args` is `(w, stake,
    cidx, batch_idx, noise, keep)`: `init_state()` and round 0's
    `draw_round(sim.gen, 0)`. `fn(*args)` returns (w', stake', mask, err)
    and equals `sim.round_step(w, stake, 0)`. The reference's argument
    list is `(w, stake, it, seed, x, y, x_val, y_val)`; here the round's
    draws are arguments instead of `it` and `seed`, because torch does not
    reproduce `jax.random` (the draws are made from (seed, it) by
    `draw_round`, and the tests inject the reference's own), and the data
    stay on the Simulator, `fn.__self__`.

    With S = 16 contributors this step runs no hand-written kernel on the
    card: B1 scores pools of 512..4096 (`ops/krum_cuda.py`, the
    reference's Pallas window), and below that Krum is the plain torch
    path, as the reference's is."""
    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.parallel.sim import Simulator

    cfg = BiscottiConfig(
        dataset="mnist", num_nodes=16, batch_size=10, epsilon=1.0,
        noising=True, verification=True, defense=Defense.KRUM,
        sample_percent=1.0, num_verifiers=0, num_miners=0)
    sim = Simulator(cfg, device=device)
    w, stake = sim.init_state()
    return sim.round_step_from_draws, (w, stake, *sim.draw_round(sim.gen, 0))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def check_cluster_blocks(dump: str, trained: Dict[int, int],
                         refused: int) -> int:
    """Hold a device cluster's chain `dump` to the rounds it trained
    (`trained`: workers served a delta, by iteration) and the updates its
    verifiers refused; returns the number of non-empty blocks, and raises
    when none was minted or a block could not have come from the run.

    Every non-empty block comes from a trained round. A trained round
    mints an empty block only when its intake closed on a refused
    worker's decline before the accepted worker's shares came: the leader
    miner mints once num_samples workers are accounted for (1 when the
    seats take every peer), and Krum pools the first update to arrive. So
    such a round had two workers or more, and there are no more such
    rounds than refusals."""
    blocks = [ln.split() for ln in dump.splitlines()[1:]]
    real = {int(b[0].removeprefix("iter=")) for b in blocks
            if b[1] != "ndeltas=0"}
    _check(len(real) > 0 and real <= trained.keys(),
           f"device cluster minted rounds {sorted(real)}, trained "
           f"{sorted(trained)}")
    empty = sorted(trained.keys() - real)
    _check(all(trained[it] >= 2 for it in empty) and len(empty) <= refused,
           f"device cluster: trained rounds {empty} minted empty blocks "
           f"(workers {[trained[it] for it in empty]}, {refused} refused)")
    return len(real)


def _dryrun_rank(mesh, n_devices: int, base_port: int) -> Optional[str]:
    from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts
    from biscotti_tpu_torch.device import synchronize
    from biscotti_tpu_torch.ops import secretshare as ss
    from biscotti_tpu_torch.parallel.mesh import (device_mesh, local_slice,
                                                 mesh_device)
    from biscotti_tpu_torch.parallel.sim import (Simulator,
                                                 make_sharded_round_step)
    from biscotti_tpu_torch.runtime.device_cluster import run_cluster

    dev = mesh_device(mesh)
    # 1. one sharded round, 2 creditcard peers a rank
    cfg = BiscottiConfig(
        dataset="creditcard", num_nodes=2 * n_devices, batch_size=8,
        epsilon=1.0, noising=True, verification=True, defense=Defense.KRUM,
        sample_percent=1.0, num_verifiers=0, num_miners=0)
    sim = Simulator(cfg, device=dev, peers=local_slice(mesh, cfg.num_nodes))
    step = make_sharded_round_step(sim, mesh)
    w = torch.zeros(sim.num_params, dtype=torch.float32, device=dev)
    w, mask, err = step(w, 0)
    synchronize(dev)
    _check(bool(torch.isfinite(w).all()), "sharded round: w is not finite")
    accepted = int(mask.sum())
    _check(accepted == cfg.num_nodes - cfg.num_nodes // 2,
           f"sharded round accepted {accepted} of {cfg.num_nodes}")

    # 2. the share pipeline over the chunk axis, at the reference's widths
    make_sh, agg_sh, recover_sh = ss.make_sharded_share_fns(
        device_mesh("chunks", dev.type), total_shares=20)
    for d in (7_850, 164_266):
        q = np.random.default_rng(d).integers(-10_000, 10_000, size=d)
        shares = make_sh(ss.to_chunks(q, chunk_multiple=n_devices))
        rec = recover_sh(agg_sh(torch.stack([shares] * 3)), ss.share_xs(20))
        _check(np.array_equal(ss.from_chunks(rec.cpu().numpy(), d), 3 * q),
               f"sharded share round trip at d={d}")

    # 3. the integrated runtime on the mesh: 4 mnist peers a rank
    n_peers, n_iters = 4 * n_devices, 8
    dcfg = BiscottiConfig(
        num_nodes=n_peers, dataset="mnist", base_port=base_port,
        num_verifiers=2, num_miners=2, num_noisers=1, secure_agg=True,
        noising=True, verification=True, defense=Defense.KRUM,
        convergence_error=0.0, sample_percent=1.0, batch_size=8, seed=3,
        timeouts=Timeouts(update_s=15.0, block_s=60.0, krum_s=15.0,
                          share_s=15.0, rpc_s=20.0))
    stepper, _, results = asyncio.run(run_cluster(dcfg, mesh, n_iters))
    if mesh.get_local_rank() != 0:
        return None
    dumps = [r["chain_dump"] for r in results]
    _check(all(dd == dumps[0] for dd in dumps), "chain oracle violated")
    refused = sum(r["counters"].get("update_rejected", 0) for r in results)
    minted = check_cluster_blocks(dumps[0], stepper.trained, refused)
    seats = dcfg.num_verifiers + dcfg.num_miners + dcfg.num_noisers
    _check(n_peers <= seats or minted >= n_iters - 1,
           f"device cluster minted only {minted} non-empty blocks of {n_iters}")
    line = (f"dryrun_multichip({n_devices}): ok — mask {accepted}/"
            f"{cfg.num_nodes}, err {float(err):.3f}, sharded secure-agg ok "
            f"at d=7850/164266, device-cluster mint ok at mnist dims "
            f"d={stepper.num_params} ({minted}/{n_iters} blocks, {n_peers} "
            f"peers, 2v/2m committee, {stepper.batches} mesh batches)")
    print(line, flush=True)
    return line


def dryrun_multichip(n_devices: int,
                     device: Optional[Union[str, torch.device]] = None,
                     base_port: int = BASE_PORT) -> str:
    """Run the three checks on `n_devices` ranks (None: GPUs, one a rank);
    returns rank 0's summary line, which it also prints. Any failed check
    raises."""
    from biscotti_tpu_torch.parallel.mesh import spawn

    return spawn(_dryrun_rank, n_devices, device,
                 args=(n_devices, base_port))[0]


def mesh_cfg(model_name: str = "", n: int = 1024):
    """The sharded-round measurement's configuration: mnist (softmax, or
    `model_name`) at N = n, every peer contributing, KRUM, DP ε = 1,
    batch 10, 30 % poisoned."""
    from biscotti_tpu_torch.config import BiscottiConfig, Defense

    return BiscottiConfig(dataset="mnist", model_name=model_name,
                          num_nodes=n, sample_percent=1.0,
                          defense=Defense.KRUM, verification=True,
                          noising=True, epsilon=1.0, batch_size=10,
                          poison_fraction=0.3, seed=0)


def sharded_rounds(mesh, model_name: str, n: int, rounds: int):
    """One warm-up and `rounds` timed rounds of the sharded step on `mesh`
    at `mesh_cfg(model_name, n)`: returns (the Simulator, the step,
    (w_in, w, mask, err) a round, each round's host ms ending in a
    synchronize, B1's launches in each round)."""
    import time

    from biscotti_tpu_torch.device import synchronize
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.parallel.mesh import local_slice, mesh_device
    from biscotti_tpu_torch.parallel.sim import (Simulator,
                                                 make_sharded_round_step)

    kern = krum_cuda.krum_scores_kernel
    dev = mesh_device(mesh)
    sim = Simulator(mesh_cfg(model_name, n), device=dev,
                    peers=local_slice(mesh, n))
    step = make_sharded_round_step(sim, mesh)
    w, _, _ = step(sim.init_state()[0], 0)  # warm-up
    synchronize(dev)
    trace, round_ms, launches = [], [], []
    for it in range(1, rounds + 1):
        before = kern.launches
        t0 = time.perf_counter()
        w_in = w
        w, mask, err = step(w_in, it)
        synchronize(dev)
        round_ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(kern.launches - before)
        trace.append((w_in, w, mask, err))
    return sim, step, trace, round_ms, launches


def rounds_on_rank(mesh, model_name: str, n: int, rounds: int) -> dict:
    """`sharded_rounds` on this rank, for `spawn`: its device, round times,
    B1's launches a round and each round's (w, mask, err) as numpy, the
    collectives alone: the all-gather of this rank's noised updates and
    the psum of w (host ms, ending in a synchronize), and what the rank
    holds: its peers, the bytes of its x and y, and on a GPU the most the
    process allocated on it (`torch.cuda.max_memory_allocated`)."""
    import time

    from biscotti_tpu_torch.device import synchronize
    from biscotti_tpu_torch.parallel.mesh import all_gather, mesh_device, psum
    from biscotti_tpu_torch.parallel.sim import rank_updates, sharded_draws

    dev = mesh_device(mesh)
    sim, _, trace, round_ms, launches = sharded_rounds(mesh, model_name, n,
                                                       rounds)
    w = trace[-1][1]
    bidx, noise, _ = sharded_draws(sim, 0, sim.cfg.seed, sim.peers)
    _, noised = rank_updates(sim, sim.x, sim.y, w, bidx, noise)

    def host_ms(fn, reps: int = 10) -> float:
        fn()
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        synchronize(dev)
        return 1e3 * (time.perf_counter() - t0) / reps

    return {"rank": mesh.get_local_rank(), "device": str(dev),
            "name": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu", "round_ms": round_ms, "b1_launches": launches,
            "all_gather_ms": host_ms(lambda: all_gather(mesh, noised)),
            "psum_ms": host_ms(lambda: psum(mesh, w)),
            **held_bytes(sim),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None,
            "trace": [(w.cpu().numpy(), mask.cpu().numpy(), float(err))
                      for _, w, mask, err in trace]}


def held_bytes(sim) -> dict:
    """What a Simulator holds on its device: its peers and the bytes of
    its x and y."""
    return {"peers_held": len(sim.peers),
            "x_bytes": sim.x.numel() * sim.x.element_size(),
            "y_bytes": sim.y.numel() * sim.y.element_size()}


def mesh_rounds(ranks=(1, 4), model_name: str = "", n: int = 1024,
                rounds: int = 5,
                device: Optional[Union[str, torch.device]] = None) -> list:
    """The sharded round of mnist (softmax, or `model_name`) at N = n on a
    mesh of each size in `ranks`, one after another; returns a row a size:
    each rank's round times, B1 launches and collective times, and whether
    its masks equal, and its w and errors lie within rtol 1e-5 of, the
    first size's, round by round. Raises if any size disagrees."""
    import statistics

    from biscotti_tpu_torch.parallel.mesh import spawn

    rows, first = [], None
    for k in ranks:
        got = spawn(rounds_on_rank, k, device, args=(model_name, n, rounds))
        trace = got[0]["trace"]
        first = first or trace
        row = {"ranks": k, "nodes": n, "model": model_name or "softmax",
               "devices": [r["device"] for r in got],
               "names": sorted({r["name"] for r in got}),
               "round_ms_median": [statistics.median(r["round_ms"])
                                   for r in got],
               "round_ms": [r["round_ms"] for r in got],
               "b1_launches": [r["b1_launches"] for r in got],
               "all_gather_ms": [r["all_gather_ms"] for r in got],
               "psum_ms": [r["psum_ms"] for r in got],
               **{key: [r[key] for r in got] for key in (
                   "peers_held", "x_bytes", "y_bytes",
                   "max_memory_allocated")},
               "masks_equal_first": all(np.array_equal(m, m0) for (_, m, _), (
                   _, m0, _) in zip(trace, first)),
               "w_close_first": all(np.allclose(
                   w, w0, rtol=1e-5, atol=1e-5 * np.abs(w0).max())
                   for (w, _, _), (w0, _, _) in zip(trace, first)),
               "err_close_first": all(abs(e - e0) <= 1e-5 * abs(e0)
                                      for (_, _, e), (_, _, e0)
                                      in zip(trace, first)),
               "accepted": [int(m.sum()) for _, m, _ in trace]}
        rows.append(row)
        if not (row["masks_equal_first"] and row["w_close_first"]
                and row["err_close_first"]):
            raise AssertionError(f"the sharded round at {k} ranks differs "
                                 f"from {ranks[0]} ranks: {row}")
    return rows


def main(argv=None) -> int:
    """`mesh_rounds` at the given sizes, one JSON line a size, then
    `dryrun_multichip` at the largest."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description="the sharded paths across "
                                 "meshes of several sizes")
    ap.add_argument("--ranks", default="1,4")
    ap.add_argument("--model", default="", help="'' (softmax) or mnist_cnn")
    ap.add_argument("--platform", default="cuda",
                    help="'cuda' (a GPU a rank; the default) or 'cpu'")
    ns = ap.parse_args(argv)
    ranks = tuple(int(k) for k in ns.ranks.split(","))
    for row in mesh_rounds(ranks, ns.model, device=ns.platform):
        print(json.dumps(row), flush=True)
    dryrun_multichip(max(ranks), ns.platform)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
