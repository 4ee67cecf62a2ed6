"""In-process N-peer round simulator on the GPU (counterpart of
`biscotti_tpu/parallel/sim.py::Simulator`).

One federated round for all peers at once:

    draws    = draw_round(gen, it)   — contributors, minibatch rows, DP noise
                                       (Gaussian or mcmc13), dropped frames
    deltas   = vmap(local_step)      — S contributors' SGD steps
    mask     = defense_mask          — verifier committee: Krum, Multi-Krum
                                       (both on the Hopper kernel B1 inside
                                       its window), FoolsGold, RONI, or
                                       accept-all
    w'       = w + Σ maskᵢ·deltaᵢ    — miner aggregation (ref honest.go:360-375),
                                       or the trimmed mean
    stake'   = ±STAKE_UNIT scatter   — ledger bookkeeping (ref honest.go:414-419)
    err      = error_flat            — the test split's error

With a `Telemetry` attached (`Simulator(..., telemetry=)`), `round_step`
opens the span `sim.round` and, inside it in this order, `sim.draws`,
`sim.local_step`, `sim.defense`, `sim.aggregate` and `sim.eval`; the
stake bookkeeping is `sim.round`'s own time. A device-timed Telemetry
times each on the card too, without a synchronise (docs/TORCH_SIM_SPANS.md).
Without one every span is one shared no-op context.

The round is split in two: `draw_round` makes every random choice from the
simulator's `torch.Generator`, and `round_step_from_draws` is pure and
deterministic in its tensors. The reference draws from `jax.random`, whose
streams torch does not reproduce; tests hold the port to the reference by
feeding the reference's own draws to `round_step_from_draws`.

The peer stack x[N, rows, d] lives on the device; a round gathers only its
S·B minibatch rows from it. `run_scan` loops over the rounds with nothing
read back to the host until the end (the reference compiles that loop into
one `lax.scan`). Steps and evaluations run inside `fp32_math`, so
the CNN families' convolutions stay float32 on the card.

Peers-across-devices: `make_sharded_round_step` shards the peer axis over a
`torch.distributed` mesh (`parallel/mesh.py`), one rank a device; the only
cross-peer traffic is an all-gather of the [N, d] noised updates for the
accept mask and a psum of the masked aggregate, as in the reference. Its
draws (`sharded_draws`) and pure step (`sharded_step_from_draws`) are split
the same way. Each rank's Simulator is built with `peers=local_slice(mesh,
N)` and holds only those peers' shards on its device, 1/k of x and y (the
reference's `device_put` with `P(axis)`, sim.py:467-470).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from biscotti_tpu_torch.config import BiscottiConfig, Defense
from biscotti_tpu_torch.data import datasets as ds
from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.models.base import Model, fp32_math
from biscotti_tpu_torch.models.trainer import (local_step_fn, sample_batch,
                                               stream_seed)
from biscotti_tpu_torch.models.zoo import model_for_dataset
from biscotti_tpu_torch.ops import dp_noise
from biscotti_tpu_torch.ops.krum import default_num_adversaries, krum_accept_mask
from biscotti_tpu_torch.ops.robust_agg import (foolsgold_accept_mask,
                                               multikrum_accept_mask,
                                               trimmed_mean_aggregate)
from biscotti_tpu_torch.ops.roni import roni_accept_mask
from biscotti_tpu_torch.parallel.mesh import (all_gather, local_slice,
                                             mesh_device, psum)
from biscotti_tpu_torch.tools.verdicts import poisoned_ids

_NO_SPAN = contextlib.nullcontext()


@dataclass
class RoundLog:
    """One reference-log row: `iteration,error,timestamp`, and the round's
    accepted-update count."""

    iteration: int
    error: float
    timestamp: float
    accepted: int = 0

    def csv(self) -> str:
        return f"{self.iteration},{self.error:.6f},{self.timestamp:.6f}"


def defense_mask(defense: Defense, model: Model, w: torch.Tensor,
                 noised: torch.Tensor, x_val: torch.Tensor,
                 y_val: torch.Tensor, roni_threshold: float,
                 num_adversaries: int) -> torch.Tensor:
    """Verifier-committee accept mask over the round's noised updates.
    TRIMMED_MEAN is an aggregation rule, not a mask (see
    masked_aggregate), and ENSEMBLE's trust ledger lives in the live
    runtime, so both accept every update here, like NONE, as the
    reference's simulator does (sim.py:63-84)."""
    if defense == Defense.KRUM:
        return krum_accept_mask(noised, num_adversaries)
    if defense == Defense.MULTIKRUM:
        return multikrum_accept_mask(noised, num_adversaries)
    if defense == Defense.FOOLSGOLD:
        return foolsgold_accept_mask(noised)
    if defense == Defense.RONI:
        return roni_accept_mask(model, w, noised, x_val, y_val, roni_threshold)
    return torch.ones(noised.shape[0], dtype=torch.bool, device=noised.device)


def masked_aggregate(mask: torch.Tensor, deltas: torch.Tensor,
                     noised: torch.Tensor, dp_in_model: bool,
                     defense: Defense = Defense.KRUM,
                     trim_fraction: float = 0.35) -> torch.Tensor:
    """Miner aggregation: the sum of the accepted RAW deltas, or of the
    noised ones in dp_in_model mode, where the noise is part of the update
    (ref: honest.go:172-179). Under TRIMMED_MEAN the coordinate-wise
    trimmed aggregate replaces the sum; the mask is all-ones there."""
    src = noised if dp_in_model else deltas
    if defense == Defense.TRIMMED_MEAN:
        return trimmed_mean_aggregate(src, trim_fraction)
    return torch.where(mask[:, None], src, torch.zeros_like(src)).sum(dim=0)


def _held_peers(peers: Optional[slice], n: int) -> range:
    """The contiguous peer ids a Simulator holds: every one of n for None,
    else the slice `peers` (step 1, inside [0, n), not empty)."""
    if peers is None:
        return range(n)
    if not isinstance(peers, slice):
        raise ValueError(f"peers must be None or a slice, not "
                         f"{type(peers).__name__}")
    held = range(0 if peers.start is None else peers.start,
                 n if peers.stop is None else peers.stop,
                 1 if peers.step is None else peers.step)
    if held.step != 1 or not 0 <= held.start < held.stop <= n:
        raise ValueError(f"peers {peers} is not a contiguous, non-empty "
                         f"slice of the {n} peers")
    return held


class Simulator:
    """N peers on one device: the round's contributors batched as tensors.

    `peers` (a slice of peer ids; None: all N) names the peers
    whose shards the Simulator puts on its device: a rank of the sharded
    round holds its own slice (`make_sharded_round_step`). The host still
    reads every shard, so `rows`, the cut every shard shares, is the
    minimum over all N, as in the reference. A Simulator that holds a
    proper slice refuses the single-device round, which indexes x by
    global peer id."""

    def __init__(self, cfg: BiscottiConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 model: Optional[Model] = None, metrics=None,
                 peers: Optional[slice] = None, telemetry=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # optional telemetry registry (telemetry.MetricsRegistry): run()
        # then feeds the reference's per-round histogram and height/error
        # gauges (the CLI's --metrics-out)
        self.metrics = metrics
        # optional telemetry.Telemetry: round_step's layer spans
        self.telemetry = telemetry
        self.model = model or model_for_dataset(cfg.dataset, cfg.model_name)
        self.mode = "sgd" if self.model.name == "logreg" else "grad"
        self.num_params = self.model.num_params
        if cfg.dp_mechanism not in ("gaussian", "mcmc13"):
            raise ValueError(f"unknown dp_mechanism {cfg.dp_mechanism!r}")
        self.defense = cfg.defense if cfg.verification else Defense.NONE

        n = cfg.num_nodes
        self.peers = _held_peers(peers, n)
        poisoned = poisoned_ids(n, cfg.poison_fraction)
        xs, ys = [], []
        for i in range(n):
            shard = ds.load_shard(cfg.dataset,
                                  ds.shard_name(cfg.dataset, i, i in poisoned))
            xs.append(shard["x_train"])
            ys.append(shard["y_train"])
        rows = min(len(x) for x in xs)  # over ALL peers (ref: sim.py:138)
        self.x = torch.from_numpy(np.stack(
            [xs[g][:rows] for g in self.peers])).to(self.device)
        self.y = torch.from_numpy(np.stack(
            [ys[g][:rows] for g in self.peers])).to(self.device)
        self.rows = rows

        test = ds.load_shard(cfg.dataset, f"{cfg.dataset}_test")
        self.x_val = torch.from_numpy(test["x_test"]).to(self.device)
        self.y_val = torch.from_numpy(test["y_test"]).to(self.device)
        attack = ds.load_shard(cfg.dataset, f"{cfg.dataset}_digit1")
        self.x_attack = torch.from_numpy(attack["x_test"]).to(self.device)
        self.y_attack = torch.from_numpy(attack["y_test"]).to(self.device)

        self.gen = torch.Generator(device=self.device)
        step = local_step_fn(self.model, self.mode, clip=cfg.grad_clip,
                             alpha=cfg.logreg_alpha)
        self._batched_step = torch.func.vmap(step, in_dims=(None, 0, 0))
        self._use_noise = cfg.noising or cfg.dp_in_model
        self._noise_eps = cfg.epsilon if self._use_noise else 0.0
        self._noise_scale = dp_noise.sigma_for(self._noise_eps, cfg.delta)
        self._noise_alpha = cfg.logreg_alpha if self.mode == "sgd" else 1.0
        self._drop_p = cfg.fault_plan.drop if cfg.fault_plan.enabled else 0.0
        if self._drop_p > 0.0 and self.defense == Defense.TRIMMED_MEAN:
            raise ValueError(
                "fault_plan.drop is not supported with defense=TRIMMED_MEAN "
                "in the simulator: the trimmed aggregate has no per-update "
                "mask to carry the drops")

    # ------------------------------------------------------------- the round

    def _span(self, name: str, it: Optional[int]):
        tel = self.telemetry
        return _NO_SPAN if tel is None else tel.span(name, it=it)

    def _whole(self, what: str) -> None:
        """Raise unless this Simulator holds every peer: `what` indexes x
        by global peer id."""
        n = self.cfg.num_nodes
        if len(self.peers) != n:
            raise ValueError(
                f"{what} needs every peer's shard, but this Simulator holds "
                f"only peers {self.peers.start}..{self.peers.stop - 1} of {n} "
                f"(peers=slice({self.peers.start}, {self.peers.stop})); "
                f"build it with peers=None for the single-device round")

    def draw_round(self, gen: torch.Generator, it: int,
                   seed: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
        """Every random choice of round `it`, re-seeding `gen` so the draws
        are pure in (seed, it) like the reference's fold_in keys; `seed`
        overrides cfg.seed. Returns cidx[S] (contributors, without
        replacement), batch_idx[S, B] (each row's minibatch, without
        replacement), noise[S, d] (DP noise, already scaled by −α/b; zeros
        when noising is off) and keep[S] (False where the fault plan drops
        the contributor's frame, drawn from the fault seed)."""
        self._whole("draw_round")
        cfg = self.cfg
        n, s = cfg.num_nodes, cfg.num_samples
        gen.manual_seed(stream_seed(cfg.seed if seed is None else seed,
                                    "round", it))
        if s >= n:
            cidx = torch.arange(n, device=self.device)
        else:
            cidx = torch.randperm(n, generator=gen, device=self.device)[:s]
        s = cidx.shape[0]
        batch_idx = sample_batch(gen, self.rows, cfg.batch_size, s)
        return cidx, batch_idx, self.draw_noise(gen, s), self.draw_keep(gen, it, s)

    def draw_noise(self, gen: torch.Generator, s: int) -> torch.Tensor:
        """s contributors' DP noise [s, d] from `gen`, already scaled by
        −α/b (ref: sim.py:185-199); zeros when noising is off."""
        cfg = self.cfg
        if self._use_noise and cfg.dp_mechanism == "mcmc13":
            # one exact Song&Sarwate'13 row a contributor, scaled as the
            # Gaussian bank is (ref: sim.py:189-199)
            return (-self._noise_alpha / cfg.batch_size) * dp_noise.knorm_draw(
                gen, self._noise_eps, s, self.num_params)
        if self._use_noise:
            return dp_noise.round_noise(gen, s, self.num_params,
                                        self._noise_scale, cfg.batch_size,
                                        self._noise_alpha)
        return torch.zeros(s, self.num_params, device=self.device)

    def draw_keep(self, gen: torch.Generator, it: int, s: int) -> torch.Tensor:
        """keep[s]: False where the fault plan drops a contributor's frame in
        round `it`, drawn from the fault seed (ref: sim.py:259-266)."""
        if self._drop_p > 0.0:
            gen.manual_seed(stream_seed(self.cfg.fault_plan.seed, "drop", it))
            return torch.rand(s, generator=gen, device=self.device) >= self._drop_p
        return torch.ones(s, dtype=torch.bool, device=self.device)

    def local_updates(self, w: torch.Tensor, cidx: torch.Tensor,
                      batch_idx: torch.Tensor,
                      noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(deltas[S, d], noised[S, d]): each contributor's step on its own
        minibatch, and the copy the verifiers see."""
        self._whole("local_updates")
        rows = cidx[:, None]
        with fp32_math():
            deltas = self._batched_step(w, self.x[rows, batch_idx],
                                        self.y[rows, batch_idx])
        return deltas, deltas + noise

    def round_step_from_draws(self, w, stake, cidx, batch_idx, noise, keep,
                              it: Optional[int] = None):
        """One round from its draws; pure. Returns (w_next, stake_next, mask,
        err). A dropped frame (keep False) was scored by the verifiers but
        joins no aggregate and moves no stake. `it` is the round that the
        layer spans carry."""
        self._whole("round_step_from_draws")
        cfg = self.cfg
        with fp32_math():
            with self._span("sim.local_step", it):
                deltas, noised = self.local_updates(w, cidx, batch_idx, noise)
            with self._span("sim.defense", it):
                mask = defense_mask(self.defense, self.model, w, noised,
                                    self.x_val, self.y_val, cfg.roni_threshold,
                                    default_num_adversaries(cidx.shape[0]))
            unit = torch.full_like(cidx, cfg.stake_unit, dtype=stake.dtype)
            delta_stake = torch.where(mask, unit, -unit)
            mask = mask & keep
            delta_stake = torch.where(keep, delta_stake, torch.zeros_like(unit))
            with self._span("sim.aggregate", it):
                w_next = w + masked_aggregate(mask, deltas, noised,
                                              cfg.dp_in_model, self.defense,
                                              cfg.trim_fraction)
            stake_next = stake.index_add(0, cidx, delta_stake)
            with self._span("sim.eval", it):
                err = self.model.error_flat(w_next, self.x_val, self.y_val)
        return w_next, stake_next, mask, err

    def round_step(self, w: torch.Tensor, stake: torch.Tensor, it: int,
                   seed: Optional[int] = None):
        self._whole("round_step")
        with self._span("sim.round", it):
            with self._span("sim.draws", it):
                draws = self.draw_round(self.gen, it, seed)
            return self.round_step_from_draws(w, stake, *draws, it)

    # ------------------------------------------------------------------ run

    def init_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        w = torch.zeros(self.num_params, dtype=torch.float32, device=self.device)
        stake = torch.full((self.cfg.num_nodes,), self.cfg.default_stake,
                           dtype=torch.int32, device=self.device)
        return w, stake

    def run(self, num_rounds: Optional[int] = None, log_every: int = 1,
            stop_at_convergence: bool = True):
        """Python round loop; returns (w, stake, logs) like the reference."""
        self._whole("run")
        if num_rounds is None:
            num_rounds = self.cfg.max_iterations
        w, stake = self.init_state()
        logs: List[RoundLog] = []
        m = self.metrics
        own = m is not None and self.telemetry is None
        if own:
            # the round histogram reads the sim.round spans
            from biscotti_tpu_torch.telemetry import Telemetry

            self.telemetry = Telemetry(device=self.device)
        seen = self.telemetry.recorder.seq if m is not None else 0
        try:
            for it in range(num_rounds):
                w, stake, mask, err = self.round_step(w, stake, it)
                logged = it % log_every == 0 or it == num_rounds - 1
                e = float(err) if logged else 0.0
                if m is not None:
                    seen = self._observe_rounds(m, seen)
                    m.gauge("biscotti_sim_round_height",
                            "simulator rounds completed").set(it + 1)
                if logged:
                    logs.append(RoundLog(it, e, time.time(), int(mask.sum())))
                    if m is not None:
                        m.gauge("biscotti_sim_error",
                                "simulator latest test error").set(e)
                    if stop_at_convergence and e < self.cfg.convergence_error:
                        break
        finally:
            if own:
                self.telemetry = None
        return w, stake, logs

    def _observe_rounds(self, m, seen: int) -> int:
        """Feed `biscotti_sim_round_seconds` from the sim.round spans
        recorded after sequence number `seen`: each span's device time on
        a device-timed Telemetry, its host time otherwise, never the two
        mixed (a span past the device clock's bound, which has no device
        time, is left out). Called every round, so the recorder's ring
        never wraps past a span unread; a span the device has not passed
        yet is read at a later round, and the last round's error read-back
        lets the device pass them all. Returns the recorder's new cursor."""
        tel = self.telemetry
        tel.flush()
        field = "dur_s" if tel.clock is None else "dev_s"
        hist = m.histogram("biscotti_sim_round_seconds",
                           "simulator round: the sim.round span's device "
                           "time on a card, its host time on the CPU")
        for ev in tel.recorder.tail_since(seen, limit=1 << 30):
            if (ev["event"] == "span" and ev["phase"] == "sim.round"
                    and field in ev):
                hist.observe(ev[field])
        return tel.recorder.seq

    def run_scan(self, num_rounds: Optional[int] = None,
                 seed: Optional[int] = None):
        """All rounds with no host in the loop: the round's tensors stay on
        the device and the errors and accept counts are read back once, at
        the end (the reference's `lax.scan`, sim.py:315-352). `seed`
        overrides cfg.seed without rebuilding the Simulator. Returns
        (w, stake, errs[num_rounds], accepted[num_rounds]) with numpy
        arrays for the last two."""
        self._whole("run_scan")
        if num_rounds is None:
            num_rounds = self.cfg.max_iterations
        w, stake = self.init_state()
        errs, accepted = [], []
        for it in range(num_rounds):
            w, stake, mask, err = self.round_step(w, stake, it, seed)
            errs.append(err)
            accepted.append(mask.sum())
        if not errs:
            return w, stake, np.zeros(0, np.float32), np.zeros(0, np.int64)
        return (w, stake, torch.stack(errs).cpu().numpy(),
                torch.stack(accepted).cpu().numpy())

    # --------------------------------------------------------------- metrics

    def test_error(self, w: torch.Tensor) -> float:
        with fp32_math():
            return float(self.model.error_flat(w.to(self.device), self.x_val,
                                               self.y_val))

    def attack_rate(self, w: torch.Tensor) -> float:
        with fp32_math():
            return float(self.model.error_flat(w.to(self.device), self.x_attack,
                                               self.y_attack))

    def attack_success_rate(self, w: torch.Tensor) -> float:
        """Fraction of attack-source samples predicted as exactly the attack
        target class (the 1→7 rate)."""
        target = ds.spec(self.cfg.dataset).attack_target
        with fp32_math():
            logits = self.model.apply_flat(w.to(self.device), self.x_attack)
        pred = torch.argmax(logits, dim=-1)
        return float((pred == target).to(torch.float32).mean())


# ---------------------------------------------------------------- sharded path


def sharded_draws(sim: Simulator, it: int, seed: int, gids: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Round `it`'s draws on the sharded path for the peers `gids`: each
    peer's minibatch rows and DP noise from its own stream,
    `stream_seed(seed, "sharded", it, gid)` (the reference's fold_in(bkey,
    gid) and fold_in(nkey, gid), sim.py:409-426), so no draw depends on
    which rank holds the peer; and the fault plane's keep mask over all N
    peers (sim.py:433-438). Returns (batch_idx[len(gids), B],
    noise[len(gids), d], keep[N]).

    A peer's rows are `sample_batch`'s: the first B of a uniform random
    permutation of its shard, the order of its own uniform keys. The keys
    of all the rank's peers are sorted in one batched, stable argsort,
    whose every row is that row's own sort."""
    keys = torch.empty(len(gids), sim.rows, device=sim.device)
    noise = []
    for i, gid in enumerate(gids):
        sim.gen.manual_seed(stream_seed(seed, "sharded", it, gid))
        torch.rand(sim.rows, generator=sim.gen, out=keys[i])
        noise.append(sim.draw_noise(sim.gen, 1))
    idx = torch.argsort(keys, dim=1, stable=True)[:, :min(sim.cfg.batch_size,
                                                         sim.rows)]
    return (idx, torch.cat(noise),
            sim.draw_keep(sim.gen, it, sim.cfg.num_nodes))


def rank_updates(sim: Simulator, x_loc: torch.Tensor, y_loc: torch.Tensor,
                 w: torch.Tensor, batch_idx: torch.Tensor,
                 noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(deltas, noised) of the peers whose data are x_loc, y_loc (a rank's
    own, in order): each one's step on its rows batch_idx, and the copy
    the verifiers see."""
    rows = torch.arange(x_loc.shape[0], device=x_loc.device)[:, None]
    with fp32_math():
        deltas = sim._batched_step(w, x_loc[rows, batch_idx],
                                   y_loc[rows, batch_idx])
    return deltas, deltas + noise


def sharded_step_from_draws(sim: Simulator, mesh, x_loc: torch.Tensor,
                            y_loc: torch.Tensor, w: torch.Tensor,
                            batch_idx: torch.Tensor, noise: torch.Tensor,
                            keep: torch.Tensor):
    """One round of the peers-across-devices step from its draws; pure.
    This rank holds the peers `local_slice(mesh, N)`: their data x_loc,
    y_loc, their rows batch_idx and noise; keep[N] covers every peer.
    Every peer contributes (S = N). One all-gather of the [N, d] noised
    updates; the accept mask over all of them, replicated on every rank
    (B1 scores the gathered pool inside its window); under TRIMMED_MEAN a
    second gather (of the raw deltas, or none in dp_in_model mode) and the
    trimmed aggregate replicated, else this rank's masked sum and one psum
    (ref: sim.py:428-457). Returns (w_next, mask[N], err), the same on
    every rank."""
    cfg, n = sim.cfg, sim.cfg.num_nodes
    mine = local_slice(mesh, n)
    with fp32_math():
        deltas, noised = rank_updates(sim, x_loc, y_loc, w, batch_idx, noise)
        all_noised = all_gather(mesh, noised)  # [N, d]
        mask = defense_mask(sim.defense, sim.model, w, all_noised, sim.x_val,
                            sim.y_val, cfg.roni_threshold,
                            default_num_adversaries(n)) & keep
        if sim.defense == Defense.TRIMMED_MEAN:
            src = all_noised if cfg.dp_in_model else all_gather(mesh, deltas)
            agg = masked_aggregate(mask, src, src, cfg.dp_in_model,
                                   sim.defense, cfg.trim_fraction)
        else:
            agg = psum(mesh, masked_aggregate(mask[mine], deltas, noised,
                                              cfg.dp_in_model))
        w_next = w + agg
        err = sim.model.error_flat(w_next, sim.x_val, sim.y_val)
    return w_next, mask, err


def make_sharded_round_step(sim: Simulator, mesh, axis: str = "peers"):
    """The peers-across-devices round step on a 1-D `DeviceMesh`
    (`parallel/mesh.py`) named `axis`, one rank a device (ref:
    sim.py:377-476). The simulator is built on this rank's device with
    `peers=local_slice(mesh, N)`, so it holds this rank's N/k shards and
    no other (the reference's `device_put` with `P(axis)`); at one rank
    that slice is every peer, and the plain Simulator serves. Returns
    `run_step(w, it, seed=None) -> (w_next, mask, err)`, replicated on
    every rank; `seed` overrides cfg.seed, as on the single-device path."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
    if sim.x.device != mesh_device(mesh):
        raise ValueError(f"the simulator's data is on {sim.x.device}, this "
                         f"rank's device is {mesh_device(mesh)}")
    mine = local_slice(mesh, sim.cfg.num_nodes)
    gids = range(mine.start, mine.stop)
    if sim.peers != gids:
        raise ValueError(
            f"the simulator holds peers {sim.peers.start}..{sim.peers.stop - 1}"
            f", this rank's slice is {gids.start}..{gids.stop - 1}: build it "
            f"with peers=local_slice(mesh, {sim.cfg.num_nodes})")

    def run_step(w: torch.Tensor, it: int, seed: Optional[int] = None):
        draws = sharded_draws(sim, it, sim.cfg.seed if seed is None else seed,
                              gids)
        return sharded_step_from_draws(sim, mesh, sim.x, sim.y, w, *draws)

    return run_step


# ------------------------------------------------------------------- CLI


def main(argv=None) -> int:
    """Standalone federated simulation on the GPU (`--device cpu` to ask for
    the CPU); prints one JSON summary line."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description="in-process N-peer simulator (PyTorch)")
    BiscottiConfig.add_args(ap)
    ap.add_argument("--rounds", type=int, default=0,
                    help="override max-iterations for the run")
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when not given")
    ap.add_argument("--scan", action="store_true",
                    help="run all rounds with no host read-back until the end")
    ap.add_argument("--csv", default="",
                    help="write iteration,error,timestamp rows here")
    ap.add_argument("--metrics-out", default="",
                    help="write a Prometheus text page of the run's "
                         "telemetry (round histogram, height/error gauges) "
                         "here; non-scan runs only")
    ns = ap.parse_args(argv)
    if ns.metrics_out and ns.scan:
        ap.error("--metrics-out requires a non-scan run (a --scan run reads "
                 "nothing back per round; there are no per-round host "
                 "observations to export)")
    cfg = BiscottiConfig.from_args(ns)
    registry = None
    if ns.metrics_out:
        from biscotti_tpu_torch.telemetry import MetricsRegistry

        registry = MetricsRegistry()
    sim = Simulator(cfg, device=ns.device, metrics=registry)
    rounds = ns.rounds or cfg.max_iterations
    if ns.scan:
        w, stake, errs, accepted = sim.run_scan(rounds)
        logs = [RoundLog(i, float(e), time.time(), int(a))
                for i, (e, a) in enumerate(zip(errs, accepted))]
    else:
        w, stake, logs = sim.run(rounds)
    if ns.csv:
        with open(ns.csv, "w") as f:
            f.write("\n".join(l.csv() for l in logs) + "\n")
    if registry is not None:
        with open(ns.metrics_out, "w") as f:
            f.write(registry.render())
    print(json.dumps({
        "dataset": cfg.dataset, "nodes": cfg.num_nodes,
        "device": (torch.cuda.get_device_name(sim.device)
                   if sim.device.type == "cuda" else "cpu"),
        "rounds_run": len(logs),
        "final_error": logs[-1].error if logs else float("nan"),
        "test_error": sim.test_error(w),
        "attack_rate": sim.attack_rate(w),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
