"""The peer agent — per-host protocol state machine (the port's
counterpart of `biscotti_tpu/runtime/peer.py`).

One asyncio process per peer, replacing the reference's Go binary
(ref: DistSys/main.go). The RPC surface is the reference's nine `Peer`
methods (SURVEY.md §2.1 row 2); round math (SGD step, DP noise, Krum/RONI,
share algebra) dispatches to the port's Trainer and ops on the peer's
device (`PeerAgent(device=...)`, the GPU unless the caller asks for the
CPU); EC crypto (commitments, Schnorr, VRF) runs on the host via
biscotti_tpu_torch.crypto, or on the armed device plane with
cfg.device_crypto.

The port differs from the reference at four seams, all device calls:
  * the verifier masks (`_decide_round`) and ENSEMBLE's Krum inputs run
    the port's ops over the pool as float32 tensors on the peer's device,
    and come back through `.cpu().numpy()`; ENSEMBLE's float64 cosine and
    residual math stays on the host, as in the reference;
  * the trimmed mean runs `ops/robust_agg.trimmed_mean_aggregate`;
  * device crypto arms on the peer's device and raises where the
    reference would fall back to the CPU (no `available()` probe);
  * `main()` has no x64 switch: the port's share math is numpy int64; its
    `--platform` (`cuda`, the default, or `cpu`) names the peer's torch
    device, the counterpart of the `JAX_PLATFORMS` the reference's peer
    processes inherit.
A device call inside a handler blocks the event loop while it runs, as the
reference's `np.asarray` on a device result does.

Round choreography (ref: SURVEY.md §3):
  worker   : compute update → noise from noisers → verifier signatures →
             shares to miners (secure-agg) or update to miners (plain)
  verifier : collect updates to threshold → Krum/RONI on device → release
             parked callers with signatures / rejections
  miner    : collect updates|shares → leader mints block at deadline →
             broadcast; everyone holds an empty-block fallback timer so the
             round ALWAYS advances (ref: main.go:2099-2143)
  noiser   : serve presampled DP noise (ref: honest.go:564-592)

FedSys mode (cfg.fedsys): fixed leader node 0, no committees/crypto, deltas
AVERAGED not summed (ref: FedSys/honest.go:311) — the baseline system as a
config flag.

Single-threaded asyncio replaces the reference's goroutine+mutex web: every
state transition happens on the event loop, so rounds are linearizable by
construction (the races patched ad-hoc in the reference, e.g.
main.go:1481-1482, cannot occur).
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import os
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from biscotti_tpu_torch.config import BiscottiConfig, Defense
from biscotti_tpu_torch.crypto import commitments as cm
from biscotti_tpu_torch.crypto import kernels as devkern
from biscotti_tpu_torch.crypto.vrf import VRFKey
from biscotti_tpu_torch.data import datasets as ds
from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.ledger.block import Block, BlockData, Update
from biscotti_tpu_torch.ledger.chain import Blockchain, ChainInvariantError
from biscotti_tpu_torch.models.trainer import Trainer
from biscotti_tpu_torch.ops import secretshare as ss
from biscotti_tpu_torch.ops import trust as trustlib
from biscotti_tpu_torch.parallel import roles as R
from biscotti_tpu_torch.tools.verdicts import poisoned_ids as _poisoned_ids
from biscotti_tpu_torch.runtime import admission as adm
from biscotti_tpu_torch.runtime import adversary
from biscotti_tpu_torch.runtime import codecs as wcodecs
from biscotti_tpu_torch.runtime import faults, rpc, wire
from biscotti_tpu_torch.runtime import overlay as ov
from biscotti_tpu_torch.runtime import placement
from biscotti_tpu_torch.runtime import protocol
from biscotti_tpu_torch.runtime import stragglers
from biscotti_tpu_torch.runtime.faults import CircuitOpenError
from biscotti_tpu_torch.runtime.rpc import BusyError, RPCError, StaleError
from biscotti_tpu_torch.telemetry import Telemetry, serve_metrics, tracectx
from biscotti_tpu_torch.tools import keygen


# keyless-mode derived keypairs, cached module-wide: in-process clusters
# construct N agents that each need all N publics — deriving them N² times
# (a base mult each) would dominate small-test startup
_keyless_pub_cache: Dict[Tuple[int, int], Tuple[bytes, bytes]] = {}


def _keyless_pubs(seed: int, node: int) -> Tuple[bytes, bytes]:
    """(schnorr_pub, vrf_noise_pub) for a keyless-mode node. The seeds are
    deterministic in (cfg.seed, id), so every peer can derive every public —
    no integrity in a hostile deployment (pass --key-dir for that), but the
    full verification code path runs in local tests."""
    key = (seed, node)
    if key not in _keyless_pub_cache:
        from biscotti_tpu_torch.crypto import ed25519 as ed

        s_seed = hashlib.sha256(f"schnorr-{seed}-{node}".encode()).digest()
        n_seed = hashlib.sha256(f"vrf-noise-{seed}-{node}".encode()).digest()
        _keyless_pub_cache[key] = (ed.public_key(s_seed),
                                   VRFKey(n_seed).public)
    return _keyless_pub_cache[key]


def _decline_message(iteration: int, sid: int) -> bytes:
    """Domain-separated payload a rejected worker signs to tell miners it
    will not contribute this round (see RoundState.miner_declined)."""
    return (b"biscotti-decline|" + int(iteration).to_bytes(8, "little")
            + int(sid).to_bytes(8, "little"))


def partial_batch_members(batch_of: Dict[int, frozenset],
                          nodes: Sequence[int]) -> List[int]:
    """Sids in `nodes` whose verification batch is NOT fully contained in
    `nodes`. The aggregated VSS check (cm.vss_verify_multi) proves
    consistency of each intake batch AS A WHOLE; error cancellation inside
    a batch is harmless only when the whole batch is aggregated, so an
    aggregate over a partial batch must re-prove exactly these members at
    the aggregation boundary (docs/NATIVE_CRYPTO.md §aggregated-vss)."""
    nset = set(nodes)
    return [n for n in nodes
            if batch_of.get(n) is None or not batch_of[n] <= nset]


@dataclass
class RoundState:
    """Everything scoped to one iteration; rebuilt on every round
    transition (the reference's flushUpdates/flushSecrets,
    ref: main.go:1096-1107)."""

    iteration: int
    verifier_pool: List[Update] = field(default_factory=list)
    verifier_sources: Set[int] = field(default_factory=set)
    krum_decision: Optional[asyncio.Future] = None
    miner_updates: Dict[int, Update] = field(default_factory=dict)
    miner_shares: Dict[int, np.ndarray] = field(default_factory=dict)
    miner_commitments: Dict[int, bytes] = field(default_factory=dict)
    # secure-agg intake is accepted OPTIMISTICALLY (digest + shape +
    # signature checks at intake); the share-vs-commitment VSS check runs
    # ONCE per round as a single batched RLC+MSM over the whole intake just
    # before shares are served/aggregated, with per-worker fallback to
    # identify offenders when the batch fails
    miner_vss: Dict[int, Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict)
    # (comms, blinds) retained for sids that passed verification, plus the
    # batch each sid was verified IN: the aggregated check is sound for an
    # aggregate covering a WHOLE batch, so serving any partial batch
    # re-checks exactly the partial members against these records (see
    # docs/NATIVE_CRYPTO.md §aggregated-vss and _ensure_subset_consistent)
    miner_vss_records: Dict[int, Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict)
    miner_vss_batch: Dict[int, frozenset] = field(default_factory=dict)
    vss_lock: asyncio.Lock = field(default_factory=asyncio.Lock)
    # worker-provided verifier signatures, carried into the minted block's
    # update records so block quorums are re-verifiable by every receiver
    # and by future joiners adopting the chain
    miner_sigs: Dict[int, Tuple[List[int], List[bytes]]] = field(
        default_factory=dict)
    # this round's share-point slice for our miner index, FROZEN at round
    # start: the deferred intake verification must never consult the next
    # round's committee if a block lands mid-check
    my_xs: Optional[List[int]] = None
    # sources whose submission failed cryptographic verification this round:
    # carried into the minted block as accepted=False records and debited
    # STAKE_UNIT (ref: honest.go:363-370 debits rejected block updates)
    miner_rejected: Dict[int, Update] = field(default_factory=dict)
    # sampled workers that signed a DECLINE notice (their update was
    # refused by the verifier committee, so they will not contribute):
    # completes the miner's have+rejected >= NUM_SAMPLES mint condition,
    # which otherwise can never fire when Krum approves fewer than the
    # mint target (short pools accept pool − pool//2) and the round rides
    # the full update deadline — observed as ~90 s stalls in ~4% of
    # rounds at N=100
    miner_declined: Set[int] = field(default_factory=set)
    # the one aggregation set this miner will serve this round: releasing
    # aggregates over a SECOND, different subset would let a malicious
    # leader difference the two sums and unmask an individual update
    served_part: Optional[List[int]] = None
    # incremental VSS intake accumulator (cfg.batch_intake,
    # crypto/commitments.VssIntakeBatch): arriving share slices are
    # folded into one running point sum in waves, so mint-time
    # verification is just the RLC settle — the grid-summation lump the
    # one-shot batch check paid on the critical path amortizes across
    # the round's network wait. Consumed (set back to None) when a
    # batch retires; later arrivals start a fresh accumulator.
    vss_accum: Optional[cm.VssIntakeBatch] = None
    # plain-mode intake micro-batch (cfg.batch_intake): updates arriving
    # in a burst after the defense decision wait here ~one event-loop
    # beat and are verified as ONE batched RLC commitment check, with
    # bisection identifying offenders exactly as the sequential
    # recompute would (crypto/commitments.batch_verify_commitments).
    # A LIST, not a per-sid dict: every submission is verified against
    # its OWN payload — a Byzantine double-send with the same source_id
    # but different bytes must not inherit the first copy's verdict
    plain_pending: List[Tuple[Update, asyncio.Future]] = field(
        default_factory=list)
    plain_drainer: Optional[asyncio.Task] = None
    # hierarchical aggregation overlay (cfg.overlay, docs/OVERLAY.md) —
    # MINER side: whole-subtree aggregates accepted via
    # RegisterAggregate. A group entry holds the summed share-row slice,
    # the homomorphically summed commitment grid, and the summed blind
    # tensor; miner_group_of maps each member sid to its group so the
    # mint/serve paths treat a subtree as one atomic intake component
    # (servable whole or not at all — the group sum cannot be subset).
    miner_groups: Dict[frozenset, Dict] = field(default_factory=dict)
    miner_group_of: Dict[int, frozenset] = field(default_factory=dict)
    # RELAY side: co-hosted workers' OverlayOffer payloads buffered until
    # the flush (all expected leaves offered, or the window expired);
    # flushed sids are remembered so a late wave aggregates separately
    # instead of double-counting
    relay_offers: Dict[int, Dict] = field(default_factory=dict)
    relay_flushed: Set[int] = field(default_factory=set)
    relay_task: Optional[asyncio.Task] = None
    block_done: Optional[asyncio.Event] = None
    tasks: List[asyncio.Task] = field(default_factory=list)


class PeerAgent:
    def __init__(self, cfg: BiscottiConfig, key_dir: str = "",
                 log_path: str = "", ckpt_dir: str = "", ckpt_every: int = 10,
                 stepper=None, hive=None, light_trainer: bool = False,
                 ticket: Optional[Dict] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        # the one device of this peer: its Trainer, the verifier masks,
        # the trimmed mean and the armed crypto plane run there (None:
        # the GPU, which must exist; the CPU only when asked for)
        self.device = resolve_device(device)
        # peers-as-devices mode: a shared BatchStepper (or the hive's
        # HiveStepper) computes ALL local peers' SGD deltas in one
        # batched device call per round (runtime/device_cluster.py,
        # runtime/hive.py); None = per-agent trainer dispatch
        self.stepper = stepper
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = max(1, ckpt_every)
        self.id = cfg.node_id
        self.converged = False
        self.total_updates = 0

        poisoned = _poisoned_ids(cfg.num_nodes, cfg.poison_fraction)
        shard = ds.shard_name(cfg.dataset, self.id, self.id in poisoned)
        # light trainers (hive co-hosting) hold no per-peer train shard
        # or noise bank — the shared stepper serves both; eval splits and
        # metric fns remain (models/trainer.py docstring)
        self.trainer = Trainer(cfg.dataset, shard, cfg=cfg, seed=self.id,
                               light=light_trainer, device=self.device)
        self.chain = Blockchain(self.trainer.num_params, cfg.num_nodes,
                                cfg.default_stake)

        # peers: id -> (host, port); file format = host:port per line
        # (ref: peersfile.txt, README.md:49-66)
        self.peers: Dict[int, Tuple[str, int]] = {}
        if cfg.peers_file:
            with open(cfg.peers_file) as f:
                for i, addr in enumerate(a.strip() for a in f if a.strip()):
                    host, port = addr.rsplit(":", 1)
                    self.peers[i] = (host, int(port))
        else:
            for i in range(cfg.num_nodes):
                self.peers[i] = (cfg.my_ip, cfg.port_of(i))
        # membership: evicted peers stop receiving RPCs but keep their slot
        # in the id space (ref: main.go:1479-1482 — peerLookup never shrinks)
        self.alive: Set[int] = set(self.peers)
        # reverse address map for _peer_for_addr; kept in sync with the one
        # mutation site (_h_register_peer address updates)
        self._addr_to_pid: Dict[Tuple[str, int], int] = {
            addr: pid for pid, addr in self.peers.items()}

        # identity keys: from the dealer when provided, else derived
        # deterministically from (seed, id) so local tests need no keygen
        if key_dir:
            all_keys = keygen.load_node_keys(key_dir)
            keys = all_keys[str(self.id)]
            self.schnorr_seed = bytes.fromhex(keys["schnorr_seed"])
            self.noise_vrf = VRFKey(bytes.fromhex(keys["vrf_noise_seed"]))
            self.node_pubs = {
                int(i): bytes.fromhex(k["schnorr_pub"])
                for i, k in all_keys.items()
            }
            self.noise_pubs = {
                int(i): bytes.fromhex(k["vrf_noise_pub"])
                for i, k in all_keys.items()
            }
            self.commit_key = keygen.load_commit_key(key_dir)
        else:
            self.schnorr_seed = hashlib.sha256(
                f"schnorr-{cfg.seed}-{self.id}".encode()).digest()
            self.noise_vrf = VRFKey(hashlib.sha256(
                f"vrf-noise-{cfg.seed}-{self.id}".encode()).digest())
            pubs = {i: _keyless_pubs(cfg.seed, i)
                    for i in range(cfg.num_nodes)}
            self.node_pubs = {i: p[0] for i, p in pubs.items()}
            self.noise_pubs = {i: p[1] for i, p in pubs.items()}
            self.commit_key = None

        self.timeouts = cfg.timeouts  # already-scaled instance may be passed
        self.pool = rpc.Pool()  # persistent multiplexed connections
        # outbound dials must never squat on a cluster LISTEN port: on
        # hosts whose ephemeral range covers the protocol ports a pooled
        # connection could otherwise hold the source port another
        # co-hosted peer needs to bind (rpc.open_frame_stream redials)
        self.pool.avoid_local_ports = frozenset(
            p for _, p in self.peers.values())
        # wire data plane (runtime/codecs.py, docs/WIRE_PLANE.md): the
        # configured codec pipeline, our advertised capability set, and
        # what each peer advertised back (absent = assume legacy raw64).
        # Lossy stages project the delta BEFORE commitment/noising/
        # sharing (see _worker_flow) and the mint rounds global_w onto
        # the downcast grid (see _create_block), so the wire itself is
        # always bit-exact and all crypto survives compression.
        self.wire = wcodecs.get(cfg.wire_codec)
        # versioned protocol plane (runtime/protocol.py,
        # docs/PROTOCOL.md): ONE advertised feature set for every
        # negotiated family — codec stages, chunking, trace stamping,
        # busy-status, snapshot bootstrap, overlay relay — derived from
        # the config and (when --protocol-version pins an old row)
        # capped to that historical version's features. Feature tokens
        # ride the hello's existing `codecs` list: old builds ignore
        # unknown tokens and codec negotiation is all-or-raw64 over the
        # stages alone, so the extension is wire-compatible both ways.
        self.caps = protocol.advertised(cfg)
        # features we speak that a given peer's hello did not grant —
        # re-derived at every hello so the readout tracks restarts;
        # emission (feature_degraded trace + counter) deduped per
        # observed set in _record_caps
        self._degraded_seen: Dict[int, frozenset] = {}
        # hierarchical aggregation overlay (runtime/overlay.py,
        # docs/OVERLAY.md): the deterministic per-round tree this peer
        # routes bulk fan-out through. Inactive (seed-identical flat
        # fan-out) unless cfg.overlay armed a real group size.
        self.overlay = ov.Router.from_config(cfg)
        # relay flush window: how long an interior node waits for the
        # rest of its subtree's offers before shipping a partial
        # aggregate (late offers aggregate as a second wave) — scaled
        # off the share deadline so fast-timeout harness clusters flush
        # promptly while production keeps a wide batching window
        self.overlay_window_s = min(2.0, self.timeouts.share_s / 8)
        self.peer_caps: Dict[int, frozenset] = {}
        # top-k error-feedback residual (what sparsification dropped,
        # fed forward into next round's delta) — per-peer state: each
        # worker owns exactly one, for its own update stream
        self._ef_residual: Optional[np.ndarray] = None
        self._topk_k = max(1, int(round(cfg.wire_topk
                                        * self.trainer.num_params)))
        # per-peer circuit breaker (consecutive transport failures open it;
        # half-open probing re-closes it) — quarantined peers fail fast in
        # _call and are skipped by gossip fan-out instead of burning the
        # round budget re-timing-out (runtime/faults.py)
        self.health = faults.HealthLedger(
            threshold=cfg.breaker_threshold,
            cooldown_s=cfg.breaker_cooldown_s)
        if cfg.fault_plan.enabled:
            # deterministic chaos plane: every outbound frame's fate is a
            # pure function of (fault seed, src, dst, msg_type, attempt)
            self.pool.faults = faults.FaultInjector(
                cfg.fault_plan, self.id, self._peer_for_addr)
        # overload-governance plane (runtime/admission.py): ALWAYS
        # constructed — the inflight/parked accounting and the snapshot
        # schema exist either way — but only an ENABLED plan wires
        # enforcement into the RPC server boundary and arms the
        # slow-loris read deadline; a disabled plan admits everything
        # and parks without bound (the seed behavior)
        self.admission = adm.AdmissionController(cfg.admission_plan)
        # peers that answered BusyError this round: retried with backoff
        # (never breaker-fed) and DEPRIORITIZED by gossip fan-out until
        # the round advances — an overloaded peer gets breathing room,
        # not quarantine
        self._busy_peers: Dict[int, int] = {}
        # with a peers file the PORT layout is the dealer's, not
        # base_port+id arithmetic; the bind ADDRESS stays cfg.my_ip — the
        # peers-file entry is how others reach us, which behind NAT is not
        # a local interface we could bind
        bind_port = (self.peers[self.id][1] if cfg.peers_file
                     else cfg.port_of(self.id))
        self.server = rpc.RPCServer(cfg.my_ip, bind_port, self._handle)
        # straggler-tolerance plane (runtime/stragglers.py,
        # docs/STRAGGLERS.md): this peer's seeded speed profile (the
        # `slow` fault kind — NO_SLOW unless the plan drew us), the
        # adaptive deadline controller (answers the legacy Timeouts
        # constants verbatim until armed AND warmed), and the forensics
        # ledger (waiting-on view, excluded-straggler and stall tallies).
        # The per-RPC service delay lives on the TRANSPORT seam — the
        # TCP server dispatch and the hive loopback dispatch both read
        # server.service_delay_s — so TCP and co-hosted layouts serve
        # identically slow from one seeded schedule.
        self.slow = cfg.fault_plan.slow_profile(self.id, cfg.num_nodes)
        self.server.service_delay_s = self.slow.service_s
        self.deadlines = stragglers.DeadlineController(
            enabled=cfg.adaptive_deadlines, margin=cfg.deadline_margin,
            floor_s=cfg.deadline_floor_s)
        self.straggler = stragglers.StragglerLedger()
        self._round_t0 = time.monotonic()
        self.round = RoundState(iteration=self.chain.next_iteration)
        self.role_map = R.RoleMap({i: 1 for i in range(cfg.num_nodes)})
        self.logs: List[Tuple[int, float, float]] = []  # iter, err, ts
        # per-event counters: every traced protocol event is tallied here so
        # harnesses can assert on security/attack accounting without log
        # scraping (ref: the reference prints attack counters at exit,
        # main.go:1071-1088)
        self.counters: Dict[str, int] = {}
        # unified telemetry plane (biscotti_tpu/telemetry): metrics
        # registry + round-correlated spans + flight recorder. The old
        # per-event write()+flush() JSONL log (`log_path`) becomes the
        # recorder's batched spill; the old ad-hoc PhaseClock lives inside
        # Telemetry and still backs run()'s legacy `phases` key.
        self.tele = Telemetry(node=self.id, enabled=cfg.telemetry,
                              ring=cfg.recorder_ring, spill_path=log_path,
                              spill_batch=cfg.recorder_batch,
                              # per-peer labels (biscotti_breaker_state)
                              # must fit the whole cluster before the
                              # cardinality cap starts collapsing series
                              max_label_sets=max(256, 4 * cfg.num_nodes),
                              trace=cfg.trace)
        # per-phase wall-clock accounting (SURVEY §5.1): totals come back
        # in run()'s result; eval/eval_cost_breakdown.py aggregates them
        self.phases = self.tele.phases
        if cfg.telemetry:
            # transport + fault-plane + admission instrumentation share
            # the registry
            self.pool.metrics = self.tele.registry
            self.server.metrics = self.tele.registry
            if self.pool.faults is not None:
                self.pool.faults.metrics = self.tele.registry
            self.admission.metrics = self.tele.registry
            self.trainer.metrics = self.tele.registry
            self.straggler.metrics = self.tele.registry
        # accelerator-resident crypto plane (crypto/kernels,
        # docs/CRYPTO_KERNELS.md): the arming switch AND the instrument
        # hooks are process-wide — mixed device/CPU peers in ONE process
        # are unsupported (every real deployment runs one config per
        # process; in-process harnesses arm whole clusters), and in a
        # co-hosted harness the LAST-constructed peer's telemetry
        # receives every crypto_device span/observation (aggregate
        # totals stay correct; per-node attribution is a known harness
        # approximation). Armed with telemetry on, the kernel call sites
        # emit `crypto_device` spans + the biscotti_crypto_device_seconds
        # histogram, so profile_round / trace_round can split the crypto
        # critical path into crypto_cpu vs crypto_device. Any
        # non-qualifying construction CLEARS the hooks so a torn-down
        # cluster's telemetry never keeps receiving kernel events.
        # armed means armed: the port's plane raises on a device fault
        # instead of finishing on the CPU, and arming on a missing GPU
        # raises here (the reference's `available()` probe has no
        # counterpart). Co-hosted peers share the one armed device.
        devkern.set_enabled(cfg.device_crypto, device=self.device)
        self.device_crypto = cfg.device_crypto
        self._devkern_span_hook = None
        self._devkern_registry = None
        if cfg.device_crypto and cfg.telemetry:
            self._devkern_span_hook = (
                lambda kernel: self.tele.span("crypto_device",
                                              kernel=kernel))
            self._devkern_registry = self.tele.registry
            devkern.set_metrics_registry(self._devkern_registry)
            devkern.set_span_hook(self._devkern_span_hook)
        else:
            devkern.set_metrics_registry(None)
            devkern.set_span_hook(None)
        # the controller is wired into the server UNCONDITIONALLY so the
        # inflight accounting (and its gauges) is live even in
        # observability-only runs; a DISABLED plan admits everything
        # inside try_admit, so enforcement — and the read deadline —
        # only engage when the plan is armed
        self.server.admission = self.admission
        if cfg.admission_plan.enabled:
            self.server.read_deadline = cfg.admission_plan.read_deadline_s
        # reply-codec capability set for the RPC server: callers request
        # a reply codec via `acodec`, granted iff inside OUR caps
        self.server.caps = self.caps
        # a version pin predating the busy feature sheds with the old
        # build's plain-error reply (no structured retryable status)
        self.server.busy_status = protocol.BUSY in self.caps
        # distributed tracing: arm the transport seams' receiver-side
        # dispatch spans (rpc.RPCServer._dispatch + the hive loopback
        # dispatch both read server.telemetry); None keeps the seed
        # span-free dispatch path
        if self.tele.trace:
            self.server.telemetry = self.tele
        # hive co-hosting (runtime/hive.py, docs/HIVE.md): register with
        # the process-local LoopbackHub and attach it to the pool, so
        # RPCs toward co-hosted peers skip TCP framing and serialization
        # while still flowing through the fault draw, the destination's
        # admission controller, and the wire byte counters. `hive_info`
        # is the hive's shared readout dict (peers, RSS, loop lag),
        # surfaced under telemetry_snapshot()["hive"]; `_announce_skip`
        # names co-hosted peers made mutually known at construction, so
        # a genesis hive launch skips the O(H²) intra-hive hello storm.
        self.hive_info: Optional[Dict] = None
        self._announce_skip: frozenset = frozenset()
        if hive is not None:
            hive.register(self)
            self.pool.loopback = hive
            self.pool.loopback_src = self.id
        self._metrics_server = None
        self._rng = random.Random(cfg.seed * 7919 + self.id)
        # strong refs to fire-and-forget tasks: the loop only keeps weak
        # references, so an unreferenced parked task can be GC'd mid-sleep
        self._bg_tasks: Set[asyncio.Task] = set()
        # speculative next-round worker products (cfg.pipeline +
        # cfg.speculation): the SGD delta (and, when no state-mutating
        # transform sits between them, the quantized update + VSS
        # commitment) for (iteration, base head hash), computed in the
        # background the moment a block lands. Consumed by _worker_flow
        # iff the base still matches; a fork discards it with a traced
        # counter (speculation_discard)
        self._spec: Optional[Dict] = None
        self._spec_task: Optional[asyncio.Task] = None
        self._spec_key: Optional[Tuple[int, bytes]] = None
        # the (it, head) an inflight _spec_task is actually computing
        # for — _claim_spec awaits the task only when ITS target matches
        # (a retargeted _spec_key must not make the worker wait out a
        # doomed stale speculation)
        self._spec_task_key: Optional[Tuple[int, bytes]] = None
        # (iteration, sid) pairs already granted a pipelined
        # pre-verification — caps early-crypto CPU per round (see
        # _pipelined_iteration); pruned at every round start
        self._preverify_gate: Set[Tuple[int, int]] = set()
        # share-point layouts are fixed for the whole run — built once
        # instead of per round / per blind-row evaluation (the xs list
        # was rebuilt on every _vss_blind_rows call and the recovery
        # Vandermonde per mint; ops/secretshare memoizes the matching
        # pseudoinverse)
        self._xs_all = [int(x) - ss.SHARE_OFFSET
                        for x in range(cfg.total_shares)]
        self._xs_arr = np.asarray(self._xs_all, np.int64)
        # block hashes whose verifier quorums this peer already
        # authenticated (_block_quorums_ok memo). Entries are keyed on the
        # COMPUTED hash of the verified block, never the sender's claimed
        # hash, so a relabeled genuine block cannot seed the cache for a
        # forged block that claims the same hash. Insertion-ordered dict =
        # LRU eviction of the stalest entry.
        self._quorum_ok_hashes: Dict[bytes, None] = {}
        # membership plane (docs/MEMBERSHIP.md): the epoch counts this
        # peer's OBSERVED membership transitions — a peer quarantined
        # (left), a quarantined peer rehabilitated or a new hello from a
        # non-alive id (joined), a resharing round run. Local by design
        # (membership in a P2P system is a per-observer view); the gauge
        # + join/leave counters make churn scrapeable mid-run
        self.membership_epoch = 0
        # rounds at which OUR OWN seeded churn schedule kills this peer
        # (--fault-churn; the in-process ChurnRunner instead kills from
        # the outside, which also covers hard-crash semantics)
        self._churn_kills: frozenset = frozenset()
        if cfg.fault_plan.churn_enabled:
            self._churn_kills = frozenset(
                e.round for e in cfg.fault_plan.churn_schedule(
                    cfg.num_nodes, cfg.max_iterations)
                if e.node == self.id and e.kind == faults.KILL)
        # adaptive-adversary campaign plane (runtime/adversary.py,
        # docs/ADVERSARY.md): armed only on the peers the plan draws as
        # attackers — every other peer (and every disabled plan) runs
        # the seed protocol untouched, allocation-free. Decisions are
        # pure functions of (campaign seed, observed protocol state),
        # so a campaign run replays from its flags like any fault run.
        self.campaign = adversary.build(cfg.campaign_plan, self.id,
                                        cfg.num_nodes, cfg.seed)
        # latest round this peer actually submitted an update for — how
        # the campaign reads its own submission's fate out of the next
        # block (absent record after a submission = rejected)
        self._campaign_submitted: int = -1
        if self.campaign is not None:
            if cfg.telemetry:
                self.campaign.metrics = self.tele.registry
            # frame-level actions ride the fault plane's injector seam;
            # construct one even when no frame faults are armed (a
            # disabled plan draws benign for every frame, so only the
            # campaign's targeted replays fire)
            if self.pool.faults is None:
                self.pool.faults = faults.FaultInjector(
                    cfg.fault_plan, self.id, self._peer_for_addr)
                if cfg.telemetry:
                    self.pool.faults.metrics = self.tele.registry
            self.pool.faults.campaign = self.campaign
            # identity recycling rides the churn self-kill seam: the
            # sybil schedule's kills join ours, and the launcher
            # (ChurnRunner / chaos --campaign / any supervisor)
            # relaunches the fresh incarnation
            self._churn_kills = frozenset(
                self._churn_kills
                | self.campaign.kill_rounds(cfg.max_iterations))
        # adaptive defense plane (ops/trust.py, docs/DEFENSES.md): the
        # cross-round TrustLedger is constructed ONLY under
        # --defense ENSEMBLE — every other defense runs the seed verdict
        # path with no ledger object at all (bit-identity guarded by
        # tests/test_trust.py). Independently of the ledger, every
        # verifier records a bounded per-round verdict stream
        # (accept/reject walk + observed magnitudes) so attack-matrix
        # cells carry the hugger's walk as replayable evidence even for
        # the defenses it defeats.
        self.trust: Optional[trustlib.TrustLedger] = (
            trustlib.TrustLedger(cfg.trust_plan, cfg.num_nodes)
            if cfg.defense == Defense.ENSEMBLE else None)
        self._verdict_stream: List[Dict] = []
        # elastic fleet plane (runtime/placement.py, docs/PLACEMENT.md):
        # GetMigrationTicket serves this peer's serialized state ONLY to
        # a caller presenting the drain token its controller installed —
        # None (the default) refuses every request, so an unmanaged peer
        # cannot be drained (or have its EF residual read) over the wire
        self._drain_token: Optional[str] = None
        # genesis DKG deal intake (crypto/dkg.py): dealer id -> verified
        # deal, populated by the DkgDeal RPC during a live ceremony
        self._dkg_deals: Dict[int, object] = {}
        if ticket is not None:
            # migrated incarnation: rehydrate chain (through the guarded
            # snapshot-adoption path), breaker ledger, admission buckets,
            # EF residual, and round position from the controller's
            # ticket — run() then announces and catches up live
            placement.restore_agent(self, ticket)

    # ------------------------------------------------------------ utilities

    @property
    def iteration(self) -> int:
        return self.chain.next_iteration

    def _trace(self, event: str, **kw) -> None:
        """Structured per-round event log (SURVEY.md §5.1: the TPU build's
        replacement for the reference's timestamped text logs). Events go
        to the flight recorder — in-memory ring + BATCHED JSONL spill with
        (wall, monotonic, seq) stamps — not straight to disk: the old
        per-event write()+flush() was two syscalls on the hot path for
        every gossip receipt and share intake. The recorder is flushed at
        round end and on shutdown/crash (telemetry/recorder.py)."""
        self.counters[event] = self.counters.get(event, 0) + 1
        self.tele.event(event, it=self.iteration, **kw)

    # ----------------------------------------------------------- telemetry

    _BREAKER_LEVEL = {faults.CLOSED: 0, faults.HALF_OPEN: 1, faults.OPEN: 2}

    def _refresh_gauges(self) -> None:
        """Pull-model gauges, recomputed at scrape time (Metrics RPC /
        HTTP exposition / run() result) rather than pushed on the hot
        path: round height, liveness, and per-peer breaker state."""
        if not self.tele.enabled:
            return
        reg = self.tele.registry
        reg.gauge("biscotti_round_height",
                  "blockchain iteration this peer is at").set(self.iteration)
        reg.gauge("biscotti_converged",
                  "1 once the convergence threshold was met").set(
            int(self.converged))
        reg.gauge("biscotti_alive_peers",
                  "peers currently in the gossip liveness set").set(
            len(self.alive))
        breaker = reg.gauge(
            "biscotti_breaker_state",
            "per-peer circuit breaker: 0 closed, 1 half-open, 2 open")
        for pid, h in self.health.snapshot().items():
            breaker.set(self._BREAKER_LEVEL.get(h["state"], 2), peer=pid)
        # admission levels, pull-refreshed so a scrape is never stale
        # (the controller also pushes on change)
        reg.gauge(adm.INFLIGHT_GAUGE, adm.INFLIGHT_HELP).set(
            self.admission.inflight_total)
        reg.gauge(adm.PARKED_GAUGE, adm.PARKED_HELP).set(
            len(self.admission.parking))
        # pipelined-round readout (docs/RUNTIME.md §Pipelined rounds):
        # configured overlap depth plus the speculation ledger — hits are
        # rounds whose SGD/commit came precomputed, discards are
        # speculative steps a fork (or head mismatch) threw away
        reg.gauge("biscotti_pipeline_depth",
                  "rounds of cross-round phase overlap (0 = serial)").set(
            self.cfg.pipeline_depth if self.cfg.pipeline else 0)
        reg.gauge("biscotti_speculation_hits",
                  "speculative worker steps consumed by the round").set(
            self.counters.get("speculation_hit", 0))
        reg.gauge("biscotti_speculation_discards",
                  "speculative worker steps discarded on fork/mismatch").set(
            self.counters.get("speculation_discard", 0))
        # overlay plane (docs/OVERLAY.md): tree shape of the armed
        # aggregation overlay — flat (depth 1) when disabled
        if self.overlay.enabled:
            reg.gauge(ov.DEPTH_GAUGE, ov.DEPTH_HELP).set(self.overlay.depth)
            reg.gauge(ov.SUBTREE_GAUGE, ov.SUBTREE_HELP).set(
                len(self.overlay.members(self.overlay.gid_of(self.id))))
        # membership plane (docs/MEMBERSHIP.md): this peer's view of who
        # is in, and how many times that view has changed
        reg.gauge("biscotti_membership_epoch",
                  "observed membership transitions (join/leave/reshare)"
                  ).set(self.membership_epoch)
        # straggler plane (docs/STRAGGLERS.md): this peer's emulated
        # slowdown and the controller's current per-phase deadline
        # decisions — a scrape shows at a glance whether (and how far)
        # the fleet has tightened the legacy constants
        reg.gauge("biscotti_slow_compute_factor",
                  "this peer's emulated compute-slowdown multiple "
                  "(1 = unslowed)").set(self.slow.compute_factor)
        dl = reg.gauge(stragglers.DEADLINE_GAUGE, stragglers.DEADLINE_HELP)
        for ph, row in self.deadlines.snapshot()["phases"].items():
            if "deadline_s" in row:
                dl.set(row["deadline_s"], phase=ph)
        # adaptive defense plane (docs/DEFENSES.md): this verifier's
        # per-peer ledger scores — slow-trust weight x (1 − drift score),
        # zeroed while a peer is flagged or held
        if self.trust is not None:
            tg = reg.gauge(trustlib.TRUST_METRIC, trustlib.TRUST_HELP)
            for pid, score in self.trust.trust_scores().items():
                tg.set(score, peer=str(pid))

    def _release_device_hooks(self) -> None:
        """Teardown half of the device-crypto arming: drop the
        process-global kernel instrument hooks IF this agent installed
        them (identity-compared — a later live agent's hooks are left
        untouched). Without this, the span closure pins the whole agent
        object graph for the process lifetime and a torn-down cluster's
        telemetry keeps receiving kernel events."""
        if self._devkern_span_hook is not None or \
                self._devkern_registry is not None:
            devkern.release_hooks(span_hook=self._devkern_span_hook,
                                  registry=self._devkern_registry)

    def telemetry_snapshot(self) -> Dict:
        """THE public observability readout — one structured dict serving
        the `Metrics` RPC, the run() result's `telemetry` key, the chaos
        CLI, and the test suites (which used to reach into
        `pool.faults.counts` and private peer dicts; docs/OBSERVABILITY.md
        documents the schema). JSON-clean: label keys are strings."""
        self._refresh_gauges()
        return {
            "node": self.id,
            "iter": self.iteration,
            "converged": self.converged,
            "counters": dict(self.counters),
            "phases": self.phases.summary(),
            "health": {str(p): dict(v)
                       for p, v in self.health.snapshot().items()},
            "faults": (dict(self.pool.faults.counts)
                       if self.pool.faults is not None else {}),
            "metrics": self.tele.registry.snapshot(),
            # overload-governance readout (runtime/admission.py): shed
            # tallies by reason, current + peak inflight/parked levels,
            # and the configured caps — the chaos report and the flood
            # acceptance assertions (bounded peaks, nonzero sheds on
            # honest peers) read THIS, not private controller state
            "admission": self.admission.snapshot(),
            # membership plane (docs/MEMBERSHIP.md): epoch + current
            # alive view — the obs CLI's membership column and the churn
            # harness assertions read this
            "membership": {"epoch": self.membership_epoch,
                           "alive": len(self.alive),
                           "pruned_before": self.chain.pruned_before},
            # straggler-tolerance plane (docs/STRAGGLERS.md): this peer's
            # speed profile, the waiting-on view / excluded + stall
            # tallies, and the deadline controller's per-phase state —
            # the obs `waiting-on` column and the chaos `stragglers`
            # report key read exactly this
            "stragglers": {
                "profile": {"compute_factor": self.slow.compute_factor,
                            "service_s": self.slow.service_s,
                            "preset": self.slow.preset,
                            "slowed": self.slow.slowed},
                **self.straggler.snapshot(),
                "deadlines": self.deadlines.snapshot(),
            },
            # the recorder may be real even with telemetry disabled (an
            # explicit spill path keeps the event log alive) — report
            # whatever it actually holds
            "recorder": {"events": getattr(self.tele.recorder, "_seq", 0),
                         "wrapped": self.tele.recorder.wrapped},
            # hive co-hosting readout (runtime/hive.py): the shared
            # per-hive dict (id, co-hosted peer count, RSS, event-loop
            # lag) the obs CLI groups its per-host columns by. None for
            # a standalone agent.
            "hive": dict(self.hive_info) if self.hive_info else None,
            # versioned-protocol readout (docs/PROTOCOL.md): the version
            # this peer speaks (pinned or current), its advertised
            # feature set, and the features currently degraded per peer
            # — the mixed-version matrix and the soak harness read this
            "protocol": protocol.snapshot(self.cfg, self.caps,
                                          self._degraded_seen),
            # aggregation-overlay readout (docs/OVERLAY.md): tree shape
            # plus this peer's aggregated/relayed/fallback tallies — the
            # obs overlay table and the chaos report's `overlay` key
            # merge exactly this
            "overlay": {
                "enabled": self.overlay.enabled,
                "group_size": self.overlay.group,
                "depth": self.overlay.depth,
                "aggregated": self.counters.get(
                    "overlay_aggregate_registered", 0),
                "aggregates_sent": self.counters.get(
                    "overlay_aggregate_sent", 0),
                "offers": (self.counters.get("overlay_offer_sent", 0)
                           + self.counters.get("overlay_offer_local", 0)),
                "relayed": self.counters.get("overlay_relayed_sent", 0),
                "forwarded": self.counters.get(
                    "overlay_relay_forwarded", 0),
                "direct": (self.counters.get("overlay_offer_fallback", 0)
                           + self.counters.get("overlay_relay_fallback",
                                               0)),
                "fallback": (self.counters.get(
                    "overlay_aggregate_refused", 0)
                    + self.counters.get("overlay_fallback_forwarded", 0)),
            },
            # device-crypto readout (docs/CRYPTO_KERNELS.md): present
            # only when --device-crypto is armed, so the disarmed
            # snapshot schema stays byte-identical to the seed. The
            # seconds/calls tallies are the kernel plane's process-wide
            # accumulators (one armed cluster per process).
            **({"device_crypto": {
                "enabled": True,
                "active": devkern.active(),
                "seconds": devkern.device_seconds(),
                "calls": devkern.device_calls(),
            }} if self.cfg.device_crypto else {}),
            # adversary-campaign readout (docs/ADVERSARY.md): present
            # only on an ARMED attacker peer, so the honest/disabled
            # snapshot schema stays byte-identical to the seed. The
            # `schedule` list is the deterministic decision log the
            # layout-invariance tests compare; actions/targets_hit are
            # execution tallies.
            **({"campaign": self.campaign.snapshot()}
               if self.campaign is not None else {}),
            # adaptive-defense readout (docs/DEFENSES.md): present only
            # when the ENSEMBLE ledger is armed or this peer recorded
            # verifier verdicts, so every other snapshot schema stays
            # byte-identical to the seed. `stream` is the per-round
            # accept/reject walk (+ observed magnitudes and, under
            # ENSEMBLE, per-peer scorer votes) that attack-matrix cell
            # rows and obs.merge_trust read; `ledger` is the TrustLedger
            # state the layout-invariance tests compare.
            **({"trust": {
                "defense": self.cfg.defense.value,
                "stream": list(self._verdict_stream),
                **({"ledger": self.trust.snapshot()}
                   if self.trust is not None else {}),
            }} if (self.trust is not None or self._verdict_stream)
               else {}),
        }

    async def _h_metrics(self, meta, arrays):
        """Live exposition over the protocol transport: any peer (or the
        `tools.obs` scraper) can pull this node's Prometheus text + the
        structured snapshot mid-run; `{"tail": n}` additionally returns
        the newest n flight-recorder events. Read-only — safe for any
        caller (it reveals nothing an observer of the gossip plane could
        not already infer)."""
        reply = {"snapshot": self.telemetry_snapshot(),
                 "prom": self.tele.render()}
        tail = int(meta.get("tail", 0) or 0)
        since = meta.get("since_seq")
        if tail > 0 or since is not None:
            # the recorder tolerates unserializable field values (its
            # spill uses default=str) but the wire codec is strict JSON —
            # sanitize the same way before the events enter the reply
            import json as _json

            page = min(tail, 1000) if tail > 0 else 1000
            if since is not None:
                # incremental poll (tools/obs --watch, tools/trace_round):
                # only events past the caller's cursor, a bounded page at
                # a time — re-fetching the full ring every scrape is what
                # this cursor exists to stop. `last_seq` advances the
                # cursor even on an empty page; a first event with
                # seq > since_seq + 1 means the ring wrapped past the
                # cursor (the poller fell behind eviction).
                try:
                    since = max(0, int(since))
                except (TypeError, ValueError):
                    raise RPCError("since_seq must be an integer")
                events = self.tele.recorder.tail_since(since, limit=page)
                reply["last_seq"] = (events[-1]["seq"] if events
                                     else max(since, self.tele.recorder.seq))
            else:
                events = self.tele.recorder.tail(page)
            reply["seq"] = self.tele.recorder.seq
            reply["events"] = _json.loads(_json.dumps(events, default=str))
        return reply, {}

    def _sign(self, message: bytes) -> bytes:
        return cm.schnorr_sign(self.schnorr_seed, message)

    def _quantize_np(self, delta: np.ndarray) -> np.ndarray:
        """Protocol-plane quantization (ref: kyber.go:698-710), done in
        numpy on the host so worker commit and miner re-verify are
        bit-identical regardless of which backend jitted the update."""
        scale = 10.0 ** self.cfg.precision
        return np.trunc(np.asarray(delta, np.float64) * scale).astype(np.int64)

    def _commit(self, q: np.ndarray) -> bytes:
        if self.commit_key is not None:
            return cm.commit_update(q, self.commit_key)
        # keyless local mode: binding-only hash commitment
        return hashlib.sha256(q.tobytes()).digest()

    def _verify_plain_commitment(self, u: Update) -> bool:
        """Miner-side recompute-and-compare (ref: kyber.go:564-577)."""
        q = self._quantize_np(u.delta)
        if self.commit_key is not None:
            return cm.verify_commitment(u.commitment, q, self.commit_key)
        return hashlib.sha256(q.tobytes()).digest() == u.commitment

    @staticmethod
    def _sig_message(commitment: bytes, iteration: int, source_id: int) -> bytes:
        """Domain-separated verifier-approval message. Binding the iteration
        and source prevents cross-round replay of an old approval (the
        commitment alone is round-independent) and signature transplantation
        between sources."""
        return (b"biscotti-approve" + commitment
                + int(iteration).to_bytes(8, "little", signed=True)
                + int(source_id).to_bytes(8, "little", signed=True))

    def _verify_sig_quorum(self, commitment: bytes, iteration: int,
                           source_id: int, signers: List[int],
                           signatures: List[bytes]) -> bool:
        """≥ half the round's verifiers must have Schnorr-signed the
        (commitment, iteration, source) approval message (ref: main.go:1686 —
        the reference counts signatures; its miner-side verify,
        kyber.go:898-925, was written but disabled. Here each claimed
        (signer, sig) pair is actually verified).

        Fast path: the whole quorum in ONE batched RLC Schnorr check
        (cm.batch_schnorr_verify — a single MSM instead of one
        double-mult per signature). Honest quorums are all-valid, so the
        batch passing proves every claimed pair and the count is just
        len(items); any failure falls back to the original per-signature
        loop, whose verdict (count the valid subset, tolerate junk
        entries) is preserved bit-for-bit."""
        msg = self._sig_message(commitment, iteration, source_id)
        verifiers, _, _, _ = self.role_map.committee()
        vset = set(verifiers)
        need = max(1, (len(vset) + 1) // 2)
        items: List[Tuple[bytes, bytes, bytes]] = []
        seen: Set[int] = set()
        for vid, sig in zip(signers, signatures):
            if vid not in vset or vid in seen:
                continue
            pub = self.node_pubs.get(vid)
            if not pub:
                continue
            seen.add(vid)
            items.append((pub, msg, sig))
        if len(items) >= need and cm.batch_schnorr_verify(items):
            return True
        # batch failed (or thin): per-signature scan, EXACTLY the
        # pre-batch semantics — e.g. a duplicate signer whose first
        # entry is junk but whose second is valid still counts here,
        # where the deduped batch above could not see the second
        valid: Set[int] = set()
        for vid, sig in zip(signers, signatures):
            if vid not in vset or vid in valid:
                continue
            pub = self.node_pubs.get(vid)
            if pub and cm.schnorr_verify(pub, msg, sig):
                valid.add(vid)
        return len(valid) >= need

    def _peer_for_addr(self, host: str, port: int) -> Optional[int]:
        """(host, port) → peer id, for the fault plane's per-link keying —
        O(1) off the cached reverse map (the fault plane consults this for
        EVERY outbound frame; a linear scan would be O(N²) comparisons per
        gossip round on the event loop)."""
        return self._addr_to_pid.get((host, port))

    def _grant(self, pid: int) -> frozenset:
        """The negotiated per-peer feature set: our advertised features
        ∩ what `pid`'s hello advertised (raw64 floor; no hello yet =
        assume a legacy build). Every per-peer feature decision — codec,
        chunking, trace stamping, relay routing, snapshot donors —
        consults this grant (runtime/protocol.py, docs/PROTOCOL.md)."""
        return protocol.grant(self.caps, self.peer_caps.get(pid))

    def _wire_to(self, pid: int) -> Tuple[str, int]:
        """(codec, chunk_bytes) to use toward `pid`: the configured
        pipeline when the grant carries every stage, else raw64/
        unchunked — the graceful fallback that keeps legacy (or
        legacy-configured, or version-pinned) peers interoperable."""
        if self.peer_caps.get(pid) is None:
            return wcodecs.RAW, 0
        g = self._grant(pid)
        codec = wcodecs.negotiate(self.cfg.wire_codec, g)
        chunk = self.cfg.wire_chunk_bytes if wcodecs.CHUNK_CAP in g else 0
        return codec, chunk

    def _reply_codec_meta(self, pid: int) -> Dict[str, int]:
        """Meta keys asking `pid` to code/chunk its REPLY (the
        Accept-Encoding of this protocol) — set on calls whose reply
        carries the bulk (GetBlock bodies, RegisterPeer chain
        adoption). Peers that don't understand them ignore them."""
        codec, chunk = self._wire_to(pid)
        out: Dict[str, int] = {}
        if codec != wcodecs.RAW:
            out["acodec"] = codec
        if chunk:
            out["achunk"] = chunk
        return out

    def _peer_traces(self, pid: int) -> bool:
        """True when trace context should ride frames toward `pid`:
        WE trace and the peer advertised the `trace` capability in its
        hello — the same all-or-nothing negotiation the wire codecs use,
        so legacy peers (and mixed clusters) get untouched frames."""
        return self.tele.trace and protocol.TRACE in self._grant(pid)

    def _record_caps(self, pid: int, caps) -> None:
        """Record a peer's advertised capability set from a hello or a
        hello reply. The legacy-hello reset rule lives in ONE place —
        protocol.normalize_hello: a hello WITHOUT a capability set
        resets the entry to raw64-only, so a peer that restarted on a
        legacy build stops receiving coded/stamped/relayed frames
        immediately instead of keeping its previous incarnation's caps.
        Features WE speak that the new hello does not grant are traced
        (`feature_degraded{feature,peer}`) and counted, once per
        observed set — a re-hello with the same caps is silent, an
        upgrade clears the entry, a downgrade re-emits."""
        recorded = protocol.normalize_hello(caps)
        self.peer_caps[pid] = recorded
        lost = protocol.degraded(self.caps, recorded)
        if lost == self._degraded_seen.get(pid, frozenset()):
            return
        self._degraded_seen[pid] = lost
        for feat in sorted(lost):
            self._trace("feature_degraded", feature=feat, peer=pid)
            if self.tele.enabled:
                self.tele.registry.counter(
                    protocol.DEGRADED_METRIC, protocol.DEGRADED_HELP,
                ).inc(feature=feat, peer=str(pid))

    def _peer_busy(self, pid: int) -> bool:
        """True while `pid` is deprioritized for gossip: it answered
        BusyError during the CURRENT round. Round-scoped on purpose —
        overload is transient, and a new round is fresh evidence either
        way (a still-busy peer re-marks itself on the next busy reply)."""
        return self._busy_peers.get(pid) == self.iteration

    def _bump_epoch(self, change: str, peer: Optional[int] = None) -> None:
        """One observed membership transition: epoch++, traced + counted
        (`member_join` / `member_leave` / `reshare_round`) so churn is
        visible on every scrape surface (docs/MEMBERSHIP.md)."""
        self.membership_epoch += 1
        self._trace(f"member_{change}" if change in ("join", "leave")
                    else change,
                    peer=peer, epoch=self.membership_epoch)

    def _record_peer_ok(self, peer_id: int) -> None:
        """One RPC toward `peer_id` proved the transport healthy: reset its
        failure streak and, if the breaker was tripped, close it."""
        if self.health.record_success(peer_id):
            self._trace("breaker_close", peer=peer_id)
            if peer_id not in self.alive:
                # rejoined the live set via OUR outbound probe (no inbound
                # frame announced it first — the inbound seam in _handle
                # owns that case, so one rejoin is never counted twice)
                self._bump_epoch("join", peer_id)
        self.alive.add(peer_id)

    def _record_peer_fail(self, peer_id: int) -> None:
        if self.health.record_failure(peer_id):
            self._trace("breaker_open", peer=peer_id)
            self._bump_epoch("leave", peer_id)

    async def _call(self, peer_id: int, msg_type: str, meta=None, arrays=None,
                    timeout: Optional[float] = None,
                    retries: Optional[int] = None):
        """RPC with the reference's timeout-evict semantics
        (ref: main.go:1460-1487), hardened for partial faults:

        * transport failures (timeout / refused / reset) are RETRIED up to
          cfg.rpc_retries times with exponential backoff + decorrelated
          jitter — a single lost frame no longer costs the round its call
        * protocol replies are FATAL, never retried: RPCError is the
          callee's answer, StaleError is a signal (triggers catch-up) —
          both prove the transport healthy and feed the breaker as success
        * a peer whose breaker is OPEN fails fast with CircuitOpenError
          (a ConnectionError) without dialing; after the cooldown one
          half-open probe decides re-admission (runtime/faults.py)

        Each attempt keys a fresh fault-plane draw (the attempt number is
        part of the schedule), so under injection a retry is a genuinely
        new frame, not a replay of the same doomed one.
        """
        host, port = self.peers[peer_id]
        timeout = timeout or self.timeouts.rpc_s
        if not self.health.allow(peer_id):
            self._trace("rpc_fast_fail", peer=peer_id)
            self.alive.discard(peer_id)
            raise CircuitOpenError(f"peer {peer_id} quarantined")
        # if allow() just granted us the HALF-OPEN probe slot, we must hand
        # it back should this call die before any outcome lands (cancelled,
        # or a non-transport error like a codec bug) — otherwise the slot
        # leaks and the peer stays quarantined forever
        i_am_probe = self.health.state(peer_id) == faults.HALF_OPEN
        attempts = 1 + (self.cfg.rpc_retries if retries is None else retries)
        backoff = faults.backoff_schedule(
            self._rng, self.cfg.rpc_backoff_base_s,
            self.cfg.rpc_backoff_cap_s)
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            if attempt:
                # re-checked AFTER the backoff sleep: a CONCURRENT call
                # toward this peer may have tripped the breaker while we
                # slept — dialing anyway would violate the quarantine
                if not self.health.allow(peer_id):
                    break
                if self.health.state(peer_id) == faults.HALF_OPEN:
                    i_am_probe = True  # that allow() claimed the slot
            try:
                codec, chunk = self._wire_to(peer_id)
                # distributed tracing: each ATTEMPT is its own wire
                # exchange, so each gets its own client span whose id
                # rides the frame (`_tr`) — the receiver's dispatch span
                # adopts it as parent, and the request/reply midpoints
                # of exactly this span pair are what trace_round's
                # clock-offset estimator aligns on
                if self._peer_traces(peer_id):
                    ctx = self.tele.new_ctx()
                    send_meta = tracectx.stamp(meta, ctx)
                    span = self.tele.span("rpc_call", it=self.iteration,
                                          ctx=ctx, peer=peer_id,
                                          msg=msg_type)
                else:
                    send_meta, span = meta, contextlib.nullcontext()
                with span:
                    out = await self.pool.call(host, port, msg_type,
                                               send_meta, arrays, timeout,
                                               attempt=attempt, codec=codec,
                                               chunk_bytes=chunk)
                self._record_peer_ok(peer_id)
                return out
            except StaleError:
                # the callee is ahead of us: pull the blocks we're missing
                # in the background (the reference instead parks the CALLEE,
                # main.go:1211-1214; pulling heals faster after partitions)
                self._record_peer_ok(peer_id)
                self._schedule_catch_up(peer_id)
                raise
            except BusyError as e:
                # overload signal, NOT a fault (docs/ADMISSION.md): the
                # busy reply PROVES the transport and the peer healthy, so
                # the breaker must not advance — a busy honest peer must
                # never be quarantined. Retry with the same backoff the
                # transport plane uses, and deprioritize the peer for this
                # round's gossip fan-out so it gets breathing room.
                self._record_peer_ok(peer_id)
                self._busy_peers[peer_id] = self.iteration
                last = e
                if attempt + 1 >= attempts:
                    break
                self._trace("rpc_busy_retry", peer=peer_id, msg=msg_type,
                            attempt=attempt + 1)
                await asyncio.sleep(next(backoff))
            except RPCError:
                self._record_peer_ok(peer_id)
                raise
            except (asyncio.TimeoutError, ConnectionError, OSError) as e:
                last = e
                self._record_peer_fail(peer_id)
                if attempt + 1 >= attempts \
                        or self.health.state(peer_id) != faults.CLOSED:
                    break  # budget spent, or the breaker tripped mid-loop
                self._trace("rpc_retry", peer=peer_id, msg=msg_type,
                            attempt=attempt + 1)
                await asyncio.sleep(next(backoff))
            except BaseException:
                # cancellation, or an error OUTSIDE the transport set (e.g.
                # a codec bug encoding the payload): no breaker outcome was
                # recorded, so a held half-open probe slot must be handed
                # back or the peer stays quarantined indefinitely
                if i_am_probe:
                    self.health.release_probe(peer_id)
                raise
        assert last is not None
        if isinstance(last, BusyError):
            # budget exhausted against a BUSY peer: it is alive and
            # healthy — do not evict it from the gossip liveness set
            self._trace("rpc_busy_give_up", peer=peer_id, msg=msg_type)
            raise last
        self.alive.discard(peer_id)
        raise last

    def _schedule_catch_up(self, pid: int) -> None:
        if getattr(self, "_catching_up", False):
            return
        self._catching_up = True

        async def go():
            try:
                for _ in range(self.cfg.max_iterations):
                    it = self.iteration
                    host, port = self.peers[pid]
                    try:
                        bmeta, barrays = await self.pool.call(
                            host, port, "GetBlock",
                            {"iteration": it,
                             **self._reply_codec_meta(pid)},
                            timeout=self.timeouts.rpc_s)
                    except Exception:
                        break
                    blk = wire.unpack_block(bmeta, barrays)
                    if blk.hash != blk.compute_hash():
                        break
                    self._accept_block(blk, gossip=False)
                    if self.iteration <= it:
                        break  # no progress: stop pulling
                    self._trace("caught_up_block", height=it)
            finally:
                self._catching_up = False

        t = asyncio.get_running_loop().create_task(go())
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)

    # --------------------------------------------------------------- roles

    def _elect_role_map(self) -> R.RoleMap:
        """The role map the CURRENT chain state elects — pure read, so
        the speculation plane can ask "will I be a worker next round?"
        the moment a block lands, before the round machinery runs
        (ref: main.go:497-527). FedSys: node 0 is the eternal miner
        (ref: FedSys/main.go:758-768)."""
        cfg = self.cfg
        if cfg.fedsys:
            return R.RoleMap.build(cfg.num_nodes, verifiers=[],
                                   miners=[0], noisers=[])
        stake = self.chain.latest_stake_map()
        try:
            verifiers, miners = R.elect_committees(
                stake, self.chain.latest_hash(), cfg.num_verifiers,
                cfg.num_miners, cfg.num_nodes)
        except ValueError:
            # debits can zero out enough nodes that the staked population no
            # longer covers the committees; fall back to a uniform one-
            # ticket lottery — deterministic, so every peer still agrees
            self._trace("lottery_uniform_fallback")
            verifiers, miners = R.elect_committees(
                {i: 1 for i in range(cfg.num_nodes)},
                self.chain.latest_hash(), cfg.num_verifiers,
                cfg.num_miners, cfg.num_nodes)
        return R.RoleMap.build(cfg.num_nodes, verifiers, miners)

    def _compute_roles(self) -> None:
        self.role_map = self._elect_role_map()

    def _noiser_draw(self) -> R.NoiserDraw:
        """Private stake-weighted noiser lottery + the VRF proof that binds
        it to (our key, latest block hash) — noisers verify the proof before
        serving (ref: vrf.go:54-99 returns the proof; the capability its
        returned-but-unchecked proof existed for)."""
        return R.elect_noisers(
            self.noise_vrf, self.chain.latest_stake_map(),
            self.chain.latest_hash(), self.id, self.cfg.num_noisers,
            self.cfg.num_nodes)

    async def _own_noise(self, it: int) -> np.ndarray:
        """This peer's DP noise vector for `it` — from the per-agent
        presample bank, or (hive co-hosting with a light trainer) from
        the shared stepper's batched per-round draw. Deterministic per
        (peer, iteration) either way, so a noiser serves the same vector
        on every request for a round."""
        if self.trainer.light:
            return await self.stepper.noise(self.id, it)
        return self.trainer.get_noise(it)

    # -------------------------------------------------- campaign plane

    def _campaign_observe(self, it: int) -> None:
        """Per-round adversary observation (docs/ADVERSARY.md): feed the
        campaign exactly what a real attacker at this peer can see — the
        public committee election (a pure function of chain state every
        peer computes anyway) and its own submission's fate in the
        latest block — and trace the decisions it returns. Pure in
        (campaign seed, observed chain state), so the same seed yields
        the identical action schedule on any transport layout."""
        verifiers, miners, _, _ = self.role_map.committee()
        accepted_last: Optional[bool] = None
        blk = self.chain.latest
        if self._campaign_submitted >= 0 \
                and blk.iteration == self._campaign_submitted:
            # we submitted for the round this block settled: accepted iff
            # our record rides it with accepted=True (a verifier
            # rejection leaves no record at all — also a False)
            accepted_last = any(u.source_id == self.id and u.accepted
                                for u in blk.data.deltas)
        decided = self.campaign.observe_round(
            it, miners=sorted(miners), verifiers=list(verifiers),
            accepted_last=accepted_last)
        if decided:
            self._trace("campaign_round", campaign=self.campaign.name,
                        **decided)

    def _campaign_honest_step(self) -> Optional[np.ndarray]:
        """The attacker's estimate of one honest accepted delta: the
        latest block's applied aggregate (global_w difference). Under
        the default sum aggregation (Biscotti SUMS accepted deltas, see
        _create_block) that difference is divided by the accepted
        count; TRIMMED_MEAN applies a per-coordinate MEAN, so the
        difference is already one-delta scale. Chain-derived only —
        nothing here an observer of the gossip plane could not
        compute (the aggregation rule is public config)."""
        cur = self.chain.latest
        if cur.iteration < 0:
            return None
        prev = self.chain.get_block(cur.iteration - 1)
        if prev is None:
            return None  # pruned away (snapshot-bootstrapped attacker)
        n_acc = sum(1 for u in cur.data.deltas if u.accepted)
        if n_acc == 0:
            return None
        step = cur.data.global_w - prev.data.global_w
        if self.cfg.defense == Defense.TRIMMED_MEAN:
            return step
        return step / float(n_acc)

    def _campaign_shape(self, it: int, delta: np.ndarray) -> np.ndarray:
        """Adaptive-poison post-processing of OUR OWN delta (the one
        thing an attacker may always tamper with): blend toward the
        observed honest step at the campaign's current scale, plus the
        seeded per-attacker decorrelation jitter. The campaign decides
        (scale, jitter seed, jitter fraction); the arithmetic lives
        here where numpy does."""
        sh = self.campaign.shape(it)
        if sh is None:
            return delta
        scale, jitter_seed, jitter_frac = sh
        est = self._campaign_honest_step()
        if est is None:
            est = np.zeros_like(delta)
        shaped = est + scale * (delta - est)
        if jitter_frac > 0.0:
            rng = np.random.default_rng(jitter_seed)
            j = rng.standard_normal(delta.shape)
            nj = float(np.linalg.norm(j))
            ref = float(np.linalg.norm(est)) or float(np.linalg.norm(delta))
            if nj > 0.0 and ref > 0.0:
                shaped = shaped + j * (jitter_frac * ref / nj)
        self._trace("campaign_poison", scale=round(float(scale), 4))
        return np.asarray(shaped, delta.dtype)

    # ------------------------------------------------- straggler plane

    async def _slow_pad(self, base_s: float) -> None:
        """Compute-slowdown emulation (docs/STRAGGLERS.md): pad a just-
        measured compute segment to `compute_factor` x its duration. The
        pad is an event-loop sleep, so a slow peer's compute takes
        longer WITHOUT burning host CPU other co-hosted peers need —
        and because it is derived from the measured duration, chains
        and protocol bytes are bit-identical to the unslowed run; only
        the timing changes. No-op for an unslowed profile."""
        f = self.slow.compute_factor
        if f > 1.0 and base_s > 0.0:
            await asyncio.sleep(base_s * (f - 1.0))

    def _deadline(self, phase: str, legacy: float) -> float:
        """One deadline decision through the controller, traced when it
        tightens the legacy constant (scrape-visible via the
        biscotti_deadline_seconds gauge in _refresh_gauges)."""
        decided = self.deadlines.deadline(phase, legacy)
        if decided < legacy:
            self._trace("deadline_adaptive", phase=phase,
                        deadline_s=round(decided, 3), legacy_s=legacy)
        return decided

    async def _gather_quorum(self, phase: str, calls: Dict[int, object],
                             need: int, legacy_s: float) -> int:
        """Collection-point fan-out with partial-quorum graceful
        degradation. `calls` maps peer id -> coroutine returning truthy
        on success (its side effects carry the actual payload). Plane
        DISARMED (cfg.adaptive_deadlines off): plain gather over the
        same coroutines — the seed behavior, to the await. Armed: wait
        for everyone until the phase's soft deadline (the controller's
        estimate, clamped to `legacy_s`), then proceed the moment
        `need` successes exist, CANCELLING the laggards — each counted
        in biscotti_straggler_excluded_total{phase} and traced. A
        cancelled _call records no breaker outcome (its BaseException
        path hands back any probe slot), and nothing here touches
        stake: an excluded honest straggler is an observability event,
        never evidence. The waiting-on view tracks the pending set
        either way; completed-phase durations feed the controller so a
        later adaptive run warms up from history. Returns the success
        count."""
        if not calls:
            return 0
        tasks = {pid: asyncio.ensure_future(c) for pid, c in calls.items()}
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        armed = self.cfg.adaptive_deadlines
        soft_s = self._deadline(phase, legacy_s) if armed else legacy_s

        def successes() -> int:
            return sum(1 for t in tasks.values()
                       if t.done() and not t.cancelled()
                       and t.exception() is None and t.result())

        try:
            while True:
                pending = {pid: t for pid, t in tasks.items()
                           if not t.done()}
                self.straggler.waiting(phase, pending)
                if not pending:
                    # everyone answered: a full observation the
                    # controller learns the phase's distribution from
                    self.deadlines.observe(phase, loop.time() - t0)
                    break
                elapsed = loop.time() - t0
                if armed and elapsed >= soft_s and successes() >= need:
                    excluded = sorted(pending)
                    for t in pending.values():
                        t.cancel()
                    await asyncio.gather(*pending.values(),
                                         return_exceptions=True)
                    self.straggler.exclude(phase, excluded)
                    self._trace("straggler_excluded", phase=phase,
                                peers=excluded,
                                waited_s=round(elapsed, 3))
                    break
                timeout = (max(0.02, soft_s - elapsed)
                           if (armed and elapsed < soft_s) else None)
                await asyncio.wait(pending.values(), timeout=timeout,
                                   return_when=(
                                       asyncio.FIRST_COMPLETED
                                       if elapsed >= soft_s and armed
                                       else asyncio.ALL_COMPLETED))
        finally:
            self.straggler.clear(phase)
            for t in tasks.values():
                if not t.done():
                    t.cancel()
        return successes()

    # ---------------------------------------------------------- RPC surface

    async def _handle(self, msg_type, meta, arrays):
        # any inbound RPC proves the caller is reachable: re-admit it to the
        # gossip set (eviction is otherwise permanent, so a peer that
        # recovered from a partition or restart would never again receive
        # pushes from us; ref parity gap — main.go:1479-1482 only re-adds
        # on RegisterPeer)
        src = meta.get("source_id")
        if src is not None:
            try:
                src = int(src)
                if src in self.peers:
                    if src not in self.alive and src != self.id:
                        # first frame from outside our live view: a late
                        # joiner's hello, a restart, or an evicted peer
                        # resurfacing — a membership transition, observed
                        # at the earliest possible point (this seam runs
                        # before any handler, so the hello-path check in
                        # _h_register_peer would always see it alive)
                        self._bump_epoch("join", src)
                    self.alive.add(src)
                    # inbound traffic is liveness evidence for the THEM→US
                    # path only: it expires a tripped breaker's cooldown so
                    # our next outbound call probes immediately (a restart's
                    # announce re-admits without waiting out the cooldown),
                    # but it must NOT reset the outbound failure streak — an
                    # asymmetrically partitioned peer (reachable inbound,
                    # dead outbound) has to stay quarantinable
                    self.health.note_inbound(src)
            except (TypeError, ValueError):
                pass
        dispatch = {
            "RegisterPeer": self._h_register_peer,
            "RegisterBlock": self._h_register_block,
            "AdvertiseBlock": self._h_advertise_block,
            "GetBlock": self._h_get_block,
            "RegisterUpdate": self._h_register_update,
            "RegisterSecret": self._h_register_secret,
            "RegisterDecline": self._h_register_decline,
            "RequestNoise": self._h_request_noise,
            "VerifyUpdateKRUM": self._h_verify_update,
            "VerifyUpdateRONI": self._h_verify_update,
            "GetUpdateList": self._h_get_update_list,
            "GetMinerPart": self._h_get_miner_part,
            "GetSnapshot": self._h_get_snapshot,
            "GetReshareDeal": self._h_get_reshare_deal,
            "Metrics": self._h_metrics,
            # hierarchical aggregation overlay (docs/OVERLAY.md)
            "OverlayOffer": self._h_overlay_offer,
            "RegisterAggregate": self._h_register_aggregate,
            "RelayFrames": self._h_relay_frames,
            # elastic fleet plane (docs/PLACEMENT.md)
            "GetMigrationTicket": self._h_get_migration_ticket,
            "DkgDeal": self._h_dkg_deal,
        }
        h = dispatch.get(msg_type)
        if h is None or not protocol.serves(self.caps, msg_type):
            # second arm: a --protocol-version pin answers feature-gated
            # messages introduced after its row exactly like the old
            # build it emulates — unknown method (runtime/protocol.py)
            raise RPCError(f"unknown method {msg_type}")
        return await h(meta, arrays)

    async def _wait_for_iteration(self, it: int, budget: float = 30.0) -> None:
        """Park a future-iteration message until we catch up
        (ref: main.go:1211-1214, krum.go:240-243). Iterations past the
        run's absolute end are refused IMMEDIATELY — parking them would
        let one hostile packet pin a handler task for the full budget.
        Anything inside [0, max_iterations] stays parkable: a peer far
        behind can legitimately leap there via one chain adoption.

        Parking is a COUNTED, CAPPED resource (runtime/admission.py):
        with an enabled admission plan, the lot sheds its OLDEST waiter
        (woken into a retryable BusyError) instead of growing without
        bound — the pre-admission behavior let one hostile peer park
        thousands of 30-second handler tasks for free."""
        if it > self.cfg.max_iterations:
            raise RPCError("iteration beyond reachable horizon")
        if self.iteration >= it:
            return  # no wait, no parking accounting
        tok = self.admission.park("wait_iteration")
        try:
            deadline = time.monotonic() + budget
            while self.iteration < it:
                if tok.shed is not None:
                    raise BusyError("parked waiter shed: " + tok.shed)
                if time.monotonic() > deadline:
                    raise RPCError("caller too far ahead")
                await asyncio.sleep(0.05)
        finally:
            self.admission.unpark(tok)

    async def _wait_round_ready(self, it: int, budget: float = 30.0) -> RoundState:
        """Park until OUR round state for iteration `it` exists — callers may
        race ahead of a peer that is still bootstrapping or mid-transition
        (the reference blocks such callers the same way, krum.go:240-243).
        Returns the ready RoundState; raises StaleError if we are already
        past `it`. Parked time is budgeted by the admission plane's
        parking lot, same as _wait_for_iteration."""
        await self._wait_for_iteration(it, budget)
        if self.iteration > it:
            raise StaleError()
        st = self.round
        if st.iteration == it and st.krum_decision is not None:
            return st  # fast path: round already live, no parking
        tok = self.admission.park("wait_round_ready")
        try:
            deadline = time.monotonic() + budget
            while True:
                if self.iteration > it:
                    raise StaleError()
                st = self.round
                if st.iteration == it and st.krum_decision is not None:
                    return st
                if tok.shed is not None:
                    raise BusyError("parked waiter shed: " + tok.shed)
                if time.monotonic() > deadline:
                    raise RPCError("round never became ready")
                await asyncio.sleep(0.02)
        finally:
            self.admission.unpark(tok)

    async def _h_register_peer(self, meta, arrays):
        """Join/announce: record the caller, return our chain so they can
        adopt the longest one (ref: main.go:950-1024 — which returns the
        full chain unconditionally; at bootstrap that is N² chain bodies
        on the wire, ~30 s of pure encode at N=150 single-box). The caller
        states how many blocks it already holds and we reply with the
        chain only when ours is strictly longer — peers at the same height
        converge through block gossip and the advertise/pull catch-up, not
        the join path."""
        pid = int(meta["source_id"])
        if "host" in meta and "port" in meta:
            self.peers[pid] = (meta["host"], int(meta["port"]))
            self._addr_to_pid[self.peers[pid]] = pid
            self.pool.avoid_local_ports = frozenset(
                p for _, p in self.peers.values())
        self.alive.add(pid)  # join transitions bump in _handle's seam
        # wire-plane negotiation: record the caller's codec capability
        # set (absent in a legacy hello → it stays raw64-only) and
        # advertise ours in the reply, so both ends of a first contact
        # leave knowing what the other can decode
        self._record_caps(pid, meta.get("codecs"))
        # omit iff our chain would LOSE fork choice against the caller's
        # claimed key — same (weight, length) rule as maybe_adopt, so an
        # isolation survivor padded with empty blocks (long but light)
        # still receives the heavier honest chain. Claims are advisory:
        # overclaiming only denies the claimant a chain it would have
        # refused to adopt anyway; the adopted chain itself is verified.
        caller_key = (int(meta.get("have_weight", 0)),
                      int(meta.get("have_blocks", 0)))
        # `no_chain`: a snapshot-bootstrapping joiner's hello — it will
        # pull a sealed suffix via GetSnapshot instead, so replying with
        # the full chain here would silently re-pay exactly the genesis
        # replay the snapshot path exists to avoid. A PRUNED server also
        # omits: its gap-containing chain decodes as a contiguous
        # candidate the receiver's quorum gate is guaranteed to refuse,
        # so shipping it is pure wasted bulk — the caller should pull
        # GetSnapshot (clusters mixing snapshot_bootstrap=0 joiners with
        # all-pruned peers have no announce-path catch-up by design;
        # docs/MEMBERSHIP.md §snapshot).
        if meta.get("no_chain") or self.chain.pruned_before \
                or self.chain.adoption_key() <= caller_key:
            return {"chain_omitted": True,
                    "snapshot_available": bool(self.chain.pruned_before),
                    "codecs": sorted(self.caps)}, {}
        cmeta, carrays = wire.pack_chain(self.chain.blocks)
        cmeta["codecs"] = sorted(self.caps)
        return cmeta, carrays

    async def _h_register_block(self, meta, arrays):
        blk = wire.unpack_block(meta, arrays)
        self._accept_block(blk, gossip=True)
        return {}, {}

    async def _h_advertise_block(self, meta, arrays):
        """Header-only gossip: pull the body from the advertiser iff we do
        not already hold this block (see _gossip_block). An advert AHEAD
        of our round means we also miss ancestors (a lost broadcast frame
        for an earlier block) — a single-height pull could not extend the
        chain, so catch up block-by-block from the advertiser instead."""
        it = int(meta["iteration"])
        h = bytes.fromhex(meta.get("hash", ""))
        src = int(meta.get("source_id", -1))
        have = self.chain.get_block(it)
        if have is not None and have.hash == h:
            return {}, {}
        if src not in self.peers:
            return {}, {}
        if it > self.iteration:
            self._schedule_catch_up(src)
            return {}, {}

        async def pull():
            try:
                if self.overlay.enabled:
                    # overlay pull backoff (docs/OVERLAY.md): with the
                    # tree armed, our subtree's relay is most likely
                    # mid-forward of this very body — an instant pull
                    # would re-fetch it cross-host and undo the
                    # deduplication (observed as a GetBlock.reply storm
                    # when the minter's OWN hive advertises over
                    # loopback before the remote relay finishes its 50
                    # co-hosted deliveries). Poll the chain for a
                    # bounded window, jittered so expiring waiters don't
                    # stampede; a dead relay costs a few seconds of
                    # extra latency, never the round.
                    deadline = (time.monotonic() + 3.0
                                + 1.5 * self._rng.random())
                    while time.monotonic() < deadline:
                        have2 = self.chain.get_block(it)
                        if have2 is not None and have2.hash == h:
                            return
                        if self.iteration > it:
                            return
                        await asyncio.sleep(0.25)
                bmeta, barrays = await self._call(
                    src, "GetBlock",
                    {"iteration": it, **self._reply_codec_meta(src)},
                    timeout=self.timeouts.rpc_s)
                blk = wire.unpack_block(bmeta, barrays)
                if blk.hash == blk.compute_hash():
                    self._accept_block(blk, gossip=True)
            except Exception:
                pass

        t = asyncio.get_running_loop().create_task(pull())
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)
        return {}, {}

    async def _h_get_block(self, meta, arrays):
        """Serve a block body to a puller (the chain doubles as the block
        store; ref: the reference serves its chain via RegisterPeer,
        main.go:431-433 — this is the single-block variant)."""
        it = int(meta["iteration"])
        blk = self.chain.get_block(it)
        if blk is None:
            raise RPCError(f"no block at iteration {it}")
        return wire.pack_block(blk)

    # ----------------------------------------------- membership: snapshot

    async def _h_get_snapshot(self, meta, arrays):
        """Serve a chain SNAPSHOT to a bootstrapping joiner
        (docs/MEMBERSHIP.md): genesis + the last `snapshot_tail`+1 sealed
        blocks — the +1 is the trust-anchor base whose stake map seeds
        the suffix's quorum verification — plus an advisory weight claim
        for the pruned-away range. Bulk-classed at admission, chunked by
        the wire plane like any oversized reply; read-only and safe for
        any caller (the chain is public gossip either way). The joiner
        names the tail it wants (its own snapshot_tail); absent, the
        server's policy applies — over-asking merely degrades toward the
        full chain RegisterPeer would have served anyway."""
        chain = self.chain
        tail = max(1, int(meta.get("tail", 0) or 0)
                   or self.cfg.snapshot_tail)
        suffix = chain.blocks[1:]
        dropped: List[Block] = []
        if len(suffix) > tail + 1:
            dropped = suffix[:-(tail + 1)]
            suffix = suffix[-(tail + 1):]
        pruned_weight = (chain.pruned_weight
                         + sum(1 for b in dropped if not b.is_empty()))
        cmeta, carrays = wire.pack_chain([chain.blocks[0]] + suffix)
        cmeta["snapshot"] = {
            "pruned_weight": pruned_weight,
            "base_height": suffix[0].iteration if suffix else -1,
        }
        self._trace("snapshot_served",
                    base=cmeta["snapshot"]["base_height"],
                    blocks=len(suffix))
        return cmeta, carrays

    # ------------------------------------- elastic fleet: migration, DKG

    async def _h_get_migration_ticket(self, meta, arrays):
        """Serve this peer's migration ticket to its placement
        supervisor (docs/PLACEMENT.md). Token-gated and one-shot: the
        supervisor installs a drain token on this agent out of band
        (controller seam / supervisor process boundary) before asking;
        any caller without it — which includes every ordinary peer,
        since tickets carry the breaker ledger, admission buckets and
        EF residual — gets a refusal, not state."""
        token = str(meta.get("token", ""))
        if not self._drain_token or token != self._drain_token:
            raise RPCError("migration not authorized")
        self._drain_token = None  # one-shot: a replayed drain is refused
        ticket = placement.ticket_from_agent(self)
        self._trace("migration_ticket_served",
                    height=int(self.chain.latest.iteration),
                    nbytes=placement.ticket_nbytes(ticket))
        return placement.ticket_wire(ticket)

    async def _h_dkg_deal(self, meta, arrays):
        """Accept one dealer's genesis deal (crypto/dkg.py): rebuild
        it, verify every share row against the dealer's own Pedersen
        grid, and store it for ceremony aggregation. A failing deal is
        a LOUD verdict — counted, traced, and reported back to the
        dealer — never a silent drop, because aggregation excludes it
        from the transcript and the dealer must learn why."""
        from biscotti_tpu_torch.crypto import dkg

        dealer = int(meta.get("dealer_id", -1))
        try:
            deal = dkg.DkgDeal(
                dealer_id=dealer,
                comms=np.asarray(arrays["comms"], dtype=np.uint8),
                xs=[int(x) for x in meta.get("xs", [])],
                rows=np.asarray(arrays["rows"], dtype=np.int64),
                blind_rows=np.asarray(arrays["blind_rows"],
                                      dtype=np.uint8))
            ok = dkg.verify_deal(deal)
        except Exception:
            ok = False
        verdict = "verified" if ok else "rejected"
        if ok:
            self._dkg_deals[dealer] = deal
        if self.tele.enabled:
            self.tele.registry.counter(
                dkg.DEALS_METRIC, dkg.DEALS_HELP).inc(verdict=verdict)
        self._trace("dkg_deal", dealer=dealer, verdict=verdict)
        return {"verdict": verdict, "dealer": dealer}

    async def _snapshot_bootstrap(self) -> bool:
        """Joiner half of the snapshot handshake: pull GetSnapshot from
        peers (seeded-random order) until one validated snapshot adopts.
        The preceding hello carried `no_chain`, so NO pre-snapshot block
        ever crosses the wire for this peer — asserted by the wire byte
        accounting (GetSnapshot.reply vs GetBlock.reply) in the
        acceptance test.

        The suffix's quorums verify against the BASE block's own carried
        stake map, so a lone Byzantine donor could otherwise fabricate
        base + committee + quorums wholesale: before adopting, the base
        block's hash is corroborated by an INDEPENDENT peer (one
        GetBlock at the base height — a single block, not history).
        Capture now needs the donor AND the sampled corroborator to
        collude; clusters with fewer than two other peers have nobody to
        cross-check against and skip the step (genesis replay via the
        announce path remains the fallback either way)."""
        order = sorted(p for p in self.peers if p != self.id)
        self._rng.shuffle(order)
        for pid in order:
            if protocol.SNAPSHOT not in self._grant(pid):
                # the donor's hello did not grant the snapshot feature
                # (old build / version pin): it would answer GetSnapshot
                # with unknown-method — skip it without the wasted RPC.
                # The announce already recorded every peer's hello, so
                # an all-legacy fleet exhausts the order and falls back
                # to the announce path's genesis replay.
                self._trace("snapshot_refused",
                            reason="feature_ungranted", peer=pid)
                continue
            try:
                rmeta, rarrays = await self._call(
                    pid, "GetSnapshot",
                    {"source_id": self.id,
                     "tail": self.cfg.snapshot_tail,
                     **self._reply_codec_meta(pid)})
            except Exception:
                continue
            try:
                blocks = wire.unpack_chain(rmeta, rarrays)
            except Exception:
                # a malformed reply must cost the DONOR its turn, never
                # crash the joiner's run()
                self._trace("snapshot_refused", reason="undecodable",
                            peer=pid)
                continue
            claim = int((rmeta.get("snapshot") or {})
                        .get("pruned_weight", 0) or 0)
            base = blocks[1].iteration if len(blocks) >= 2 else -1
            if base > 0 and len(order) >= 2:
                ok = await self._corroborate_base(blocks[1], pid, order)
                if not ok:
                    self._trace("snapshot_refused",
                                reason="base_uncorroborated", peer=pid)
                    continue
            # validation + adoption run ON the event loop: the suffix is
            # at most snapshot_tail+1 blocks (bounded work), and the
            # chain mutation must never race the live RPC handlers that
            # read self.chain between awaits
            if self._adopt_snapshot(blocks, claim, pid):
                return True
        return False

    async def _corroborate_base(self, base: Block, donor: int,
                                order: List[int]) -> bool:
        """Ask peers OTHER than the snapshot's donor for the block at the
        base height and compare hashes. The first peer that answers
        decides; peers that are unreachable or pruned below the base are
        skipped. Returns False when the answer disagrees (fork or
        fabrication) or nobody could answer."""
        for other in order:
            if other == donor:
                continue
            try:
                bmeta, barrays = await self._call(
                    other, "GetBlock",
                    {"iteration": int(base.iteration),
                     "source_id": self.id,
                     **self._reply_codec_meta(other)},
                    timeout=self.timeouts.rpc_s)
            except Exception:
                continue  # unreachable / pruned: ask the next peer
            try:
                blk = wire.unpack_block(bmeta, barrays)
            except Exception:
                continue  # undecodable corroborator: ask the next peer
            return blk.hash == base.hash
        return False

    def _adopt_candidate(self, blocks: List[Block],
                         source: Optional[int] = None,
                         quorums_ok: Optional[bool] = None) -> bool:
        """Full-chain adoption with TRACED refusal reasons — the one gate
        every chain offered to a (re)joining peer passes through
        (announce replies, contiguous snapshots): genesis hash pinned,
        fork-choice weight, quorum authentication, then maybe_adopt's
        structural verify. Refusals land in the flight recorder as
        `chain_refused{reason=…}` so a rejoin that kept its old history
        is diagnosable from a scrape, not a debugger."""
        if not blocks:
            return False
        if blocks[0].hash != self.chain.blocks[0].hash:
            self._trace("chain_refused", reason="genesis_mismatch",
                        peer=source)
            return False
        other = Blockchain.__new__(Blockchain)
        other.blocks = blocks
        if other.adoption_key() <= self.chain.adoption_key():
            self._trace("chain_refused", reason="not_heavier", peer=source)
            return False
        # `quorums_ok` lets an async caller precompute the expensive
        # batched-signature sweep in a worker thread (read-only, so
        # thread-safe) while THIS method — which mutates self.chain —
        # always runs on the event loop, never racing the live handlers
        if (self._chain_quorums_ok(blocks)
                if quorums_ok is None else quorums_ok) is not True:
            self._trace("chain_refused", reason="quorum_unauthenticated",
                        peer=source)
            return False
        return self.chain.maybe_adopt(other)

    def _adopt_snapshot(self, blocks: List[Block], pruned_weight: int,
                        source: Optional[int] = None) -> bool:
        """Validate + adopt one GetSnapshot reply. Same refusal logic as
        a checkpoint restore / live adoption, extended to the sealed
        suffix: the genesis hash must be OURS (a foreign cluster's
        snapshot is refused outright), the suffix must be structurally
        sealed (hashes + links), and every block above the trust-anchor
        base must carry verifier quorums valid under the committee its
        carried parent state elects. The base block itself is the
        snapshot's trust anchor — unverifiable without the pruned
        history by construction; its integrity is pinned by the quorums
        sealed on top of it (docs/MEMBERSHIP.md §trust-model)."""
        if len(blocks) < 2 or blocks[0].iteration != -1:
            self._trace("snapshot_refused", reason="malformed", peer=source)
            return False
        if blocks[0].hash != self.chain.blocks[0].hash:
            self._trace("snapshot_refused", reason="genesis_mismatch",
                        peer=source)
            return False
        base = blocks[1].iteration
        if base <= 0:
            # contiguous from genesis (short chain): ordinary adoption —
            # full quorum verification, no trust anchor involved
            if self._adopt_candidate(blocks, source):
                self._trace("snapshot_adopted", base=0,
                            height=self.chain.latest.iteration)
                return True
            return False
        cand = Blockchain.__new__(Blockchain)
        cand.blocks = blocks
        cand.pruned_before = base
        # the weight claim is advisory but STICKY (it enters our own
        # adoption_key forever): clamp it to the pruned range's length —
        # one non-empty block per pruned height is the physical maximum —
        # so a Byzantine donor's pruned_weight=10**9 cannot make every
        # future honest chain offer lose fork choice as "not_heavier"
        cand.pruned_weight = max(0, min(int(pruned_weight), base))
        try:
            cand.verify()
        except ChainInvariantError as e:
            self._trace("snapshot_refused", reason=f"structure: {e}",
                        peer=source)
            return False
        for i in range(2, len(blocks)):
            if not self._block_quorums_ok(blocks[i],
                                          blocks[i - 1].stake_map,
                                          blocks[i - 1].hash):
                self._trace("snapshot_refused",
                            reason="quorum_unauthenticated",
                            height=blocks[i].iteration, peer=source)
                return False
        if cand.adoption_key() <= self.chain.adoption_key():
            self._trace("snapshot_refused", reason="not_heavier",
                        peer=source)
            return False
        self.chain.blocks = blocks
        self.chain.pruned_before = base
        self.chain.pruned_weight = cand.pruned_weight
        self._trace("snapshot_adopted", base=base,
                    height=self.chain.latest.iteration)
        return True

    def _accept_block(self, blk: Block, gossip: bool,
                      minted: bool = False) -> None:
        if blk.iteration > self.iteration:
            # future block: we're behind — park it and retry as we catch up
            # (ref: main.go:1300-1320 sleep-loop)
            t = asyncio.get_running_loop().create_task(self._late_accept(blk))
            self._bg_tasks.add(t)
            t.add_done_callback(self._bg_tasks.discard)
            return
        if not minted and not blk.is_empty():
            # authenticate a FOREIGN non-empty block's verifier quorums
            # against the committee its parent state elects — a Byzantine
            # leader cannot mint fake contributions into the ledger
            parent = self.chain.get_block(blk.iteration - 1)
            if parent is None or not self._block_quorums_ok(
                    blk, parent.stake_map, parent.hash):
                self._trace("block_quorum_rejected", height=blk.iteration)
                return
        changed = self.chain.consider_block(blk)
        if changed:
            self._trace("block_accepted", height=blk.iteration,
                        empty=blk.is_empty(), hash=blk.hash.hex()[:16])
            if self.round.block_done and blk.iteration >= self.round.iteration:
                self.round.block_done.set()
            # the instant the head moves is the widest overlap window:
            # start next round's speculative worker precompute NOW, while
            # this round still evaluates convergence and tears down
            self._maybe_speculate()
            if gossip:
                # minted here → full fan-out; received → bounded re-gossip
                self._gossip_block(blk, full=minted)

    async def _late_accept(self, blk: Block, budget: float = 20.0) -> None:
        deadline = time.monotonic() + budget
        while self.iteration < blk.iteration and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        if blk.iteration <= self.iteration:
            self._accept_block(blk, gossip=False)

    def _gossip_block(self, blk: Block, full: bool = False) -> None:
        """Block propagation, two-tier. The MINTER pushes the full block to
        every live peer (ref: main.go:1410-1418), encoding the frame ONCE
        and writing the same bytes to each connection. RECEIVERS do not
        re-broadcast the multi-MB body (the reference re-gossips whole
        blocks on append, main.go:1390 — O(N²) bodies); they advertise the
        (iteration, hash) header to a log-sized random subset, and anyone
        missing the block pulls it. Same epidemic coverage, but the body
        crosses the wire O(N) times instead of O(N·fanout)."""
        # deliver to the FULL membership, not the alive subset: `alive` is
        # a liveness heuristic evicted on any transient RPC timeout, and a
        # quiet worker that never calls us back would otherwise drop out of
        # every gossip target draw and strand on its block timer (observed
        # at N=50+ under load). A truly dead target costs one fast failed
        # dial; a mislabeled live one gets its block. The one exception is
        # a QUARANTINED peer (breaker open, cooling down): it already
        # failed `breaker_threshold` consecutive times moments ago, so the
        # fan-out skips it until a half-open probe — or its own inbound
        # rejoin traffic — re-admits it.
        targets = []
        busy_targets = []
        for pid in self.peers:
            if pid == self.id:
                continue
            if not self.health.available(pid):
                self._trace("gossip_skip_quarantined", peer=pid)
                continue
            # a peer that answered BusyError THIS round is deprioritized,
            # not dropped: full pushes still deliver (last, so fresh peers
            # drain first), but the advertise fan-out samples it only when
            # fresh targets cannot fill the draw — epidemic coverage still
            # reaches it through other peers' re-gossip
            if self._peer_busy(pid):
                self._trace("gossip_deprioritize_busy", peer=pid)
                busy_targets.append(pid)
            else:
                targets.append(pid)
        if full:
            from biscotti_tpu_torch.runtime import messages as msgs

            meta, arrays = wire.pack_block(blk)
            meta["rid"] = 0
            # encode once PER CODEC GROUP, not per peer: targets that
            # negotiated the same (codec, chunking) share one frame, so
            # a homogeneous cluster still pays a single encode while a
            # mixed cluster's raw64 stragglers get their own legacy copy
            # (frame bytes, effective codec) per group — the effective
            # codec (from encode stats) labels the byte accounting, so
            # a block whose arrays all fell back to raw counts as raw64
            # fresh targets first, busy ones last: every peer still gets
            # the block (it is a push they need to advance), but a peer
            # shedding load is not first in line for a multi-MB frame
            targets = targets + busy_targets
            # hive loopback partition (runtime/hive.py): co-hosted targets
            # get the SAME block object via post_direct — no frame encode
            # at all, the dominant broadcast cost — while remote targets
            # share one encode per codec group as before. The partition is
            # re-checked at send time inside push(): a co-hosted peer that
            # died in between gets the ConnectionError a closed TCP socket
            # would raise, never a silent drop.
            # distributed tracing: the broadcast inherits the CURRENT
            # span (the mint / the handler that accepted the block) as
            # the receivers' parent — stamped once per traced group, so
            # the encode-once-per-group optimization survives and
            # untraced/legacy groups keep byte-identical frames
            wctx = tracectx.current() if self.tele.trace else None
            meta_tr = tracectx.stamp(meta, wctx) if wctx is not None \
                else meta
            loopback_pids = frozenset(
                pid for pid in targets
                if self.pool.loopback_endpoint(*self.peers[pid]) is not None)
            # overlay down-path (docs/OVERLAY.md): remote targets sharing
            # a subtree get the block THROUGH that subtree's relay — the
            # multi-MB body crosses TCP once per remote subtree instead
            # of once per remote peer; a failed relay falls back to the
            # direct pushes below for exactly its orphaned targets
            relayed_plan: Dict[int, List[int]] = {}
            if self.overlay.enabled:
                _, relayed_plan = self.overlay.plan(
                    [p for p in targets if p not in loopback_pids],
                    blk.iteration, self.id)
            relayed_pids = frozenset(t for ts in relayed_plan.values()
                                     for t in ts)
            frames: Dict[Tuple[str, int, bool], Tuple[bytes, str]] = {}
            group: Dict[int, Tuple[str, int, bool]] = {}
            for pid in targets:
                if pid in loopback_pids or pid in relayed_pids:
                    continue
                traced = wctx is not None and self._peer_traces(pid)
                key = self._wire_to(pid) + (traced,)
                group[pid] = key
                if key not in frames:
                    codec, chunk, traced = key
                    stats: Dict[str, int] = {}
                    frame = msgs.encode(
                        "RegisterBlock", meta_tr if traced else meta,
                        arrays,
                        codec=None if codec == wcodecs.RAW else codec,
                        chunk_bytes=chunk, stats=stats)
                    eff = str(stats.get("codec", wcodecs.RAW))
                    frames[key] = (frame, eff)
                    wcodecs.observe_ratio(
                        self.pool.metrics, eff,
                        stats["raw_bytes"], stats["wire_bytes"])

            async def push(pid):
                host, port = self.peers[pid]
                try:
                    if pid in loopback_pids:
                        await self.pool.post_direct(
                            host, port, "RegisterBlock",
                            meta_tr if self._peer_traces(pid) else meta,
                            arrays, timeout=self.timeouts.rpc_s)
                    else:
                        frame, eff = frames[group[pid]]
                        await self.pool.post(host, port, frame,
                                             timeout=self.timeouts.rpc_s,
                                             msg_type="RegisterBlock",
                                             codec=eff)
                except Exception:
                    self.alive.discard(pid)
                    self._record_peer_fail(pid)
                else:
                    # a drained post only proves the OS accepted the bytes
                    # — a wedged peer's socket buffers still drain fine —
                    # so it may keep a CLOSED streak clean but must never
                    # rehabilitate a tripped breaker (that would flap the
                    # quarantine every gossip round); only a reply-bearing
                    # _call closes it
                    if self.health.state(pid) == faults.CLOSED:
                        self._record_peer_ok(pid)
                    else:
                        self.alive.add(pid)

            # gossip outlives the round on purpose (stragglers still need
            # the block); _bg_tasks holds the strong ref and the bounded
            # send in rpc.py caps each task's lifetime at rpc_s
            loop_now = asyncio.get_running_loop()
            # relay frames FIRST: the remote subtrees' forwards race the
            # advert re-gossip our own loopback deliveries will trigger,
            # so the cross-host copies get the head start
            for relay, ts in relayed_plan.items():
                t = loop_now.create_task(self._relay_send(
                    relay, "RegisterBlock", meta, arrays, ts,
                    blk.iteration, timeout=self.timeouts.rpc_s))
                self._bg_tasks.add(t)
                t.add_done_callback(self._bg_tasks.discard)
            for pid in targets:
                if pid in relayed_pids:
                    continue
                t = loop_now.create_task(push(pid))
                self._bg_tasks.add(t)
                t.add_done_callback(self._bg_tasks.discard)
            return

        import math

        population = len(targets) + len(busy_targets)
        fanout = max(3, int(math.log2(max(2, population))) + 1)
        if len(targets) > fanout:
            targets = self._rng.sample(targets, fanout)
        elif len(targets) < fanout and busy_targets:
            # fresh targets cannot fill the draw: top up from the busy
            # set rather than shrinking coverage below the epidemic bound
            need = min(fanout - len(targets), len(busy_targets))
            targets = targets + self._rng.sample(busy_targets, need)
        ad = {"iteration": blk.iteration, "hash": blk.hash.hex(),
              "source_id": self.id}

        async def advertise(pid):
            try:
                await self._call(pid, "AdvertiseBlock", ad,
                                 timeout=self.timeouts.rpc_s)
            except Exception:
                pass

        for pid in targets:
            t = asyncio.get_running_loop().create_task(advertise(pid))
            self._bg_tasks.add(t)
            t.add_done_callback(self._bg_tasks.discard)

    def _reject_source(self, st: RoundState, sid: int, it: int,
                       commitment: bytes, reason: str) -> None:
        """Record a cryptographically invalid submission: carried into the
        minted block as an accepted=False record and debited STAKE_UNIT
        (ref: honest.go:363-370)."""
        st.miner_rejected[sid] = Update(
            source_id=sid, iteration=it, delta=np.zeros(0, np.float64),
            commitment=commitment, accepted=False)
        self._trace("submission_rejected", source=sid, reason=reason)

    def _pipelined_iteration(self, it: int, source) -> bool:
        """True when this frame may pre-verify: a near-future round
        (ahead of the current one by at most pipeline_depth), a KNOWN
        peer id, and the first such frame for (it, sid). The expensive
        committee-INDEPENDENT checks (the O(d) commitment recompute,
        VSS digests) then run before the handler parks for the round,
        overlapping the current round's mining; committee-dependent
        checks (signature quorums) still wait for the election.

        The (known peer, once per (it, sid)) gate bounds the
        pre-verification CPU at num_nodes·depth checks per round — the
        same order the round itself pays — so replayed or sid-spoofed
        future frames cannot turn early verification into a free MSM
        amplifier (they just park, and the post-round-start path with
        its dedup/role gates handles them as before)."""
        if not (self.cfg.pipeline
                and self.iteration < it
                <= self.iteration + self.cfg.pipeline_depth):
            return False
        try:
            sid = int(source)
        except (TypeError, ValueError):
            return False
        if sid not in self.peers:
            return False
        key = (it, sid)
        if key in self._preverify_gate:
            return False
        self._preverify_gate.add(key)
        return True

    async def _h_register_update(self, meta, arrays):
        """Miner intake, plain mode (ref: main.go:420-436). The commitment
        is recomputed from the received delta (ref: kyber.go:564-577) and
        the verifier signature quorum is checked before acceptance.

        Pipelined (cfg.pipeline): a submission for the NEXT round runs
        its commitment recompute — the O(d) MSM that dominates plain
        intake — immediately, while this peer is still mining the
        current round; only the quorum check (needs the next committee)
        waits. Batched (cfg.batch_intake): concurrent same-round
        submissions wait one event-loop beat and are verified as ONE
        RLC batch with bisection fallback (_drain_plain_batch) — one
        ~d-point MSM per micro-batch instead of one per update. Both
        paths produce bit-identical accept/reject verdicts and identical
        round state to the sequential loop they replace."""
        it = int(meta["iteration"])
        if it < self.iteration:
            raise StaleError()
        pre_ok: Optional[bool] = None
        u: Optional[Update] = None
        if (not self.cfg.fedsys
                and self._pipelined_iteration(it, meta.get("source_id"))):
            u = wire.unpack_update(meta, arrays)
            if len(u.delta) == self.trainer.num_params:
                with self.tele.span("miner_verify", it=it):
                    pre_ok = await asyncio.to_thread(
                        self._verify_plain_commitment, u)
                self._trace("intake_preverified", source=u.source_id,
                            ok=pre_ok)
        st = await self._wait_round_ready(it)
        if not self.role_map.is_miner(self.id):
            raise RPCError("not a miner this round")
        if u is None:  # the pre-verified path already decoded this payload
            u = wire.unpack_update(meta, arrays)
        if len(u.delta) != self.trainer.num_params:
            raise RPCError("bad update dimension")
        if u.source_id in st.miner_updates or u.source_id in st.miner_rejected:
            return {}, {}
        why = ""
        if not self.cfg.fedsys:  # FedSys carries no crypto (ref: FedSys/)
            if pre_ok is not None:
                commit_ok = pre_ok
            elif self.cfg.batch_intake:
                commit_ok = await self._plain_commit_batched(st, u)
            else:
                with self.tele.span("miner_verify", it=it):
                    commit_ok = await asyncio.to_thread(
                        self._verify_plain_commitment, u)
            if not commit_ok:
                why = "commitment recompute mismatch"
            else:
                with self.tele.span("sig_check", it=it):
                    quorum_ok = (not self.cfg.verification
                                 or await asyncio.to_thread(
                                     self._verify_sig_quorum, u.commitment,
                                     it, u.source_id, u.signers,
                                     u.signatures))
                if not quorum_ok:
                    why = "verifier signature quorum failed"
        if why:
            self._reject_source(st, u.source_id, it, u.commitment, why)
            raise RPCError(f"update rejected: {why}")
        st.miner_updates.setdefault(u.source_id, u)
        self._trace("update_registered", source=u.source_id,
                    have=len(st.miner_updates))
        return {}, {}

    async def _plain_commit_batched(self, st: RoundState, u: Update) -> bool:
        """Park this update in the round's micro-batch and await its
        commitment verdict (cfg.batch_intake). The first parker spawns
        the drainer; everyone arriving within the batch window shares
        one RLC check — but every submission is verified against its own
        payload (no verdict sharing, even for a repeated source_id)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        st.plain_pending.append((u, fut))
        if st.plain_drainer is None or st.plain_drainer.done():
            st.plain_drainer = loop.create_task(self._drain_plain_batch(st))
        return await asyncio.shield(fut)

    async def _drain_plain_batch(self, st: RoundState) -> None:
        """Verify every parked plain-mode update in one batched RLC
        commitment check; on batch failure bisection narrows to the
        exact per-update recompute verdicts (find_bad_commitments), so
        the offender set — and the stake debits it feeds — is identical
        to the sequential path's. Keyless mode (hash commitments) has no
        RLC structure; it verifies per update inside one thread hop.
        Hardened: any unexpected error in the batch machinery falls back
        to the exact sequential recompute per update, and parked futures
        are ALWAYS resolved — one malformed submission must not hang the
        honest batch behind it."""
        await asyncio.sleep(0.02)  # micro-batch window: let a burst land
        while st.plain_pending:
            batch, st.plain_pending = st.plain_pending, []
            updates = [u for u, _ in batch]

            def run() -> List[bool]:
                try:
                    if self.commit_key is not None:
                        items = [(u.commitment, self._quantize_np(u.delta))
                                 for u in updates]
                        if cm.batch_verify_commitments(items,
                                                       self.commit_key):
                            return [True] * len(updates)
                        bad = set(cm.find_bad_commitments(items,
                                                          self.commit_key))
                        return [i not in bad for i in range(len(updates))]
                except Exception as e:
                    # a malformed submission (the decode, quantize and
                    # stack steps raise ValueError) drops to the exact
                    # per-update recompute below. Armed, any other error
                    # is the device's and raises: the host MSM never
                    # finishes the intake after a device fault.
                    if devkern.active() and not isinstance(e, ValueError):
                        raise
                return [self._verify_plain_commitment(u) for u in updates]

            try:
                with self.tele.span("miner_verify", it=st.iteration):
                    verdicts = await asyncio.to_thread(run)
            except BaseException as e:
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(
                            RPCError(f"intake verification failed: "
                                     f"{type(e).__name__}"))
                raise
            self._trace("plain_batch_verified", n=len(updates),
                        bad=sum(1 for v in verdicts if not v))
            for (_, fut), ok in zip(batch, verdicts):
                if not fut.done():
                    fut.set_result(ok)

    async def _h_register_decline(self, meta, arrays):
        """A sampled worker whose update the verifier committee refused
        notifies the miners it will not contribute this round. The notice
        only shrinks the expected-contributor count (it injects nothing),
        and it must carry the worker's own Schnorr signature — otherwise
        an attacker could decline OTHER peers into early, thin blocks."""
        it = int(meta["iteration"])
        if it < self.iteration:
            raise StaleError()
        st = await self._wait_round_ready(it)
        if not self.role_map.is_miner(self.id):
            raise RPCError("not a miner this round")
        sid = int(meta["source_id"])
        if not self.role_map.is_vanilla(sid):
            # only this round's WORKERS are expected contributors; a
            # committee member's self-decline would inflate the accounted
            # count and mint early, excluding in-flight honest updates
            raise RPCError("decline from a non-contributor")
        sig = bytes.fromhex(meta.get("sig", ""))
        pub = self.node_pubs.get(sid)
        if pub is None or not await asyncio.to_thread(
                cm.schnorr_verify, pub, _decline_message(it, sid), sig):
            raise RPCError("bad decline signature")
        st.miner_declined.add(sid)
        return {}, {}

    async def _h_register_secret(self, meta, arrays):
        """Miner intake, secure-agg mode: one share-row slice per
        contributor (ref: main.go:256-286, 330-367). Intake itself checks
        the cheap invariants — tensor shapes, commitment digest, verifier
        signature quorum; the share-vs-commitment VSS check is deferred to
        _verify_intake, which settles the WHOLE round's intake in one
        batched RLC+MSM before any share is served or aggregated (ref:
        kyber.go:650-673 verifySecret ran a pairing per share at intake).
        Nothing unverified can reach aggregation — it can only sit parked
        in this round's state until the batch check runs.

        Pipelined (cfg.pipeline): a next-round submission runs its
        committee-independent checks (shapes, VSS digest) before parking
        for the round; with cfg.batch_intake the registered slice is
        additionally folded into the round's VSS accumulator in the
        background, so the grid summation the mint-time batch check
        needs amortizes across the intake window (_kick_intake_fold)."""
        it = int(meta["iteration"])
        if it < self.iteration:
            raise StaleError()
        basic: Optional[Tuple[bool, str]] = None
        commitment = bytes.fromhex(meta.get("commitment", ""))
        if self._pipelined_iteration(it, meta.get("source_id")):
            with self.tele.span("intake_validate", it=it):
                basic = await asyncio.to_thread(
                    self._check_secret_basic, commitment, arrays)
            self._trace("intake_preverified", source=meta.get("source_id"),
                        ok=basic[0])
        st = await self._wait_round_ready(it)
        if not self.role_map.is_miner(self.id):
            raise RPCError("not a miner this round")
        sid = int(meta["source_id"])
        if sid in st.miner_shares or sid in st.miner_rejected \
                or sid in st.miner_group_of:
            return {}, {}
        rows = np.asarray(arrays.get("share_rows", np.zeros(0)), dtype=np.int64)
        expect = (self.cfg.shares_per_miner,
                  ss.num_chunks(self.trainer.num_params, self.cfg.poly_size))
        if rows.shape != expect:
            raise RPCError(f"bad share shape {rows.shape} != {expect}")
        if basic is None:
            with self.tele.span("intake_validate", it=it):
                basic = await asyncio.to_thread(
                    self._check_secret_basic, commitment, arrays)
        ok, why = basic
        if ok:
            with self.tele.span("sig_check", it=it):
                ok, why = await asyncio.to_thread(
                    self._check_secret_quorum, commitment, meta)
        if not ok:
            self._reject_source(st, sid, it, commitment, why)
            raise RPCError(f"secret rejected: {why}")
        st.miner_shares.setdefault(sid, rows)
        st.miner_commitments[sid] = commitment
        st.miner_vss[sid] = (np.asarray(arrays["comms"], np.uint8),
                             np.asarray(arrays["blind_rows"], np.uint8))
        try:
            st.miner_sigs[sid] = (
                [int(x) for x in meta.get("signers", [])],
                [bytes.fromhex(s) for s in meta.get("signatures", [])],
            )
        except (ValueError, TypeError):
            pass  # quorum already checked above; records stay sig-less
        self._trace("secret_registered", source=sid,
                    have=len(st.miner_shares))
        if self.cfg.pipeline and self.cfg.batch_intake:
            # fold the freshly registered slice (and any other pending
            # ones) into the round's VSS accumulator while the round's
            # network wait is still running — the summation lump the
            # mint-time settle would otherwise pay
            self._kick_intake_fold(st)
        return {}, {}

    def _kick_intake_fold(self, st: RoundState) -> None:
        """Debounced background incremental _verify_intake pass: at most
        one in flight (the vss_lock serializes the work; the guard keeps
        a burst of arrivals from stacking N no-op tasks)."""
        if st.vss_lock.locked():
            return  # a fold/settle pass is already running; it will sweep

        async def go():
            try:
                await self._verify_intake(st, finalize=False)
            except Exception:
                pass  # next finalize pass repeats the sweep

        t = asyncio.get_running_loop().create_task(go())
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)

    def _check_secret_basic(self, commitment: bytes,
                            arrays) -> Tuple[bool, str]:
        """Committee-INDEPENDENT intake checks for one RegisterSecret
        payload (runs off the event loop): tensor shapes and the VSS
        digest binding. Safe to run for a near-future round before its
        committee exists — the pipelined half of the old
        _check_secret_intake."""
        cfg = self.cfg
        comms = arrays.get("comms")
        blind_rows = arrays.get("blind_rows")
        if comms is None or blind_rows is None:
            return False, "missing VSS tensors"
        comms = np.asarray(comms, np.uint8)
        # the polynomial degree is bound by the protocol, not the sender: a
        # higher-degree commitment would pass pointwise VSS checks while
        # making poly_size-column least-squares recovery return garbage
        c_expect = ss.num_chunks(self.trainer.num_params, cfg.poly_size)
        if comms.shape != (c_expect, cfg.poly_size, 64):
            return False, f"bad commitment tensor shape {comms.shape}"
        if np.asarray(blind_rows).shape != (cfg.shares_per_miner, c_expect, 32):
            return False, "bad blind tensor shape"
        if cm.vss_digest(comms) != commitment:
            return False, "commitment digest mismatch"
        return True, ""

    def _check_secret_quorum(self, commitment: bytes,
                             meta) -> Tuple[bool, str]:
        """Committee-DEPENDENT half of the intake check: the verifier
        signature quorum over the commitment digest (needs this round's
        elected committee, so it always runs after _wait_round_ready)."""
        if not self.cfg.verification:
            return True, ""
        try:
            signers = [int(x) for x in meta.get("signers", [])]
            sigs = [bytes.fromhex(s) for s in meta.get("signatures", [])]
        except (ValueError, TypeError):
            return False, "malformed signature metadata"
        if not self._verify_sig_quorum(commitment, int(meta["iteration"]),
                                       int(meta["source_id"]),
                                       signers, sigs):
            return False, "verifier signature quorum failed"
        return True, ""

    def _check_secret_intake(self, commitment: bytes, meta,
                             arrays) -> Tuple[bool, str]:
        """Cheap intake checks for one RegisterSecret payload — the
        composed (basic + quorum) form, kept for callers and tests that
        exercise the whole gate in one hop; the share-vs-commitment VSS
        check itself is deferred to the round's batched verification
        (_verify_intake)."""
        ok, why = self._check_secret_basic(commitment, arrays)
        if not ok:
            return ok, why
        return self._check_secret_quorum(commitment, meta)

    def _committee_for(self, stake_map: Dict[int, int],
                       prev_hash: bytes) -> List[int]:
        """The verifier committee a given (stake, hash) state elects —
        deterministic, so any peer can recompute ANY round's committee from
        chain data alone (including a candidate chain's own rounds)."""
        cfg = self.cfg
        try:
            verifiers, _ = R.elect_committees(
                stake_map, prev_hash, cfg.num_verifiers, cfg.num_miners,
                cfg.num_nodes)
        except ValueError:
            verifiers, _ = R.elect_committees(
                {i: 1 for i in range(cfg.num_nodes)}, prev_hash,
                cfg.num_verifiers, cfg.num_miners, cfg.num_nodes)
        return verifiers

    def _block_quorums_ok(self, blk: Block, stake_map: Dict[int, int],
                          prev_hash: bytes) -> bool:
        """Authenticate a block's accepted updates: each must carry a
        Schnorr quorum (≥ half) from the verifier committee that the
        parent state elects. One batched RLC check covers the whole block
        (commitments.batch_schnorr_verify). This is what makes chain
        WEIGHT unforgeable: minting a non-empty block requires genuine
        signatures from elected verifiers, not just sealing bytes (the
        reference's corresponding check existed but was disabled,
        main.go:269-277)."""
        cfg = self.cfg
        if not cfg.verification or cfg.fedsys:
            return True  # these modes carry no signatures (ref parity)
        accepted = [u for u in blk.data.deltas if u.accepted]
        if not accepted:
            return True
        # a block hash covers its quorum payload (sealed over updates incl
        # signatures), so a hash this peer already authenticated needs no
        # re-verification — duplicate gossip receipts and every catch-up
        # chain pull otherwise re-pay the whole batched check (measured
        # ~2.3 verifications per peer per block at N=100)
        if (blk.hash in self._quorum_ok_hashes
                and blk.hash == blk.compute_hash()):
            # memo entries are keyed on computed hashes, and the recompute
            # (one SHA-256, vs the Schnorr batch the memo saves) binds this
            # block's CONTENT to the claimed hash locally — the hit no
            # longer relies on consider_block/chain.verify enforcing the
            # binding downstream; refresh its LRU position
            self._quorum_ok_hashes.pop(blk.hash)
            self._quorum_ok_hashes[blk.hash] = None
            return True
        vset = set(self._committee_for(stake_map, prev_hash))
        need = max(1, (len(vset) + 1) // 2)
        items: List[Tuple[bytes, bytes, bytes]] = []
        for u in accepted:
            seen: Set[int] = set()
            per_update = []
            for vid, sig in zip(u.signers, u.signatures):
                if vid not in vset or vid in seen:
                    continue
                pub = self.node_pubs.get(vid)
                if not pub:
                    continue
                seen.add(vid)
                per_update.append(
                    (pub, self._sig_message(u.commitment, blk.iteration,
                                            u.source_id), sig))
            if len(per_update) < need:
                return False
            items.extend(per_update)
        if cm.batch_schnorr_verify(items):
            # bind the memo entry to the block CONTENTS: only a block whose
            # claimed hash IS its computed hash may seed the cache.
            # Otherwise a Byzantine peer could send the round's genuine
            # block relabeled with a forged block's hash (quorum verifies,
            # claimed hash enters the memo, consider_block drops it on the
            # hash mismatch) and then pass the self-consistent forged block
            # through the memo without a single signature being checked.
            if blk.hash == blk.compute_hash():
                self._quorum_ok_hashes[blk.hash] = None
                while len(self._quorum_ok_hashes) > 512:
                    # evict the least-recently-confirmed entry, never the
                    # one just added (set.pop's arbitrary choice could)
                    self._quorum_ok_hashes.pop(
                        next(iter(self._quorum_ok_hashes)))
            return True
        # batch failed: at least one signature is forged — per-item scan
        # would identify it, but for acceptance a single failure damns the
        # block either way
        return False

    def _chain_quorums_ok(self, blocks: List[Block],
                          pruned_before: int = 0) -> bool:
        """Authenticate every non-empty block of a CANDIDATE chain against
        the committees the chain itself elects (parent stake map + parent
        hash). Run before maybe_adopt: without it, chain weight — and
        therefore fork choice — would be forgeable by anyone. A PRUNED
        chain (pruned_before > 0, e.g. a snapshot-bootstrapped peer's own
        checkpoint on restore) starts the check ABOVE the trust-anchor
        base: blocks[1] sits across the gap, so its quorums cannot be
        verified against genesis — same trust model as _adopt_snapshot,
        which sealed that base when the chain was first adopted."""
        start = 2 if pruned_before else 1
        for i in range(start, len(blocks)):
            if not self._block_quorums_ok(blocks[i], blocks[i - 1].stake_map,
                                          blocks[i - 1].hash):
                self._trace("candidate_chain_rejected",
                            height=blocks[i].iteration)
                return False
        return True

    def _my_share_xs(self) -> List[int]:
        _, miners, _, _ = self.role_map.committee()
        idx = sorted(miners).index(self.id)
        sl = ss.miner_rows(self.cfg.total_shares, idx, len(miners))
        return self._xs_all[sl]

    def _sec_sources(self, st: RoundState) -> Set[int]:
        """Every sid whose shares this miner holds — directly registered
        plus members of accepted overlay subtree aggregates."""
        return set(st.miner_shares) | set(st.miner_group_of)

    def _sec_decompose(self, st: RoundState, nodes: Sequence[int]):
        """Decompose an aggregation set into its intake COMPONENTS:
        whole overlay subtree aggregates plus direct sids. Returns
        (rows_list, rec_list) where rows_list holds each component's
        share-row slice and rec_list its (comms, blinds) VSS record
        (None for keyless direct intake) — summation over components
        equals the seed's per-sid summation by associativity, so
        aggregates, reshare deals, and recovered updates are
        bit-identical to the flat path. Returns None when `nodes`
        splits a subtree (the group sum cannot be subset) or names a
        sid this miner does not hold."""
        remaining = set(int(n) for n in nodes)
        rows: List[np.ndarray] = []
        recs: List = []
        for g, rec in st.miner_groups.items():
            inter = g & remaining
            if not inter:
                continue
            if inter != g:
                return None
            rows.append(rec["rows"])
            recs.append((rec["comms"], rec["blinds"]))
            remaining -= g
        for n in sorted(remaining):
            r = st.miner_shares.get(n)
            if r is None:
                return None
            rows.append(r)
            recs.append(st.miner_vss_records.get(n))
        return rows, recs

    async def _verify_intake(self, st: RoundState,
                             finalize: bool = True) -> None:
        """Round-batched VSS verification of every pending share slice: one
        RLC+MSM for the whole intake; per-worker fallback identifies and
        rejects offenders (ref: kyber.go:650-673 checks share-by-share with
        a pairing each — same capability, amortized to one group equation
        per ROUND here). Guarded so concurrent GetUpdateList/GetMinerPart
        callers share one pass; shares that arrive WHILE a batch is being
        checked stay pending and are verified by the next sweep of the
        loop — only the sids actually covered by a batch are retired.

        cfg.batch_intake swaps the one-shot group check for the
        incremental accumulator (cm.VssIntakeBatch): pending slices are
        booked + folded in waves (`finalize=False`, kicked per arrival
        when pipelining), and the mint/serve-time call (`finalize=True`)
        only settles the accumulated set — the RLC scalar chain and one
        MSM, the sole crypto left on the critical path. Group semantics,
        retirement bookkeeping, and rejection evidence are identical to
        the one-shot path."""
        if not st.miner_vss and not (finalize and st.vss_accum is not None):
            return
        async with st.vss_lock:
            if not self.cfg.batch_intake:
                if not finalize:
                    return  # seed behavior: one lump at mint/serve time
                await self._verify_intake_oneshot(st)
                return
            while st.miner_vss:
                if st.my_xs is None:
                    st.miner_vss.clear()
                    return
                pending = {
                    sid: (comms, blinds)
                    for sid, (comms, blinds) in st.miner_vss.items()
                    if sid in st.miner_shares
                }
                if not pending:
                    st.miner_vss.clear()
                    return
                if st.vss_accum is None:
                    cfg = self.cfg
                    st.vss_accum = cm.VssIntakeBatch(
                        cfg.shares_per_miner,
                        ss.num_chunks(self.trainer.num_params, cfg.poly_size),
                        cfg.poly_size)
                acc = st.vss_accum
                t0_fold = time.monotonic()
                with self.tele.span("intake_fold", it=st.iteration):
                    for sid, (comms, blinds) in pending.items():
                        booked = await asyncio.to_thread(
                            acc.add, sid, comms, st.miner_shares[sid], blinds)
                        if not booked:
                            self._vss_reject(st, sid,
                                             "share rows fail VSS "
                                             "verification")
                    for sid in await asyncio.to_thread(acc.fold):
                        self._vss_reject(st, sid,
                                         "share rows fail VSS verification")
                await self._slow_pad(time.monotonic() - t0_fold)
                for sid in pending:
                    st.miner_vss.pop(sid, None)
            if not finalize:
                return
            acc = st.vss_accum
            if acc is None or not len(acc):
                return
            xs = st.my_xs
            if xs is None:
                st.vss_accum = None
                return
            t0_mv = time.monotonic()
            with self.tele.span("miner_verify", it=st.iteration):
                ok = await asyncio.to_thread(acc.verify, xs)
            await self._slow_pad(time.monotonic() - t0_mv)
            members = acc.members()
            self._trace("vss_batch_settled", n=len(members), ok=ok)
            if ok:
                # the whole accumulated set is consistent AS A GROUP —
                # same retirement bookkeeping as the one-shot batch
                batch = frozenset(members)
                for sid, (comms, _rows, blinds) in members.items():
                    st.miner_vss_records[sid] = (comms, blinds)
                    st.miner_vss_batch[sid] = batch
            else:
                for sid, (comms, rows, blinds) in members.items():
                    if await asyncio.to_thread(cm.vss_verify_multi,
                                               [(comms, xs, rows, blinds)]):
                        st.miner_vss_records[sid] = (comms, blinds)
                        st.miner_vss_batch[sid] = frozenset((sid,))
                        continue
                    self._vss_reject(st, sid,
                                     "share rows fail VSS verification")
            # retired: later arrivals start a fresh accumulator (and a
            # fresh batch, exactly like a second one-shot sweep would)
            st.vss_accum = None

    def _vss_reject(self, st: RoundState, sid: int, why: str) -> None:
        st.miner_shares.pop(sid, None)
        commitment = st.miner_commitments.pop(sid, b"")
        self._reject_source(st, sid, st.iteration, commitment, why)

    async def _verify_intake_oneshot(self, st: RoundState) -> None:
        """The pre-accumulator verification body (cfg.batch_intake off):
        one vss_verify_multi lump per sweep — kept verbatim as the seed
        round schedule the disabled configuration must reproduce."""
        while st.miner_vss:
            xs = st.my_xs
            if xs is None:
                st.miner_vss.clear()
                return
            pending = {
                sid: (comms, xs, st.miner_shares[sid], blinds)
                for sid, (comms, blinds) in st.miner_vss.items()
                if sid in st.miner_shares
            }
            if not pending:
                st.miner_vss.clear()
                return
            t0_mv = time.monotonic()
            with self.tele.span("miner_verify", it=st.iteration):
                ok = await asyncio.to_thread(
                    cm.vss_verify_multi, list(pending.values()))
            await self._slow_pad(time.monotonic() - t0_mv)
            self._trace("vss_batch_settled", n=len(pending), ok=ok)
            if ok:
                # the whole batch is consistent AS A GROUP: remember who
                # was verified together, so partial-batch aggregates are
                # re-checked at the aggregation boundary
                batch = frozenset(pending)
                for sid, inst in pending.items():
                    st.miner_vss_records[sid] = (inst[0], inst[3])
                    st.miner_vss_batch[sid] = batch
            else:
                for sid, inst in pending.items():
                    if await asyncio.to_thread(cm.vss_verify_multi,
                                               [inst]):
                        # single-instance checks are exact — the sid is
                        # individually consistent, a singleton batch
                        st.miner_vss_records[sid] = (inst[0], inst[3])
                        st.miner_vss_batch[sid] = frozenset((sid,))
                        continue
                    st.miner_shares.pop(sid, None)
                    commitment = st.miner_commitments.pop(sid, b"")
                    self._reject_source(st, sid, st.iteration, commitment,
                                        "share rows fail VSS verification")
            for sid in pending:
                st.miner_vss.pop(sid, None)

    async def _ensure_subset_consistent(self, st: RoundState,
                                        nodes: List[int]) -> bool:
        """Aggregation-boundary VSS re-check: True iff the aggregate over
        `nodes` provably equals the sum of their committed values. Whole
        verified batches pass for free; members of partially-included
        batches are re-proved as a group of their own (a coalition whose
        errors cancelled inside the intake batch cannot cancel here,
        because the check now runs over EXACTLY the aggregation set).
        Offenders surfaced by a failed re-check are rejected and debited
        like any intake failure."""
        if st.my_xs is None or not self.cfg.secure_agg:
            return True
        # overlay subtree aggregates are servable only WHOLE — the group
        # sum cannot be subset. A set that splits one drops the whole
        # subtree from the servable intake (a state gap like the
        # missing-records path below, never verification evidence: no
        # debit) so callers that shrink the set and retry always make
        # progress. Fully-covered groups pass through: their batch
        # (== their membership) is inside `nodes`, the exact condition
        # the aggregated intake check is sound for.
        nset = set(nodes)
        for g in list(st.miner_groups):
            inter = g & nset
            if inter and inter != g:
                st.miner_groups.pop(g, None)
                for sid in g:
                    st.miner_group_of.pop(sid, None)
                    st.miner_vss_batch.pop(sid, None)
                self._trace("overlay_group_dropped", n=len(g))
                return False
        pending = partial_batch_members(st.miner_vss_batch, nodes)
        if not pending:
            return True
        xs = st.my_xs
        insts: Dict[int, tuple] = {}
        for sid in pending:
            rec = st.miner_vss_records.get(sid)
            rows = st.miner_shares.get(sid)
            if rec is None or rows is None:
                # cannot re-prove without the retained records: drop the
                # sid from the servable set (no debit — this is a state
                # gap, not verification evidence) so callers that shrink
                # the set and retry always make progress
                st.miner_shares.pop(sid, None)
                st.miner_vss_batch.pop(sid, None)
                return False
            insts[sid] = (rec[0], xs, rows, rec[1])
        t0_mv = time.monotonic()
        with self.tele.span("miner_verify", it=st.iteration):
            ok = await asyncio.to_thread(cm.vss_verify_multi,
                                         list(insts.values()))
        await self._slow_pad(time.monotonic() - t0_mv)
        if ok:
            return True
        for sid, inst in insts.items():
            if await asyncio.to_thread(cm.vss_verify_multi, [inst]):
                continue
            st.miner_shares.pop(sid, None)
            st.miner_vss_records.pop(sid, None)
            st.miner_vss_batch.pop(sid, None)
            commitment = st.miner_commitments.pop(sid, b"")
            self._reject_source(st, sid, st.iteration, commitment,
                                "share rows fail aggregation-boundary "
                                "VSS re-check")
        return False

    async def _h_request_noise(self, meta, arrays):
        """Noiser serving its presampled DP noise for the round
        (ref: main.go:239-248 → honest.go:564-592) — but only after
        verifying the requester's lottery proof: the VRF output must verify
        under the requester's noise key over OUR latest block hash, and the
        draw it determines must actually include us. A peer who fabricates
        its noiser set (e.g. to collect noise vectors it can cancel) is
        refused (enforces the proof from ref vrf.go:54-99)."""
        it = int(meta["iteration"])
        if it < self.iteration:
            raise StaleError()
        await self._wait_for_iteration(it)
        if it < self.iteration:
            raise StaleError()
        sid = int(meta.get("source_id", -1))
        try:
            draw = R.NoiserDraw(
                noisers=[int(x) for x in meta.get("noisers", [])],
                output=bytes.fromhex(meta.get("vrf_output", "")),
                proof=bytes.fromhex(meta.get("vrf_proof", "")),
            )
        except ValueError:
            raise RPCError("malformed noiser draw")
        pub = self.noise_pubs.get(sid)
        ok = (
            pub is not None
            and self.id in draw.noisers
            and sid != self.id
            and await asyncio.to_thread(
                R.verify_noiser_draw, pub, self.chain.latest_stake_map(),
                self.chain.latest_hash(), sid, draw, self.cfg.num_nodes)
        )
        if not ok:
            self._trace("noise_draw_rejected", source=sid)
            raise RPCError("noiser lottery proof failed verification")
        noise = await self._own_noise(it)
        return {}, {"noise": noise}

    async def _h_verify_update(self, meta, arrays):
        """Verifier: park until the round's defense decision resolves, then
        sign or reject (ref: DistSys/krum.go:227-365)."""
        it = int(meta["iteration"])
        if it < self.iteration:
            raise StaleError()
        st = await self._wait_round_ready(it)
        if not self.role_map.is_verifier(self.id):
            raise RPCError("not a verifier this round")
        u = wire.unpack_update(meta, arrays)
        vec = u.noised_delta if u.noised_delta is not None else u.delta
        if vec is None or len(vec) != self.trainer.num_params:
            raise RPCError("bad update dimension")
        if u.source_id not in st.verifier_sources:
            st.verifier_sources.add(u.source_id)
            st.verifier_pool.append(u)
            self._trace("verify_request", source=u.source_id,
                        pool=len(st.verifier_pool),
                        thresh=self.cfg.krum_update_thresh)
            if len(st.verifier_pool) >= self.cfg.krum_update_thresh:
                # threshold-triggered decision: its latency from round
                # start is the krum timer's adaptive signal (timeout-
                # path decisions are NOT observed — see _miner_flow)
                if st.iteration == self.round.iteration:
                    self.deadlines.observe(
                        stragglers.KRUM,
                        time.monotonic() - self._round_t0)
                self._decide_round()
        accepted = await asyncio.wait_for(
            asyncio.shield(st.krum_decision), self.timeouts.krum_s * 2)
        if u.source_id in accepted:
            sig = self._sign(self._sig_message(u.commitment, it, u.source_id))
            return {"signature": sig.hex()}, {}
        raise RPCError("rejected by defense")

    def _decide_round(self) -> None:
        """Run the defense over the collected pool and release every parked
        caller (ref: krum.go:296-336). Colluding poisoners on the committee
        rubber-stamp each other (ref: krum.go:47-58)."""
        st = self.round
        if st.krum_decision is None or st.krum_decision.done():
            return
        pool = sorted(st.verifier_pool, key=lambda u: u.source_id)
        if self.cfg.krum_sample_size and len(pool) > self.cfg.krum_sample_size:
            rng = random.Random(st.iteration)  # deterministic, ref krum.go:370
            pool = sorted(rng.sample(pool, self.cfg.krum_sample_size),
                          key=lambda u: u.source_id)
        accepted: Set[int] = set()
        votes_detail: Optional[List[List[str]]] = None
        vecs: Optional[np.ndarray] = None
        if pool:
            vecs = np.stack([
                u.noised_delta if u.noised_delta is not None else u.delta
                for u in pool
            ])
            if self.cfg.defense == Defense.ENSEMBLE and len(pool) > 2:
                mask, votes_detail = self._ensemble_mask(
                    st.iteration, pool, vecs)
            else:
                mask = self._defense_mask(vecs)
            accepted = {u.source_id for u, m in zip(pool, mask) if m}
        from biscotti_tpu_torch.ops.krum import collusion_accept_override

        if collusion_accept_override(self.id, self.cfg.num_nodes,
                                     self.cfg.poison_fraction):
            poisoners = _poisoned_ids(self.cfg.num_nodes,
                                      self.cfg.poison_fraction)
            accepted |= {u.source_id for u in st.verifier_pool
                         if u.source_id in poisoners}
        self._trace("defense_decided", pool=len(pool),
                    accepted=sorted(accepted))
        if pool:
            self._verdict_record(st.iteration, pool, vecs, accepted,
                                 votes_detail)
        st.krum_decision.set_result(accepted)

    def _f32(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a float32 tensor on the peer's device."""
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _defense_mask(self, vecs: np.ndarray) -> np.ndarray:
        """The verifier accept mask of every defense but ENSEMBLE over the
        pool's vectors [n, d], on the peer's device (KRUM, MULTIKRUM and
        FOOLSGOLD need n > 2; NONE and TRIMMED_MEAN accept every update)."""
        from biscotti_tpu_torch.ops.krum import default_num_adversaries, krum_accept_mask
        from biscotti_tpu_torch.ops.robust_agg import (foolsgold_accept_mask,
                                                       multikrum_accept_mask)
        from biscotti_tpu_torch.ops.roni import roni_accept_mask

        n, defense = len(vecs), self.cfg.defense
        if defense == Defense.KRUM and n > 2:
            mask = krum_accept_mask(self._f32(vecs), default_num_adversaries(n))
        elif defense == Defense.MULTIKRUM and n > 2:
            mask = multikrum_accept_mask(self._f32(vecs),
                                         default_num_adversaries(n))
        elif defense == Defense.FOOLSGOLD and n > 2:
            mask = foolsgold_accept_mask(self._f32(vecs),
                                         self.cfg.fg_min_cluster)
        elif defense == Defense.RONI:
            mask = roni_accept_mask(
                self.trainer.model, self._f32(self.chain.latest_gradient()),
                self._f32(vecs), self.trainer.x_test, self.trainer.y_test,
                self.cfg.roni_threshold)
        else:
            return np.ones(n, dtype=bool)
        return mask.cpu().numpy()

    def _verdict_record(self, it: int, pool: List[Update],
                        vecs: np.ndarray, accepted: Set[int],
                        votes: Optional[List[List[str]]]) -> None:
        """Append one verdict-stream row: this verifier's per-peer
        accept/reject walk plus the observed delta magnitudes — the
        replayable artifact evidence behind every attack-matrix cell
        (docs/DEFENSES.md §Evidence). Recorded for EVERY defense decision
        so the hugger's scale walk is visible in the cells it wins, not
        only where ENSEMBLE suppresses it. Bounded by
        trust_plan.stream_cap; ENSEMBLE rows also carry per-peer scorer
        votes."""
        if len(self._verdict_stream) >= self.cfg.trust_plan.stream_cap:
            return
        norms = np.linalg.norm(np.asarray(vecs, np.float64), axis=1)
        row: Dict = {
            "it": it,
            "src": [u.source_id for u in pool],
            "norm": [round(float(x), 5) for x in norms],
            "accept": [int(u.source_id in accepted) for u in pool],
        }
        if votes is not None:
            row["votes"] = votes
        self._verdict_stream.append(row)

    def _trust_sync_chain(self) -> None:
        """Fold newly-settled real blocks into the TrustLedger's chain
        walk. Each block's electorate is re-derived from its predecessor
        (the same common coin every peer runs), so eligibility — and
        therefore the absence-means-rejected inference, the same one the
        hug campaign itself runs on — is a pure function of the committed
        chain. A pruned/unknown predecessor yields an unknown electorate
        and that block contributes no absence signal."""
        for blk in self.chain.blocks:
            if blk.iteration < 0 or blk.iteration <= self.trust.synced_it:
                continue
            records = {u.source_id: bool(u.accepted)
                       for u in blk.data.deltas}
            committee: Optional[Set[int]] = None
            prev = self.chain.get_block(blk.iteration - 1)
            if prev is not None:
                try:
                    vs, ms = R.elect_committees(
                        dict(prev.stake_map), prev.hash,
                        self.cfg.num_verifiers, self.cfg.num_miners,
                        self.cfg.num_nodes)
                    committee = set(vs) | set(ms)
                except ValueError:
                    committee = None
            self.trust.sync_block(blk.iteration, records, committee)

    def _ensemble_mask(self, it: int, pool: List[Update],
                       vecs: np.ndarray,
                       ) -> Tuple[np.ndarray, List[List[str]]]:
        """ENSEMBLE defense decision (ops/trust.py, docs/DEFENSES.md):
        sync the ledger against the committed chain, compute the
        geometry/similarity inputs (Krum scores + keep mask on device,
        cosine matrix and kept-centroid residuals in float64 host math so
        the ledger's decision is layout-deterministic), then let the
        TrustLedger compose the vetoes into one accept mask."""
        from biscotti_tpu_torch.ops.krum import (default_num_adversaries,
                                                 krum_accept_mask, krum_scores)

        self._trust_sync_chain()
        x32 = self._f32(vecs)
        f = default_num_adversaries(len(pool))
        scores = [float(s) for s in krum_scores(x32, f).cpu().numpy()]
        keep = [bool(b) for b in krum_accept_mask(x32, f).cpu().numpy()]
        v64 = np.asarray(vecs, np.float64)
        norms = np.linalg.norm(v64, axis=1)
        unit = v64 / np.maximum(norms, 1e-12)[:, None]
        cos = unit @ unit.T
        np.fill_diagonal(cos, -1.0)
        kept_rows = v64[np.asarray(keep)] if any(keep) else v64
        centroid = kept_rows.mean(axis=0)
        residuals = np.linalg.norm(v64 - centroid[None, :], axis=1)
        ids = [u.source_id for u in pool]
        accepts, votes, detail = self.trust.decide(
            it, ids, [float(n) for n in norms],
            [float(r) for r in residuals], scores, keep, cos.tolist())
        if self.tele.enabled:
            ctr = self.tele.registry.counter(trustlib.VOTES_METRIC,
                                             trustlib.VOTES_HELP)
            for vlist, ok in zip(votes, accepts):
                for scorer in vlist:
                    ctr.inc(scorer=scorer, vote="reject")
                ctr.inc(scorer="ensemble",
                        vote="accept" if ok else "reject")
        self._trace("trust_decided", pool=len(pool),
                    rejected=sorted(pid for pid, ok in zip(ids, accepts)
                                    if not ok),
                    sim_bar=round(detail["sim_bar"], 4),
                    ref_geo=round(detail["ref_geo"], 6))
        return np.asarray(accepts, dtype=bool), votes

    @staticmethod
    def _part_message(kind: str, iteration: int, nodes: Sequence[int]) -> bytes:
        """Domain-separated leader-request message for share-release RPCs."""
        payload = f"biscotti-{kind}:{iteration}:" \
                  f"{','.join(str(n) for n in nodes)}"
        return hashlib.sha256(payload.encode()).digest()

    def _check_leader_request(self, kind: str, it: int,
                              nodes: Sequence[int], meta) -> None:
        """Share-release RPCs must come from the round's leader miner,
        proven by a Schnorr signature — without this ANY caller could pull
        aggregated share rows and difference subsets to unmask individual
        updates (the reference shares this weakness; ADVICE round-1 low)."""
        if not self.cfg.verification or self.cfg.fedsys:
            return  # signature-less modes (ref parity)
        _, miners, _, _ = self.role_map.committee()
        leader = self._miner_leader(sorted(miners))
        src = int(meta.get("source_id", -1))
        if src != leader:
            raise RPCError("share release restricted to the leader miner")
        try:
            sig = bytes.fromhex(meta.get("sig", ""))
        except ValueError:
            raise RPCError("malformed leader signature")
        pub = self.node_pubs.get(leader)
        if not pub or not cm.schnorr_verify(
                pub, self._part_message(kind, it, nodes), sig):
            raise RPCError("leader signature failed verification")

    async def _h_get_update_list(self, meta, arrays):
        """Leader-miner asks which sources this miner holds shares for
        (ref: main.go:438-457, 2237-2277)."""
        it = int(meta["iteration"])
        st = await self._wait_round_ready(it, budget=self.timeouts.rpc_s / 2)
        self._check_leader_request("update-list", it, [], meta)
        await self._verify_intake(st)
        srcs = sorted(self._sec_sources(st))
        return {"sources": srcs, "rejected": sorted(st.miner_rejected)}, {}

    async def _h_get_miner_part(self, meta, arrays):
        """Leader-miner collects this miner's share slice, aggregated over
        the agreed node list (ref: main.go:459-485, kyber.go:244-287).
        Release conditions: leader-signed request, a minimum aggregation
        set (an aggregate over one node IS that node's update), and at most
        ONE distinct set per round (a second subset could be differenced
        against the first to isolate an individual)."""
        it = int(meta["iteration"])
        st = await self._wait_round_ready(it, budget=self.timeouts.rpc_s / 2)
        nodes = [int(x) for x in meta["nodes"]]
        self._check_leader_request("miner-part", it, nodes, meta)
        await self._verify_intake(st)
        if len(set(nodes)) != len(nodes):
            # [v, v] would pass the size floor yet aggregate to 2·share_v
            raise RPCError("duplicate nodes in aggregation set")
        srcs = self._sec_sources(st)
        if not all(n in srcs for n in nodes):
            raise RPCError("missing shares for requested nodes")
        if len(nodes) < min(2, len(srcs)):
            raise RPCError("aggregation set below privacy floor")
        if st.served_part is not None and st.served_part != sorted(nodes):
            raise RPCError("a different aggregation set was already served")
        # KNOWN RESIDUAL (documented, strictly better than the reference,
        # which serves any subset to any caller any number of times): the
        # once-only guard is per-miner, and the share layout's 2× row
        # redundancy (TOTAL_SHARES = 2·POLY_SIZE) means any ⌈M/2⌉ miners'
        # rows suffice for recovery — a malicious leader could serve set S
        # to one disjoint miner half and S∖{v} to the other and difference
        # the two aggregates. Structural fixes (future work): redundancy
        # < 2× forces any two recovering miner subsets to overlap in a
        # miner whose once-only guard then fires; or an explicit signed
        # set-agreement round among miners.
        if not await self._ensure_subset_consistent(st, nodes):
            raise RPCError("aggregation set fails VSS re-check")
        decomp = self._sec_decompose(st, nodes)
        if decomp is None:
            raise RPCError("aggregation set splits an overlay subtree")
        st.served_part = sorted(nodes)
        stack = np.stack(decomp[0])
        agg = np.asarray(ss.aggregate_shares(stack))
        return {"nodes": nodes}, {"agg_rows": agg}

    # ---------------------------------------------- membership: resharing

    def _reshare_context(self, it: int) -> bytes:
        """Domain-separated deal context: binds every sub-deal to (this
        chain head, this round) so deals — like intake commitments —
        can never be replayed across rounds or forks."""
        return (self.chain.latest_hash()
                + int(it).to_bytes(8, "little") + b"|reshare")

    def _build_reshare_deal(self, st: RoundState, nodes: List[int],
                            xs_new: List[int], it: int) -> Dict[str, np.ndarray]:
        """Holder half of the distributed resharing round
        (docs/MEMBERSHIP.md §resharing): sub-share every row of OUR
        aggregated slice over `xs_new` as a fresh Shamir instance whose
        constant term is the row value, commit each sub-polynomial with
        the constant blinding coefficient pinned to our aggregated blind
        (crypto/commitments.reshare_commit_row) — that pin is what lets
        any recipient verify the deal homomorphically against the
        ORIGINAL workers' commitments, no dealer anywhere. Runs off the
        event loop (O(R·C·k) fixed-base commits)."""
        rows_c, recs_c = self._sec_decompose(st, nodes)
        agg_rows = np.asarray(ss.aggregate_shares(np.stack(rows_c)))  # [R, C]
        agg_blinds = cm.sum_blind_rows(
            [rec[1] for rec in recs_c])                    # [R][C] ints
        ctx = self._reshare_context(it)
        coeffs = ss.reshare_coeffs(agg_rows, self.cfg.poly_size,
                                   self.schnorr_seed, ctx)
        sub = ss.reshare_subshares(coeffs, xs_new)          # [S', R, C]
        r_rows = agg_rows.shape[0]
        sub_comms = np.zeros((r_rows,) + (coeffs.shape[1],
                                          self.cfg.poly_size, 64), np.uint8)
        sub_blinds = np.zeros((r_rows, len(xs_new), coeffs.shape[1], 32),
                              np.uint8)
        for r in range(r_rows):
            # per-row context: reusing one blind XOF stream across rows
            # would let an observer difference two rows' commitments and
            # cancel the H term (the Feldman leak the blinds exist for)
            comms_r, blinds_r = cm.reshare_commit_row(
                coeffs[r], agg_blinds[r], self.schnorr_seed,
                ctx + r.to_bytes(4, "little"))
            sub_comms[r] = comms_r
            sub_blinds[r] = cm.vss_blind_rows(blinds_r, xs_new)
        return {"sub_rows": sub, "sub_comms": sub_comms,
                "sub_blinds": sub_blinds}

    async def _h_get_reshare_deal(self, meta, arrays):
        """Surviving share-holder serves its re-deal to the resharing
        coordinator (the round leader) after a membership epoch bump.
        Release conditions mirror GetMinerPart exactly — leader-signed
        request (the signature covers the node set AND the new point
        layout), privacy floor, at most ONE aggregation set per round
        (shared `served_part` guard: a leader cannot pull a reshare deal
        for one subset and a share slice for another and difference
        them), aggregation-boundary VSS re-check."""
        it = int(meta["iteration"])
        st = await self._wait_round_ready(it, budget=self.timeouts.rpc_s / 2)
        nodes = [int(x) for x in meta["nodes"]]
        xs_new = [int(x) for x in meta["xs_new"]]
        # the length prefix pins the nodes/xs_new boundary inside the
        # signed flat list — without it, sign(n + xs) for one split is
        # byte-identical to a shifted split of the same ints
        self._check_leader_request("reshare", it,
                                   [len(nodes)] + nodes + xs_new, meta)
        await self._verify_intake(st)
        if len(set(nodes)) != len(nodes):
            raise RPCError("duplicate nodes in aggregation set")
        if len(set(xs_new)) != len(xs_new) or \
                len(xs_new) < self.cfg.poly_size:
            raise RPCError("reshare point layout degenerate")
        if any(abs(x) > 4 * self.cfg.total_shares for x in xs_new):
            # hostile far-out points would blow the exact-int64 bound of
            # the sub-share evaluation (ops/secretshare.RESHARE_COEF_BOUND)
            raise RPCError("reshare points outside the exactness bound")
        srcs = self._sec_sources(st)
        if not all(n in srcs for n in nodes):
            raise RPCError("missing shares for requested nodes")
        if len(nodes) < min(2, len(srcs)):
            raise RPCError("aggregation set below privacy floor")
        if st.served_part is not None and st.served_part != sorted(nodes):
            raise RPCError("a different aggregation set was already served")
        if not await self._ensure_subset_consistent(st, nodes):
            raise RPCError("aggregation set fails VSS re-check")
        decomp = self._sec_decompose(st, nodes)
        if decomp is None or any(rec is None for rec in decomp[1]):
            # plain hash-commitment mode (keyless) carries no VSS records
            # to re-deal against — resharing is a secure-agg capability —
            # and an overlay-split set has no per-component records either
            raise RPCError("no VSS records to reshare")
        st.served_part = sorted(nodes)
        with self.tele.span("reshare_deal", it=it):
            deal = await asyncio.to_thread(self._build_reshare_deal, st,
                                           nodes, xs_new, it)
        self._trace("reshare_deal_served", rows=int(deal["sub_rows"].shape[1]))
        return {"nodes": nodes}, deal

    def _verify_reshare_deal(self, grid_sum: np.ndarray, xs_old: List[int],
                             xs_new: List[int],
                             deal: Dict) -> Optional[np.ndarray]:
        """Coordinator-side check of one holder's re-deal: every row's
        sub-commitments must equal the homomorphic evaluation of the
        summed ORIGINAL commitments at the holder's old point, and every
        sub-share must verify against its sub-commitments
        (crypto/commitments.reshare_verify_deal). Returns the holder's
        reconstructed row values [R, C] (the exact material the seed
        protocol would have pulled via GetMinerPart) or None."""
        sub_rows = np.asarray(deal["sub_rows"], np.int64)
        sub_comms = np.asarray(deal["sub_comms"], np.uint8)
        sub_blinds = np.asarray(deal["sub_blinds"], np.uint8)
        r_rows = len(xs_old)
        k = self.cfg.poly_size
        c_chunks = grid_sum.shape[0]
        if (sub_rows.shape != (len(xs_new), r_rows, c_chunks)
                or sub_comms.shape != (r_rows, c_chunks, k, 64)
                or sub_blinds.shape != (r_rows, len(xs_new), c_chunks, 32)):
            return None
        for r in range(r_rows):
            if not cm.reshare_verify_deal(grid_sum, xs_old[r], sub_comms[r],
                                          xs_new, sub_rows[:, r, :],
                                          sub_blinds[r]):
                return None
        try:
            return ss.reshare_recover_rows(sub_rows, xs_new, k)
        except ValueError:
            return None

    async def _reshare_recover(self, st: RoundState, miners: List[int],
                               reachable: List[int], nodes: List[int],
                               it: int) -> Optional[np.ndarray]:
        """The distributed resharing round (docs/MEMBERSHIP.md): a miner
        died after share intake, so the committee's share layout no
        longer covers recovery by the seed protocol. The leader — acting
        as the new epoch's coordinator — collects a verifiable RE-DEAL
        of every surviving holder's aggregated slice (GetReshareDeal),
        checks each against the homomorphically-evaluated original
        commitments, reconstructs the surviving rows from the re-dealt
        material alone, and completes recovery when ≥ poly_size rows
        survive (r=2 redundancy tolerates half the committee, r=1.5 a
        third). Returns the recovered aggregate, or None → empty block,
        exactly the seed outcome."""
        cfg = self.cfg
        per = cfg.shares_per_miner
        if len(reachable) * per < cfg.poly_size:
            self._trace("reshare_short", survivors=len(reachable))
            return None
        decomp = self._sec_decompose(st, nodes)
        if decomp is None or any(rec is None for rec in decomp[1]):
            self._trace("reshare_short", reason="missing vss records")
            return None
        grids = [rec[0] for rec in decomp[1]]
        self._bump_epoch("reshare_round")
        xs_new = list(self._xs_all)
        with self.tele.span("reshare_verify", it=it):
            grid_sum = await asyncio.to_thread(cm.sum_commitment_grids,
                                               grids)
        if grid_sum is None:
            return None
        # our own slice needs no re-deal: the coordinator holds it
        rows_parts: List[np.ndarray] = []
        xs_parts: List[int] = []
        own_idx = miners.index(self.id)
        rows_parts.append(np.asarray(ss.aggregate_shares(
            np.stack(decomp[0]))))
        xs_parts.extend(self._xs_all[ss.miner_rows(cfg.total_shares,
                                                   own_idx, len(miners))])
        sig = self._sign(self._part_message(
            "reshare", it, [len(nodes)] + nodes + xs_new)).hex()
        for m in reachable:
            if m == self.id:
                continue
            idx = miners.index(m)
            xs_m = self._xs_all[ss.miner_rows(cfg.total_shares, idx,
                                              len(miners))]
            try:
                _, deal = await self._call(m, "GetReshareDeal", {
                    "iteration": it, "nodes": nodes, "xs_new": xs_new,
                    "source_id": self.id, "sig": sig,
                })
            except Exception:
                self._trace("reshare_deal_failed", peer=m)
                continue
            with self.tele.span("reshare_verify", it=it):
                y_rows = await asyncio.to_thread(
                    self._verify_reshare_deal, grid_sum, list(xs_m),
                    xs_new, deal)
            if y_rows is None:
                self._trace("reshare_deal_rejected", peer=m)
                continue
            rows_parts.append(y_rows)
            xs_parts.extend(xs_m)
        if len(xs_parts) < cfg.poly_size:
            self._trace("reshare_short", rows=len(xs_parts))
            return None
        full = np.concatenate(rows_parts)
        with self.tele.span("recovery", it=it):
            agg = np.asarray(ss.recover_update(
                full, np.asarray(xs_parts, np.int64),
                self.trainer.num_params, cfg.poly_size, cfg.precision))
        self._trace("reshare_recovered", rows=len(xs_parts),
                    survivors=len(reachable))
        return agg

    # --------------------------------------------------- speculation plane

    def _maybe_speculate(self) -> None:
        """Kick the speculative next-round worker precompute the moment a
        block lands (cfg.pipeline + cfg.speculation): SGD off the fresh
        head — and, when no state-mutating transform sits between the
        delta and the commitment, the quantize + VSS commit too — runs
        in the background while this peer still evaluates convergence,
        flushes telemetry, and elects the next committees. One slot,
        keyed (iteration, head hash); a stale unconsumed slot is a
        speculative step a fork threw away (speculation_discard)."""
        cfg = self.cfg
        if not (cfg.pipeline and cfg.speculation) or cfg.fedsys:
            return
        if self.stepper is not None:
            # peers-as-devices mode memoizes the batched SGD per
            # ITERATION (device_cluster._memo): a speculative call off a
            # head that later forks would poison the whole co-hosted
            # group's cache for the real round — speculation stays a
            # per-agent-trainer feature
            return
        it = self.iteration
        if it >= cfg.max_iterations or self.converged:
            return
        head = self.chain.latest_hash()
        key = (it, head)
        if self._spec_key == key and (
                self._spec is not None
                or (self._spec_task is not None
                    and not self._spec_task.done())):
            return  # already speculated (or speculating) off this head
        if self._spec is not None:
            # an unconsumed speculative step against a superseded head:
            # the fork/rollback case the counter exists for
            self._spec = None
            self._trace("speculation_discard")
        self._spec_key = key
        if self._spec_task is not None and not self._spec_task.done():
            # one speculative step in flight at a time: a catch-up storm
            # accepting N blocks back-to-back must not fan out N SGD
            # threads. The inflight task's store-guard drops its stale
            # result; the NEXT block accept (or the round itself)
            # proceeds serially — a missed speculation, never a wrong one
            return
        t = asyncio.get_running_loop().create_task(self._speculate(it, head))
        self._spec_task = t
        self._spec_task_key = key
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)

    async def _speculate(self, it: int, head: bytes) -> None:
        cfg = self.cfg
        try:
            if not self._elect_role_map().is_vanilla(self.id):
                return  # committee duty next round: nothing to precompute
            w = self.chain.latest_gradient()
            with self.tele.span("spec_sgd", it=it):
                delta = await asyncio.to_thread(self.trainer.private_fun,
                                                w, it)
            if self.chain.latest_hash() != head:
                self._trace("speculation_discard")
                return
            spec: Dict = {"it": it, "base": head, "delta": delta}
            if (cfg.secure_agg and not cfg.fedsys and not cfg.dp_in_model
                    and not self.wire.lossy):
                # delta reaches quantization unchanged on this config, so
                # the VSS chunk commitments are speculatable too — the
                # dominant worker-crypto cost. The context is pinned to
                # the speculated head, and _worker_flow re-checks q
                # equality before reuse, so a hit is bit-identical to
                # the serial computation.
                q = self._quantize_np(delta)
                with self.tele.span("spec_commit", it=it):
                    vss = await asyncio.to_thread(self._vss_build, q, it,
                                                  head)
                if self.chain.latest_hash() != head:
                    self._trace("speculation_discard")
                    return
                spec["q"] = q
                spec["vss"] = vss
            if self._spec_key == (it, head):
                self._spec = spec
                self._trace("speculation_ready")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._trace("speculation_error",
                        error=f"{type(e).__name__}: {e}")

    async def _claim_spec(self, it: int) -> Optional[Dict]:
        """Hand the speculative products to the round's worker flow iff
        they were computed off exactly the head this round builds on;
        anything else is discarded with the traced counter. Awaits an
        in-flight matching speculation first — that is the same work the
        serial path would do inline, already mid-flight."""
        t = self._spec_task
        if (t is not None and not t.done()
                and self._spec_task_key == (it, self.chain.latest_hash())):
            # the inflight task is computing for EXACTLY this head:
            # awaiting it is the same work the serial path would do
            # inline. A task retargeted away (fork mid-speculation) is
            # NOT awaited — its result is doomed, the serial path below
            # proceeds immediately
            await asyncio.shield(t)
        spec, self._spec = self._spec, None
        if spec is None:
            return None
        if spec["it"] == it and spec["base"] == self.chain.latest_hash():
            self._trace("speculation_hit")
            return spec
        self._trace("speculation_discard")
        return None

    # --------------------------------------------------------------- worker

    async def _worker_flow(self) -> None:
        cfg = self.cfg
        it = self.iteration
        st = self.round
        spec = None
        if cfg.pipeline and cfg.speculation and not cfg.fedsys:
            spec = await self._claim_spec(it)
        w = self.chain.latest_gradient()
        # heavy device call off the event loop: in-process clusters share one
        # loop, and a blocked loop starves every peer's timers
        t0_sgd = time.monotonic()
        with self.tele.span("sgd", it=it):
            if spec is not None:
                delta = spec["delta"]  # precomputed off this exact head
            elif self.stepper is not None:
                delta = await self.stepper.step(self.id, w, it)
            else:
                delta = await asyncio.to_thread(self.trainer.private_fun,
                                                w, it)
        if spec is None:
            # straggler plane (docs/STRAGGLERS.md): a slow peer's SGD step
            # takes compute_factor x as long. Hive co-hosting memo-hits
            # measure ~0 for their own await, so the pad bases on the
            # shared batch's real cost there — TCP and loopback layouts
            # slow identically.
            base = time.monotonic() - t0_sgd
            if self.stepper is not None:
                base = max(base, getattr(self.stepper, "step_cost_s", 0.0))
            await self._slow_pad(base)
        self.total_updates += 1

        if self.campaign is not None:
            # adaptive-poison seam (docs/ADVERSARY.md): the campaign may
            # reshape OUR OWN delta before quantize/commit/noise/share —
            # everything downstream (Pedersen verification, Shamir
            # recovery, defense scoring) operates on the shaped values,
            # exactly as it would on any delta a hostile trainer emits.
            # Recording the submission round is how the campaign reads
            # its own fate out of the next block.
            delta = self._campaign_shape(it, delta)
            self._campaign_submitted = it

        noise = None
        if cfg.dp_in_model:
            delta = delta + await self._own_noise(it)
        if self.wire.lossy:
            # lossy-before-commit (docs/WIRE_PLANE.md): project the delta
            # onto the codec's representable set NOW — the quantization,
            # Pedersen commitment, DP noising and Shamir shares below all
            # operate on the projected values, which the wire then
            # carries bit-exactly. Top-k keeps an error-feedback residual
            # that folds what this round dropped into the next delta.
            delta, self._ef_residual = self.wire.transform(
                delta, residual=self._ef_residual, topk_k=self._topk_k)
        noised = delta
        if cfg.noising and not cfg.fedsys:
            draw = self._noiser_draw()
            if self.campaign is not None:
                # the one committee an attacker can observe beyond the
                # public election: its OWN private noiser draw — the
                # roleflood campaign adds the drawn noisers to this
                # round's flood targets (docs/ADVERSARY.md)
                self.campaign.observe_noisers(it, draw.noisers)
            nmeta = {
                "iteration": it, "source_id": self.id,
                "noisers": list(draw.noisers),
                "vrf_output": draw.output.hex(),
                "vrf_proof": draw.proof.hex(),
            }
            got: Dict[int, np.ndarray] = {}
            if cfg.adaptive_deadlines:
                # partial-quorum noise collection (docs/STRAGGLERS.md):
                # concurrent fan-out that proceeds with >= 1 vector once
                # the phase's soft deadline passes — one straggling
                # noiser no longer pins the worker for rpc_s x retries.
                # Excluded noisers are counted, never breaker-fed (the
                # cancelled _call records no outcome).
                async def ask_noise(nid):
                    try:
                        _, arrs = await self._call(nid, "RequestNoise",
                                                   nmeta)
                        got[nid] = np.asarray(arrs["noise"], np.float64)
                        return True
                    except Exception:
                        return False

                await self._gather_quorum(
                    stragglers.NOISE,
                    {nid: ask_noise(nid) for nid in draw.noisers},
                    need=1, legacy_s=self.timeouts.rpc_s)
            else:
                for nid in draw.noisers:
                    try:
                        _, arrs = await self._call(nid, "RequestNoise",
                                                   nmeta)
                        got[nid] = np.asarray(arrs["noise"], np.float64)
                    except Exception:
                        continue
            # averaged in draw order (NOT completion order) so the armed
            # fan-out's float reduction is deterministic in the
            # collected set
            used = [n for n in draw.noisers if n in got]
            vectors = [got[n] for n in used]
            if vectors:
                noise = np.mean(vectors, axis=0)
                noised = delta + noise
            # privacy-attack accounting (ref: main.go:1026-1057,1138-1144):
            # colluders are the top `colluders%` of node ids (id ≥
            # collusion_threshold); when a colluding verifier sees our
            # noised delta AND every noiser whose vector actually masks
            # it colludes, the colluders cancel the noise and recover the
            # raw update — counted over the USED set, not the drawn one:
            # a partial-quorum proceed (or a failed honest noiser on the
            # seed path) that leaves only colluders' vectors in the mean
            # is a real breach the drawn-set check would miss
            if cfg.colluders > 0:
                verifiers_now, _, _, _ = self.role_map.committee()
                thresh = cfg.collusion_threshold
                if (any(v >= thresh for v in verifiers_now)
                        and used
                        and all(n >= thresh for n in used)):
                    self._trace("unmasked_update")

        q = self._quantize_np(delta)
        vss = None
        if cfg.secure_agg and not cfg.fedsys:
            # commitment = digest over the per-chunk Pedersen VSS coefficient
            # commitments: the exact object miners verify share rows against,
            # so verifier signatures and share verification bind together
            if (spec is not None and spec.get("vss") is not None
                    and np.array_equal(spec["q"], q)):
                # speculated off this exact head AND the quantized update
                # matches bit-for-bit: the precomputed commitment IS the
                # serial one (same q, same context)
                vss = spec["vss"]
            else:
                t0_c = time.monotonic()
                with self.tele.span("crypto_commit", it=it):
                    vss = await asyncio.to_thread(self._vss_build, q, it)
                await self._slow_pad(time.monotonic() - t0_c)
            commitment = cm.vss_digest(vss[0])
        else:
            t0_c = time.monotonic()
            with self.tele.span("crypto_commit", it=it):
                commitment = await asyncio.to_thread(self._commit, q)
            await self._slow_pad(time.monotonic() - t0_c)
        u = Update(source_id=self.id, iteration=it, delta=delta,
                   commitment=commitment, noise=noise, noised_delta=noised)

        approved = True
        if cfg.verification and not cfg.fedsys:
            verifiers, _, _, _ = self.role_map.committee()
            # verifiers see ONLY the noised copy + commitment: the raw delta
            # is exactly what DP noising and share-based aggregation hide
            # (ref: SURVEY §2.3 row 21 — NoisedDelta to verifiers, Delta to
            # miners)
            # noised copy travels f32: the defense kernels score in f32 on
            # device either way (_decide_round casts), every verifier sees
            # identical bytes (determinism holds), and the dominant
            # verifier-bound payload halves
            redacted = Update(source_id=self.id, iteration=it,
                              delta=np.zeros(0, np.float64),
                              commitment=commitment,
                              noised_delta=np.asarray(noised, np.float32))
            meta, arrays = wire.pack_update(redacted)
            sigs: List[Tuple[int, bytes]] = []

            async def ask(v):
                try:
                    rmeta, _ = await self._call(
                        v, "VerifyUpdateKRUM" if cfg.defense == Defense.KRUM
                        else "VerifyUpdateRONI", meta, arrays,
                        timeout=self.timeouts.krum_s * 2 + self.timeouts.rpc_s)
                    sigs.append((v, bytes.fromhex(rmeta["signature"])))
                    return True
                except Exception as e:
                    self._trace("verify_call_failed", verifier=v,
                                error=f"{type(e).__name__}: {e}")
                    return False

            # partial-quorum signature collection (docs/STRAGGLERS.md):
            # disarmed this is a plain gather over the same coroutines
            # (seed behavior); armed, the fan-out proceeds once the
            # approval quorum is in hand after the phase's soft deadline
            # instead of waiting out a straggling verifier's full
            # krum_s*2+rpc_s budget
            with self.tele.span("verify_wait", it=it):
                await self._gather_quorum(
                    stragglers.VERIFY, {v: ask(v) for v in verifiers},
                    need=max(1, (len(verifiers) + 1) // 2),
                    legacy_s=self.timeouts.krum_s * 2 + self.timeouts.rpc_s)
            # approved iff ≥ half the verifiers signed (ref: main.go:1686)
            approved = len(sigs) >= max(1, (len(verifiers) + 1) // 2)
            u.signers = [v for v, _ in sigs]
            u.signatures = [s for _, s in sigs]
        if not approved:
            self._trace("update_rejected")
            # signed decline notice to the miners: completes their
            # expected-contributor count so the round mints as soon as
            # every sampled worker is accounted for, instead of riding
            # the update deadline (see RoundState.miner_declined)
            _, miners, _, _ = self.role_map.committee()
            dmeta = {
                "iteration": it, "source_id": self.id,
                "sig": self._sign(_decline_message(it, self.id)).hex(),
            }
            await asyncio.gather(*(
                self._safe_call(m, "RegisterDecline", dmeta)
                for m in sorted(miners)
            ))
            return

        _, miners, _, _ = self.role_map.committee()
        if cfg.secure_agg and not cfg.fedsys:
            comms, blind_bytes, c_chunks = vss
            t0_sh = time.monotonic()
            with self.tele.span("share_gen", it=it):
                blind_rows = await asyncio.to_thread(
                    self._vss_blind_rows, blind_bytes, c_chunks)
                shares = np.asarray(ss.make_shares(
                    np.asarray(q), cfg.poly_size, cfg.total_shares))
            await self._slow_pad(time.monotonic() - t0_sh)
            # overlay up-path (docs/OVERLAY.md): hand the full tensors to
            # this round's subtree relay (loopback-free in a hive), which
            # pre-aggregates the whole subtree into one frame per miner.
            # Any failure falls through to the seed's direct fan-out.
            sent = await self._overlay_submit_secret(
                it, commitment, u, shares, blind_rows, comms)
            if not sent:
                for idx, m in enumerate(sorted(miners)):
                    sl = ss.miner_rows(cfg.total_shares, idx, len(miners))
                    try:
                        await self._call(m, "RegisterSecret", {
                            "iteration": it, "source_id": self.id,
                            "miner_index": idx,
                            "commitment": commitment.hex(),
                            "signers": list(u.signers),
                            "signatures": [s.hex() for s in u.signatures],
                        }, self._secret_arrays(shares, blind_rows, comms,
                                               sl))
                    except Exception:
                        pass
        else:
            meta, arrays = wire.pack_update(u)
            meta["iteration"] = it
            # send to every miner: only the leader (max id) mints, so the
            # update must reach it (the reference's first-miner-wins race,
            # main.go:1777-1845, maps onto our single-leader mint). With
            # the overlay armed, miners sharing a remote subtree receive
            # the frame via that subtree's relay — one TCP crossing per
            # subtree, direct fallback on relay failure.
            await self._overlay_fanout("RegisterUpdate", meta, arrays,
                                       sorted(miners), it)
        self._trace("update_sent", secure_agg=cfg.secure_agg)

    def _vss_build(self, q: np.ndarray, it: int,
                   head: Optional[bytes] = None) -> Tuple[np.ndarray, bytes, int]:
        """Pedersen-VSS commitments for every polynomial chunk of the
        quantized update, bound to this round via the (block hash,
        iteration) context. Returns (comms uint8 [C,k,64] affine pairs,
        packed blind coefficients, chunk count). The blinding-SHARE tensor
        is evaluated later, post-approval (_vss_blind_rows): only accepted
        updates ship shares, so rejected workers skip that cost.
        `head` pins the context hash for the speculative caller, which
        must not race a mid-build chain advance; None reads the live
        chain (the serial path)."""
        cfg = self.cfg
        c = ss.num_chunks(len(q), cfg.poly_size)
        padded = np.zeros(c * cfg.poly_size, np.int64)
        padded[: len(q)] = q
        chunks = padded.reshape(c, cfg.poly_size)
        context = ((head if head is not None else self.chain.latest_hash())
                   + int(it).to_bytes(8, "little"))
        comms, blind_bytes = cm.vss_commit_chunks_bytes(
            chunks, self.schnorr_seed, context)
        return comms, blind_bytes, c

    def _vss_blind_rows(self, blind_bytes: bytes, c: int) -> np.ndarray:
        """Blinding-polynomial share tensor uint8 [S,C,32] for all share
        points (the post-approval half of _vss_build)."""
        return cm.vss_blind_rows_bytes(blind_bytes, c, self.cfg.poly_size,
                                       self._xs_all)

    def _secret_arrays(self, shares: np.ndarray, blind_rows: np.ndarray,
                       comms: np.ndarray, sl: slice) -> Dict[str, np.ndarray]:
        """Per-miner RegisterSecret payload — seam overridden by Byzantine
        test peers to inject corrupted tensors."""
        return {"share_rows": shares[sl], "blind_rows": blind_rows[sl],
                "comms": comms}

    async def _safe_call(self, pid, msg_type, meta=None, arrays=None) -> bool:
        try:
            await self._call(pid, msg_type, meta, arrays)
            return True
        except Exception:
            return False

    # ------------------------------------------- aggregation overlay plane
    # (runtime/overlay.py, docs/OVERLAY.md). Every method below is gated
    # on the armed Router: with cfg.overlay off, none of these run and
    # the round's traffic schedule is the seed's, bit for bit.

    def _overlay_saved(self, frames_avoided: int, meta, arrays) -> None:
        """Tick the bytes-saved estimate: `frames_avoided` copies of this
        payload did NOT cross the wire because the tree deduplicated or
        aggregated them."""
        if frames_avoided <= 0:
            return
        self.tele.registry.counter(ov.SAVED_METRIC, ov.SAVED_HELP).inc(
            frames_avoided * ov.frame_estimate(meta, arrays))

    async def _overlay_submit_secret(self, it: int, commitment: bytes,
                                     u: Update, shares: np.ndarray,
                                     blind_rows: np.ndarray,
                                     comms: np.ndarray) -> bool:
        """Worker half of the secure-agg up-path: hand the FULL share /
        blind / commitment tensors to this round's subtree relay in one
        frame (loopback-free when co-hosted). Returns False — caller
        falls back to the seed's per-miner fan-out — whenever the
        overlay is off, the subtree is trivial, or the relay is
        unreachable (the missing-interior-node degradation)."""
        if not self.overlay.enabled:
            return False
        gid = self.overlay.gid_of(self.id)
        workers = [n for n in self.overlay.members(gid)
                   if self.role_map.is_vanilla(n)]
        if len(workers) < 2:
            # a lone contributor has nothing to combine with: the relay
            # hop would add latency without deduplicating anything
            return False
        relay = self.overlay.relay(gid, it)
        offer_meta = {
            "iteration": it, "source_id": self.id,
            "commitment": commitment.hex(),
            "signers": list(u.signers),
            "signatures": [s.hex() for s in u.signatures],
        }
        offer = {
            "commitment": commitment.hex(),
            "signers": list(u.signers),
            "signatures": [s.hex() for s in u.signatures],
            "shares": np.asarray(shares, np.int64),
            "blinds": np.asarray(blind_rows, np.uint8),
            "comms": np.asarray(comms, np.uint8),
        }
        if relay == self.id:
            st = self.round
            if st.iteration != it:
                return False
            self._relay_book_offer(st, self.id, offer)
            self._trace("overlay_offer_local")
            return True
        if protocol.RELAY not in self._grant(relay):
            # the relay's hello did not grant the relay feature (old
            # build / version pin): seed per-miner fan-out, no wasted RPC
            self._trace("overlay_offer_fallback", relay=relay,
                        error="feature_ungranted")
            return False
        try:
            await self._call(relay, "OverlayOffer", offer_meta, {
                "share_rows": offer["shares"],
                "blind_rows": offer["blinds"],
                "comms": offer["comms"],
            })
        except Exception as e:
            self._trace("overlay_offer_fallback", relay=relay,
                        error=type(e).__name__)
            return False
        self._trace("overlay_offer_sent", relay=relay)
        return True

    async def _h_overlay_offer(self, meta, arrays):
        """Relay intake: one subtree leaf's full secure-agg tensors.
        Only leaves of OUR subtree may offer, and only to the peer the
        seed-derived rotation names relay this round; the digest binding
        is checked here (cheap) so one garbage offer cannot poison — and
        thereby fall back — the whole subtree's aggregate. Everything
        else (signature quorums, the share-vs-commitment check) is the
        MINER's job, exactly as on the direct path."""
        it = int(meta["iteration"])
        if it < self.iteration:
            raise StaleError()
        st = await self._wait_round_ready(it)
        if not (self.overlay.enabled and self.cfg.secure_agg):
            raise RPCError("overlay aggregation disabled")
        sid = int(meta["source_id"])
        gid = self.overlay.gid_of(self.id)
        if self.overlay.gid_of(sid) != gid or sid == self.id:
            raise RPCError("offer outside this relay's subtree")
        if self.overlay.relay(gid, it) != self.id:
            raise RPCError("not this round's relay")
        cfg = self.cfg
        c = ss.num_chunks(self.trainer.num_params, cfg.poly_size)
        shares = np.asarray(arrays.get("share_rows", np.zeros(0)), np.int64)
        blinds = np.asarray(arrays.get("blind_rows", np.zeros(0)), np.uint8)
        comms = np.asarray(arrays.get("comms", np.zeros(0)), np.uint8)
        if shares.shape != (cfg.total_shares, c) \
                or blinds.shape != (cfg.total_shares, c, 32) \
                or comms.shape != (c, cfg.poly_size, 64):
            raise RPCError("bad offer tensor shapes")
        commitment = bytes.fromhex(meta.get("commitment", ""))
        if cm.vss_digest(comms) != commitment:
            raise RPCError("commitment digest mismatch")
        self._relay_book_offer(st, sid, {
            "commitment": meta.get("commitment", ""),
            "signers": [int(x) for x in meta.get("signers", [])],
            "signatures": [str(s) for s in meta.get("signatures", [])],
            "shares": shares, "blinds": blinds, "comms": comms,
        })
        return {}, {}

    def _relay_book_offer(self, st: RoundState, sid: int,
                          offer: Dict) -> None:
        if sid in st.relay_offers or sid in st.relay_flushed:
            return  # duplicate offer: first wins, like miner intake
        st.relay_offers[sid] = offer
        self._relay_last_offer = asyncio.get_running_loop().time()
        if st.relay_task is None or st.relay_task.done():
            t = asyncio.get_running_loop().create_task(
                self._relay_flush_loop(st))
            st.relay_task = t
            self._bg_tasks.add(t)
            t.add_done_callback(self._bg_tasks.discard)

    async def _relay_flush_loop(self, st: RoundState) -> None:
        """Wait for the rest of the subtree's offers. Flush the moment
        every expected leaf (this round's vanilla workers in the group)
        is accounted for; otherwise flush once the offer burst stops
        (no new offer for one debounce beat — the verifier releases all
        approved workers at once, so offers arrive as one burst and a
        leaf that DECLINED will simply never offer), with the window as
        the hard cap. The debounce must stay well inside the miner's
        post-quorum grace (~1 s): a relay waiting a full window for a
        decliner would otherwise hold honest shares past the mint. Late
        offers re-arm the loop and aggregate as their own wave (the
        miner accepts disjoint groups)."""
        loop = asyncio.get_running_loop()
        grp = self.overlay.members(self.overlay.gid_of(self.id))
        expected = {n for n in grp if self.role_map.is_vanilla(n)}
        deadline = loop.time() + self.overlay_window_s
        debounce_s = 0.25
        try:
            # outer loop: an offer booked WHILE a flush's RPCs are in
            # flight sees relay_task still alive and arms no new task —
            # it would be silently stranded unless this loop re-checks
            # the buffer after every flush
            while True:
                while loop.time() < deadline:
                    if self.round is not st or (st.block_done is not None
                                                and st.block_done.is_set()):
                        break
                    if expected <= (st.relay_offers.keys()
                                    | st.relay_flushed):
                        break
                    last = getattr(self, "_relay_last_offer", loop.time())
                    if st.relay_offers and loop.time() - last >= debounce_s:
                        break
                    await asyncio.sleep(0.05)
                await self._relay_flush(st)
                if not st.relay_offers or self.round is not st:
                    return
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._trace("overlay_relay_error",
                        error=f"{type(e).__name__}: {e}")

    async def _relay_flush(self, st: RoundState) -> None:
        """Interior-node combine: sum the buffered leaves' share rows,
        blind rows (mod q) and Pedersen commitment grids (point-wise —
        additively homomorphic), then ship ONE RegisterAggregate per
        miner. A miner that refuses the aggregate (RLC failure, member
        conflict) gets the buffered per-member frames instead — the
        exact per-update path, so rejection evidence is unchanged."""
        offers, st.relay_offers = st.relay_offers, {}
        if not offers or self.round is not st:
            return
        members = sorted(offers)
        st.relay_flushed |= set(members)
        cfg = self.cfg
        _, miners, _, _ = self.role_map.committee()
        miners = sorted(miners)

        def build():
            grids = cm.sum_commitment_grids(
                [offers[n]["comms"] for n in members])
            blinds = cm.sum_blind_row_tensors(
                [offers[n]["blinds"] for n in members])
            rows = np.asarray(ss.aggregate_shares(
                np.stack([offers[n]["shares"] for n in members])))
            return grids, blinds, rows

        with self.tele.span("overlay_aggregate", it=st.iteration):
            comms_sum, blinds_sum, rows_sum = await asyncio.to_thread(build)
        member_meta = [{"source_id": n,
                        "commitment": offers[n]["commitment"],
                        "signers": offers[n]["signers"],
                        "signatures": offers[n]["signatures"]}
                       for n in members]
        for idx, m in enumerate(miners):
            sl = ss.miner_rows(cfg.total_shares, idx, len(miners))
            ok = False
            if (comms_sum is not None and len(members) >= 2
                    and protocol.RELAY not in self._grant(m)):
                # the miner's hello did not grant the relay feature (old
                # build / version pin): skip straight to the per-member
                # forwarding below without burning an RPC on a refusal
                self._trace("overlay_aggregate_refused", miner=m,
                            error="feature_ungranted")
            elif comms_sum is not None and len(members) >= 2:
                try:
                    await self._call(m, "RegisterAggregate", {
                        "iteration": st.iteration, "source_id": self.id,
                        "miner_index": idx, "members": member_meta,
                    }, {"agg_rows": rows_sum[sl],
                        "agg_blinds": blinds_sum[sl],
                        "agg_comms": comms_sum})
                    ok = True
                except Exception as e:
                    self._trace("overlay_aggregate_refused", miner=m,
                                error=type(e).__name__)
            if ok:
                self._trace("overlay_aggregate_sent", miner=m,
                            n=len(members))
                self._overlay_saved(
                    len(members) - 1,
                    member_meta[0],
                    {"share_rows": rows_sum[sl],
                     "blind_rows": blinds_sum[sl],
                     "comms": comms_sum})
                continue
            # fallback: forward the buffered per-member frames — bit-
            # equivalent to the workers' own direct sends, so the miner's
            # per-update verification (and its bisection evidence on a
            # corrupted member) applies unchanged
            for n in members:
                o = offers[n]
                self._trace("overlay_fallback_forwarded", miner=m, source=n)
                await self._safe_call(m, "RegisterSecret", {
                    "iteration": st.iteration, "source_id": n,
                    "miner_index": idx, "commitment": o["commitment"],
                    "signers": o["signers"], "signatures": o["signatures"],
                }, {"share_rows": o["shares"][sl],
                    "blind_rows": o["blinds"][sl], "comms": o["comms"]})

    async def _h_register_aggregate(self, meta, arrays):
        """Miner intake of one subtree aggregate: per-member signature
        quorums are checked INDIVIDUALLY (unaggregated, so defense
        verdicts and stake accounting are unchanged), then the whole
        subtree settles in ONE share-vs-commitment RLC check against
        the homomorphically summed grid — W verifications collapse to
        one per subtree. Refusals are ordinary RPCErrors: the relay
        falls back to per-member delivery and the exact per-update
        machinery assigns blame.

        The summed grid is relay-supplied: the per-member digest binding
        is enforced at the RELAY (which holds the per-member grids), not
        here — the documented overlay residual (runtime/overlay.py
        KNOWN RESIDUAL, docs/OVERLAY.md §trust-model): a Byzantine relay
        can substitute its own subtree's aggregate, which in the
        deployed intra-hive shape adds nothing to what the members' own
        host could already do."""
        it = int(meta["iteration"])
        if it < self.iteration:
            raise StaleError()
        st = await self._wait_round_ready(it)
        if not self.role_map.is_miner(self.id):
            raise RPCError("not a miner this round")
        if not (self.overlay.enabled and self.cfg.secure_agg):
            raise RPCError("overlay aggregation disabled")
        mm = meta.get("members") or []
        try:
            members = [int(x["source_id"]) for x in mm]
        except (TypeError, KeyError, ValueError):
            raise RPCError("malformed member metadata")
        if not members or len(set(members)) != len(members):
            raise RPCError("bad member list")
        if any(n not in self.peers for n in members):
            raise RPCError("unknown member")
        conflicts = sorted(n for n in members
                           if n in st.miner_shares
                           or n in st.miner_group_of
                           or n in st.miner_rejected)
        if conflicts:
            raise RPCError(f"members already registered: {conflicts}")
        cfg = self.cfg
        c = ss.num_chunks(self.trainer.num_params, cfg.poly_size)
        rows = np.asarray(arrays.get("agg_rows", np.zeros(0)), np.int64)
        blinds = np.asarray(arrays.get("agg_blinds", np.zeros(0)), np.uint8)
        comms = np.asarray(arrays.get("agg_comms", np.zeros(0)), np.uint8)
        if rows.shape != (cfg.shares_per_miner, c) \
                or blinds.shape != (cfg.shares_per_miner, c, 32) \
                or comms.shape != (c, cfg.poly_size, 64):
            raise RPCError("bad aggregate tensor shapes")
        if cfg.verification:
            # all member quorums in ONE thread hop: a 50-leaf subtree
            # must not serialize 50 to_thread round-trips on the
            # round-critical intake path (each check is itself a batched
            # RLC Schnorr verify inside _verify_sig_quorum)
            def check_quorums() -> str:
                for x in mm:
                    commitment = bytes.fromhex(str(x.get("commitment", "")))
                    ok, why = self._check_secret_quorum(
                        commitment,
                        {"iteration": it, "source_id": x["source_id"],
                         "signers": x.get("signers", []),
                         "signatures": x.get("signatures", [])})
                    if not ok:
                        return f"member {x['source_id']}: {why}"
                return ""
            with self.tele.span("sig_check", it=it):
                bad = await asyncio.to_thread(check_quorums)
            if bad:
                raise RPCError(bad)
        xs = st.my_xs
        if xs is None:
            raise RPCError("share layout not armed")
        t0_mv = time.monotonic()
        with self.tele.span("miner_verify", it=it):
            ok = await asyncio.to_thread(
                cm.vss_verify_multi, [(comms, xs, rows, blinds)])
        await self._slow_pad(time.monotonic() - t0_mv)
        if not ok:
            self._trace("overlay_aggregate_rejected", n=len(members))
            raise RPCError("aggregate fails the RLC consistency check")
        g = frozenset(members)
        st.miner_groups[g] = {"rows": rows, "comms": comms,
                              "blinds": blinds}
        for x in mm:
            n = int(x["source_id"])
            st.miner_group_of[n] = g
            st.miner_commitments[n] = bytes.fromhex(
                str(x.get("commitment", "")))
            try:
                st.miner_sigs[n] = (
                    [int(s) for s in x.get("signers", [])],
                    [bytes.fromhex(s) for s in x.get("signatures", [])])
            except (ValueError, TypeError):
                pass
            st.miner_vss_batch[n] = g
        self._trace("overlay_aggregate_registered", n=len(members),
                    have=len(self._sec_sources(st)))
        self.tele.registry.counter(ov.FRAMES_METRIC, ov.FRAMES_HELP).inc(
            kind="aggregated")
        return {}, {}

    async def _relay_send(self, relay: int, inner_type: str, meta, arrays,
                          ts: List[int], it: int,
                          timeout: Optional[float] = None) -> None:
        """One deduplicated fan-out leg: ship the frame to `relay` for
        forwarding to `ts`. On ANY failure the orphaned targets get the
        seed path's direct sends — the missing-interior-node
        degradation, shared by the update and block broadcast paths."""
        if protocol.RELAY not in self._grant(relay):
            # relay feature ungranted (old build / version pin): the
            # whole leg degrades to direct sends without a wasted RPC
            self._trace("overlay_relay_fallback", relay=relay,
                        error="feature_ungranted")
            await asyncio.gather(*(
                self._safe_call(t, inner_type, meta, arrays) for t in ts))
            return
        try:
            await self._call(relay, "RelayFrames", {
                "iteration": it, "source_id": self.id,
                "inner_type": inner_type, "inner_meta": meta,
                "targets": ts,
            }, arrays, timeout=timeout)
        except Exception as e:
            self._trace("overlay_relay_fallback", relay=relay,
                        error=type(e).__name__)
            await asyncio.gather(*(
                self._safe_call(t, inner_type, meta, arrays) for t in ts))
            return
        self._trace("overlay_relayed_sent", relay=relay, targets=len(ts))
        self._overlay_saved(len(ts) - 1, meta, arrays)
        self.tele.registry.counter(ov.FRAMES_METRIC,
                                   ov.FRAMES_HELP).inc(kind="relayed")

    async def _overlay_fanout(self, msg_type: str, meta, arrays,
                              targets: List[int], it: int) -> None:
        """Overlay-aware push fan-out for verbatim frames: targets that
        share a remote subtree receive the frame through that subtree's
        relay (one TCP crossing per subtree); everything else — and any
        subtree whose relay fails — goes direct, the seed path."""
        direct, relayed = self.overlay.plan(targets, it, self.id)
        await asyncio.gather(
            *(self._safe_call(t, msg_type, meta, arrays) for t in direct),
            *(self._relay_send(r, msg_type, meta, arrays, ts, it)
              for r, ts in relayed.items()))

    async def _h_relay_frames(self, meta, arrays):
        """Interior-node forwarding of a verbatim frame to leaves of OUR
        subtree. The inner type is whitelisted to the two push frames
        the overlay deduplicates; every receiver re-validates the
        forwarded content exactly as it would a direct send, so a
        Byzantine relay can at worst drop (the round's existing
        degradation), never forge. Forwarding is scheduled and the ACK
        returned immediately — custody semantics match a fire-and-
        forget post."""
        if not self.overlay.enabled:
            raise RPCError("overlay disabled")
        inner_type = str(meta.get("inner_type", ""))
        if inner_type not in ("RegisterUpdate", "RegisterBlock"):
            raise RPCError("inner type not relayable")
        inner_meta = meta.get("inner_meta")
        if not isinstance(inner_meta, dict):
            raise RPCError("malformed inner meta")
        try:
            targets = [int(x) for x in meta.get("targets", [])]
        except (TypeError, ValueError):
            raise RPCError("malformed target list")
        grp = set(self.overlay.members(self.overlay.gid_of(self.id)))
        if not targets or len(set(targets)) != len(targets) \
                or any(t not in grp for t in targets):
            raise RPCError("targets outside this relay's subtree")

        async def forward(t: int):
            try:
                if t == self.id:
                    await self._handle(inner_type, dict(inner_meta),
                                       arrays)
                else:
                    await self._call(t, inner_type, dict(inner_meta),
                                     arrays)
                self._trace("overlay_relay_forwarded", target=t,
                            inner=inner_type)
            except asyncio.CancelledError:
                raise
            except Exception:
                pass  # receiver-side verdicts are the receiver's business

        loop = asyncio.get_running_loop()
        for t in targets:
            task = loop.create_task(forward(t))
            self._bg_tasks.add(task)
            task.add_done_callback(self._bg_tasks.discard)
        return {"targets": len(targets)}, {}

    # ---------------------------------------------------------------- miner

    def _miner_leader(self, miners: List[int]) -> int:
        """Leader = max node id among miners (ref: main.go:2027-2045)."""
        return max(miners)

    async def _miner_flow(self) -> None:
        cfg = self.cfg
        it = self.iteration
        st = self.round
        _, miners, _, _ = self.role_map.committee()
        sec = cfg.secure_agg and not cfg.fedsys
        phase = stragglers.SHARE if sec else stragglers.UPDATE
        legacy = self.timeouts.share_s if sec else self.timeouts.update_s
        # adaptive intake deadline (docs/STRAGGLERS.md): disarmed (or
        # unwarmed) the controller answers `legacy` verbatim; armed, a
        # fleet whose intakes historically complete in seconds stops
        # riding the 90 s constant when a worker dies mid-round
        deadline = self._deadline(phase, legacy)
        # both intake paths trigger at NUM_SAMPLES/2 — Krum approves about
        # half the pool (f=0.5·n), so a full-sample target would always ride
        # the deadline (ref: main.go:345-363 shares, main.go:1222-1230
        # updates); FedSys's leader waits for the full sample count
        # (ref: FedSys/main.go:530-558)
        target = (max(1, cfg.num_samples) if cfg.fedsys
                  else max(1, cfg.num_samples // 2))
        expected = [n for n in self.peers
                    if self.role_map.is_vanilla(n) or cfg.fedsys]
        t0 = time.monotonic()
        grace_until = None
        accounted_set: Set[int] = set()
        # the intake wait is a tracing-only span: under the cross-peer
        # timeline the miner's "waiting for shares" window is a real
        # critical-path segment (parked), not untraced dead air
        with self.tele.trace_span("intake_wait", it=it):
            try:
                while time.monotonic() - t0 < deadline:
                    have_keys = (self._sec_sources(st) if sec
                                 else set(st.miner_updates))
                    have = len(have_keys)
                    # every expected contributor has responded — a
                    # submission, a provably bad one, or a signed decline
                    # (verifier-refused workers, RegisterDecline): mint at
                    # once. Union-counted so a Byzantine worker both
                    # declining and submitting is one peer.
                    accounted_set = (have_keys | st.miner_rejected.keys()
                                     | st.miner_declined)
                    accounted = len(accounted_set)
                    # stall forensics: while blocked, publish exactly who
                    # this intake is waiting on (the obs `waiting-on`
                    # column)
                    self.straggler.waiting(
                        phase, (n for n in expected
                                if n not in accounted_set
                                and n != self.id))
                    if accounted >= cfg.num_samples:
                        break
                    if have >= target:
                        # quorum reached — hold a short straggler window
                        # so same-instant submissions (and their
                        # rejections) land in this block rather than
                        # silently missing the round
                        if grace_until is None:
                            grace_until = time.monotonic() + min(
                                1.0, deadline / 4)
                        elif time.monotonic() >= grace_until:
                            break
                    if st.block_done and st.block_done.is_set():
                        return  # someone else minted first
                    await asyncio.sleep(0.05)
            finally:
                self.straggler.clear(phase)
        # feed the controller BOTH outcomes: a satisfied intake records
        # its real completion time, and an EXPIRED one records the full
        # wait (== the deadline) — so a fleet that slowed past the
        # adapted budget grows it back geometrically (×margin per
        # expired round, ceiling = the legacy constant) instead of
        # freezing a too-tight estimate forever and minting short with
        # honest workers excluded every round; once intakes complete
        # again, real observations pull the estimate back down
        self.deadlines.observe(phase, time.monotonic() - t0)
        if self.id != self._miner_leader(miners):
            return  # non-leader miners rely on the block timer fallback
        if st.block_done and st.block_done.is_set():
            return
        # straggler accounting at mint: the sampling design expects
        # `num_samples` contributors — mints short of that proceeded
        # without honest stragglers. Counted by the SHORTFALL (not every
        # unaccounted worker: with sample_percent < 1 the design itself
        # expects fewer responders than workers), traced with the
        # candidate ids, NEVER debited (only provably-bad commitments
        # are) and never breaker evidence — the
        # honest-straggler-never-quarantined contract.
        shortfall = cfg.num_samples - len(accounted_set)
        if shortfall > 0 and (self._sec_sources(st) if sec
                              else st.miner_updates):
            missing = sorted(n for n in expected
                             if n not in accounted_set and n != self.id)
            self.straggler.exclude(phase, missing[:shortfall])
            self._trace("straggler_excluded", phase=phase,
                        peers=missing, short=shortfall,
                        waited_s=round(time.monotonic() - t0, 3))
        # tracing-only composite span: the recovery/verify child spans
        # inside _create_block hang off it, and the broadcast below
        # stamps it as the receivers' parent — the settle leg of the
        # cross-peer causal tree (the gossip fan-out reads the CURRENT
        # context, which inside this block is the mint span)
        with self.tele.trace_span("mint", it=it):
            blk = await self._create_block()
            if blk is not None:
                self._accept_block(blk, gossip=True, minted=True)

    async def _create_block(self) -> Optional[Block]:
        cfg = self.cfg
        st = self.round
        it = self.iteration
        w = self.chain.latest_gradient()
        stake = self.chain.latest_stake_map()

        # Debits are backed ONLY by this leader's own verification evidence
        # (st.miner_rejected): trusting other miners' claimed rejection
        # lists would let a single Byzantine miner zero out arbitrary
        # nodes' stake every round.
        if cfg.secure_agg and not cfg.fedsys:
            # settle our own intake's VSS verification before agreeing on
            # the contributor set (other miners settle theirs when we call
            # GetUpdateList/GetMinerPart on them); rejected_ids is
            # snapshotted AFTER the aggregation-boundary re-check below so
            # offenders it surfaces are debited too
            await self._verify_intake(st)
            _, miners, _, _ = self.role_map.committee()
            miners = sorted(miners)
            # 1. agree on the contributor set: intersection across miners.
            # Miners that fail the exchange are tracked as LOST: with the
            # resharing plane armed (cfg.reshare) the round can still
            # recover from the survivors' re-dealt shares — the seed
            # behavior (a lost miner empties the intersection and the
            # round) remains when resharing is off.
            node_sets = [self._sec_sources(st)]
            reachable = [self.id]
            for m in miners:
                if m == self.id:
                    continue
                try:
                    rmeta, _ = await self._call(m, "GetUpdateList", {
                        "iteration": it, "source_id": self.id,
                        "sig": self._sign(self._part_message(
                            "update-list", it, [])).hex(),
                    })
                    node_sets.append(set(int(x) for x in rmeta["sources"]))
                    reachable.append(m)
                except Exception:
                    if not self.cfg.reshare:
                        node_sets.append(set())
            lost = [m for m in miners if m not in reachable]
            if lost and self.cfg.reshare:
                self._trace("miner_lost", peers=sorted(lost))
            nodes = sorted(set.intersection(*node_sets)) if node_sets else []
            # aggregation-boundary re-check (docs §aggregated-vss): when
            # the agreed set covers the leader's intake batch only
            # partially, the partial members are re-proved; offenders the
            # re-check surfaces are rejected with LEADER evidence (so the
            # minted block debits them), dropped from the set, and the
            # remainder re-proved — colluders whose corruptions cancelled
            # inside the intake batch are caught the moment the agreed
            # set splits the coalition. Terminates: every False iteration
            # removes at least one sid from miner_shares.
            while nodes and not await self._ensure_subset_consistent(
                    st, nodes):
                nodes = [n for n in nodes if n in self._sec_sources(st)]
            rejected_ids = set(st.miner_rejected)
            agg = np.zeros(self.trainer.num_params, np.float64)
            if nodes and lost and self.cfg.reshare:
                # membership epoch bump: the committee lost a holder
                # mid-round — run the distributed resharing round over
                # the survivors and recover from the re-dealt shares
                recovered = await self._reshare_recover(st, miners,
                                                        reachable, nodes,
                                                        it)
                if recovered is None:
                    return self._empty_block()
                agg = recovered
            elif nodes:
                # 2. gather every miner's aggregated slice
                slices: Dict[int, np.ndarray] = {}
                ok = True
                for idx, m in enumerate(miners):
                    if m == self.id:
                        decomp = self._sec_decompose(st, nodes)
                        if decomp is None:
                            return self._empty_block()
                        slices[idx] = np.asarray(ss.aggregate_shares(
                            np.stack(decomp[0])))
                        continue
                    try:
                        _, arrs = await self._call(m, "GetMinerPart", {
                            "iteration": it, "nodes": nodes,
                            "source_id": self.id,
                            "sig": self._sign(self._part_message(
                                "miner-part", it, nodes)).hex(),
                        })
                        slices[idx] = np.asarray(arrs["agg_rows"], np.int64)
                    except Exception:
                        ok = False
                if not ok or len(slices) != len(miners):
                    # a miner died BETWEEN set agreement and slice
                    # collection: same epoch bump, same resharing round —
                    # survivors re-deal and recovery proceeds without the
                    # lost rows (the guard inside _h_get_reshare_deal
                    # accepts the identical aggregation set it already
                    # served a plain slice for, and refuses any other)
                    if not self.cfg.reshare:
                        return self._empty_block()
                    survivors = [self.id] + [
                        m for i, m in enumerate(miners)
                        if m != self.id and i in slices]
                    self._trace("miner_lost", peers=sorted(
                        m for m in miners if m not in survivors))
                    recovered = await self._reshare_recover(
                        st, miners, survivors, nodes, it)
                    if recovered is None:
                        return self._empty_block()
                    agg = recovered
                else:
                    # 3. reassemble rows and recover the aggregate
                    full = np.concatenate([slices[i]
                                           for i in range(len(miners))])
                    xs = self._xs_arr
                    t0_rec = time.monotonic()
                    with self.tele.span("recovery", it=it):
                        agg = np.asarray(ss.recover_update(
                            full, xs, self.trainer.num_params,
                            cfg.poly_size, cfg.precision))
                    await self._slow_pad(time.monotonic() - t0_rec)
            deltas = [Update(source_id=n, iteration=it,
                             delta=np.zeros(0, np.float64),
                             commitment=self.round.miner_commitments.get(n, b""),
                             accepted=True,
                             signers=st.miner_sigs.get(n, ([], []))[0],
                             signatures=st.miner_sigs.get(n, ([], []))[1])
                      for n in nodes]
            contributors = list(nodes)
        else:
            rejected_ids = set(st.miner_rejected)
            updates = [st.miner_updates[k] for k in sorted(st.miner_updates)]
            agg = np.zeros(self.trainer.num_params, np.float64)
            if updates:
                mat = np.stack([u.delta for u in updates])
                if cfg.fedsys:
                    agg = mat.mean(axis=0)  # FedSys averages (FedSys/honest.go:311)
                elif cfg.defense == Defense.TRIMMED_MEAN:
                    # non-IID-robust aggregation (ops/robust_agg.py):
                    # deterministic over the sorted update set, so every
                    # miner computes the identical aggregate and the
                    # chain-equality oracle holds. Only reachable with
                    # secure_agg off (config.__post_init__ enforces the
                    # shares-vs-order-statistics incompatibility).
                    # Applied for ALL n >= 1 — degraded rounds carrying
                    # 1–2 updates (exactly what the fault plane produces)
                    # must not silently lapse to an undefended sum; the
                    # kernel clamps its trim to keep >= 1 element, so for
                    # n <= 2 it degenerates to the (sum-scaled) mean,
                    # traced below for artifact visibility (ADVICE r5).
                    from biscotti_tpu_torch.ops.robust_agg import trimmed_mean_aggregate

                    if len(updates) <= 2:
                        self._trace("trimmed_mean_degenerate",
                                    n=len(updates))
                    agg = trimmed_mean_aggregate(
                        self._f32(mat), cfg.trim_fraction
                    ).cpu().numpy().astype(np.float64)
                else:
                    agg = mat.sum(axis=0)  # Biscotti sums (honest.go:360-375)
                for u in updates:
                    u.accepted = True
                    # noise / noised_delta are worker→verifier transport
                    # fields; carrying them in the minted block doubles its
                    # wire size for no reader (the delta is the receipt)
                    u.noise = None
                    u.noised_delta = None
                    if cfg.fedsys:
                        # the reference's FedSys broadcasts the MODEL only
                        # (RegisterModel, FedSys/main.go:612-647) — there
                        # is no ledger receipt of individual deltas. Keep
                        # the contributor record, drop the array: a full
                        # delta list made the block ~70x larger than the
                        # model it carries
                        u.delta = np.zeros(0, np.float64)
            deltas = updates
            contributors = [u.source_id for u in updates]

        rejected_ids -= set(contributors)
        if not contributors and not rejected_ids:
            return self._empty_block()
        # rejected submissions ride in the block as accepted=False records
        # and are debited, mirroring the reference's block-level stake
        # update (ref: honest.go:363-370: +STAKE_UNIT accepted, − rejected);
        # stake is floored at zero so repeat offenders cannot push the
        # lottery ticket pool negative
        deltas = deltas + [st.miner_rejected[n] for n in sorted(rejected_ids)]
        new_stake = dict(stake)
        for n in contributors:
            new_stake[n] = new_stake.get(n, 0) + cfg.stake_unit
        for n in rejected_ids:
            new_stake[n] = max(0, new_stake.get(n, 0) - cfg.stake_unit)
        blk = Block(
            # mint onto the codec's downcast grid (transform_dense is the
            # identity for raw64/zlib): the sealed hash then covers values
            # an f32/bf16 wire carries exactly, so every receiver's hash
            # check passes regardless of which codec its link negotiated.
            # Never sparsified — topk applies to per-round deltas only.
            data=BlockData(iteration=it,
                           global_w=self.wire.transform_dense(w + agg),
                           deltas=deltas),
            prev_hash=self.chain.latest_hash(),
            stake_map=new_stake,
        ).seal()
        self._trace("block_minted", contributors=len(contributors),
                    rejected=len(rejected_ids))
        return blk

    def _empty_block(self) -> Block:
        """Round-advancing empty block (ref: main.go:2099-2143)."""
        return Block(
            data=BlockData(iteration=self.iteration,
                           global_w=self.chain.latest_gradient()),
            prev_hash=self.chain.latest_hash(),
            stake_map=self.chain.latest_stake_map(),
        ).seal()

    # ----------------------------------------------------------- main loop

    async def _run_round(self) -> None:
        cfg = self.cfg
        self._compute_roles()
        it = self.iteration
        loop = asyncio.get_running_loop()
        self.round = RoundState(
            iteration=it,
            krum_decision=loop.create_future(),
            block_done=asyncio.Event(),
        )
        if self._preverify_gate:
            # entries for settled rounds are dead weight; live near-future
            # entries survive so their one-shot grant still holds
            self._preverify_gate = {k for k in self._preverify_gate
                                    if k[0] >= it}
        st = self.round
        if self.role_map.is_miner(self.id) and self.cfg.secure_agg:
            st.my_xs = self._my_share_xs()
        self._round_t0 = time.monotonic()
        if self.tele.trace:
            # root the round's causal tree: every peer derives the SAME
            # trace id for iteration `it` (pure function of the protocol
            # seed), so the N per-peer trees stitch into one cluster-wide
            # round trace. The root context is installed on THIS task, and
            # create_task's context copy threads it into the worker/miner
            # flows, watchdogs, and gossip pushes below; the round_start
            # event below carries the root span id (its `parent` field),
            # which is how trace_round finds each peer's root.
            self.tele.round_root(tracectx.trace_id_for(cfg.seed, it), it)
        self._trace("round_start",
                    verifier=self.role_map.is_verifier(self.id),
                    miner=self.role_map.is_miner(self.id))

        # adversary observation hook (docs/ADVERSARY.md): an armed
        # campaign sees what any participant at this peer sees — the
        # public election just computed above and the latest block —
        # and fixes this round's actions (flood targets, recycle,
        # poison scale) BEFORE any of them fire (the self-kill below
        # included, so a recycle is counted before it executes)
        if self.campaign is not None:
            self._campaign_observe(it)

        # seeded churn self-kill (--fault-churn, docs/MEMBERSHIP.md): this
        # round is OUR scheduled death — exit cleanly so the launcher can
        # relaunch us at the scheduled restart round. The in-process
        # ChurnRunner kills from the outside instead (hard-crash
        # semantics); both ride the same replayable schedule.
        if it in self._churn_kills:
            self._trace("churn_self_kill", height=it)
            raise faults.ChurnExit(it)

        # random self-crash fault injection (ref: main.go:54-55,1117-1120)
        if cfg.fail_prob > 0 and self._rng.random() < cfg.fail_prob:
            self._trace("self_crash")
            os._exit(17)

        work = []
        if self.role_map.is_verifier(self.id):
            async def krum_timer():
                # adaptive defense-decision timer (docs/STRAGGLERS.md):
                # disarmed/unwarmed = the legacy krum_s fallback verbatim
                await asyncio.sleep(self._deadline(stragglers.KRUM,
                                                   self.timeouts.krum_s))
                self._decide_round()  # timeout fallback (ref: krum.go:178-224)
            work.append(loop.create_task(krum_timer()))
        if self.role_map.is_miner(self.id):
            work.append(loop.create_task(self._miner_flow()))
        if self.role_map.is_vanilla(self.id) or cfg.fedsys:
            if not (cfg.fedsys and self.id == 0):
                work.append(loop.create_task(self._worker_flow()))

        # block deadline: every peer advances the round no matter what
        # (ref: main.go:2326-2355 startBlockDeadlineTimer). Armed, the
        # controller shrinks this toward the fleet's observed round times
        # (clamped to [floor, block_s]) — a dead miner costs the cluster
        # roughly one typical round, not the full 300 s constant.
        block_dl = self._deadline(stragglers.BLOCK, self.timeouts.block_s)
        _, _miners_now, _, _ = self.role_map.committee()
        leader = self._miner_leader(sorted(_miners_now)) \
            if _miners_now else None

        async def stall_watchdog():
            # stall forensics (always-on, read-only): a round stuck past
            # half its block deadline records WHICH phase it is blocked
            # on and WHOM it awaits — biscotti_round_stalls_total{phase}
            # plus a traced event carrying the peer ids, so a wedged
            # production round is diagnosable from a scrape instead of a
            # post-mortem log dig
            await asyncio.sleep(max(0.05, block_dl / 2))
            if st.block_done.is_set() or self.iteration != it:
                return
            waiting = {ph: ps for ph, ps in
                       self.straggler.waiting_on.items() if ps}
            if waiting:
                ph, peers = next(iter(waiting.items()))
            else:
                ph, peers = stragglers.BLOCK, \
                    ([leader] if leader is not None
                     and leader != self.id else [])
            self.straggler.stall(ph, peers, it)
            self._trace("round_stall", phase=ph, peers=sorted(peers),
                        after_s=round(block_dl / 2, 3))

        work.append(loop.create_task(stall_watchdog()))
        st.tasks.extend(work)

        try:
            self.straggler.waiting(
                stragglers.BLOCK,
                [leader] if leader is not None and leader != self.id
                else [])
            # tracing-only: the block wait is most of a non-miner's round
            # — under the timeline it is an explicit parked segment
            with self.tele.trace_span("block_wait", it=it):
                await asyncio.wait_for(st.block_done.wait(), block_dl)
            self.straggler.clear(stragglers.BLOCK)
            # a block landed: the completed round duration is the
            # controller's primary signal for next round's block budget
            self.deadlines.observe(stragglers.BLOCK,
                                   time.monotonic() - self._round_t0)
            self._empty_fallbacks = 0
        except asyncio.TimeoutError:
            self.straggler.clear(stragglers.BLOCK)
            if self.iteration == it:
                # before minting an empty block, try pulling the round's
                # block from a few peers — if the network minted one and
                # only our copy of the gossip was lost, this re-joins the
                # consensus chain instead of forking onto an empty one
                pulled = False
                candidates = [p for p in self.peers if p != self.id]
                for pid in self._rng.sample(candidates,
                                            min(3, len(candidates))):
                    try:
                        bmeta, barrays = await self._call(
                            pid, "GetBlock",
                            {"iteration": it,
                             **self._reply_codec_meta(pid)},
                            timeout=min(5.0, self.timeouts.rpc_s))
                        blk = wire.unpack_block(bmeta, barrays)
                        if blk.hash == blk.compute_hash():
                            self._accept_block(blk, gossip=True)
                            if self.iteration != it:
                                self._trace("block_timeout_pull_recovered")
                                # a successful pull is proof of connectivity
                                # — don't let earlier fallbacks accumulate
                                # into a spurious isolation re-announce
                                self._empty_fallbacks = 0
                                pulled = True
                                break
                    except Exception:
                        continue
                if not pulled and self.iteration == it:
                    self._trace("block_timeout_empty_fallback")
                    self._empty_fallbacks = getattr(
                        self, "_empty_fallbacks", 0) + 1
                    self._accept_block(self._empty_block(), gossip=True,
                                       minted=True)
        if not st.krum_decision.done():
            st.krum_decision.set_result(set())
        for t in work:
            if not t.done():
                t.cancel()
        await asyncio.gather(*work, return_exceptions=True)

        # convergence must be a *uniform* decision: every peer evaluates the
        # same model on the same global test split, so all peers exit at the
        # same height and the chain-equality oracle holds (the reference
        # likewise scores the shared global data, ref: honest.go:141-162)
        with self.tele.span("metrics", it=it):
            if self.stepper is not None and hasattr(self.stepper,
                                                    "test_error"):
                # co-located peers share one evaluation: identical model ×
                # identical global split (the uniformity the oracle needs)
                err = await self.stepper.test_error(
                    self.chain.latest_gradient(), it)
            else:
                err = await asyncio.to_thread(self.trainer.test_error,
                                              self.chain.latest_gradient())
        self.logs.append((it, err, time.time()))
        # height pins the event to the round just finished: the implicit
        # iter stamp has already advanced past the accepted block, which
        # would credit this round's end to the NEXT round's ledger
        # (tools/profile_round keys its wall-clock table on it)
        self._trace("round_end", error=err, height=it)
        if err < cfg.convergence_error:
            self.converged = True
        # round boundary = the recorder's durability point (its spill is
        # batched, not per-event) and a natural moment to refresh the
        # scrape gauges so a mid-run `Metrics` pull is never a round stale
        self._refresh_gauges()
        self.tele.flush()

    async def _announce(self, want_chain: bool = True) -> None:
        """Bootstrap: register with every peer concurrently, adopt the
        longest chain seen (ref: main.go:926-1024 — the reference announces
        serially; at N=100 a serial announce storm alone costs whole
        rounds, so the fan-out runs as one gather). A snapshot-
        bootstrapping joiner announces with `want_chain=False` (wire flag
        `no_chain`): the hello still registers it everywhere, but chain
        bodies stay off the wire — catch-up comes from GetSnapshot.

        Concurrency is bounded to the pool's connection cap: an unbounded
        gather keeps every dialed connection busy at once, so LRU eviction
        cannot close any of them and the CLUSTER transiently holds O(N²)
        sockets — observed blowing the 20k fd limit at N≳150 single-box
        (fedsys's star topology made it visible first, but the spike is
        mode-independent). Bounded, the working set stays ≈ pool cap per
        peer and eviction keeps up."""
        sem = asyncio.Semaphore(self.pool.max_conns)

        async def one(pid: int) -> None:
            try:
                async with sem:
                    w, ln = self.chain.adoption_key()
                    hello = {"source_id": self.id,
                             "host": self.peers[self.id][0],
                             "port": self.peers[self.id][1],
                             "have_weight": w, "have_blocks": ln,
                             # wire-plane hello: what we can decode, plus
                             # a reply-codec ask for the chain body
                             # (honoured only by capable peers, ignored
                             # by legacy ones)
                             "codecs": sorted(self.caps),
                             **self._reply_codec_meta(pid)}
                    if not want_chain:
                        hello["no_chain"] = True
                    cmeta, carrays = await self._call(pid, "RegisterPeer",
                                                      hello)
                self._record_caps(pid, cmeta.get("codecs"))
                if not want_chain:
                    return
                blocks = wire.unpack_chain(cmeta, carrays)
                if blocks:
                    # quorum sweep off-loop (read-only); the adoption —
                    # the chain MUTATION — on the loop, where no handler
                    # can observe a half-swapped chain
                    ok = await asyncio.to_thread(self._chain_quorums_ok,
                                                 blocks)
                    self._adopt_candidate(blocks, pid, quorums_ok=ok)
            except Exception:
                pass

        # co-hosted peers (hive mode) were made mutually known — caps +
        # liveness — at construction; REMOTE peers still get the hello,
        # which is how a late-started hive adopts the cluster's chain
        await asyncio.gather(*(one(pid) for pid in sorted(self.peers)
                               if pid != self.id
                               and pid not in self._announce_skip))

    async def run(self) -> Dict:
        # resume from the newest on-disk snapshot, then let longest-chain
        # adoption advance us further (SURVEY §5.4: the chain IS the
        # checkpoint; the snapshot only survives full-network restarts)
        if self.ckpt_dir:
            from biscotti_tpu_torch.utils import checkpoint as ckpt

            # newest snapshot first, older ones as fallback: a torn newest
            # write must not discard an intact older snapshot. Any corrupt
            # snapshot (bad zip, bad json, structurally wrong manifest,
            # failed chain verify) is skipped, never a startup crash —
            # worst case we start from genesis and longest-chain adoption
            # catches us up from live peers.
            for step in reversed(ckpt.list_steps(self.ckpt_dir)):
                try:
                    restored = ckpt.load(self.ckpt_dir, step=step)
                except Exception as e:
                    self._trace("checkpoint_rejected", step=step,
                                error=f"{type(e).__name__}: {e}")
                    continue
                # same guards as live-network adoption: heavier, verified,
                # quorum-authenticated, grown from OUR genesis — a stale/
                # foreign ckpt-dir (different dims / num_nodes / stake)
                # hashes to a different genesis and is refused, as is an
                # empty chain or one with forged contributions
                if self._chain_quorums_ok(restored.blocks,
                                          restored.pruned_before) \
                        and self.chain.maybe_adopt(restored):
                    self._trace("checkpoint_restored",
                                height=self.chain.latest.iteration)
                    break
                self._trace("checkpoint_rejected", step=step,
                            error="not adoptable")
        if self.device_crypto:
            # warm the device-crypto plane at this deployment's bucket
            # shapes BEFORE the first round (kernel build, first
            # launches): that cost belongs to startup, not inside a round
            # deadline. The thread hop keeps the event loop serving while
            # it runs.
            ck = ss.num_chunks(self.trainer.num_params,
                               self.cfg.poly_size) * self.cfg.poly_size
            await asyncio.to_thread(devkern.prewarm, ck)
            self._trace("device_crypto_prewarmed", grid_points=ck)
        await self.server.start()
        if self.cfg.metrics_port:
            # optional HTTP exposition beside the RPC server: stock
            # Prometheus (or curl) can scrape this peer with no protocol
            # codec — same +node_id port layout as base_port
            self._metrics_server = await serve_metrics(
                self._render_metrics, self.cfg.my_ip,
                self.cfg.metrics_port + self.id)
        if self.id != 0:
            if self.cfg.snapshot_bootstrap \
                    and protocol.SNAPSHOT in self.caps:
                # membership plane: hello everywhere WITHOUT chain bodies,
                # then catch up from one peer's sealed snapshot — the
                # pre-snapshot history never crosses the wire. A
                # --protocol-version pin predating the snapshot feature
                # joins like the old build: full-chain announce.
                await self._announce(want_chain=False)
                await self._snapshot_bootstrap()
            else:
                await self._announce()
        # a RELAUNCHED incarnation rebuilds the same churn schedule from
        # the same flags — kill rounds at or below the history it just
        # adopted (checkpoint restore and/or announce) were already
        # executed by the previous incarnation and must not re-fire: a
        # supervisor-relaunched peer re-traversing its own kill round
        # would otherwise die again in a clean-exit loop. A genesis
        # launch adopts nothing, so its full schedule survives this.
        self._churn_kills = frozenset(r for r in self._churn_kills
                                      if r > self.iteration)
        try:
            while not self.converged \
                    and self.iteration < self.cfg.max_iterations:
                await self._run_round()
                # two consecutive rounds advanced only by our own
                # timeout-minted empty blocks: we are likely isolated
                # (partition survivor or gossip-evicted) — re-announce to
                # re-adopt the longest chain and re-enter peers' gossip
                # sets (the reference can only heal via its startup
                # announce; ref: localTest.sh's partition test was left
                # commented out)
                if getattr(self, "_empty_fallbacks", 0) >= 2:
                    self._trace("isolation_reannounce")
                    await self._announce()
                    self._empty_fallbacks = 0
                if self.ckpt_dir and self.iteration % self.ckpt_every == 0:
                    from biscotti_tpu_torch.utils import checkpoint as ckpt

                    await asyncio.to_thread(ckpt.save, self.chain,
                                            self.ckpt_dir)
                    await asyncio.to_thread(ckpt.prune, self.ckpt_dir, 3)
        except faults.ChurnExit:
            # scheduled self-kill (--fault-churn): an abrupt but CLEAN
            # exit — sockets released synchronously so the relaunched
            # incarnation can rebind immediately, spill drained, NO crash
            # dump (scripted chaos is not a failure). The launcher
            # relaunches at the scheduled restart round; rejoin then goes
            # through checkpoint restore + announce (or snapshot
            # bootstrap) like any other restart.
            self.server.close_now()
            self.pool.close()
            if self._metrics_server is not None:
                self._metrics_server.close()
            snapshot = self.telemetry_snapshot()
            self._release_device_hooks()
            self.tele.close()
            return self._result(snapshot, churned=True)
        except asyncio.CancelledError:
            # routine teardown (a harness cancelling the task, Ctrl-C):
            # drain the batched spill so the event log is complete, but a
            # cancellation is not a crash — no forensic dump. The RPC
            # server's listen socket is released SYNCHRONOUSLY: left to
            # GC it stays bound for an unbounded grace period, and the
            # next cluster on this port fails its bind
            self.server.close_now()
            self.pool.close()
            if self._metrics_server is not None:
                self._metrics_server.close()
            self._release_device_hooks()
            self.tele.close()
            raise
        except BaseException as e:
            # crash path: the last `recorder_ring` events before the
            # exception are exactly the forensic record the reference
            # never had — dump the ring beside the spill file and flush
            # whatever the batch buffer still holds, then re-raise
            self.tele.crash_dump(reason=f"{type(e).__name__}: {e}")
            self.server.close_now()
            self.pool.close()
            if self._metrics_server is not None:
                self._metrics_server.close()
            self._release_device_hooks()
            self.tele.close()
            raise
        dump = self.chain.dump()
        # Linger before tearing down: the FINAL round's block gossip has no
        # later round to heal it — a peer that missed the push must pull
        # the body from someone still serving GetBlock. Finish our own
        # outbound gossip/advert tasks (bounded) and keep the server up for
        # a short grace window so stragglers' pulls land; without this, a
        # single dropped broadcast frame in the last round stranded peers
        # on their 300 s block timer at N=100 while everyone who could have
        # served the block had already exited.
        if self._bg_tasks:
            await asyncio.wait(list(self._bg_tasks),
                               timeout=min(5.0, self.timeouts.rpc_s))
        await asyncio.sleep(min(2.0, self.timeouts.rpc_s / 3))
        self.pool.close()
        await self.server.stop()
        if self._metrics_server is not None:
            self._metrics_server.close()
        snapshot = self.telemetry_snapshot()
        self._release_device_hooks()
        self.tele.close()  # final flush of the batched spill
        return self._result(snapshot, chain_dump=dump)

    def _result(self, snapshot: Dict, chain_dump: Optional[str] = None,
                **extra) -> Dict:
        """The run() result schema, shared by the normal exit and the
        churn self-kill exit (which additionally flags `churned`)."""
        out = {
            "node": self.id,
            "iterations": self.iteration,
            "converged": self.converged,
            "chain_dump": (chain_dump if chain_dump is not None
                           else self.chain.dump()),
            "final_error": self.logs[-1][1] if self.logs else float("nan"),
            "logs": [f"{i},{e:.6f},{t:.6f}" for i, e, t in self.logs],
            # attack/security accounting, printed at exit by the reference
            # (ref: main.go:1071-1088) — here returned structured
            "counters": dict(self.counters),
            "phases": self.phases.summary(),
            # robustness accounting: per-peer breaker states/opens/closes/
            # fast-fails, and (when the fault plane is armed) the injected
            # fault tallies — chaos harnesses assert on these
            "health": self.health.snapshot(),
            "faults": (dict(self.pool.faults.counts)
                       if self.pool.faults is not None else {}),
            # the unified readout (same schema the Metrics RPC serves):
            # chaos harnesses, eval drivers, and tools/obs.py consume
            # this; the flat keys above stay as the back-compat view
            "telemetry": snapshot,
        }
        out.update(extra)
        return out

    def _render_metrics(self) -> str:
        """Prometheus page for the optional HTTP endpoint — gauges are
        refreshed per scrape (pull model, see _refresh_gauges)."""
        self._refresh_gauges()
        return self.tele.render()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="biscotti-tpu peer agent (PyTorch port, on the GPU)")
    BiscottiConfig.add_args(ap)
    ap.add_argument("--platform", default="cuda",
                    help="torch device of the peer: 'cuda' (the default; "
                         "raises without a GPU) or 'cpu'")
    ap.add_argument("--key-dir", default="")
    ap.add_argument("--log-dir", default="")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ns = ap.parse_args(argv)
    cfg = BiscottiConfig.from_args(ns)
    cfg = cfg.replace(timeouts=cfg.timeouts.scaled(
        cfg.num_nodes, cfg.num_verifiers, cfg.num_miners,
        random_sampling=cfg.random_sampling,
        defense_is_krum=cfg.defense == Defense.KRUM))
    log_path = (os.path.join(ns.log_dir, f"events_{cfg.node_id}.jsonl")
                if ns.log_dir else "")
    ckpt_dir = (os.path.join(ns.ckpt_dir, f"node_{cfg.node_id}")
                if ns.ckpt_dir else "")
    agent = PeerAgent(cfg, key_dir=ns.key_dir, log_path=log_path,
                      ckpt_dir=ckpt_dir, ckpt_every=ns.ckpt_every,
                      device=ns.platform)
    result = asyncio.run(agent.run())
    print("=== CHAIN DUMP ===")
    print(result["chain_dump"])
    print("=== LOGS ===")
    for line in result["logs"]:
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
