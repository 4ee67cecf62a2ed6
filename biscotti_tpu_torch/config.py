# The port's own copy of biscotti_tpu/config.py, in full: torch-free, and it imports nothing of biscotti_tpu.
"""Typed configuration covering the reference's full flag + constant surface.

Mirrors the CLI flags of the reference protocol binary
(ref: DistSys/main.go:613-649) and its compile-time constants
(ref: DistSys/main.go:28-60), plus TPU topology fields that have no
reference analogue. Derived quantities (NUM_SAMPLES, KRUM_UPDATETHRESH,
TOTAL_SHARES, collusion threshold; ref: DistSys/main.go:670-687,825-831)
are computed properties so they can never drift from the primary fields.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import math
from dataclasses import dataclass, field

# stdlib-only modules (hash-derived decisions, breaker state machine,
# token buckets): safe to import here without dragging the asyncio
# runtime into config users
from biscotti_tpu_torch.ops.trust import TrustPlan
from biscotti_tpu_torch.runtime.admission import AdmissionPlan
from biscotti_tpu_torch.runtime.adversary import CAMPAIGNS, CampaignPlan
from biscotti_tpu_torch.runtime.faults import SLOW_PRESETS, FaultPlan
from biscotti_tpu_torch.runtime.placement import PlacementPlan


class Defense(str, enum.Enum):
    """Poisoning-defense selection (ref: DistSys/main.go:57 POISON_DEFENSE).

    MULTIKRUM / TRIMMED_MEAN have no reference analogue — they are the
    non-IID-robust options (ops/robust_agg.py) covering the regime where
    vanilla Krum's closest-neighbour score fails (Dirichlet-skewed shards;
    see poison_mnist_dir0.3_100.json heterogeneity_note).

    Trade-off to understand before picking TRIMMED_MEAN on the live
    protocol: it is an aggregation rule with NO per-update reject, so the
    block-level stake penalty never fires — poisoners keep earning stake
    (and committee lottery weight) even while their coordinate values are
    trimmed out of every aggregate. Where the proof-of-stake deterrent
    matters, prefer MULTIKRUM (a verifier accept mask like KRUM: rejected
    updates are stake-debited) or run TRIMMED_MEAN only in simulator/
    FedSys-style settings where stake does not gate committee election."""

    NONE = "NONE"
    KRUM = "KRUM"
    RONI = "RONI"
    MULTIKRUM = "MULTIKRUM"
    TRIMMED_MEAN = "TRIMMED_MEAN"
    # FoolsGold-style mutual-similarity outlier rejection (robust_agg.py):
    # an accept-mask defense like KRUM, so it composes with secure-agg and
    # the stake penalty; targets the sybil-shaped attack the reference
    # ships (near-duplicate poisoned shards) where it separates under
    # Dirichlet skew that defeats vanilla Krum. Scoring is single-round on
    # the copies the verifier sees: with committee noising at ε=1.0 and
    # mnist dims the DP noise masks update geometry and EVERY geometry
    # defense (this one and Krum alike) degrades toward accept-everyone —
    # its demonstrated win is the noising-off defense-geometry operating
    # point (see ops/robust_agg.py OPERATING POINT note)
    FOOLSGOLD = "FOOLSGOLD"
    # Adaptive defense plane (ops/trust.py, docs/DEFENSES.md): the
    # cross-round TrustLedger composes Krum geometry, keep-set-calibrated
    # pairwise similarity, a magnitude band, a temporal-drift scorer fed
    # by the committed chain's accept/reject walk, and a stake-weighted
    # slow-trust ramp into ONE accept mask with hysteresis. Still a
    # verifier accept-mask defense — rejection mechanics are exact parity
    # with KRUM/MULTIKRUM (worker declines, no record lands), so it
    # composes with secure aggregation; the evidence trail is the verdict
    # stream + trust snapshot. Built to close the measured hugger gap
    # (the threshold-walking poisoner that defeats memoryless Krum).
    ENSEMBLE = "ENSEMBLE"


@dataclass
class Timeouts:
    """Deadline-timer constants, in seconds (ref: DistSys/main.go:28-36).

    The reference scales these by node count and committee sizes at startup
    (ref: DistSys/main.go:786-825); `scaled()` reproduces that behavior.
    """

    update_s: float = 90.0
    block_s: float = 300.0
    krum_s: float = 60.0
    share_s: float = 90.0
    rpc_s: float = 120.0

    def scaled(self, num_nodes: int, num_verifiers: int, num_miners: int,
               random_sampling: bool = False,
               defense_is_krum: bool = True) -> "Timeouts":
        """The reference's startup scaling, rule for rule
        (ref: DistSys/main.go:786-825): the base constants are sized for
        100 nodes; random sampling doubles RPC+update deadlines; committees
        >10 at N=100 double the affected deadlines; N/100 (integer, so a
        no-op below 200 nodes) multiplies everything."""
        update_s, krum_s, rpc_s = self.update_s, self.krum_s, self.rpc_s
        block_s, share_s = self.block_s, self.share_s
        if defense_is_krum and random_sampling:
            rpc_s *= 2  # ref: main.go:788-791
            update_s *= 2
        if num_miners > 10 and num_nodes == 100:
            update_s *= 2  # ref: main.go:796-800
        if num_verifiers > 10 and num_nodes == 100:
            krum_s *= 2  # ref: main.go:802-807
            update_s *= 2
        mult = num_nodes // 100  # ref: main.go:810-825 (integer division)
        if mult >= 1:
            update_s *= mult
            krum_s *= mult
            block_s *= mult
            rpc_s *= mult
            share_s *= mult
        return Timeouts(update_s=update_s, block_s=block_s, krum_s=krum_s,
                        share_s=share_s, rpc_s=rpc_s)


@dataclass
class BiscottiConfig:
    # --- identity / topology (ref flags -i -t -p -pa -a, main.go:613-649) ---
    node_id: int = 0
    num_nodes: int = 10
    dataset: str = "creditcard"
    # model-zoo override: "" picks the dataset's default entry (softmax for
    # image sets, logreg for creditcard — the reference's client_obj.init
    # default); set e.g. "cifar_cnn" / "mnist_cnn" / "svm" for the CNN/SVM
    # stacks (ref: ML/Pytorch model files)
    model_name: str = ""
    peers_file: str = ""
    my_ip: str = "127.0.0.1"
    public_ip: str = ""
    base_port: int = 8000

    # --- committees (ref flags -na -nv -nn, main.go:629-633) ---
    num_miners: int = 3  # "aggregators" in the reference
    num_verifiers: int = 3
    num_noisers: int = 2

    # --- toggles (ref flags -sa -np -vp, main.go:635-641) ---
    secure_agg: bool = True
    noising: bool = True
    verification: bool = True
    # FedSys baseline mode: fixed leader (node 0) collects and AVERAGES
    # updates, no chain crypto/VRF/committees — the reference's separate
    # FedSys binary as a feature flag (ref: FedSys/main.go, SURVEY §2.5)
    fedsys: bool = False

    # --- privacy / attack (ref flags -ep -po -c, main.go:625,643-647) ---
    epsilon: float = 1.0
    delta: float = 1e-5
    poison_fraction: float = 0.0
    colluders: int = 0
    dp_in_model: bool = False  # DP_IN_MODEL mode (ref: main.go:155,860-864)
    # DP mechanism: "gaussian" = Abadi-16 presampled Gaussian (the
    # reference's default path, client_obj.py:59-67); "mcmc13" = the
    # Song&Sarwate'13 MCMC draw from exp(−ε/2·‖x‖) (the reference's
    # diffPriv13 branch, client_obj.py:44-57 — emcee there, a vectorized
    # Metropolis ensemble under lax.scan here, ops/dp_noise.py)
    dp_mechanism: str = "gaussian"

    # --- sampling (ref flags -ns -rs, main.go:645,649) ---
    sample_percent: float = 0.70  # NUM_SAMPLES = 70% of contributors
    random_sampling: bool = False
    krum_sample_size: int = 0  # 0 = use all collected updates

    # --- protocol constants (ref: DistSys/main.go:28-60) ---
    default_stake: int = 10  # DEFAULT_STAKE (main.go:39)
    stake_unit: int = 5  # STAKE_UNIT (honest.go:46)
    precision: int = 4  # decimal digits kept by quantization (main.go:45)
    poly_size: int = 10  # Shamir chunk degree (main.go:46)
    # Share-row redundancy factor r: TOTAL_SHARES = ceil(r·k/M)·M. The
    # reference hardwires r=2 (main.go:825) — generous fault tolerance, but
    # it lets any ⌈M/2⌉ miners reconstruct an aggregate, so two DISJOINT
    # miner subsets can serve two different aggregation sets and a
    # malicious leader can difference them to unmask an individual update.
    # Any r < 2 makes recovering subsets need > M/2 miners, so every pair
    # of them overlaps in a miner whose one-set-per-round guard then fires
    # (see _h_get_miner_part). r=1.5 still tolerates ⌊M/3⌋ dead miners.
    #
    # DEFAULT r=1.5 (hardened): the configuration people actually run gets
    # the anti-differencing guarantee, not just the documented option.
    # Layouts where ceil-rounding breaks the promise (e.g. M=10, k=10)
    # fail loudly from total_shares — set r=2.0 explicitly for
    # reference-parity fault tolerance there.
    share_redundancy: float = 1.5
    max_iterations: int = 100  # MAX_ITERATIONS (main.go:48)
    fail_prob: float = 0.0  # random per-iteration self-crash (main.go:54-55)
    defense: Defense = Defense.KRUM  # POISON_DEFENSE (main.go:57)
    roni_threshold: float = 0.02  # RONI reject score (main.go:203-231)
    # trimmed-mean trim fraction per tail (no reference analogue): must
    # exceed the worst-case Byzantine fraction (Yin'18); 0.35 clears the
    # reference's 30% operating point with margin
    trim_fraction: float = 0.35
    convergence_error: float = 0.05  # train-error exit threshold
    timeouts: Timeouts = field(default_factory=Timeouts)

    # --- robustness plane (no reference analogue; runtime/faults.py) ---
    # unicast RPC retry budget: attempts = rpc_retries + 1, sleeps follow
    # exponential backoff with decorrelated jitter in [base, cap]
    rpc_retries: int = 2
    rpc_backoff_base_s: float = 0.05
    rpc_backoff_cap_s: float = 2.0
    # per-peer circuit breaker: `threshold` consecutive transport failures
    # open it; after `cooldown_s` one half-open probe may re-close it
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 5.0
    # seeded deterministic fault injection over the live RPC transport
    # (drop/delay/duplicate/reset/flood per frame); default = disabled.
    # The simulator mirrors the `drop` knob at round granularity
    # (parallel/sim.py) so degraded-round semantics agree between sim
    # and live.
    fault_plan: FaultPlan = field(default_factory=FaultPlan)
    # overload governance (runtime/admission.py, docs/ADMISSION.md):
    # per-message-class token-bucket rates, per-peer/global inflight
    # caps, bounded parked-waiter budget, slow-loris read deadline.
    # Over-budget inbound work is shed with a retryable BusyError that
    # never advances the circuit breaker. Default = disabled (seed
    # behavior: admit everything, park without bound).
    admission_plan: AdmissionPlan = field(default_factory=AdmissionPlan)
    # adaptive-adversary campaign plane (runtime/adversary.py,
    # docs/ADVERSARY.md): seeded, state-observing attack strategies —
    # role-aware coordinated flood, churn-riding identity recycling,
    # threshold-hugging adaptive poison. Armed only on the peers the
    # plan draws as attackers; every decision is a pure function of
    # (campaign seed, observed protocol state) and is traced + counted
    # (biscotti_campaign_actions_total). Default = disabled: the seed
    # schedule, bit-identical (guarded by tests/test_adversary.py).
    campaign_plan: CampaignPlan = field(default_factory=CampaignPlan)
    # adaptive defense plane (ops/trust.py, docs/DEFENSES.md): armed only
    # when defense == ENSEMBLE — the plan knobs calibrate the ensemble
    # vetoes, the drift scorer, hysteresis and the slow-trust ramp. With
    # any other defense no TrustLedger is constructed and verdicts are
    # bit-identical to the seed (guarded by tests/test_trust.py).
    trust_plan: TrustPlan = field(default_factory=TrustPlan)
    # elastic fleet plane (runtime/placement.py, docs/PLACEMENT.md):
    # load-aware placement of co-hosted peers — a seeded controller
    # reads signals the planes already export (hive RSS/loop-lag
    # gauges, admission shed rates, straggler profiles) and live-
    # migrates peers between hives with chain, stake, breaker history
    # and round position intact. Default = disabled: no controller is
    # constructed, no biscotti_migration_* metric exists, and the seed
    # schedule is bit-identical (guarded by tests/test_placement.py).
    placement_plan: PlacementPlan = field(default_factory=PlacementPlan)
    # FoolsGold minimum mutually-similar cluster size for a rejection
    # (ops/robust_agg.py small-N fix): 3 stops N=10 honest pools from
    # mass-flagging accidental honest pairs; 1 restores pre-PR-16
    # pair-level rejection
    fg_min_cluster: int = 3

    # --- straggler-tolerance plane (runtime/stragglers.py,
    # docs/STRAGGLERS.md) ---
    # adaptive_deadlines=True arms the per-peer deadline controller AND
    # partial-quorum graceful degradation: each deadline-bearing phase
    # (block wait, miner intake, krum timer, worker collection fan-outs)
    # sets its next budget to clamp(max(EWMA, p95) x margin,
    # [deadline_floor_s, legacy constant]) from its own observed
    # durations, and worker fan-outs proceed once a sufficient quorum is
    # reached after that soft deadline instead of waiting all-or-timeout
    # (excluded honest stragglers are counted, never breaker-fed or
    # stake-debited). Default off = the reference's fixed Timeouts
    # constants and all-or-timeout collection, bit-identical.
    adaptive_deadlines: bool = False
    deadline_margin: float = 1.5
    deadline_floor_s: float = 1.0

    # --- membership plane (runtime/membership.py, docs/MEMBERSHIP.md) ---
    # snapshot_bootstrap=True: a (re)joining peer catches up from a chain
    # SNAPSHOT pulled over the chunked GetSnapshot RPC — genesis hash
    # pinned, the sealed suffix's quorums verified — instead of replaying
    # every block since genesis through the RegisterPeer reply. Default
    # off = the seed join path.
    snapshot_bootstrap: bool = False
    # how many sealed blocks of suffix a GetSnapshot reply carries (plus
    # the trust-anchor base block and genesis); chains at or below this
    # height serve their full chain and the joiner adopts it normally
    snapshot_tail: int = 8
    # reshare=True arms the distributed resharing round: when the leader
    # loses a miner mid-round (a membership epoch bump), surviving share
    # holders re-deal their slices via GetReshareDeal — Shamir proactive
    # resharing with homomorphically-updated Pedersen commitments — and
    # the round's secure-agg recovery proceeds from the re-dealt shares
    # where the seed protocol could only mint an empty block
    reshare: bool = True

    # --- pipelined round engine (docs/RUNTIME.md §Pipelined rounds) ---
    # pipeline=True overlaps work across round boundaries: near-future
    # intake (iteration ≤ current + pipeline_depth) runs its
    # committee-independent crypto checks BEFORE parking for the round
    # (so commitment verification of round r+1 submissions runs while
    # round r mines), and the miner folds secure-agg intake into the
    # round's VSS accumulator as waves arrive instead of in one lump at
    # mint. speculation=True additionally lets a worker start its next
    # local SGD step + VSS commitment off the just-accepted head while
    # the round machinery finishes; a fork discards the speculative
    # products (traced `speculation_discard`). batch_intake=True turns
    # the miner's per-update plain-mode verification loop into one
    # batched RLC check per micro-batch (bisection identifies offenders
    # exactly as the sequential path would). All three default OFF: the
    # disabled configuration reproduces the pre-pipeline round schedule
    # bit-for-bit (guarded by tests/test_pipeline.py).
    pipeline: bool = False
    pipeline_depth: int = 1
    speculation: bool = False
    batch_intake: bool = False

    # --- hierarchical aggregation overlay (runtime/overlay.py,
    # docs/OVERLAY.md) ---
    # overlay=True arms the committee-rooted aggregation tree on the wire
    # plane: peers group into contiguous id blocks of `overlay_group`
    # (the pod_launch --peers-per-host layout, so the leaf->interior hop
    # is loopback on a hive deployment), a seed-derived per-round relay
    # per group pre-aggregates secure-agg share fan-out (summed share
    # rows + homomorphically summed Pedersen commitment grids, one
    # RegisterAggregate per miner per subtree) and deduplicates
    # plain-mode update fan-out and block broadcast (RelayFrames, one
    # frame per remote subtree). Per-update verification traffic stays
    # point-to-point; a missing relay degrades to direct delivery within
    # the round. Default OFF = the seed's flat fan-out, bit-identical
    # traffic schedule (guarded by tests/test_overlay.py).
    overlay: bool = False
    # peers per overlay group (the first interior tree level); the hive
    # launcher defaults it to its own co-hosted span, pod_launch to
    # --peers-per-host. Required >= 2 when overlay is on.
    overlay_group: int = 0

    # --- accelerator-resident crypto plane (crypto/kernels,
    # docs/CRYPTO_KERNELS.md) ---
    # device_crypto=True arms the limb-decomposed Ed25519/Pedersen
    # kernels: the batched miner-crypto seams (RLC commitment batches,
    # VSS intake wave folds + settle, Schnorr quorum batches, Shamir
    # recovery) compute their verdicts on the accelerator instead of as
    # CPU bigint work. The CPU path remains the exact-verdict oracle:
    # every rejection (bisection, per-worker fallback) and therefore
    # every stake debit still comes from the CPU recompute. In the port
    # the plane arms on the peer's device and raises where it cannot run
    # there; it never falls back to the CPU. Default OFF = the CPU path
    # bit-identical.
    device_crypto: bool = False

    # --- wire data plane (runtime/codecs.py, docs/WIRE_PLANE.md) ---
    # negotiated payload codec for protocol traffic: "raw64" (legacy
    # float64 frames, the default), "f32"/"bf16" (downcast — applied to
    # the delta BEFORE commitment/noising/sharing so Pedersen
    # verification and Shamir recovery stay exact), "zlib" (lossless
    # deflate), "topk" (sparsification with error-feedback residuals);
    # stages compose with "+", e.g. "f32+zlib". Crypto-bearing arrays
    # (int64 shares, commitment tensors) always travel lossless. Peers
    # advertise capabilities in the RegisterPeer hello and senders fall
    # back to raw64 for peers that never advertised.
    wire_codec: str = "raw64"
    # payloads above this stream as continuation chunks (reassembled in
    # rpc.FrameStream, MAX_FRAME enforced on the reassembled size);
    # 0 disables chunking. Only used toward chunk-capable peers.
    wire_chunk_bytes: int = 4 * 1024 * 1024
    # fraction of update coordinates the topk stage keeps per round
    wire_topk: float = 0.05

    # --- telemetry plane (biscotti_tpu/telemetry, docs/OBSERVABILITY.md) ---
    # telemetry=False swaps in no-op registry/recorder singletons: spans
    # still feed the legacy PhaseClock totals (pre-telemetry cost), all
    # NEW instrumentation compiles down to nothing
    telemetry: bool = True
    # >0: each peer also serves Prometheus text over HTTP on
    # metrics_port + node_id (same +id layout as base_port); 0 = RPC-only
    # exposition (the `Metrics` method is always available)
    metrics_port: int = 0
    # flight-recorder ring capacity (events) and spill batch size (events
    # buffered per JSONL write; flush happens at round end and shutdown)
    recorder_ring: int = 4096
    recorder_batch: int = 256
    # distributed tracing (docs/OBSERVABILITY.md §Distributed tracing):
    # trace=True threads a compact trace context (trace_id, parent span,
    # round) through every RPC frame toward trace-capable peers
    # (negotiated via the RegisterPeer capability set like wire codecs),
    # opens a child span per dispatched RPC on both transport seams, and
    # stamps span/parent ids on recorder spans/events — the raw material
    # tools/trace_round stitches into one cross-peer round timeline.
    # Default OFF = every frame and recorder event bit-identical to the
    # pre-tracing format (guarded by tests/test_tracing.py).
    trace: bool = False

    # --- versioned protocol plane (runtime/protocol.py, docs/PROTOCOL.md) ---
    # -1 = speak the current protocol version. 0..CURRENT pins the
    # advertised feature set to a historical version row ("old build"
    # emulation for the mixed-version matrix and rolling upgrades):
    # the hello advertises only that row's features AND feature-gated
    # messages introduced later (snapshot pulls, overlay relay frames)
    # are refused exactly like the old build would — unknown method.
    protocol_version: int = -1

    # --- ML hyperparameters (ref: ML/Pytorch/client.py:30,56; ML/code/logistic_model.py:8-13) ---
    learning_rate: float = 1e-3  # torch-path SGD lr (used by optimizer-step modes)
    logreg_alpha: float = 1e-2  # numpy-logreg step size α (ref: logistic_model.py:12)
    # NOTE deliberately absent: momentum / weight_decay. The reference
    # configures SGD(momentum=.75, weight_decay=1e-3) (client.py:30) but its
    # protocol path never calls optimizer.step() — privateFun returns the
    # clipped −grad only (client.py:38-65) — so the knobs do nothing there;
    # carrying dead fields here would imply behavior we (and it) don't have.
    grad_clip: float = 100.0
    batch_size: int = 10
    noise_presample_iters: int = 100  # DP noise tensor depth (client_obj.py:59-67)

    # --- TPU topology (no reference analogue) ---
    mesh_shape: tuple = (1,)
    mesh_axes: tuple = ("peers",)
    param_dtype: str = "float32"
    seed: int = 0

    def __post_init__(self) -> None:
        # trimmed mean reads per-update coordinate values at the
        # aggregation point; additive secret shares only support
        # Σ-aggregates, so the combination cannot be made to work —
        # fail at construction, not silently mid-protocol
        if self.defense == Defense.TRIMMED_MEAN and self.secure_agg:
            raise ValueError(
                "defense=TRIMMED_MEAN is incompatible with secure_agg: "
                "coordinate-wise order statistics cannot be computed over "
                "additive secret shares (ops/robust_agg.py). Run with "
                "secure_agg=0, or choose KRUM/MULTIKRUM, which are "
                "verifier-side accept masks and compose with secure-agg.")
        if not (0.0 <= self.trim_fraction < 0.5) \
                and self.defense == Defense.TRIMMED_MEAN:
            raise ValueError(
                f"trim_fraction={self.trim_fraction} must be in [0, 0.5)")
        # wire-plane validation: a typo'd codec must fail at construction,
        # not mid-round on the event loop (lazy import keeps this module's
        # import footprint numpy-free)
        from biscotti_tpu_torch.runtime.codecs import WireCodecError, parse_codec

        try:
            parse_codec(self.wire_codec)
        except WireCodecError as e:
            raise ValueError(f"wire_codec: {e}") from None
        if not (0.0 < self.wire_topk <= 1.0):
            raise ValueError(
                f"wire_topk={self.wire_topk} must be in (0, 1]")
        if self.wire_chunk_bytes < 0:
            raise ValueError("wire_chunk_bytes must be >= 0")
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        # speculation rides the pipeline plane's block-accept hook; on
        # its own the knob would silently do nothing — refuse the dead
        # configuration instead of benchmarking the serial engine under
        # a flag that claims otherwise (batch_intake IS independent: the
        # micro-batch and the accumulator settle work without pipeline,
        # only the per-arrival fold kicks need it)
        if self.speculation and not self.pipeline:
            raise ValueError(
                "speculation=True requires pipeline=True (speculative "
                "steps are scheduled by the pipelined block-accept hook; "
                "docs/RUNTIME.md §Pipelined rounds)")
        # an enabled admission plan with nonsensical caps must fail at
        # construction, not mid-round when the first frame is budgeted
        self.admission_plan.validate()
        # campaign plane: a typo'd campaign name or nonsensical knob
        # must fail at construction too; fedsys has no election to
        # observe, no stake and no committees — an "adaptive" adversary
        # there would silently be the static one, so refuse the
        # combination instead of mislabeling a run
        self.campaign_plan.validate()
        if self.campaign_plan.enabled \
                and self.campaign_plan.attacker_node >= self.num_nodes:
            raise ValueError(
                f"campaign_plan.attacker_node="
                f"{self.campaign_plan.attacker_node} outside the id "
                f"space 1..{self.num_nodes - 1}: attacker_ids would "
                "silently drop the pin and the run would be an honest "
                "cluster labeled as an attack scenario")
        if self.campaign_plan.enabled and self.fedsys:
            raise ValueError(
                "campaign_plan is incompatible with fedsys mode: the "
                "campaigns adapt to the VRF election and chain state, "
                "which the FedSys baseline does not have "
                "(docs/ADVERSARY.md)")
        # placement plane: an enabled plan with nonsensical cadence or
        # thresholds must fail at construction, not at the controller's
        # first decision point
        self.placement_plan.validate()
        # adaptive defense plane: a nonsensical knob must fail at
        # construction, not on the first verifier decision; the ledger's
        # drift scorer and slow-trust ramp read the committed chain, so
        # fedsys (no chain, no election) cannot host it
        self.trust_plan.validate()
        if self.defense == Defense.ENSEMBLE and self.fedsys:
            raise ValueError(
                "defense=ENSEMBLE is incompatible with fedsys mode: the "
                "TrustLedger's drift scorer and slow-trust ramp are "
                "derived from the committed chain's accept/reject walk, "
                "which the FedSys baseline does not have "
                "(docs/DEFENSES.md)")
        if self.fg_min_cluster < 1:
            raise ValueError(
                f"fg_min_cluster={self.fg_min_cluster} must be >= 1 "
                "(1 = pre-fix pair-level FoolsGold rejection)")
        if not (0.0 <= self.fault_plan.churn < 1.0):
            raise ValueError(
                f"fault_plan.churn={self.fault_plan.churn} must be in "
                "[0, 1): it is the membership fraction churned per window")
        # straggler plane: a typo'd preset must fail at construction, not
        # when the first profile is drawn mid-round; knob sanity likewise
        if self.fault_plan.slow_preset \
                and self.fault_plan.slow_preset not in SLOW_PRESETS:
            raise ValueError(
                f"fault_plan.slow_preset={self.fault_plan.slow_preset!r} "
                f"unknown: pick from {SLOW_PRESETS}")
        if not (0.0 <= self.fault_plan.slow <= 1.0):
            raise ValueError(
                f"fault_plan.slow={self.fault_plan.slow} must be in "
                "[0, 1]: it is the membership fraction assigned a slow "
                "profile")
        if self.fault_plan.slow_factor < 1.0:
            raise ValueError("fault_plan.slow_factor must be >= 1 (it "
                             "multiplies compute wall-clock)")
        if self.deadline_margin < 1.0:
            raise ValueError("deadline_margin must be >= 1: the adaptive "
                             "deadline is estimate x margin and a margin "
                             "below 1 guarantees spurious expiry")
        if self.deadline_floor_s <= 0.0:
            raise ValueError("deadline_floor_s must be > 0")
        if self.snapshot_tail < 1:
            raise ValueError("snapshot_tail must be >= 1")
        # tracing rides the flight recorder and the span plane; with
        # telemetry off it would silently record nothing — refuse the
        # dead configuration (same policy as speculation-sans-pipeline)
        if self.trace and not self.telemetry:
            raise ValueError(
                "trace=True requires telemetry=True (trace context and "
                "span ids ride the flight recorder; "
                "docs/OBSERVABILITY.md §Distributed tracing)")
        # protocol plane: a pin outside the version table is a typo, not
        # an old build — fail at construction (lazy import: the protocol
        # registry pulls the codec table, which imports numpy)
        from biscotti_tpu_torch.runtime.protocol import CURRENT_VERSION
        if not (-1 <= self.protocol_version <= CURRENT_VERSION):
            raise ValueError(
                f"protocol_version={self.protocol_version} must be -1 "
                f"(current) or a historical row in [0, {CURRENT_VERSION}] "
                "(runtime/protocol.py version table; docs/PROTOCOL.md)")
        # the overlay needs a real subtree to aggregate over — an armed
        # flag without a group would silently run the flat fan-out
        # labeled as an overlay run; refuse the dead configuration
        # (hive/pod_launch auto-fill the group from their host layout)
        if self.overlay and self.overlay_group < 2:
            raise ValueError(
                "overlay=True requires overlay_group >= 2 (peers per "
                "aggregation subtree; the hive launcher defaults it to "
                "its co-hosted span — docs/OVERLAY.md)")
        if self.overlay_group < 0:
            raise ValueError("overlay_group must be >= 0")

    # ------------------------------------------------------------------ derived

    @property
    def num_samples(self) -> int:
        """Per-round sampled contributor count: floor(N·perc), clamped to the
        worker population N − verifiers − miners (ref: main.go:672-679)."""
        n = int(self.num_nodes * self.sample_percent)
        return max(1, min(n, self.num_nodes - self.num_verifiers - self.num_miners))

    @property
    def krum_update_thresh(self) -> int:
        """Updates a verifier collects before running Krum: the full worker
        population under random sampling, NUM_SAMPLES otherwise
        (ref: main.go:680-684)."""
        if self.random_sampling:
            return max(1, self.num_nodes - self.num_verifiers - self.num_miners)
        return self.num_samples

    @property
    def total_shares(self) -> int:
        """TOTAL_SHARES = ceil(r·POLY_SIZE/NUM_MINERS)·NUM_MINERS
        (ref: main.go:825 with r fixed at 2; see share_redundancy).

        Exact rational arithmetic — float ceil would let representation
        error round rows-per-miner up and silently reopen the differencing
        channel the knob exists to close. When r < 2 is configured, the
        property it promises (no ⌊M/2⌋-miner subset can reconstruct) is
        CHECKED against the rounded layout and misconfigurations fail
        loudly instead of silently not delivering the guarantee."""
        from fractions import Fraction

        if self.share_redundancy < 1.0:
            raise ValueError("share_redundancy < 1 leaves fewer rows than "
                             "polynomial coefficients: recovery impossible")
        r = Fraction(self.share_redundancy).limit_denominator(1_000_000)
        per = -((-r * self.poly_size) // self.num_miners)  # exact ceil
        per = max(int(per), 1)
        t = per * self.num_miners
        if self.share_redundancy < 2.0:
            half = self.num_miners // 2
            if per * half >= self.poly_size:
                raise ValueError(
                    f"share_redundancy={self.share_redundancy} with "
                    f"poly_size={self.poly_size}, num_miners="
                    f"{self.num_miners} rounds to {per} rows/miner, so "
                    f"{half} miners still hold ≥ poly_size rows and the "
                    "r<2 anti-differencing guarantee does NOT hold — "
                    "lower r, raise poly_size, or use fewer miners")
        return t

    @property
    def shares_per_miner(self) -> int:
        return self.total_shares // self.num_miners

    @property
    def collusion_probability(self) -> float:
        """PRIV_PROB: `colluders` is a percentage (ref: main.go:829)."""
        return self.colluders / 100.0

    @property
    def collusion_threshold(self) -> int:
        """collusionThresh = ceil(N · (1 − colluders/100)) (ref: main.go:830-831)."""
        return int(math.ceil(self.num_nodes * (1.0 - self.collusion_probability)))

    @property
    def quant_scale(self) -> float:
        return float(10 ** self.precision)

    def port_of(self, node_id: int) -> int:
        return self.base_port + node_id

    # ------------------------------------------------------------------ CLI

    @staticmethod
    def add_args(p: argparse.ArgumentParser) -> None:
        """Register the reference-compatible flag surface (ref: main.go:613-649)."""
        p.add_argument("-i", "--node-id", type=int, default=0)
        p.add_argument("-t", "--num-nodes", type=int, default=10)
        p.add_argument("-d", "--dataset", type=str, default="creditcard")
        p.add_argument("--model", dest="model_name", type=str, default="")
        p.add_argument("-f", "--peers-file", type=str, default="")
        p.add_argument("-a", "--my-ip", type=str, default="127.0.0.1")
        p.add_argument("-pa", "--public-ip", type=str, default="")
        p.add_argument("-p", "--base-port", type=int, default=8000)
        p.add_argument("-c", "--colluders", type=int, default=0)
        p.add_argument("-na", "--num-miners", type=int, default=3)
        p.add_argument("-nv", "--num-verifiers", type=int, default=3)
        p.add_argument("-nn", "--num-noisers", type=int, default=2)
        p.add_argument("-sa", "--secure-agg", type=int, default=1)
        p.add_argument("-np", "--noising", type=int, default=1)
        p.add_argument("-vp", "--verification", type=int, default=1)
        p.add_argument("-ep", "--epsilon", type=float, default=1.0)
        p.add_argument("--dp-mechanism", type=str, default="gaussian",
                       choices=["gaussian", "mcmc13"],
                       help="gaussian = Abadi-16 presample (ref default); "
                            "mcmc13 = Song&Sarwate'13 MCMC "
                            "(ref diffPriv13 branch)")
        p.add_argument("-po", "--poison-fraction", type=float, default=0.0)
        p.add_argument("-ns", "--sample-percent", type=float, default=70.0)
        p.add_argument("-rs", "--random-sampling", type=int, default=0)
        p.add_argument("--defense", type=str, default="KRUM", choices=[d.value for d in Defense])
        p.add_argument("--trim-fraction", type=float, default=0.35,
                       help="per-tail trim for defense=TRIMMED_MEAN "
                            "(must exceed the Byzantine fraction)")
        p.add_argument("--max-iterations", type=int, default=100)
        p.add_argument("--convergence-error", type=float, default=0.05,
                       help="train-error exit threshold (ref main.go:1067-"
                            "1094); 0 disables early exit so fault "
                            "harnesses control run length exactly")
        p.add_argument("--fail-prob", type=float, default=0.0)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--fedsys", type=int, default=0,
                       help="FedSys leader-aggregation baseline mode")
        # defaults reference the dataclass/FaultPlan field defaults — the
        # single source — so CLI and programmatic construction can't drift
        p.add_argument("--rpc-retries", type=int, default=BiscottiConfig.rpc_retries,
                       help="extra attempts per unicast RPC on transport "
                            "failure (exponential backoff + jitter)")
        p.add_argument("--breaker-threshold", type=int,
                       default=BiscottiConfig.breaker_threshold,
                       help="consecutive failures that quarantine a peer")
        p.add_argument("--breaker-cooldown-s", type=float,
                       default=BiscottiConfig.breaker_cooldown_s,
                       help="seconds quarantined before a half-open probe")
        p.add_argument("--fault-seed", type=int, default=FaultPlan.seed,
                       help="fault plane seed: same seed = same schedule")
        p.add_argument("--fault-drop", type=float, default=FaultPlan.drop,
                       help="P(outbound frame silently lost)")
        p.add_argument("--fault-delay", type=float, default=FaultPlan.delay,
                       help="P(outbound frame delayed)")
        p.add_argument("--fault-delay-s", type=float,
                       default=FaultPlan.delay_s,
                       help="max injected per-frame delay, seconds")
        p.add_argument("--fault-dup", type=float,
                       default=FaultPlan.duplicate,
                       help="P(outbound frame written twice)")
        p.add_argument("--fault-reset", type=float, default=FaultPlan.reset,
                       help="P(connection torn down instead of writing)")
        p.add_argument("--fault-flood", type=int, default=FaultPlan.flood,
                       help="frame-storm replay factor: every outbound "
                            "frame is written 1+N times (deterministic "
                            "flooding peer for admission tests)")
        p.add_argument("--fault-churn", type=float, default=FaultPlan.churn,
                       help="fraction of the membership killed+restarted "
                            "per churn window, seeded schedule (0.2 = "
                            "a 20%% turnover); window-0 "
                            "victims become late JOINERS")
        p.add_argument("--fault-churn-period", type=int,
                       default=FaultPlan.churn_period,
                       help="rounds per churn window")
        p.add_argument("--fault-churn-down", type=int,
                       default=FaultPlan.churn_down,
                       help="rounds a churned peer stays down before its "
                            "scheduled restart")
        p.add_argument("--fault-slow", type=float, default=FaultPlan.slow,
                       help="fraction of the membership assigned a slow "
                            "speed profile, seeded draw (the straggler "
                            "fault kind, docs/STRAGGLERS.md)")
        p.add_argument("--fault-slow-factor", type=float,
                       default=FaultPlan.slow_factor,
                       help="compute-slowdown multiple for drawn slow "
                            "peers (presets override)")
        p.add_argument("--fault-slow-service-s", type=float,
                       default=FaultPlan.slow_service_s,
                       help="extra per-RPC service delay a slow peer "
                            "charges every inbound request")
        p.add_argument("--fault-slow-preset", type=str,
                       default=FaultPlan.slow_preset,
                       choices=["", "tee", "bimodal", "longtail"],
                       help="named speed-profile preset for the drawn "
                            "subset: tee = the arXiv:2501.11771-"
                            "calibrated confidential-compute overhead, "
                            "bimodal = 2x/8x split, longtail = heavy-"
                            "tail severities")
        p.add_argument("--fault-slow-node", type=int,
                       default=FaultPlan.slow_node,
                       help="pin this node slow regardless of the "
                            "fraction draw (-1: none)")
        p.add_argument("--adaptive-deadlines", type=int,
                       default=int(BiscottiConfig.adaptive_deadlines),
                       help="1 arms the straggler-tolerance plane: "
                            "per-phase adaptive round deadlines "
                            "(EWMA+p95, clamped to the legacy "
                            "constants) and partial-quorum graceful "
                            "degradation (docs/STRAGGLERS.md)")
        p.add_argument("--deadline-margin", type=float,
                       default=BiscottiConfig.deadline_margin,
                       help="adaptive deadline = duration estimate x "
                            "this margin")
        p.add_argument("--deadline-floor-s", type=float,
                       default=BiscottiConfig.deadline_floor_s,
                       help="adaptive deadlines never drop below this "
                            "floor")
        p.add_argument("--snapshot-bootstrap", type=int,
                       default=int(BiscottiConfig.snapshot_bootstrap),
                       help="1: (re)joining peers catch up from a chain "
                            "snapshot (GetSnapshot RPC) instead of "
                            "replaying genesis (docs/MEMBERSHIP.md)")
        p.add_argument("--snapshot-tail", type=int,
                       default=BiscottiConfig.snapshot_tail,
                       help="sealed suffix blocks a GetSnapshot reply "
                            "carries")
        p.add_argument("--reshare", type=int,
                       default=int(BiscottiConfig.reshare),
                       help="1: distributed Shamir resharing round when "
                            "a miner is lost mid-round (0 = seed "
                            "behavior, the round goes empty)")
        p.add_argument("--campaign", type=str,
                       default=CampaignPlan.campaign,
                       choices=[""] + list(CAMPAIGNS),
                       help="arm an adaptive-adversary campaign on the "
                            "peers the plan draws as attackers: "
                            "roleflood = flood the per-round elected "
                            "miner/noisers, sybil = churn-riding "
                            "identity recycling, hug = threshold-"
                            "hugging adaptive poisoner "
                            "(docs/ADVERSARY.md; '' = seed behavior)")
        p.add_argument("--campaign-seed", type=int,
                       default=CampaignPlan.seed,
                       help="campaign decision seed (-1: the protocol "
                            "--seed) — same seed + same chain = the "
                            "identical action schedule")
        p.add_argument("--campaign-attackers", type=float,
                       default=CampaignPlan.attackers,
                       help="membership fraction drawn as colluding "
                            "attackers (top ids — the poisoned-id "
                            "formula, so matching --poison-fraction "
                            "makes the sets identical)")
        p.add_argument("--campaign-node", type=int,
                       default=CampaignPlan.attacker_node,
                       help="pin this id into the attacker set (-1: "
                            "none; node 0 refused — oracle anchor)")
        p.add_argument("--campaign-flood", type=int,
                       default=CampaignPlan.flood,
                       help="targeted frame-replay factor for the "
                            "roleflood campaign (frames toward a "
                            "target are written 1+N times)")
        p.add_argument("--campaign-recycle-period", type=int,
                       default=CampaignPlan.recycle_period,
                       help="sybil: rounds between identity recycles")
        p.add_argument("--campaign-recycle-down", type=int,
                       default=CampaignPlan.recycle_down,
                       help="sybil: rounds down before the fresh "
                            "incarnation rejoins")
        p.add_argument("--campaign-hug-start", type=float,
                       default=CampaignPlan.hug_start,
                       help="hug: initial poison blend scale")
        p.add_argument("--campaign-hug-jitter", type=float,
                       default=CampaignPlan.hug_jitter,
                       help="hug: per-attacker decorrelation jitter as "
                            "a fraction of the observed honest step "
                            "norm")
        p.add_argument("--fg-min-cluster", type=int,
                       default=BiscottiConfig.fg_min_cluster,
                       help="FoolsGold: minimum mutually-similar cluster "
                            "size for a rejection (small-N fix; 1 = "
                            "pre-fix pair-level behavior)")
        p.add_argument("--trust-geo-ratio", type=float,
                       default=TrustPlan.geo_ratio,
                       help="ENSEMBLE: geometry veto fires when a Krum "
                            "score exceeds ratio x the worst KEPT score")
        p.add_argument("--trust-sim-margin", type=float,
                       default=TrustPlan.sim_margin,
                       help="ENSEMBLE: similarity veto bar = kept-pair "
                            "cosine median + max(margin, mad_mult x MAD)")
        p.add_argument("--trust-mag-band", type=float,
                       default=TrustPlan.mag_band,
                       help="ENSEMBLE: magnitude veto fires outside "
                            "[median/band, median x band] of kept norms")
        p.add_argument("--trust-drift-hi", type=float,
                       default=TrustPlan.drift_hi,
                       help="ENSEMBLE: drift score that sets the flag "
                            "(Schmitt trigger upper threshold)")
        p.add_argument("--trust-drift-lo", type=float,
                       default=TrustPlan.drift_lo,
                       help="ENSEMBLE: drift score that clears the flag "
                            "(Schmitt trigger lower threshold)")
        p.add_argument("--trust-hold", type=int,
                       default=TrustPlan.hold_rounds,
                       help="ENSEMBLE: rounds a veto keeps rejecting a "
                            "peer after the last scorer vote (hysteresis)")
        p.add_argument("--trust-ramp-rounds", type=int,
                       default=TrustPlan.ramp_rounds,
                       help="ENSEMBLE: accepted on-chain blocks a fresh/"
                            "recycled identity needs to reach full "
                            "slow-trust weight (0 disables the ramp)")
        p.add_argument("--trust-ramp-floor", type=float,
                       default=TrustPlan.ramp_floor,
                       help="ENSEMBLE: slow-trust weight of a zero-"
                            "history identity (duty-cycle admission)")
        p.add_argument("--trust-absence-reset", type=int,
                       default=TrustPlan.absence_reset,
                       help="ENSEMBLE: consecutive eligible-absent real "
                            "blocks that restart an identity's ramp "
                            "(catches churn-recycled sybils)")
        p.add_argument("--admission", type=int,
                       default=int(AdmissionPlan.enabled),
                       help="1 arms the overload-governance plane: "
                            "over-budget inbound work is shed with a "
                            "retryable busy status (docs/ADMISSION.md)")
        p.add_argument("--admit-update-rate", type=float,
                       default=AdmissionPlan.update_rate,
                       help="token-bucket rate (frames/s per peer) for "
                            "update-class messages")
        p.add_argument("--admit-bulk-rate", type=float,
                       default=AdmissionPlan.bulk_rate,
                       help="token-bucket rate for bulk-class messages "
                            "(block push/pull, chain adoption)")
        p.add_argument("--admit-control-rate", type=float,
                       default=AdmissionPlan.control_rate,
                       help="token-bucket rate for control-class messages")
        p.add_argument("--admit-burst-factor", type=float,
                       default=AdmissionPlan.burst_factor,
                       help="bucket capacity = rate x this factor")
        p.add_argument("--admit-peer-inflight", type=int,
                       default=AdmissionPlan.peer_inflight,
                       help="max concurrent inbound handlers per peer")
        p.add_argument("--admit-global-inflight", type=int,
                       default=AdmissionPlan.global_inflight,
                       help="max concurrent inbound handlers, all peers")
        p.add_argument("--admit-parked", type=int,
                       default=AdmissionPlan.max_parked,
                       help="max handlers parked for a future round "
                            "(the oldest waiter is shed at the cap)")
        p.add_argument("--admit-read-deadline-s", type=float,
                       default=AdmissionPlan.read_deadline_s,
                       help="seconds one inbound frame may stay "
                            "partially received before the connection "
                            "drops (slow-loris bound)")
        p.add_argument("--pipeline", type=int,
                       default=int(BiscottiConfig.pipeline),
                       help="1 overlaps phases across rounds: near-future "
                            "intake pre-verifies its crypto while the "
                            "current round mines, miner VSS intake folds "
                            "incrementally (docs/RUNTIME.md)")
        p.add_argument("--pipeline-depth", type=int,
                       default=BiscottiConfig.pipeline_depth,
                       help="how many rounds ahead intake is accepted for "
                            "early verification")
        p.add_argument("--speculation", type=int,
                       default=int(BiscottiConfig.speculation),
                       help="1 starts the next local SGD step + "
                            "commitment speculatively off the freshly "
                            "accepted head (discarded on fork)")
        p.add_argument("--batch-intake", type=int,
                       default=int(BiscottiConfig.batch_intake),
                       help="1 verifies plain-mode miner intake as one "
                            "batched RLC commitment check per "
                            "micro-batch, bisection on failure")
        p.add_argument("--overlay", type=int,
                       default=int(BiscottiConfig.overlay),
                       help="1 arms the hierarchical aggregation overlay "
                            "(committee-rooted per-round tree: share "
                            "fan-out pre-aggregated per subtree, update/"
                            "block fan-out relayed once per remote "
                            "subtree; docs/OVERLAY.md). 0 = the seed's "
                            "flat fan-out, bit-identical")
        p.add_argument("--overlay-group", type=int,
                       default=BiscottiConfig.overlay_group,
                       help="peers per overlay subtree (contiguous ids; "
                            "match --peers-per-host on a hive fleet)")
        p.add_argument("--device-crypto", type=int,
                       default=int(BiscottiConfig.device_crypto),
                       help="1 arms the accelerator-resident crypto "
                            "plane: batched miner crypto (RLC commitment "
                            "batches, VSS intake folds, Schnorr quorums, "
                            "Shamir recovery) runs as limb-decomposed "
                            "device kernels; 0 = the CPU path, "
                            "bit-identical (docs/CRYPTO_KERNELS.md)")
        p.add_argument("--wire-codec", type=str,
                       default=BiscottiConfig.wire_codec,
                       help="payload codec for protocol traffic "
                            "(raw64 | f32 | bf16 | zlib | topk, composed "
                            "with '+', e.g. f32+zlib); negotiated per "
                            "peer, raw64 fallback")
        p.add_argument("--wire-chunk-bytes", type=int,
                       default=BiscottiConfig.wire_chunk_bytes,
                       help="stream payloads above this as continuation "
                            "chunks (0 disables)")
        p.add_argument("--wire-topk", type=float,
                       default=BiscottiConfig.wire_topk,
                       help="fraction of update coordinates the topk "
                            "codec stage keeps per round")
        p.add_argument("--telemetry", type=int,
                       default=int(BiscottiConfig.telemetry),
                       help="0 disables the metrics registry + flight "
                            "recorder (instrumentation becomes no-ops)")
        p.add_argument("--metrics-port", type=int,
                       default=BiscottiConfig.metrics_port,
                       help="serve Prometheus text over HTTP on "
                            "metrics_port + node_id (0 = RPC-only)")
        p.add_argument("--recorder-ring", type=int,
                       default=BiscottiConfig.recorder_ring,
                       help="flight-recorder ring capacity, events")
        p.add_argument("--recorder-batch", type=int,
                       default=BiscottiConfig.recorder_batch,
                       help="events buffered per batched JSONL write")
        p.add_argument("--trace", type=int,
                       default=int(BiscottiConfig.trace),
                       help="1 arms distributed tracing: trace context "
                            "on every RPC frame toward trace-capable "
                            "peers, a child span per dispatched RPC, "
                            "span/parent ids on recorder events "
                            "(tools/trace_round stitches the cross-peer "
                            "round timeline; 0 = frames bit-identical "
                            "to the untraced format)")
        p.add_argument("--protocol-version", type=int,
                       default=BiscottiConfig.protocol_version,
                       help="pin the advertised protocol feature set to "
                            "a historical version row (old-build "
                            "emulation for mixed-version clusters and "
                            "rolling upgrades; -1 = current — "
                            "docs/PROTOCOL.md)")
        p.add_argument("--placement", type=int,
                       default=int(PlacementPlan.enabled),
                       help="1 arms the elastic fleet plane: a seeded "
                            "placement controller live-migrates peers "
                            "off hot hives (docs/PLACEMENT.md); 0 = "
                            "static placement, bit-identical")
        p.add_argument("--placement-seed", type=int,
                       default=PlacementPlan.seed,
                       help="placement decision seed: same seed + same "
                            "signals = the identical move schedule")
        p.add_argument("--placement-interval", type=int,
                       default=PlacementPlan.interval,
                       help="anchor rounds between placement decisions")
        p.add_argument("--placement-max-moves", type=int,
                       default=PlacementPlan.max_moves,
                       help="migrations applied per decision point")
        p.add_argument("--placement-rss-hot", type=int,
                       default=PlacementPlan.rss_hot_bytes,
                       help="hive RSS bytes above which a host is hot "
                            "(0 disarms the signal)")
        p.add_argument("--placement-rss-drift-hot", type=int,
                       default=PlacementPlan.rss_drift_hot_bytes,
                       help="windowed hive RSS drift bytes above which "
                            "a host is hot (leak shape; 0 disarms)")
        p.add_argument("--placement-lag-hot-s", type=float,
                       default=PlacementPlan.lag_hot_s,
                       help="hive event-loop lag seconds above which a "
                            "host is hot (0 disarms)")
        p.add_argument("--placement-shed-hot", type=float,
                       default=PlacementPlan.shed_hot,
                       help="admission shed fraction above which a host "
                            "is hot (0 disarms)")
        p.add_argument("--placement-slow-hot", type=float,
                       default=PlacementPlan.slow_hot,
                       help="straggler compute-factor above which a "
                            "host is hot (0 disarms)")
        p.add_argument("--placement-min-hive-peers", type=int,
                       default=PlacementPlan.min_hive_peers,
                       help="never drain a hive below this many peers")

    @classmethod
    def from_args(cls, ns: argparse.Namespace) -> "BiscottiConfig":
        # -ns is a percentage on the reference CLI (e.g. 70 ⇒ 70%); always
        # divide so "-ns 1" means 1%, not 100%
        sample = ns.sample_percent / 100.0
        return cls(
            node_id=ns.node_id,
            num_nodes=ns.num_nodes,
            dataset=ns.dataset,
            model_name=getattr(ns, "model_name", ""),
            peers_file=ns.peers_file,
            my_ip=ns.my_ip,
            public_ip=ns.public_ip,
            base_port=ns.base_port,
            colluders=ns.colluders,
            num_miners=ns.num_miners,
            num_verifiers=ns.num_verifiers,
            num_noisers=ns.num_noisers,
            secure_agg=bool(ns.secure_agg),
            noising=bool(ns.noising),
            verification=bool(ns.verification),
            epsilon=ns.epsilon,
            dp_mechanism=getattr(ns, "dp_mechanism", "gaussian"),
            poison_fraction=ns.poison_fraction,
            sample_percent=sample,
            random_sampling=bool(ns.random_sampling),
            defense=Defense(ns.defense),
            trim_fraction=getattr(ns, "trim_fraction", 0.35),
            max_iterations=ns.max_iterations,
            convergence_error=getattr(ns, "convergence_error", 0.05),
            fail_prob=ns.fail_prob,
            seed=ns.seed,
            fedsys=bool(getattr(ns, "fedsys", 0)),
            # fallbacks (for hand-built namespaces that skipped add_args)
            # reference the same field defaults the parser advertises
            rpc_retries=getattr(ns, "rpc_retries", cls.rpc_retries),
            breaker_threshold=getattr(ns, "breaker_threshold",
                                      cls.breaker_threshold),
            breaker_cooldown_s=getattr(ns, "breaker_cooldown_s",
                                       cls.breaker_cooldown_s),
            pipeline=bool(getattr(ns, "pipeline", cls.pipeline)),
            pipeline_depth=getattr(ns, "pipeline_depth", cls.pipeline_depth),
            speculation=bool(getattr(ns, "speculation", cls.speculation)),
            batch_intake=bool(getattr(ns, "batch_intake", cls.batch_intake)),
            device_crypto=bool(getattr(ns, "device_crypto",
                                       cls.device_crypto)),
            overlay=bool(getattr(ns, "overlay", cls.overlay)),
            overlay_group=getattr(ns, "overlay_group", cls.overlay_group),
            wire_codec=getattr(ns, "wire_codec", cls.wire_codec),
            wire_chunk_bytes=getattr(ns, "wire_chunk_bytes",
                                     cls.wire_chunk_bytes),
            wire_topk=getattr(ns, "wire_topk", cls.wire_topk),
            adaptive_deadlines=bool(getattr(ns, "adaptive_deadlines",
                                            cls.adaptive_deadlines)),
            deadline_margin=getattr(ns, "deadline_margin",
                                    cls.deadline_margin),
            deadline_floor_s=getattr(ns, "deadline_floor_s",
                                     cls.deadline_floor_s),
            snapshot_bootstrap=bool(getattr(ns, "snapshot_bootstrap",
                                            cls.snapshot_bootstrap)),
            snapshot_tail=getattr(ns, "snapshot_tail", cls.snapshot_tail),
            reshare=bool(getattr(ns, "reshare", cls.reshare)),
            telemetry=bool(getattr(ns, "telemetry", cls.telemetry)),
            metrics_port=getattr(ns, "metrics_port", cls.metrics_port),
            recorder_ring=getattr(ns, "recorder_ring", cls.recorder_ring),
            recorder_batch=getattr(ns, "recorder_batch", cls.recorder_batch),
            trace=bool(getattr(ns, "trace", cls.trace)),
            protocol_version=getattr(ns, "protocol_version",
                                     cls.protocol_version),
            placement_plan=PlacementPlan(
                enabled=bool(getattr(ns, "placement",
                                     PlacementPlan.enabled)),
                seed=getattr(ns, "placement_seed", PlacementPlan.seed),
                interval=getattr(ns, "placement_interval",
                                 PlacementPlan.interval),
                max_moves=getattr(ns, "placement_max_moves",
                                  PlacementPlan.max_moves),
                rss_hot_bytes=getattr(ns, "placement_rss_hot",
                                      PlacementPlan.rss_hot_bytes),
                rss_drift_hot_bytes=getattr(
                    ns, "placement_rss_drift_hot",
                    PlacementPlan.rss_drift_hot_bytes),
                lag_hot_s=getattr(ns, "placement_lag_hot_s",
                                  PlacementPlan.lag_hot_s),
                shed_hot=getattr(ns, "placement_shed_hot",
                                 PlacementPlan.shed_hot),
                slow_hot=getattr(ns, "placement_slow_hot",
                                 PlacementPlan.slow_hot),
                min_hive_peers=getattr(ns, "placement_min_hive_peers",
                                       PlacementPlan.min_hive_peers),
            ),
            fault_plan=FaultPlan(
                seed=getattr(ns, "fault_seed", FaultPlan.seed),
                drop=getattr(ns, "fault_drop", FaultPlan.drop),
                delay=getattr(ns, "fault_delay", FaultPlan.delay),
                delay_s=getattr(ns, "fault_delay_s", FaultPlan.delay_s),
                duplicate=getattr(ns, "fault_dup", FaultPlan.duplicate),
                reset=getattr(ns, "fault_reset", FaultPlan.reset),
                flood=getattr(ns, "fault_flood", FaultPlan.flood),
                churn=getattr(ns, "fault_churn", FaultPlan.churn),
                churn_period=getattr(ns, "fault_churn_period",
                                     FaultPlan.churn_period),
                churn_down=getattr(ns, "fault_churn_down",
                                   FaultPlan.churn_down),
                slow=getattr(ns, "fault_slow", FaultPlan.slow),
                slow_factor=getattr(ns, "fault_slow_factor",
                                    FaultPlan.slow_factor),
                slow_service_s=getattr(ns, "fault_slow_service_s",
                                       FaultPlan.slow_service_s),
                slow_preset=getattr(ns, "fault_slow_preset",
                                    FaultPlan.slow_preset),
                slow_node=getattr(ns, "fault_slow_node",
                                  FaultPlan.slow_node),
            ),
            campaign_plan=CampaignPlan(
                campaign=getattr(ns, "campaign", CampaignPlan.campaign),
                seed=getattr(ns, "campaign_seed", CampaignPlan.seed),
                attackers=getattr(ns, "campaign_attackers",
                                  CampaignPlan.attackers),
                attacker_node=getattr(ns, "campaign_node",
                                      CampaignPlan.attacker_node),
                flood=getattr(ns, "campaign_flood", CampaignPlan.flood),
                recycle_period=getattr(ns, "campaign_recycle_period",
                                       CampaignPlan.recycle_period),
                recycle_down=getattr(ns, "campaign_recycle_down",
                                     CampaignPlan.recycle_down),
                hug_start=getattr(ns, "campaign_hug_start",
                                  CampaignPlan.hug_start),
                hug_jitter=getattr(ns, "campaign_hug_jitter",
                                   CampaignPlan.hug_jitter),
            ),
            trust_plan=TrustPlan(
                geo_ratio=getattr(ns, "trust_geo_ratio",
                                  TrustPlan.geo_ratio),
                sim_margin=getattr(ns, "trust_sim_margin",
                                   TrustPlan.sim_margin),
                mag_band=getattr(ns, "trust_mag_band", TrustPlan.mag_band),
                drift_hi=getattr(ns, "trust_drift_hi", TrustPlan.drift_hi),
                drift_lo=getattr(ns, "trust_drift_lo", TrustPlan.drift_lo),
                hold_rounds=getattr(ns, "trust_hold",
                                    TrustPlan.hold_rounds),
                ramp_rounds=getattr(ns, "trust_ramp_rounds",
                                    TrustPlan.ramp_rounds),
                ramp_floor=getattr(ns, "trust_ramp_floor",
                                   TrustPlan.ramp_floor),
                absence_reset=getattr(ns, "trust_absence_reset",
                                      TrustPlan.absence_reset),
            ),
            fg_min_cluster=getattr(ns, "fg_min_cluster",
                                   cls.fg_min_cluster),
            admission_plan=AdmissionPlan(
                enabled=bool(getattr(ns, "admission",
                                     AdmissionPlan.enabled)),
                update_rate=getattr(ns, "admit_update_rate",
                                    AdmissionPlan.update_rate),
                bulk_rate=getattr(ns, "admit_bulk_rate",
                                  AdmissionPlan.bulk_rate),
                control_rate=getattr(ns, "admit_control_rate",
                                     AdmissionPlan.control_rate),
                burst_factor=getattr(ns, "admit_burst_factor",
                                     AdmissionPlan.burst_factor),
                peer_inflight=getattr(ns, "admit_peer_inflight",
                                      AdmissionPlan.peer_inflight),
                global_inflight=getattr(ns, "admit_global_inflight",
                                        AdmissionPlan.global_inflight),
                max_parked=getattr(ns, "admit_parked",
                                   AdmissionPlan.max_parked),
                read_deadline_s=getattr(ns, "admit_read_deadline_s",
                                        AdmissionPlan.read_deadline_s),
            ),
        )

    def replace(self, **kw) -> "BiscottiConfig":
        return dataclasses.replace(self, **kw)
