"""Slim copy of `biscotti_tpu/config.py`: the fields the simulator, the
per-peer `Trainer`, the secure-aggregation plane, the wire and protocol
planes and the bench's byte columns read.

The keyword names, defaults and construction checks are the reference's,
so one dict builds both packages' configs. `FaultPlan` keeps only the frame-drop subset
(`seed`, `drop`, `enabled`) that the simulator mirrors
(`biscotti_tpu/runtime/faults.py::FaultPlan`).
"""

from __future__ import annotations

import argparse
import enum
from dataclasses import dataclass, field


class Defense(str, enum.Enum):
    """Poisoning-defense selection (ref: DistSys/main.go:57 POISON_DEFENSE).
    The port's simulator takes every member; as in the reference's
    simulator, TRIMMED_MEAN, NONE and ENSEMBLE accept every update (the
    ensemble lives in the live runtime's trust ledger)."""

    NONE = "NONE"
    KRUM = "KRUM"
    RONI = "RONI"
    MULTIKRUM = "MULTIKRUM"
    TRIMMED_MEAN = "TRIMMED_MEAN"
    FOOLSGOLD = "FOOLSGOLD"
    ENSEMBLE = "ENSEMBLE"


@dataclass
class FaultPlan:
    """Seeded frame-fault plan, drop subset: each contributor's round frame
    is lost with probability `drop`, deterministically in (seed, round)."""

    seed: int = 0
    drop: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.drop > 0.0


@dataclass
class BiscottiConfig:
    num_nodes: int = 10
    dataset: str = "creditcard"
    # "" picks the dataset's default model (softmax; logreg for creditcard)
    model_name: str = ""

    num_miners: int = 3
    num_verifiers: int = 3
    num_noisers: int = 2

    secure_agg: bool = True
    noising: bool = True
    verification: bool = True

    epsilon: float = 1.0
    delta: float = 1e-5
    poison_fraction: float = 0.0
    dp_in_model: bool = False
    dp_mechanism: str = "gaussian"

    sample_percent: float = 0.70

    default_stake: int = 10
    stake_unit: int = 5
    precision: int = 4  # decimal digits kept by quantization (main.go:45)
    poly_size: int = 10  # Shamir chunk degree (main.go:46)
    # Share-row redundancy factor r: TOTAL_SHARES = ceil(r·k/M)·M. The
    # reference protocol hardwires r=2 (main.go:825), which lets any ⌈M/2⌉
    # miners reconstruct an aggregate, so two DISJOINT miner subsets can
    # serve two different aggregation sets that a malicious leader can
    # difference. Any r < 2 makes recovering subsets overlap in a miner.
    # Layouts where ceil-rounding breaks that promise fail loudly from
    # total_shares — set r=2.0 explicitly there.
    share_redundancy: float = 1.5
    max_iterations: int = 100
    defense: Defense = Defense.KRUM
    roni_threshold: float = 0.02  # RONI reject score (main.go:203-231)
    # per-tail trim for defense=TRIMMED_MEAN; must exceed the Byzantine
    # fraction (Yin'18)
    trim_fraction: float = 0.35
    convergence_error: float = 0.05
    fault_plan: FaultPlan = field(default_factory=FaultPlan)

    # wire and protocol planes (runtime/codecs.py, runtime/protocol.py;
    # reference config.py:320-389): the payload codec, chunking threshold
    # and top-k fraction; the overlay (and its subtree size, which the
    # overlay's check reads), trace stamping and the protocol version pin
    # that `protocol.advertised` reads
    overlay: bool = False
    overlay_group: int = 0
    wire_codec: str = "raw64"
    wire_chunk_bytes: int = 4 * 1024 * 1024
    wire_topk: float = 0.05
    trace: bool = False
    protocol_version: int = -1

    logreg_alpha: float = 1e-2
    grad_clip: float = 100.0
    batch_size: int = 10
    noise_presample_iters: int = 100  # DP noise bank depth (client_obj.py:59-67)
    seed: int = 0

    def __post_init__(self) -> None:
        # the reference's checks (biscotti_tpu/config.py:414-424): order
        # statistics cannot be taken over additive secret shares
        if self.defense == Defense.TRIMMED_MEAN and self.secure_agg:
            raise ValueError(
                "defense=TRIMMED_MEAN is incompatible with secure_agg: "
                "coordinate-wise order statistics cannot be computed over "
                "additive secret shares. Run with secure_agg=0, or choose "
                "KRUM/MULTIKRUM, which are verifier-side accept masks and "
                "compose with secure-agg.")
        if not (0.0 <= self.trim_fraction < 0.5) \
                and self.defense == Defense.TRIMMED_MEAN:
            raise ValueError(
                f"trim_fraction={self.trim_fraction} must be in [0, 0.5)")
        # the wire and protocol checks (reference config.py:426-438,
        # 530-549)
        from biscotti_tpu_torch.runtime.codecs import WireCodecError, parse_codec
        from biscotti_tpu_torch.runtime.protocol import CURRENT_VERSION

        try:
            parse_codec(self.wire_codec)
        except WireCodecError as e:
            raise ValueError(f"wire_codec: {e}") from None
        if not (0.0 < self.wire_topk <= 1.0):
            raise ValueError(
                f"wire_topk={self.wire_topk} must be in (0, 1]")
        if self.wire_chunk_bytes < 0:
            raise ValueError("wire_chunk_bytes must be >= 0")
        if not (-1 <= self.protocol_version <= CURRENT_VERSION):
            raise ValueError(
                f"protocol_version={self.protocol_version} must be -1 "
                f"(current) or a historical row in [0, {CURRENT_VERSION}] "
                "(runtime/protocol.py version table; docs/PROTOCOL.md)")
        if self.overlay and self.overlay_group < 2:
            raise ValueError(
                "overlay=True requires overlay_group >= 2 (peers per "
                "aggregation subtree; the hive launcher defaults it to "
                "its co-hosted span — docs/OVERLAY.md)")
        if self.overlay_group < 0:
            raise ValueError("overlay_group must be >= 0")

    @property
    def num_samples(self) -> int:
        """Per-round sampled contributor count: floor(N·perc), clamped to the
        worker population N − verifiers − miners (ref: main.go:672-679)."""
        n = int(self.num_nodes * self.sample_percent)
        return max(1, min(n, self.num_nodes - self.num_verifiers - self.num_miners))

    @property
    def total_shares(self) -> int:
        """TOTAL_SHARES = ceil(r·POLY_SIZE/NUM_MINERS)·NUM_MINERS
        (ref: main.go:825 with r fixed at 2; see share_redundancy).

        Exact rational arithmetic — float ceil would let representation
        error round rows-per-miner up and silently reopen the differencing
        channel the knob exists to close. When r < 2 is configured, the
        property it promises (no ⌊M/2⌋-miner subset can reconstruct) is
        CHECKED against the rounded layout, and a misconfiguration raises."""
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

    @staticmethod
    def add_args(p: argparse.ArgumentParser) -> None:
        """The reference's flags for the fields above (same names)."""
        p.add_argument("-t", "--num-nodes", type=int, default=10)
        p.add_argument("-d", "--dataset", type=str, default="creditcard")
        p.add_argument("--model", dest="model_name", type=str, default="")
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
                            "mcmc13 = Song&Sarwate'13 (ref diffPriv13 branch)")
        p.add_argument("-po", "--poison-fraction", type=float, default=0.0)
        p.add_argument("-ns", "--sample-percent", type=float, default=70.0)
        p.add_argument("--defense", type=str, default="KRUM",
                       choices=[d.value for d in Defense])
        p.add_argument("--trim-fraction", type=float, default=0.35,
                       help="per-tail trim for defense=TRIMMED_MEAN "
                            "(must exceed the Byzantine fraction)")
        p.add_argument("--max-iterations", type=int, default=100)
        p.add_argument("--convergence-error", type=float, default=0.05)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--fault-seed", type=int, default=FaultPlan.seed)
        p.add_argument("--fault-drop", type=float, default=FaultPlan.drop)

    @classmethod
    def from_args(cls, ns: argparse.Namespace) -> "BiscottiConfig":
        # -ns is a percentage on the reference CLI (70 means 70%)
        return cls(
            num_nodes=ns.num_nodes, dataset=ns.dataset,
            model_name=ns.model_name, num_miners=ns.num_miners,
            num_verifiers=ns.num_verifiers, num_noisers=ns.num_noisers,
            secure_agg=bool(ns.secure_agg),
            noising=bool(ns.noising),
            verification=bool(ns.verification), epsilon=ns.epsilon,
            dp_mechanism=ns.dp_mechanism, poison_fraction=ns.poison_fraction,
            sample_percent=ns.sample_percent / 100.0,
            defense=Defense(ns.defense), trim_fraction=ns.trim_fraction,
            max_iterations=ns.max_iterations,
            convergence_error=ns.convergence_error, seed=ns.seed,
            fault_plan=FaultPlan(seed=ns.fault_seed, drop=ns.fault_drop))
