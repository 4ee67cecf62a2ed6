"""Slim copy of `biscotti_tpu/config.py`: the fields the simulator and the
per-peer `Trainer` read.

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
    max_iterations: int = 100
    defense: Defense = Defense.KRUM
    roni_threshold: float = 0.02  # RONI reject score (main.go:203-231)
    # per-tail trim for defense=TRIMMED_MEAN; must exceed the Byzantine
    # fraction (Yin'18)
    trim_fraction: float = 0.35
    convergence_error: float = 0.05
    fault_plan: FaultPlan = field(default_factory=FaultPlan)

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

    @property
    def num_samples(self) -> int:
        """Per-round sampled contributor count: floor(N·perc), clamped to the
        worker population N − verifiers − miners (ref: main.go:672-679)."""
        n = int(self.num_nodes * self.sample_percent)
        return max(1, min(n, self.num_nodes - self.num_verifiers - self.num_miners))

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
