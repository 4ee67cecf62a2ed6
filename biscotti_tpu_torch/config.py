"""Slim copy of `biscotti_tpu/config.py`: the fields the simulator reads.

The keyword names and defaults are the reference's, so one dict builds both
packages' configs. `FaultPlan` keeps only the frame-drop subset
(`seed`, `drop`, `enabled`) that the simulator mirrors
(`biscotti_tpu/runtime/faults.py::FaultPlan`).
"""

from __future__ import annotations

import argparse
import enum
from dataclasses import dataclass, field


class Defense(str, enum.Enum):
    """Poisoning-defense selection (ref: DistSys/main.go:57 POISON_DEFENSE).
    The port's simulator implements KRUM and NONE so far."""

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
    convergence_error: float = 0.05
    fault_plan: FaultPlan = field(default_factory=FaultPlan)

    logreg_alpha: float = 1e-2
    grad_clip: float = 100.0
    batch_size: int = 10
    seed: int = 0

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
        p.add_argument("-np", "--noising", type=int, default=1)
        p.add_argument("-vp", "--verification", type=int, default=1)
        p.add_argument("-ep", "--epsilon", type=float, default=1.0)
        # only what the port implements so far (ROADMAP.md A4, item 8)
        p.add_argument("--dp-mechanism", type=str, default="gaussian",
                       choices=["gaussian"])
        p.add_argument("-po", "--poison-fraction", type=float, default=0.0)
        p.add_argument("-ns", "--sample-percent", type=float, default=70.0)
        p.add_argument("--defense", type=str, default="KRUM",
                       choices=[Defense.KRUM.value, Defense.NONE.value])
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
            num_verifiers=ns.num_verifiers, noising=bool(ns.noising),
            verification=bool(ns.verification), epsilon=ns.epsilon,
            dp_mechanism=ns.dp_mechanism, poison_fraction=ns.poison_fraction,
            sample_percent=ns.sample_percent / 100.0,
            defense=Defense(ns.defense), max_iterations=ns.max_iterations,
            convergence_error=ns.convergence_error, seed=ns.seed,
            fault_plan=FaultPlan(seed=ns.fault_seed, drop=ns.fault_drop))
