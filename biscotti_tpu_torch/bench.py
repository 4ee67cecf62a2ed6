"""The port's device-round bench: the device-round half of the reference
bench's `bench_config` (bench.py:205-244) over its eight BASELINE configs
(bench.py:842-879), on the GPU.

    python -m biscotti_tpu_torch.bench [--configs NAME,NAME] [--rounds N]
                                       [--device cpu]

For each config it builds the port's `Simulator`, runs 2 warm rounds, then
10 timed rounds (4 for the rows that name a model, as bench.py:887), ending
in `torch.cuda.synchronize()`; `device_round_s` is the timed span over the
timed rounds. Standard output is one JSON line: the device, the card's
`name, power.limit` as nvidia-smi prints it (null on the CPU) and one row a
config with `device_round_s`, `accepted_per_round`, `final_error`, `params`
and `nodes`.

Left out: the MFU column (bench.py:225-232 counts dense-layer FLOPs only and
undercounts the convolutions by its own comment) and the host crypto half,
which waits for the port's secret-share and commitment seams.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List, Optional, Tuple, Union

import torch

from biscotti_tpu_torch.config import BiscottiConfig, Defense
from biscotti_tpu_torch.device import resolve_device, synchronize
from biscotti_tpu_torch.parallel.sim import Simulator

WARM_ROUNDS = 2

# bench.py:842-879, in order
BASE = dict(batch_size=10, epsilon=1.0, sample_percent=0.70,
            num_verifiers=3, num_miners=3, num_noisers=2, seed=0)
CONFIGS: List[Tuple[str, dict]] = [
    ("creditcard_10", dict(dataset="creditcard", num_nodes=10, secure_agg=True,
                           noising=True, verification=True)),
    ("mnist_100_clean", dict(dataset="mnist", num_nodes=100, secure_agg=True,
                             noising=False, verification=True)),
    ("mnist_100_poison30_krum", dict(dataset="mnist", num_nodes=100,
                                     secure_agg=True, noising=True,
                                     verification=True, poison_fraction=0.30)),
    ("mnist_100_dp_eps1", dict(dataset="mnist", num_nodes=100, secure_agg=True,
                               noising=True, verification=True)),
    ("cifar_lenet_100_krum_secagg", dict(dataset="cifar", model_name="cifar_cnn",
                                         num_nodes=100, secure_agg=True,
                                         noising=False, verification=True)),
    ("mnist_cnn_100_krum_secagg", dict(dataset="mnist", model_name="mnist_cnn",
                                       num_nodes=100, secure_agg=True,
                                       noising=False, verification=True)),
    ("lfw_cnn_100_krum_secagg", dict(dataset="lfw", model_name="lfw_cnn",
                                     num_nodes=100, secure_agg=True,
                                     noising=False, verification=True)),
    ("svm_mnist_100_krum_secagg", dict(dataset="mnist", model_name="svm",
                                       num_nodes=100, secure_agg=True,
                                       noising=False, verification=True)),
]


def config(name: str) -> BiscottiConfig:
    """The named BASELINE config, built from the reference's keywords."""
    return BiscottiConfig(defense=Defense.KRUM, **dict(CONFIGS)[name], **BASE)


def timed_rounds(cfg: BiscottiConfig) -> int:
    return 4 if cfg.model_name else 10


def bench_config(cfg: BiscottiConfig, rounds: int,
                 device: Optional[Union[str, torch.device]] = None) -> dict:
    """One config's device round: 2 warm rounds, then `rounds` timed."""
    sim = Simulator(cfg, device=device)
    w, stake = sim.init_state()
    for it in range(WARM_ROUNDS):
        w, stake, mask, err = sim.round_step(w, stake, it)
    synchronize(sim.device)
    t0 = time.perf_counter()
    for it in range(WARM_ROUNDS, WARM_ROUNDS + rounds):
        w, stake, mask, err = sim.round_step(w, stake, it)
    synchronize(sim.device)
    device_s = (time.perf_counter() - t0) / rounds
    return {"dataset": cfg.dataset, "model": sim.model.name,
            "nodes": cfg.num_nodes, "params": sim.num_params,
            "defense": cfg.defense.value, "secure_agg": cfg.secure_agg,
            "noising": cfg.noising, "poison": cfg.poison_fraction,
            "timed_rounds": rounds, "device_round_s": device_s,
            "accepted_per_round": int(mask.sum()), "final_error": float(err)}


def card_line() -> str:
    """The card's `name, power.limit` as nvidia-smi prints it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def run(names: Optional[List[str]] = None, rounds: int = 0,
        device: Optional[Union[str, torch.device]] = None) -> dict:
    """The bench over `names` (every config when not given); `rounds`
    overrides the timed-round count."""
    dev = resolve_device(device)
    rows: Dict[str, dict] = {}
    for name in names or [n for n, _ in CONFIGS]:
        cfg = config(name)
        rows[name] = bench_config(cfg, rounds or timed_rounds(cfg), dev)
    return {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "nvidia_smi": card_line() if dev.type == "cuda" else None,
            "warm_rounds": WARM_ROUNDS, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's device-round bench")
    ap.add_argument("--configs", default="",
                    help="comma-separated config names (all eight when empty): "
                         + ", ".join(n for n, _ in CONFIGS))
    ap.add_argument("--rounds", type=int, default=0,
                    help="timed rounds a config (10, or 4 for model rows)")
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when not given")
    ns = ap.parse_args(argv)
    names = [n for n in ns.configs.split(",") if n]
    unknown = set(names) - set(dict(CONFIGS))
    if unknown:
        ap.error(f"unknown configs: {sorted(unknown)}")
    print(json.dumps(run(names, ns.rounds, ns.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
