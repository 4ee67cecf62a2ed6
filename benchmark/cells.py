"""A cell, found by name: `workloads/<name>.json` names its configuration
(`configs/<config>.json`) and its traffic mix (`traffic/<traffic>.json`)
and holds the limits of its comparison. Adding a cell adds files; no file
here names a cell.

The `simulator` objects of the configuration and of the traffic mix are
the program's settings, `BiscottiConfig`'s fields by name; together they
are the cell's `settings`, which the reference reads as well. Every
other key is the benchmark's own."""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def _load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    # the first rounds whose accept masks the comparison judges
    judged_first_masks: tuple = (0, 1, 2)

    @property
    def settings(self) -> dict:
        """The program's settings: the configuration's `simulator` object
        and the traffic's, which may not name one key twice."""
        c, t = self.config["simulator"], self.traffic["simulator"]
        both = sorted(set(c) & set(t))
        if both:
            raise KeyError(f"{self.name}: configuration and traffic both set {both}")
        return {**c, **t}

    @property
    def model(self) -> str:
        return self.settings["model_name"]

    @property
    def num_samples(self) -> int:
        """Contributors a round: ⌊N · sample⌋, at most N − 6 (the
        simulator's three verifiers and three miners)."""
        s = self.settings
        n = s["num_nodes"]
        return max(1, min(int(n * s["sample_percent"]), n - 6))


def load(name: str, **config_overrides) -> Cell:
    """The cell `name`; `config_overrides` replace configuration keys, in
    its `simulator` object where that holds the key (the tests' small
    sizes)."""
    w = _load("workloads", name)
    config = _load("configs", w["config"])
    sim = dict(config["simulator"])
    for k, v in config_overrides.items():
        (sim if k in sim else config)[k] = v
    config["simulator"] = sim
    return Cell(name, config, _load("traffic", w["traffic"]),
                int(w.get("chips", 1)), w.get("limits", {}),
                tuple(w.get("judged_first_masks", (0, 1, 2))))


def weights_seed(seed: int) -> int:
    h = hashlib.sha256(f"benchmark/weights/{seed}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def initial_weights(cell: Cell, seed: int, device) -> torch.Tensor:
    """The flat float32 weights a run starts from, drawn on `device` from
    the seed in two calls, by the laws of the reference model's leaves:
    "zeros", "uniform" U(±1/√fan_in) for dense [in, out], "normal"
    N(0, 1)/√(k·k·C_in) for HWIO kernels."""
    from benchmark.reference.round import model

    leaves = model(cell.model, 1).leaves
    d = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(weights_seed(seed))
    u = torch.rand(d, generator=gen, device=device)
    z = torch.randn(d, generator=gen, device=device)
    w = torch.zeros(d, device=device)
    at = 0
    for _, shape, law in leaves:
        sl = slice(at, at + math.prod(shape))
        if law == "uniform":
            w[sl] = (2.0 * u[sl] - 1.0) / math.sqrt(shape[0])
        elif law == "normal":
            w[sl] = z[sl] / math.sqrt(math.prod(shape[:-1]))
        at = sl.stop
    return w
