"""The verifier committee's decision and the miner's aggregate, plain,
found by the defense's name: `defense_<name>.py` (the name in lower
case) holds

  decide(prec, x[n, d]) -> (mask[n], margin[n])
      the accept mask over the noised updates, and how far each update's
      decision lies from its threshold, as a share of the scale on which
      its statistic rounds: a program whose rounding puts an update on
      the other side of a near-tie is not wrong, one that moves an
      update that lies far from it is;
  aggregate(mask[n], src[n, d], settings) -> [d]
      the miner's update from the accepted updates.

A new defense is a new module here; no file names one.
"""

from __future__ import annotations

import importlib

import torch


def rule(defense: str):
    """The module of `defense`'s decision and aggregate."""
    return importlib.import_module(f"benchmark.reference.defense_{defense.lower()}")


def accept_all(prec, x: torch.Tensor):
    """Every update accepted; no decision lies near a threshold."""
    n = x.shape[0]
    return (torch.ones(n, dtype=torch.bool, device=x.device),
            torch.full((n,), float("inf"), dtype=torch.float64,
                       device=x.device))


def masked_sum(mask: torch.Tensor, src: torch.Tensor, settings=None) -> torch.Tensor:
    """The sum of the accepted updates."""
    return (src * mask[:, None].to(src.dtype)).sum(dim=0)


def median(v: torch.Tensor) -> torch.Tensor:
    """The median, the mean of the middle two of an even count."""
    s = torch.sort(v).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0
