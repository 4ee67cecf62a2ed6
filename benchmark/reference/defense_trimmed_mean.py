"""TRIMMED_MEAN: every update accepted; the aggregate is (n − 2t) times
the coordinate-wise mean of the middle n − 2t values,
t = min(⌊β·n⌋, ⌊(n − 1)/2⌋), β the settings' `trim_fraction`."""

from __future__ import annotations

import torch

from .defense import accept_all as decide  # noqa: F401


def trimmed_mean_sum(x: torch.Tensor, trim: float) -> torch.Tensor:
    n = x.shape[0]
    t = min(int(trim * n), (n - 1) // 2)
    s = torch.sort(x, dim=0).values
    return (n - 2 * t) * s[t:n - t].mean(dim=0)


def aggregate(mask: torch.Tensor, src: torch.Tensor, settings) -> torch.Tensor:
    return trimmed_mean_sum(src, settings["trim_fraction"])
