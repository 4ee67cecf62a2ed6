"""KRUM, as Biscotti's simulator states it: f = ⌊n/2⌋; score_i = Σ of
the n − f − 2 smallest squared distances to the others; the n − f lowest
scores are accepted, ties to the lower index. The miner sums the
accepted updates."""

from __future__ import annotations

import torch

from .defense import masked_sum as aggregate  # noqa: F401
from .nets import Precision


def decide(prec: Precision, x: torch.Tensor):
    """(mask[n], margin[n]) of Krum over x[n, d]. A score is a sum of
    D_ij = sq_i + sq_j − 2·G_ij, each rounded on the scale of sq_i + sq_j
    however far it cancels, so an update's margin is its score's distance
    from the boundary between accepted and rejected scores over
    Σ_j (sq_i + sq_j) over its nearest j: duplicate updates, whose
    distances cancel to 0, tie to rounding and not to their scores' size."""
    n = x.shape[0]
    f = n // 2
    k = n - f - 2
    if k <= 0:
        ones = torch.ones(n, dtype=torch.bool, device=x.device)
        return ones, torch.full((n,), float("inf"), device=x.device)
    sq = (x * x).sum(dim=1)
    dist = (sq[:, None] + sq[None, :] - 2.0 * prec.mm(x, x.T)).clamp_min(0.0)
    dist.fill_diagonal_(float("inf"))
    near = torch.sort(dist, dim=1)
    scores = near.values[:, :k].sum(dim=1)
    scale = k * sq + sq[near.indices[:, :k]].sum(dim=1)
    order = torch.sort(scores, stable=True).indices
    mask = torch.zeros(n, dtype=torch.bool, device=x.device)
    mask[order[:n - f]] = True
    ranked = scores[order]
    boundary = (ranked[n - f - 1] + ranked[n - f]) / 2.0
    return mask, ((scores - boundary).abs() / scale).double()
