"""FOOLSGOLD, as Biscotti's simulator states it: v_i = max cosine to
another update; flagged where v_i > median(v) + max(3·MAD(v), 0.05) and
i sits with at least two flagged partners (cos ≥ 0.8 · max(v_i, v_j));
medians of an even count average the middle two. The miner sums the
accepted updates."""

from __future__ import annotations

import torch

from .defense import masked_sum as aggregate  # noqa: F401
from .defense import median
from .nets import Precision


def decide(prec: Precision, x: torch.Tensor):
    """(mask[n], margin[n]) of FoolsGold over x[n, d]. A decision here
    hangs on every v and on every flagged pair, so each update's margin
    is the least distance of any of them from its threshold."""
    n = x.shape[0]
    xn = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
    cs = prec.mm(xn, xn.T)
    cs.fill_diagonal_(-float("inf"))
    v = cs.max(dim=1).values
    med = median(v)
    mad = median((v - med).abs())
    thresh = med + torch.clamp(3.0 * mad, min=0.05)
    flagged = v > thresh
    vmax = torch.maximum(v[:, None], v[None, :])
    partners = (cs >= 0.8 * vmax) & flagged[None, :] & flagged[:, None]
    flagged = flagged & (partners.sum(dim=1) + 1 >= 3)
    near = (v - thresh).abs().min()
    pair = (cs - 0.8 * vmax).abs()
    both = (v[:, None] > thresh - near) & (v[None, :] > thresh - near)
    if bool(both.any()):
        near = torch.minimum(near, pair[both].min())
    margin = (near / thresh.abs()).double()
    return ~flagged, margin.expand(n)
