"""Krum Byzantine-update filtering (counterpart of `biscotti_tpu/ops/krum.py`).

Semantics, as the reference keeps them:
  f          = floor(NumAdversaries · n), NumAdversaries = 0.5 (krum.go:27-28,110)
  D_ij       = max(‖x_i‖² + ‖x_j‖² − 2·x_i·x_j, 0)
  score_i    = Σ of the (n − f − 2) smallest D_ij, j ≠ i
  accept     = the n − f lowest-scoring updates, ties to the lower index

The reference picks the accepted set with `lax.top_k`, which puts the lower
index first on ties; `torch.topk` promises no tie order. The port ranks with
a stable ascending sort, so duplicate (colluding) updates resolve as they do
in the reference.
"""

from __future__ import annotations

import math

import torch


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """D[i,j] = ‖x_i − x_j‖² as one matmul (ref: client_obj.py:131-134),
    clamped at 0 against fp cancellation."""
    x = x.to(torch.float32)
    sq = (x * x).sum(dim=-1)
    d = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return torch.clamp(d, min=0.0)


def krum_scores(deltas: torch.Tensor, num_adversaries: int) -> torch.Tensor:
    """score_i = Σ of the (n − f − 2) nearest-neighbour distances
    (ref: client_obj.py:127-143): D with the diagonal at +inf, sorted
    ascending per row, the first k summed. This is also the plain version of
    the Hopper kernel (ops/krum_cuda.py)."""
    n = deltas.shape[0]
    k = max(n - num_adversaries - 2, 0)
    if k == 0:
        return torch.zeros(n, dtype=torch.float32, device=deltas.device)
    d = pairwise_sq_dists(deltas)
    d.fill_diagonal_(math.inf)  # the reference's sorted[0] self-distance drop
    return torch.sort(d, dim=-1).values[:, :k].sum(dim=-1)


def krum_accept_mask(deltas: torch.Tensor, num_adversaries: int) -> torch.Tensor:
    """Dense bool mask of the n − f accepted updates (lowest Krum scores;
    ref: client_obj.py:119-124). Committees inside the kernel window score
    through the Hopper kernel (ops/krum_cuda.krum_scores_auto)."""
    from biscotti_tpu_torch.ops.krum_cuda import krum_scores_auto

    n = deltas.shape[0]
    keep = n - num_adversaries
    scores = krum_scores_auto(deltas, num_adversaries)
    idx = torch.sort(scores, stable=True).indices[:keep]
    mask = torch.zeros(n, dtype=torch.bool, device=deltas.device)
    mask[idx] = True
    return mask


def krum_select(deltas: torch.Tensor, num_adversaries: int) -> torch.Tensor:
    """Reference-shaped API: the accepted index set, ascending."""
    return torch.nonzero(krum_accept_mask(deltas, num_adversaries))[:, 0]


def default_num_adversaries(n: int, frac: float = 0.5) -> int:
    """adversaryCount = int(0.5·n) (ref: krum.go:110)."""
    return int(frac * n)


def collusion_accept_override(peer_id: int, num_nodes: int,
                              poison_fraction: float) -> bool:
    """Colluding poisoners rubber-stamp each other's updates when they land
    on the verifier committee (ref: krum.go:47-58): poisoners are the node
    ids above ceil(N·(1−POISONING))."""
    if poison_fraction <= 0:
        return False
    poisoning_index = math.ceil(num_nodes * (1.0 - poison_fraction))
    return peer_id > poisoning_index
