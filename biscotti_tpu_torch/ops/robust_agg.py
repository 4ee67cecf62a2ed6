"""Non-IID-robust aggregation: Multi-Krum, coordinate-wise trimmed mean and
median, and FoolsGold similarity statistics (counterpart of
`biscotti_tpu/ops/robust_agg.py`, whose docstring gives each rule's
source and measured operating point).

Where the two frameworks differ, the port follows the reference:
  * medians average the two middle values for even n (`jnp.median`);
    `torch.median` returns the lower one, so `_median` sorts;
  * Multi-Krum's `lax.top_k(-scores, m)` puts the lower index first on
    ties; the port ranks in Krum's accept order (`ops/krum.rank_scores`),
    stable sorts that also rank non-finite scores as the reference does;
  * FoolsGold's pardoning, clip and logit transform are copied expression
    for expression, so masks compare exactly.

Multi-Krum scores through `krum_scores_auto`, so a CUDA committee inside
[KERNEL_MIN_N, KERNEL_MAX_N] runs the Hopper kernel B1.
"""

from __future__ import annotations

import torch


def multikrum_m(n: int, num_adversaries: int) -> int:
    """Blanchard et al.'s selection size m = n − f − 2, floored at 1."""
    return max(n - num_adversaries - 2, 1)


def multikrum_accept_mask(deltas: torch.Tensor, num_adversaries: int,
                          m: int = 0) -> torch.Tensor:
    """Dense bool mask of the m lowest-Krum-scored updates (m = n − f − 2
    by default), in Krum's accept order (`ops/krum.rank_scores`: ties to
    the lower index, non-finite scores as the reference ranks them)."""
    from biscotti_tpu_torch.ops.krum import accept_mask
    from biscotti_tpu_torch.ops.krum_cuda import krum_scores_auto

    n = deltas.shape[0]
    keep = min(m if m > 0 else multikrum_m(n, num_adversaries), n)
    return accept_mask(krum_scores_auto(deltas, num_adversaries), keep)


def _trim_count(n: int, trim_frac: float) -> int:
    """t = ⌊β·n⌋ per tail, capped so at least one value is kept."""
    return min(int(trim_frac * n), (n - 1) // 2)


def trimmed_mean(updates: torch.Tensor, trim_frac: float) -> torch.Tensor:
    """Coordinate-wise β-trimmed mean over the peer axis of [n, d]: sort
    each coordinate's n values, drop t from each end, average the rest."""
    n = updates.shape[0]
    t = _trim_count(n, trim_frac)
    s = torch.sort(updates.to(torch.float32), dim=0).values
    return s[t:n - t].mean(dim=0)


def trimmed_mean_aggregate(updates: torch.Tensor, trim_frac: float) -> torch.Tensor:
    """(n − 2t)·trimmed_mean: the sum-scale form that matches the
    reference's Σ-of-accepted aggregation (honest.go:360-375)."""
    n = updates.shape[0]
    return (n - 2 * _trim_count(n, trim_frac)) * trimmed_mean(updates, trim_frac)


def _median(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """`jnp.median`: the middle value, or the mean of the two middle values
    when the length is even."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    hi = s.narrow(dim, n // 2, 1).squeeze(dim)
    if n % 2:
        return hi
    return (s.narrow(dim, n // 2 - 1, 1).squeeze(dim) + hi) / 2.0


def median_aggregate(updates: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median scaled by ⌈n/2⌉, the β→0.5 limit of the
    trimmed mean."""
    n = updates.shape[0]
    return ((n + 1) // 2) * _median(updates.to(torch.float32), dim=0)


# --------------------------------------------------------------- FoolsGold


def _cosine_matrix(updates: torch.Tensor) -> torch.Tensor:
    """[n, n] pairwise cosine, rows divided by max(‖row‖, 1e-12), the
    diagonal at −inf."""
    x = updates.to(torch.float32)
    xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                         min=1e-12)
    cs = xn @ xn.T
    eye = torch.eye(cs.shape[0], dtype=torch.bool, device=cs.device)
    return torch.where(eye, torch.full_like(cs, -torch.inf), cs)


def foolsgold_weights(updates: torch.Tensor) -> torch.Tensor:
    """Per-client FoolsGold weights in [0, 1] (Fung et al., RAID'20, Alg. 1):
    pardoning by v_i/v_j, 1 − max similarity, normalised by its max, then
    the clipped logit (ref: robust_agg.py:132-155)."""
    cs = _cosine_matrix(updates)
    v = cs.max(dim=1).values
    vi, vj = v[:, None], v[None, :]
    ratio = vi / torch.where(vj > 0, vj, torch.ones_like(vj))
    cs = torch.where((vj > vi) & (vj > 0), cs * ratio, cs)
    alpha = 1.0 - cs.max(dim=1).values
    alpha = torch.clamp(alpha, 0.0, 1.0)
    alpha = alpha / torch.clamp(alpha.max(), min=1e-12)
    a = torch.clamp(alpha, 1e-5, 1.0 - 1e-5)
    return torch.clamp(torch.log(a / (1.0 - a)) + 0.5, 0.0, 1.0)


def max_mutual_cosine(updates: torch.Tensor) -> torch.Tensor:
    """v_i = max_{j≠i} cos(update_i, update_j), the sybil statistic."""
    return _cosine_matrix(updates).max(dim=1).values


def foolsgold_accept_mask(updates: torch.Tensor, min_cluster: int = 3) -> torch.Tensor:
    """Reject clients whose max mutual cosine exceeds
    median + max(3·MAD, 0.05) of the round's v AND who sit in a cluster of
    >= `min_cluster` flagged, mutually similar clients (partners' cosine
    >= 0.8 of the larger v) (ref: robust_agg.py:166-224)."""
    cs = _cosine_matrix(updates)
    v = cs.max(dim=1).values  # max_mutual_cosine
    med = _median(v)
    mad = _median(torch.abs(v - med))
    thresh = med + torch.clamp(3.0 * mad, min=0.05)
    flagged = v > thresh
    if min_cluster > 1:
        vmax = torch.maximum(v[:, None], v[None, :])
        partners = (cs >= 0.8 * vmax) & flagged[None, :] & flagged[:, None]
        csize = partners.sum(dim=1) + 1
        flagged = flagged & (csize >= min_cluster)
    return ~flagged
