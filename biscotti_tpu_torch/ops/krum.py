"""Krum Byzantine-update filtering (counterpart of `biscotti_tpu/ops/krum.py`).

Semantics, as the reference keeps them:
  f          = floor(NumAdversaries · n), NumAdversaries = 0.5 (krum.go:27-28,110)
  D_ij       = max(‖x_i‖² + ‖x_j‖² − 2·x_i·x_j, 0), plus +inf on the diagonal
  score_i    = Σ of the (n − f − 2) smallest D_ij, the diagonal ranked last
  accept     = the n − f lowest-scoring updates, ties to the lower index

The reference picks the accepted set with `lax.top_k`, which puts the lower
index first on ties; `torch.topk` promises no tie order. The port ranks with
stable ascending sorts, so duplicate (colluding) updates resolve as they do
in the reference.

Non-finite updates (an overflowing ‖x‖², ±inf, NaN). The reference's CPU
path ranks a NaN by its bits (XLA's total order), and those bits come from
the hardware: x86 gives inf − inf the NaN with its sign bit set, the card
gives it with the sign bit clear. The port does not read hardware NaN bits;
it classes each NaN by where it came from, a rule taken from the
reference's masks and scores on the CPU:
  * D is formed as (sq_i + sq_j) − 2·G_ij in ONE rounding, as XLA's fused
    expression contracts it into an fma: finite 2·G is exact, so this
    differs from two roundings only where 2·G overflows (a row of norm
    ~1.5e19 keeps a finite or +inf self-distance, not a NaN);
  * the diagonal is ADDED (+inf), not written, so a NaN self-distance
    stays NaN;
  * a NaN distance between two rows with no NaN input (inf − inf, inf·0:
    a generated NaN) ranks as the NEAREST distance, below 0; a NaN
    distance that a NaN input propagated (sq_i or sq_j is NaN) ranks as
    the FARTHEST, after +inf;
  * a score whose n − f − 2 nearest include a generated NaN is the NaN
    0xffc00000 (sign set) and ranks FIRST for acceptance; else, one whose
    nearest include a propagated NaN is the NaN 0x7fc00000 and ranks LAST
    (after +inf); ±inf and finite scores rank by value. These are the
    reference's own score bits on the CPU, written here explicitly.
So the reference accepts an update whose ‖x‖² overflows (input 1 of
ROADMAP C1: x = default_rng(1).normal((7, 16)), x[2, 5] = 2e19, f = 3 →
[0, 2, 3, 5]). A NaN input is taken with its sign bit clear (np.nan,
float("nan")); entries within a factor of n·d of FLT_MAX can overflow
in one Gram summation order and not in another, which no rule fixes.
`rank_scores` is the accept order, shared by Krum, Multi-Krum and every
backend of the scores (the plain path here and kernel B1).

Subnormals. The reference runs with flush-to-zero and denormals-are-zero
on both of its platforms (XLA's CPU flushes, the TPU has no subnormals):
a subnormal input reads as 0, every subnormal product and every
subnormal sum is 0. So on x = default_rng(0).normal((6, 8)) * 1e-20
(ROADMAP C2, f = 3) every distance is 0 and it accepts [0, 1, 2], where
IEEE arithmetic gives distances of ~1e-39 and accepts [0, 4, 5]. The
port does not rely on the thread-local FTZ/DAZ state
(`torch.set_flush_denormal` covers only the calling thread, not torch's
intra-op pool); it applies the rule to its own operands:
  * an input with |x| < FLT_MIN is 0 (DAZ);
  * sq_i sums its products x_ik² with each subnormal product as 0;
  * a Gram entry G_ij is 0 when max|x_i| · max|x_j| < FLT_MIN (every
    product of the entry is then subnormal, so the reference sums
    zeros), and a subnormal G_ij is 0;
  * a subnormal distance is 0.
Kernel B1 applies the same rule in its pre-pass (DAZ, row maxima) and its
epilogue. Not covered: a Gram entry whose products are partly normal
and partly subnormal (the reference drops each subnormal product, the
port's matmul keeps them), one whose products are all subnormal although
max|x_i| · max|x_j| is normal (the maxima sit in different columns), and
a partial sum that cancels into the subnormal range halfway through the
reference's summation; each changes a distance only near FLT_MIN.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# the two NaN scores (see the module docstring), as int32 bit patterns
_NAN_NEAREST = -0x00400000  # 0xffc00000: a generated NaN, ranks first
_NAN_FARTHEST = 0x7fc00000  # a propagated NaN, ranks last


def _nan_score(bits: int, like: torch.Tensor) -> torch.Tensor:
    """The NaN of `bits` as a float32 scalar on `like`'s device (a fill,
    not a host copy)."""
    return torch.full((), bits, dtype=torch.int32,
                      device=like.device).view(torch.float32)


FLT_MIN = torch.finfo(torch.float32).tiny  # the least normal float32
# the largest subnormal float32: `threshold(t, _SUB_MAX, 0)` keeps t >=
# FLT_MIN (and NaN), and writes +0 for the rest, in one pass
_SUB_MAX = 1.1754942106924411e-38


def _flush(t: torch.Tensor) -> torch.Tensor:
    """Subnormals (and -0) to +0, as flush-to-zero stores them; NaN and
    ±inf stay."""
    return torch.where(t.abs() < FLT_MIN, 0.0, t)


def square_norms(x: torch.Tensor) -> torch.Tensor:
    """sq_i = Σ_k x_ik² with each subnormal product as 0 (the module
    docstring's rule; a subnormal input's square is one, so x needs no
    flush first). Kernel B1's wrapper takes its sq from here, so both
    backends cancel alike."""
    return F.threshold_(x * x, _SUB_MAX, 0.0).sum(dim=-1)


def _distances(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(D without its diagonal term, sq): D[i,j] = (sq_i + sq_j) − 2G_ij
    taken in float64 and rounded once to float32, as XLA's fma rounds it,
    clamped at 0 against cancellation, under the reference's flush-to-zero
    (module docstring); a NaN stays NaN."""
    x = x.to(torch.float32)
    # one |x| buffer serves the flush, the row maxima and the squares: a
    # flushed row's max is the raw one, or 0 where the whole row is
    # subnormal; |x|·|x| is x·x, so sq is square_norms(x) bit for bit
    a = x.abs()
    amax = _flush(a.amax(dim=-1))
    x = x.masked_fill(a < FLT_MIN, 0.0)  # NaN compares false and stays
    sq = F.threshold_(a.mul_(a), _SUB_MAX, 0.0).sum(dim=-1)
    g = x @ x.T
    g = torch.where(amax[:, None] * amax[None, :] < FLT_MIN, 0.0, _flush(g))
    d = ((sq[:, None] + sq[None, :]).double() - 2.0 * g.double()).float()
    # negatives, -0 and subnormals to +0, NaN kept
    return F.threshold_(d, _SUB_MAX, 0.0), sq


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """D[i,j] = ‖x_i − x_j‖² as one matmul (ref: client_obj.py:131-134),
    clamped at 0 against fp cancellation."""
    return _distances(x)[0]


def krum_scores(deltas: torch.Tensor, num_adversaries: int) -> torch.Tensor:
    """score_i = Σ of the (n − f − 2) nearest-neighbour distances
    (ref: client_obj.py:127-143): D plus +inf on the diagonal, each row
    ranked ascending with generated NaNs first and propagated ones last,
    the first k summed; a NaN among them makes the score the NaN of its
    class (module docstring). This is also the plain version of the
    Hopper kernel (ops/krum_cuda.py)."""
    n = deltas.shape[0]
    k = max(n - num_adversaries - 2, 0)
    if k == 0:
        return torch.zeros(n, dtype=torch.float32, device=deltas.device)
    d, sq = _distances(deltas)
    d.diagonal().add_(math.inf)  # the reference's sorted[0] self-distance drop
    nan_in = torch.isnan(sq)
    generated = torch.isnan(d) & ~(nan_in[:, None] | nan_in[None, :])
    # generated NaNs below every distance (distances are >= 0); propagated
    # NaNs stay NaN, which a sort puts after +inf
    near = torch.sort(torch.where(generated, -1.0, d), dim=-1).values[:, :k]
    score = torch.where(near >= 0, near, 0.0).sum(dim=-1)
    # a generated NaN is among the k nearest whenever the row has one; a
    # propagated one only when it is the k-th
    score = torch.where(torch.isnan(near[:, -1]),
                        _nan_score(_NAN_FARTHEST, d), score)
    return torch.where(generated.any(dim=-1), _nan_score(_NAN_NEAREST, d),
                       score)


def rank_scores(scores: torch.Tensor) -> torch.Tensor:
    """Indices of `scores` in accept order: the NaN 0xffc00000 first, then
    the scores (>= 0 or +inf) ascending, then every other NaN; ties to the
    lower index (lax.top_k's order on the reference's CPU scores). One
    stable sort: that NaN becomes -inf, which no score is, and a sort puts
    NaN last."""
    nearest = torch.isnan(scores) & torch.signbit(scores)
    return torch.sort(torch.where(nearest, -math.inf, scores),
                      stable=True).indices


def same_nonfinite(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Whether two score vectors hold the same NaN, bit for bit, and the
    same ±inf at the same places: what ranks their non-finite scores."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    return bool(torch.equal(nan, torch.isnan(got))
                and torch.equal(got.view(torch.int32)[nan],
                                want.view(torch.int32)[nan])
                and torch.equal(want.isinf(), got.isinf())
                and torch.equal(want[want.isinf()], got[got.isinf()]))


def accept_mask(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """Dense bool mask of the first `keep` updates in accept order."""
    mask = torch.zeros(scores.shape[0], dtype=torch.bool, device=scores.device)
    mask[rank_scores(scores)[:keep]] = True
    return mask


def krum_accept_mask(deltas: torch.Tensor, num_adversaries: int) -> torch.Tensor:
    """Dense bool mask of the n − f accepted updates (lowest Krum scores;
    ref: client_obj.py:119-124). Committees inside the kernel window score
    through the Hopper kernel (ops/krum_cuda.krum_scores_auto)."""
    from biscotti_tpu_torch.ops.krum_cuda import krum_scores_auto

    n = deltas.shape[0]
    return accept_mask(krum_scores_auto(deltas, num_adversaries),
                       n - num_adversaries)


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
