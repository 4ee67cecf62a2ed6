"""LSH-sieve aggregator, sybil and duplicate attenuation (counterpart of
`biscotti_tpu/ops/lsh_sieve.py`; ref: ML/code/logistic_aggregator.py:7-27).

Random-hyperplane LSH: B hyperplanes give every centred update a B-bit
sign code (one [n, d]·[d, B] matmul); near neighbours are the pairs whose
codes differ in at most `radius` bits, counted from the ±1 code Gram
matrix. Each update's contribution is divided by its neighbour count, so a
cluster of near-identical sybils sums to about one update's worth.

`lsh_sieve_weights_from_planes` and `lsh_sieve_aggregate_from_planes` are
pure in the [d, B] hyperplanes, so the tests feed them the reference's own
`jax.random.normal(key, (d, B))`; `lsh_sieve_weights` and
`lsh_sieve_aggregate` draw the planes from a `torch.Generator`.
"""

from __future__ import annotations

import torch


def draw_planes(gen: torch.Generator, d: int, num_planes: int = 64) -> torch.Tensor:
    """planes[d, B] ~ N(0, 1), float32, on gen's device."""
    return torch.randn(d, num_planes, generator=gen, device=gen.device)


def lsh_sieve_weights_from_planes(deltas: torch.Tensor, planes: torch.Tensor,
                                  radius: int = 2) -> torch.Tensor:
    """Per-update attenuation weights 1/|near neighbours| (self included,
    so each weight lies in (0, 1])."""
    num_planes = planes.shape[1]
    centred = deltas - deltas.mean(dim=0, keepdim=True)
    proj = centred @ planes.to(deltas.dtype)
    codes = torch.where(proj >= 0, 1.0, -1.0).to(deltas.dtype)  # [n, B]
    # hamming(i, j) = (B − codes_i·codes_j) / 2
    hamming = (num_planes - codes @ codes.T) / 2.0
    neighbors = (hamming <= radius).sum(dim=1)  # >= 1 (self)
    return 1.0 / neighbors.to(deltas.dtype)


def lsh_sieve_aggregate_from_planes(deltas: torch.Tensor, planes: torch.Tensor,
                                    radius: int = 2) -> torch.Tensor:
    """Σᵢ wᵢ·deltaᵢ with the LSH attenuation weights."""
    w = lsh_sieve_weights_from_planes(deltas, planes, radius)
    return (deltas * w[:, None]).sum(dim=0)


def lsh_sieve_weights(deltas: torch.Tensor, gen: torch.Generator,
                      num_planes: int = 64, radius: int = 2) -> torch.Tensor:
    return lsh_sieve_weights_from_planes(
        deltas, draw_planes(gen, deltas.shape[1], num_planes), radius)


def lsh_sieve_aggregate(deltas: torch.Tensor, gen: torch.Generator,
                        num_planes: int = 64, radius: int = 2) -> torch.Tensor:
    return lsh_sieve_aggregate_from_planes(
        deltas, draw_planes(gen, deltas.shape[1], num_planes), radius)
