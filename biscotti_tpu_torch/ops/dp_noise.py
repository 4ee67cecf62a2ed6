"""Differential-privacy noise, Gaussian mechanism (counterpart of
`biscotti_tpu/ops/dp_noise.py`).

    σ = √(2·ln(1.25/δ)) / ε
    samples = Σ_batch σ·N(0,1)      (one draw with std σ·√batch)
    noise(i) = (−α/batch)·samples[i mod iters]

Draws come from an explicit `torch.Generator`. The Song&Sarwate'13 `mcmc13`
mechanism is not ported yet (ROADMAP.md Queue A, item A4).
"""

from __future__ import annotations

import math

import torch


def sigma_for(epsilon: float, delta: float = 1e-5) -> float:
    if epsilon <= 0:
        return 0.0
    return math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def presample(gen: torch.Generator, epsilon: float, delta: float,
              batch_size: int, expected_iters: int, d: int) -> torch.Tensor:
    """samples[iters, d] ~ Σ_batch σ·N(0,1) (ref: client_obj.py:63-66); one
    all-zero row when σ = 0, as the reference keeps it."""
    s = sigma_for(epsilon, delta)
    if s == 0.0:
        return torch.zeros(1, d, device=gen.device)
    return s * math.sqrt(batch_size) * torch.randn(
        expected_iters, d, generator=gen, device=gen.device)


def noise_at(samples: torch.Tensor, iteration: int, batch_size: int,
             alpha: float = 1.0) -> torch.Tensor:
    """noise(i) = (−α/batch)·samples[i mod iters] (ref: client_obj.py:97-98)."""
    return (-alpha / batch_size) * samples[iteration % samples.shape[0]]


def round_noise(gen: torch.Generator, num: int, d: int, sigma: float,
                batch_size: int, alpha: float = 1.0) -> torch.Tensor:
    """The simulator's fresh per-round draw for `num` contributors
    (biscotti_tpu/parallel/sim.py:195-199): (−α/b)·σ·√b·N(0,1)[num, d]."""
    draw = sigma * math.sqrt(batch_size) * torch.randn(
        num, d, generator=gen, device=gen.device)
    return (-alpha / batch_size) * draw
