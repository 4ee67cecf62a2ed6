"""Differential-privacy noise (counterpart of `biscotti_tpu/ops/dp_noise.py`).

Gaussian mechanism (Abadi-16, the reference's default):

    σ = √(2·ln(1.25/δ)) / ε
    samples = Σ_batch σ·N(0,1)      (one draw with std σ·√batch)
    noise(i) = (−α/batch)·samples[i mod iters]

Song&Sarwate'13 mechanism (`mcmc13`): rows from p(x) ∝ exp(−(ε/2)·‖x‖₂),
either exactly (`knorm_draw`: a uniform direction times a radius
r ~ Gamma(d, 2/ε)) or by the reference's Metropolis ensemble started in
equilibrium (`mcmc_presample`).

Draws come from an explicit `torch.Generator`; each random function has a
pure form that takes its draws (`knorm_from_draws`, `mcmc_chain`), so the
tests feed it the reference's own `jax.random` draws. torch's Gamma
sampler takes no generator, so the radius is drawn by Marsaglia–Tsang
(`gamma_draw`) on the generator's normals and uniforms, in float64: at
shape d ~ 10⁵ its acceptance test d'·(1 − v + log v) cancels to a few
units, which float32 cannot resolve.
"""

from __future__ import annotations

import math
from typing import Iterable, Iterator, Tuple

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


# ------------------------------------------------------- Song&Sarwate'13

# a Marsaglia–Tsang candidate is accepted with probability > 0.95 at every
# shape >= 1, so a row with no accepted one among 16 has odds below 1e-20
_GAMMA_CANDIDATES = 16


def gamma_draw(gen: torch.Generator, shape: float, n: int) -> torch.Tensor:
    """n draws of Gamma(shape, 1), shape >= 1, float64 on gen's device, by
    Marsaglia–Tsang (ACM TOMS 26(3), 2000): d' = shape − 1/3,
    c = 1/√(9d'); for x ~ N(0,1), v = (1 + cx)³ is accepted when v > 0 and
    log u < x²/2 + d' − d'v + d'·log v, giving d'v. Every row gets
    `_GAMMA_CANDIDATES` candidates at once and keeps its first accepted
    one, so the generator advances by the same amount whatever the data
    and nothing is read back to the host; a row with none raises (on the
    card, as a device-side assert)."""
    if shape < 1.0:
        raise ValueError(f"gamma_draw takes shape >= 1, got {shape}")
    dev, k = gen.device, _GAMMA_CANDIDATES
    dd = shape - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * dd)
    x = torch.randn(k, n, generator=gen, device=dev, dtype=torch.float64)
    u = torch.rand(k, n, generator=gen, device=dev, dtype=torch.float64)
    v = (1.0 + c * x) ** 3
    pos = v > 0
    logv = torch.log(torch.where(pos, v, torch.ones_like(v)))
    ok = pos & (torch.log(u) < 0.5 * x * x + dd - dd * v + dd * logv)
    first = torch.argmax(ok.to(torch.int8), dim=0)  # the first True
    torch._assert_async(ok.any(dim=0).all(),
                        "gamma_draw: a row accepted no candidate")
    return dd * v.gather(0, first[None])[0]


def knorm_from_draws(epsilon: float, normals: torch.Tensor,
                     gammas: torch.Tensor) -> torch.Tensor:
    """Pure form of `knorm_draw`: rows normals[n, d] / ‖·‖ (the direction)
    times gammas[n]·(2/ε), gammas ~ Gamma(d, 1) (ref: dp_noise.py:139-146)."""
    dirn = normals / torch.clamp(
        torch.linalg.vector_norm(normals, dim=1, keepdim=True), min=1e-30)
    r = gammas.to(torch.float32) * (2.0 / epsilon)
    return dirn * r[:, None]


def knorm_draw(gen: torch.Generator, epsilon: float, n: int, d: int) -> torch.Tensor:
    """Exact draw of n vectors from p(x) ∝ exp(−(ε/2)·‖x‖₂): spherically
    symmetric with radius r ~ Gamma(d, 2/ε), so a uniform direction times
    r samples it exactly (ref: dp_noise.py:130-146); zeros at ε <= 0."""
    if epsilon <= 0:
        return torch.zeros(n, d, device=gen.device)
    normals = torch.randn(n, d, generator=gen, device=gen.device)
    return knorm_from_draws(epsilon, normals, gamma_draw(gen, float(d), n))


def mcmc_walkers(expected_iters: int, n_walkers: int = 0) -> int:
    """W = max(250, min(1024, iters)) unless given (ref: dp_noise.py:95):
    enough walkers that every kept row up to 1,024 comes from its own
    never-interacting walker."""
    return int(n_walkers) if n_walkers else max(250, min(1024, expected_iters))


def mcmc_chain(epsilon: float, x0: torch.Tensor,
               steps: Iterable[Tuple[torch.Tensor, torch.Tensor]],
               burn: int, thin: int, keeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pure form of the reference's Metropolis ensemble (dp_noise.py:97-127):
    W walkers from x0[W, d], one step per (normals[W, d], log_u[W]) of
    `steps`: propose x + (4.76/ε)·normals, take it where
    log_u < lp(prop) − lp(x), lp = −(ε/2)‖x‖. After `burn` steps, the
    walkers are kept after every `thin` steps, `keeps` times. Returns
    (kept[keeps·W, d] in the reference's order, accepted moves as an int
    tensor)."""
    step = 2.38 * 2.0 / epsilon
    x = x0
    lp = -(epsilon / 2.0) * torch.linalg.vector_norm(x, dim=1)
    accepted = torch.zeros((), dtype=torch.int64, device=x0.device)
    kept = []
    it: Iterator = iter(steps)
    for i in range(burn + keeps * thin):
        normals, log_u = next(it)
        prop = x + step * normals
        lp_p = -(epsilon / 2.0) * torch.linalg.vector_norm(prop, dim=1)
        take = log_u < (lp_p - lp)
        x = torch.where(take[:, None], prop, x)
        lp = torch.where(take, lp_p, lp)
        accepted = accepted + take.sum()
        if i >= burn and (i - burn + 1) % thin == 0:
            kept.append(x)
    return torch.cat(kept), accepted


def mcmc_presample(gen: torch.Generator, epsilon: float, expected_iters: int,
                   d: int, n_walkers: int = 0, burn: int = 64,
                   thin: int = 5) -> Tuple[torch.Tensor, float]:
    """samples[expected_iters, d] from the Song&Sarwate'13 density by the
    reference's equilibrium-started Metropolis ensemble (ref:
    dp_noise.py:54-127): W = `mcmc_walkers` chains start from exact
    `knorm_draw` rows, so every emitted row is target-distributed at any d;
    step 4.76/ε (Roberts–Rosenthal's 2.38/√d against the target's
    per-coordinate scale 2√d/ε), a burn of 64, a thin of 5. Each step's
    proposal normals and log-uniforms are drawn from `gen` as it runs.
    Returns (samples, acceptance rate)."""
    if epsilon <= 0 or expected_iters <= 0 or d <= 0:
        return (torch.zeros(max(expected_iters, 0), max(d, 0), device=gen.device),
                0.0)
    w = mcmc_walkers(expected_iters, n_walkers)
    keeps = -(-expected_iters // w)

    def draws():
        while True:
            normals = torch.randn(w, d, generator=gen, device=gen.device)
            u = torch.rand(w, generator=gen, device=gen.device)
            yield normals, torch.log(u)

    x0 = knorm_draw(gen, epsilon, w, d)
    kept, accepted = mcmc_chain(epsilon, x0, draws(), burn, thin, keeps)
    rate = int(accepted) / (w * (burn + keeps * thin))
    return kept[:expected_iters], rate
