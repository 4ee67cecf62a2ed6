"""The port's Song&Sarwate'13 noise (`knorm_draw`, `mcmc_presample`)
against `biscotti_tpu/ops/dp_noise.py`.

The pure forms take the reference's own `jax.random` draws, rebuilt as
dp_noise.py:99-146 splits its keys: knorm's direction normals and Gamma
radii, and the chain's x0 and each step's proposal normals and log-uniforms.
Tolerances: knorm rtol 1e-5, atol 1e-6; the chain rtol 1e-4, atol 1e-4 on
the kept rows (float32 norms in another order, accumulated over the steps)
with the same accept count. The generator forms are held to the law: the
radius Gamma(d, 2/ε) in mean and variance, and the acceptance rate, each
within 5 standard errors.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biscotti_tpu.ops import dp_noise as jdp
from biscotti_tpu_torch.ops import dp_noise as pdp


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("eps", [0.5, 1.0, 4.0])
@pytest.mark.parametrize("n,d", [(1, 3), (5, 64), (3, 7850)])
def test_knorm_pure_form_on_reference_draws(eps, n, d):
    key = jax.random.PRNGKey(n * 100 + d)
    kd, kr = jax.random.split(key)  # dp_noise.py:141-145
    normals = jax.random.normal(kd, (n, d), jnp.float32)
    gammas = jax.random.gamma(kr, jnp.float32(d), (n,))
    ref = np.asarray(jdp.knorm_draw(key, eps, n, d))
    got = pdp.knorm_from_draws(eps, _t(normals), _t(gammas)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _reference_chain_draws(key, eps, iters, d, burn=64, thin=5):
    """x0 and every step's (normals, log-uniforms), split as
    dp_noise.py:99-124 splits them."""
    w = max(250, min(1024, iters))
    keeps = -(-iters // w)
    k_init, k_burn, k_keep = jax.random.split(key, 3)
    x0 = jdp.knorm_draw(k_init, eps, w, d)
    steps = []
    for k in list(jax.random.split(k_burn, burn)) \
            + list(jax.random.split(k_keep, keeps * thin)):
        k1, k2 = jax.random.split(k)
        steps.append((_t(jax.random.normal(k1, (w, d), jnp.float32)),
                      _t(jnp.log(jax.random.uniform(k2, (w,))))))
    return w, keeps, _t(x0), steps


@pytest.mark.parametrize("eps,iters,d,seed", [(1.0, 100, 64, 0),
                                              (0.5, 40, 16, 1),
                                              (2.0, 300, 8, 2),
                                              (1.0, 1100, 4, 3)])
def test_chain_pure_form_on_reference_draws(eps, iters, d, seed):
    key = jax.random.PRNGKey(seed)
    w, keeps, x0, steps = _reference_chain_draws(key, eps, iters, d)
    assert w == pdp.mcmc_walkers(iters)
    ref, ref_rate = jdp.mcmc_presample(key, eps, iters, d)
    kept, accepted = pdp.mcmc_chain(eps, x0, steps, 64, 5, keeps)
    assert kept.shape == (keeps * w, d)
    np.testing.assert_allclose(kept[:iters].numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    total = w * (64 + keeps * 5)
    assert int(accepted) == round(float(ref_rate) * total)


def test_gamma_draw_law():
    gen = torch.Generator().manual_seed(0)
    for shape, n in ((1.0, 200_000), (64.0, 200_000), (7850.0, 50_000)):
        g = pdp.gamma_draw(gen, shape, n)
        assert g.dtype == torch.float64 and g.shape == (n,)
        # mean shape (std √(shape/n)); variance shape (std ≈ shape·√(2/n))
        assert abs(float(g.mean()) - shape) < 5 * math.sqrt(shape / n)
        assert abs(float(g.var()) / shape - 1.0) < 5 * math.sqrt(2.0 / n) \
            * math.sqrt(1.0 + 3.0 / shape)
    with pytest.raises(ValueError):
        pdp.gamma_draw(gen, 0.5, 10)


@pytest.mark.parametrize("eps,d", [(1.0, 64), (0.5, 400), (2.0, 7850)])
def test_knorm_generator_form_radius_law(eps, d):
    n = 20_000 if d < 1000 else 4_000
    gen = torch.Generator().manual_seed(d)
    x = pdp.knorm_draw(gen, eps, n, d)
    assert x.shape == (n, d) and x.dtype == torch.float32
    r = torch.linalg.vector_norm(x.double(), dim=1)
    # r ~ Gamma(d, 2/ε): mean 2d/ε, variance d·(2/ε)²
    mean, var = 2.0 * d / eps, d * (2.0 / eps) ** 2
    assert abs(float(r.mean()) - mean) < 5 * math.sqrt(var / n)
    assert abs(float(r.var()) / var - 1.0) < 5 * math.sqrt(2.0 / n)
    # the direction is uniform: the mean vector sits near 0
    assert float((x.double() / r[:, None]).mean(0).abs().max()) < 5 / math.sqrt(n)
    assert not pdp.knorm_draw(gen, 0.0, 3, d).any()


def test_presample_acceptance_in_the_reference_range():
    # the reference's rate at d = 64 from its own 1,024-walker chain, the
    # port's from its generator form: both estimate one acceptance
    # probability p, each over W·steps proposals
    eps, d, iters = 1.0, 64, 1024
    _, ref_rate = jdp.mcmc_presample(jax.random.PRNGKey(5), eps, iters, d)
    samples, rate = pdp.mcmc_presample(torch.Generator().manual_seed(5), eps,
                                       iters, d)
    assert samples.shape == (iters, d)
    p, trials = float(ref_rate), 1024 * (64 + 5)
    assert 0.15 < p < 0.35
    assert abs(rate - p) < 5 * math.sqrt(2 * p * (1 - p) / trials)
    # every kept row is target-distributed: the radius law holds
    r = torch.linalg.vector_norm(samples.double(), dim=1)
    assert abs(float(r.mean()) - 2 * d / eps) < 5 * (2 / eps) * math.sqrt(d / iters)


def test_presample_edges():
    gen = torch.Generator().manual_seed(0)
    s, rate = pdp.mcmc_presample(gen, 0.0, 10, 5)
    assert s.shape == (10, 5) and not s.any() and rate == 0.0
    assert pdp.mcmc_walkers(100) == 250 and pdp.mcmc_walkers(5000) == 1024
    assert pdp.mcmc_walkers(600) == 600 and pdp.mcmc_walkers(100, 7) == 7
    s, rate = pdp.mcmc_presample(gen, 1.0, 30, 6, n_walkers=8)
    assert s.shape == (30, 6) and 0.0 < rate < 1.0
