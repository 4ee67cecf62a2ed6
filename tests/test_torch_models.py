"""Port models, step rules, DP noise and weight layout against the JAX
reference, on the same numpy-made weights and batches.

Tolerance: rtol 1e-5, atol 1e-6 for float32 results, because the two
frameworks sum in different orders; integer and layout results are exact.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biscotti_tpu.models import trainer as jtrainer
from biscotti_tpu.models import zoo as jzoo
from biscotti_tpu.ops import dp_noise as jdp
from biscotti_tpu_torch.models import trainer as ptrainer
from biscotti_tpu_torch.models import zoo as pzoo
from biscotti_tpu_torch.ops import dp_noise as pdp
from biscotti_tpu_torch.weights import params_from_jax, params_to_jax

RTOL, ATOL = 1e-5, 1e-6
CPU = "cpu"

# (family, dataset, step mode)
FAMILIES = [("softmax", "mnist", "grad"), ("logreg", "creditcard", "sgd"),
            ("svm", "mnist", "grad")]


def _batch(dataset, family, b, seed):
    rng = np.random.default_rng(seed)
    d_in = {"mnist": 784, "creditcard": 24}[dataset]
    x = rng.normal(size=(b, d_in)).astype(np.float32)
    k = 2 if family == "logreg" else 10
    y = rng.integers(0, k, size=b).astype(np.int32)
    return x, y


def _models(family, dataset):
    return jzoo.MODELS[family](dataset), pzoo.MODELS[family](dataset)


def _flat_w(n, seed, scale=0.05):
    return np.random.default_rng(seed).normal(0.0, scale, n).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("family,dataset,mode", FAMILIES)
def test_num_params_and_forward(family, dataset, mode):
    jm, pm = _models(family, dataset)
    assert pm.num_params == jm.num_params
    w = _flat_w(jm.num_params, 1)
    x, y = _batch(dataset, family, 12, 2)
    ref_logits = np.asarray(jm.apply_flat(jnp.asarray(w), jnp.asarray(x)))
    got_logits = pm.apply_flat(_t(w), _t(x)).numpy()
    np.testing.assert_allclose(got_logits, ref_logits, rtol=RTOL, atol=ATOL)
    ref_loss = float(jm.loss_flat(jnp.asarray(w), jnp.asarray(x), jnp.asarray(y)))
    got_loss = float(pm.loss_flat(_t(w), _t(x), _t(y)))
    np.testing.assert_allclose(got_loss, ref_loss, rtol=RTOL, atol=ATOL)
    # the same misclassified count (the f32 means may round differently)
    ref_err = float(jm.error_flat(jnp.asarray(w), jnp.asarray(x), jnp.asarray(y)))
    got_err = float(pm.error_flat(_t(w), _t(x), _t(y)))
    assert round(got_err * len(y)) == round(ref_err * len(y))


@pytest.mark.parametrize("family,dataset,mode", FAMILIES)
@pytest.mark.parametrize("clip", [100.0, 0.5])
def test_per_contributor_delta(family, dataset, mode, clip):
    # four contributors, each with its own minibatch: the port's vmapped
    # step must give each its own clipped gradient, not the summed one
    jm, pm = _models(family, dataset)
    w = _flat_w(jm.num_params, 3)
    xs, ys = zip(*(_batch(dataset, family, 10, 10 + i) for i in range(4)))
    xs, ys = np.stack(xs), np.stack(ys)
    jstep = jtrainer.local_step_fn(jm, mode, clip=clip, alpha=1e-2)
    ref = np.asarray(jax.vmap(jstep, in_axes=(None, 0, 0))(
        jnp.asarray(w), jnp.asarray(xs), jnp.asarray(ys)))
    pstep = ptrainer.local_step_fn(pm, mode, clip=clip, alpha=1e-2)
    got = torch.func.vmap(pstep, in_dims=(None, 0, 0))(_t(w), _t(xs), _t(ys)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if mode == "grad" and clip < 1.0:  # the clip bound bites
        assert np.allclose(np.linalg.norm(got, axis=1), clip, rtol=1e-5)


def test_clip_by_global_norm_matches():
    for v in (np.zeros(5, np.float32), np.full(5, 3.0, np.float32),
              np.arange(7, dtype=np.float32) * 40.0):
        ref = np.asarray(jtrainer.clip_by_global_norm(jnp.asarray(v), 100.0))
        got = ptrainer.clip_by_global_norm(_t(v), 100.0).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_sample_batch_rows_without_replacement():
    gen = torch.Generator().manual_seed(4)
    idx = ptrainer.sample_batch(gen, 480, 10, 300)
    assert idx.shape == (300, 10)
    assert all(len(set(r.tolist())) == 10 for r in idx)
    assert int(idx.min()) >= 0 and int(idx.max()) < 480
    assert ptrainer.sample_batch(gen, 6, 10, 2).shape == (2, 6)


def test_flat_layout_matches_ravel_pytree():
    # ravel_pytree orders dict leaves by sorted key: softmax is b[10] then
    # w[784, 10] row-major
    jm = jzoo.MODELS["softmax"]("mnist")
    key = jax.random.PRNGKey(1)
    flat = np.asarray(jm.flat_init(key))
    got = params_from_jax(jm.init(key), device=CPU)
    assert np.array_equal(got.numpy(), flat)
    params = jm.init(key)
    assert np.array_equal(got[:10].numpy(), np.asarray(params["b"]))
    assert np.array_equal(got[10:].reshape(784, 10).numpy(), np.asarray(params["w"]))
    assert np.array_equal(params_to_jax(got), flat)
    assert np.array_equal(params_from_jax(flat, device=CPU).numpy(), flat)


def test_dp_noise_matches():
    for eps in (0.0, 0.5, 1.0, 2.0):
        assert pdp.sigma_for(eps, 1e-5) == jdp.sigma_for(eps, 1e-5)
    samples = np.random.default_rng(5).normal(size=(7, 30)).astype(np.float32)
    for it in (0, 6, 13):
        ref = np.asarray(jdp.noise_at(jnp.asarray(samples), it, 10, 0.01))
        got = pdp.noise_at(_t(samples), it, 10, 0.01).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    gen = torch.Generator().manual_seed(0)
    assert pdp.presample(gen, 0.0, 1e-5, 10, 100, 30).shape == (1, 30)
    assert not pdp.presample(gen, 0.0, 1e-5, 10, 100, 30).any()
    # distribution of the per-round draw: std (α/b)·σ·√b, mean 0
    sigma = pdp.sigma_for(1.0, 1e-5)
    draw = pdp.round_noise(gen, 200, 500, sigma, 10, alpha=1.0)
    want = sigma * math.sqrt(10) / 10
    assert abs(float(draw.std()) / want - 1.0) < 0.02
    assert abs(float(draw.mean())) < 0.02 * want
