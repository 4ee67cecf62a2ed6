"""The port's RONI and LSH-sieve against `biscotti_tpu/ops/roni.py` and
`biscotti_tpu/ops/lsh_sieve.py`.

Tolerances: RONI scores within 1/|val| (the same misclassified count can
round differently in float32, ROADMAP "Known semantic traps"); RONI masks
exact wherever the reference's score lies more than 1/|val| from the
threshold. LSH weights on the reference's own hyperplanes
(`jax.random.normal(key, (d, B))`) exactly equal; the aggregate within
rtol 1e-5, atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biscotti_tpu.data import datasets as jds
from biscotti_tpu.models import zoo as jzoo
from biscotti_tpu.ops import lsh_sieve as jlsh
from biscotti_tpu.ops import roni as jroni
from biscotti_tpu_torch.models import zoo as pzoo
from biscotti_tpu_torch.ops import lsh_sieve as plsh
from biscotti_tpu_torch.ops import roni as proni
from biscotti_tpu_torch.weights import params_from_jax

CPU = "cpu"
N_VAL = 200

# (family, dataset, number of updates, update scale)
RONI_CASES = [("softmax", "mnist", 12, 0.05), ("svm", "mnist", 9, 0.1),
              ("mnist_cnn", "mnist", 5, 0.02), ("cifar_cnn", "cifar", 6, 0.3),
              ("lfw_cnn", "lfw", 4, 0.05)]


def _roni_inputs(family, dataset, n, scale):
    jm = jzoo.MODELS[family](dataset)
    pm = pzoo.MODELS[family](dataset)
    w = np.asarray(jm.flat_init(jax.random.PRNGKey(3)))
    test = jds.load_shard(dataset, f"{dataset}_test")
    x, y = test["x_test"][:N_VAL], test["y_test"][:N_VAL]
    deltas = np.random.default_rng(n).normal(
        0.0, scale, (n, jm.num_params)).astype(np.float32)
    deltas[0] = 0.0  # a no-op update scores exactly 0
    j = (jnp.asarray(w), jnp.asarray(deltas), jnp.asarray(x), jnp.asarray(y))
    p = (params_from_jax(w, device=CPU), torch.from_numpy(deltas),
         torch.from_numpy(x), torch.from_numpy(y))
    return jm, pm, j, p


@pytest.mark.parametrize("family,dataset,n,scale", RONI_CASES)
def test_roni_scores_and_mask_match(family, dataset, n, scale):
    jm, pm, (jw, jd, jx, jy), (w, d, x, y) = _roni_inputs(family, dataset, n, scale)
    ref = np.asarray(jroni.roni_scores(jm, jw, jd, jx, jy))
    got = proni.roni_scores(pm, w, d, x, y).numpy()
    assert got.shape == (n,) and got[0] == 0.0
    assert np.abs(got - ref).max() <= 1.0 / N_VAL + 1e-7
    for thr in (proni.RONI_THRESHOLD, 0.0, -0.01):
        rmask = np.asarray(jroni.roni_accept_mask(jm, jw, jd, jx, jy, thr))
        gmask = proni.roni_accept_mask(pm, w, d, x, y, thr).numpy()
        clear = np.abs(ref - thr) > 1.0 / N_VAL
        assert np.array_equal(gmask[clear], rmask[clear])
        kernel = proni.make_roni_kernel(pm, thr)
        assert torch.equal(kernel(w, d, x, y), proni.roni_accept_mask(
            pm, w, d, x, y, thr))


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_chunked_roni_equals_unchunked(chunk):
    _, pm, _, (w, d, x, y) = _roni_inputs("cifar_cnn", "cifar", 6, 0.3)
    whole = proni.roni_scores(pm, w, d, x, y, chunk=6)
    assert torch.equal(proni.roni_scores(pm, w, d, x, y, chunk=chunk), whole)


def test_roni_chunk_is_sized_from_the_budget():
    pm = pzoo.MODELS["mnist_cnn"]("mnist")
    # one mnist_cnn update on 2,000 rows holds its im2col columns, 25·32·32
    # floats a row, thrice
    per = 4 * 2000 * 25 * 32 * 32 * 3
    assert proni.roni_chunk(pm, 2000, 716, torch.device("cpu")) == \
        max(1, (1 << 30) // per)
    soft = pzoo.MODELS["softmax"]("mnist")
    assert proni.roni_chunk(soft, 2000, 716, torch.device("cpu")) == 716


def test_roni_rejects_a_harmful_update():
    _, pm, _, (_, d, x, y) = _roni_inputs("softmax", "mnist", 12, 0.05)
    # a nearest-class-mean classifier (softmax layout: b[10], then w[784, 10])
    mu = torch.stack([x[y == c].mean(0) for c in range(10)], dim=1)
    w = torch.cat([-0.5 * (mu * mu).sum(0), mu.reshape(-1)])
    bad = torch.zeros(2, w.numel())
    bad[1] = -w  # the zero model: every row goes to class 0
    scores = proni.roni_scores(pm, w, bad, x, y)
    assert float(scores[0]) == 0.0 and float(scores[1]) > 0.5
    assert proni.roni_accept_mask(pm, w, bad, x, y).tolist() == [True, False]


# ----------------------------------------------------------------- LSH sieve


def _lsh_inputs(n, d, seed, sybils):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (n, d)).astype(np.float32)
    if sybils:
        x[-sybils:] = x[-1] + rng.normal(0.0, 1e-3, (sybils, d)).astype(np.float32)
    return x


@pytest.mark.parametrize("n,d,seed,sybils", [(10, 32, 0, 0), (20, 64, 1, 5),
                                             (40, 200, 2, 10), (7, 500, 3, 3)])
@pytest.mark.parametrize("num_planes,radius", [(64, 2), (16, 0), (32, 5)])
def test_lsh_on_reference_planes_matches(n, d, seed, sybils, num_planes, radius):
    x = _lsh_inputs(n, d, seed, sybils)
    key = jax.random.PRNGKey(seed + 11)
    planes = torch.from_numpy(np.array(
        jax.random.normal(key, (d, num_planes), jnp.float32)))
    ref_w = np.asarray(jlsh.lsh_sieve_weights(jnp.asarray(x), key, num_planes,
                                              radius))
    got_w = plsh.lsh_sieve_weights_from_planes(torch.from_numpy(x), planes,
                                               radius).numpy()
    assert np.array_equal(got_w, ref_w)
    ref_a = np.asarray(jlsh.lsh_sieve_aggregate(jnp.asarray(x), key, num_planes,
                                                radius))
    got_a = plsh.lsh_sieve_aggregate_from_planes(torch.from_numpy(x), planes,
                                                 radius).numpy()
    np.testing.assert_allclose(got_a, ref_a, rtol=1e-5, atol=1e-6)


def test_lsh_generator_form_attenuates_sybils():
    x = torch.from_numpy(_lsh_inputs(30, 128, 4, 10))
    gen = torch.Generator().manual_seed(0)
    planes = plsh.draw_planes(gen, 128, 64)
    assert planes.shape == (128, 64) and planes.dtype == torch.float32
    w = plsh.lsh_sieve_weights(x, torch.Generator().manual_seed(0))
    assert torch.equal(w, plsh.lsh_sieve_weights_from_planes(x, planes))
    assert float(w.min()) > 0.0 and float(w.max()) <= 1.0
    # the 10 near-duplicates share one code: each carries 1/10
    assert torch.allclose(w[-10:], torch.full((10,), 0.1))
    assert torch.equal(w[:20], torch.ones(20))
    agg = plsh.lsh_sieve_aggregate(x, torch.Generator().manual_seed(0))
    assert torch.allclose(agg, (x * w[:, None]).sum(0))
