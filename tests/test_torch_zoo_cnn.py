"""The port's CNN families against the JAX model zoo, on the same weights
and seeded numpy batches.

Tolerances: logits and loss rtol 1e-4, atol 1e-5; per-contributor deltas
rtol 1e-4, atol 1e-5 (convolutions and their gradients sum in another order
in each framework). Layouts and parameter counts are exact. The init laws
are checked within 6 standard errors of the sample statistics.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biscotti_tpu.models import trainer as jtrainer
from biscotti_tpu.models import zoo as jzoo
from biscotti_tpu_torch.models import trainer as ptrainer
from biscotti_tpu_torch.models import zoo as pzoo
from biscotti_tpu_torch.models.base import unravel
from biscotti_tpu_torch.weights import params_from_jax

RTOL, ATOL = 1e-4, 1e-5
CPU = "cpu"

FAMILIES = [("mnist_cnn", "mnist", 164_266), ("cifar_cnn", "cifar", 62_006),
            ("lfw_cnn", "lfw", 133_000)]


def _models(family, dataset):
    return jzoo.MODELS[family](dataset), pzoo.MODELS[family](dataset)


def _weights(jm, seed):
    params = jm.init(jax.random.PRNGKey(seed))
    return params, params_from_jax(params, device=CPU)


def _batch(jm, b, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, jm.d_in)).astype(np.float32)
    y = rng.integers(0, jm.n_classes, size=b).astype(np.int32)
    return x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _shapes(tree, out):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            _shapes(tree[key], out)
        else:
            out.append(tuple(tree[key].shape))
    return out


@pytest.mark.parametrize("family,dataset,n", FAMILIES)
def test_num_params_and_leaf_layout(family, dataset, n):
    jm, pm = _models(family, dataset)
    assert pm.num_params == jm.num_params == n
    assert pm.name == family and (pm.d_in, pm.n_classes) == (jm.d_in, jm.n_classes)
    params = jm.init(jax.random.PRNGKey(0))
    assert [leaf.shape for leaf in pm.leaves] == _shapes(params, [])
    assert sum(leaf.size for leaf in pm.leaves) == n


@pytest.mark.parametrize("family,dataset,n", FAMILIES)
def test_params_from_jax_equals_ravel_pytree(family, dataset, n):
    jm, pm = _models(family, dataset)
    params, w = _weights(jm, 1)
    assert np.array_equal(w.numpy(), np.asarray(jm.flatten(params)))
    # each named leaf of the port's view is the reference's leaf
    view = unravel(pm.leaves, w)
    for name, got in view.items():
        ref = params
        for part in name.split("."):
            ref = ref[part]
        assert np.array_equal(got.numpy(), np.asarray(ref)), name


@pytest.mark.parametrize("family,dataset,n", FAMILIES)
def test_logits_and_loss_match(family, dataset, n):
    jm, pm = _models(family, dataset)
    params, w = _weights(jm, 2)
    x, y = _batch(jm, 5, 3)
    jw = jnp.asarray(w.numpy())
    ref = np.asarray(jm.apply_flat(jw, jnp.asarray(x)))
    got = pm.apply_flat(w, _t(x)).numpy()
    assert got.shape == (5, jm.n_classes)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    ref_loss = float(jm.loss_flat(jw, jnp.asarray(x), jnp.asarray(y)))
    got_loss = float(pm.loss_flat(w, _t(x), _t(y)))
    np.testing.assert_allclose(got_loss, ref_loss, rtol=RTOL, atol=ATOL)
    ref_err = float(jm.error_flat(jw, jnp.asarray(x), jnp.asarray(y)))
    assert round(float(pm.error_flat(w, _t(x), _t(y))) * 5) == round(ref_err * 5)


@pytest.mark.parametrize("family,dataset,n", FAMILIES)
@pytest.mark.parametrize("clip", [100.0, 0.5])
def test_per_contributor_delta(family, dataset, n, clip):
    # S = 2 contributors, B = 4 rows each: each gets the clipped gradient
    # of its own minibatch loss
    jm, pm = _models(family, dataset)
    _, w = _weights(jm, 4)
    xs, ys = zip(*(_batch(jm, 4, 10 + i) for i in range(2)))
    xs, ys = np.stack(xs), np.stack(ys)
    jstep = jtrainer.local_step_fn(jm, "grad", clip=clip)
    ref = np.asarray(jax.vmap(jstep, in_axes=(None, 0, 0))(
        jnp.asarray(w.numpy()), jnp.asarray(xs), jnp.asarray(ys)))
    pstep = ptrainer.local_step_fn(pm, "grad", clip=clip)
    got = torch.func.vmap(pstep, in_dims=(None, 0, 0))(w, _t(xs), _t(ys)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if clip < 1.0:  # the clip bites
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), clip, rtol=1e-5)


@pytest.mark.parametrize("family,dataset,n", FAMILIES)
def test_flat_init_laws(family, dataset, n):
    _, pm = _models(family, dataset)
    w = pm.flat_init(torch.Generator().manual_seed(7))
    assert w.shape == (n,) and w.dtype == torch.float32
    for leaf in pm.leaves:
        v = unravel(pm.leaves, w)[leaf.name].double().reshape(-1)
        if leaf.law == "zeros":
            assert not v.any(), leaf.name
            continue
        if leaf.law == "uniform":  # U(±1/√d_in)
            s = 1.0 / math.sqrt(leaf.shape[0])
            assert float(v.abs().max()) <= s
            want_std = s / math.sqrt(3.0)
        else:  # N(0, 1)/√fan_in, fan_in = H·W·I
            want_std = 1.0 / math.sqrt(math.prod(leaf.shape[:-1]))
        m = v.numel()
        assert abs(float(v.mean())) < 6 * want_std / math.sqrt(m), leaf.name
        # std of a sample std: σ/√(2m) (normal); the uniform's is smaller
        assert abs(float(v.std()) / want_std - 1.0) < 6 / math.sqrt(2 * m), leaf.name
    # drawn on the generator: the same seed gives the same weights
    assert torch.equal(w, pm.flat_init(torch.Generator().manual_seed(7)))


def test_model_for_dataset_picks_every_family():
    assert pzoo.model_for_dataset("creditcard").name == "logreg"
    assert pzoo.model_for_dataset("mnist").name == "softmax"
    for family, dataset, n in FAMILIES:
        m = pzoo.model_for_dataset(dataset, family)
        assert m.name == family and m.num_params == n
