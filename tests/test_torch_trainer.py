"""The port's per-peer `Trainer` against `biscotti_tpu/models/trainer.py`.

The reference draws its minibatch rows as `sample_batch(fold_in(batch_key,
it))` and its noise bank from its noise key; the port draws its own from
`torch.Generator`s, so the test feeds the reference `Trainer`'s own batch
indices to `private_fun_from_batch` and its own noise bank to `get_noise`.
Tolerances: deltas and noise rtol 1e-5, atol 1e-6 for the linear families,
rtol 1e-4, atol 1e-5 for mnist_cnn (convolution gradients sum in another
order); error metrics within one sample (1/size), RONI within two.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biscotti_tpu.config import BiscottiConfig as JConfig
from biscotti_tpu.models import trainer as jtrainer
from biscotti_tpu_torch.config import BiscottiConfig
from biscotti_tpu_torch.models import trainer as ptrainer
from biscotti_tpu_torch.telemetry import MetricsRegistry

CPU = "cpu"

# (dataset, shard, model_name, tolerance)
CASES = {"mnist_softmax": ("mnist", "mnist3", "", 1e-5),
         "creditcard_logreg": ("creditcard", "creditcard2", "", 1e-5),
         "mnist_svm": ("mnist", "mnist_bad5", "svm", 1e-5),
         "mnist_cnn": ("mnist", "mnist1", "mnist_cnn", 1e-4)}


def _pair(case, **kw):
    dataset, shard, model_name, _ = CASES[case]
    args = dict(dataset=dataset, model_name=model_name, seed=3, **kw)
    return (jtrainer.Trainer(dataset, shard, cfg=JConfig(**args)),
            ptrainer.Trainer(dataset, shard, cfg=BiscottiConfig(**args),
                             device=CPU))


def _weights(jt):
    if jt.model.name == "logreg":  # its init is all zeros
        return np.random.default_rng(0).normal(0, 0.1, jt.num_params)
    return np.asarray(jt.model.flat_init(jax.random.PRNGKey(2)), np.float64)


def _ref_batch(jt, it):
    k = jax.random.fold_in(jt._batch_key, it)
    rows = int(jt.x_train.shape[0])
    return np.asarray(jtrainer.sample_batch(k, rows, min(jt.batch_size, rows)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_private_fun_on_reference_batches(case):
    jt, pt = _pair(case)
    tol = CASES[case][3]
    assert np.array_equal(pt.x_train.numpy(), np.asarray(jt.x_train))
    w = _weights(jt)
    for it in (0, 1, 7):
        ref = jt.private_fun(w, it)
        got = pt.private_fun_from_batch(w, _ref_batch(jt, it))
        assert got.dtype == np.float64 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol / 10)


@pytest.mark.parametrize("case", ["mnist_softmax", "creditcard_logreg"])
@pytest.mark.parametrize("eps", [1.0, 0.0])
def test_get_noise_on_the_reference_bank(case, eps):
    jt, pt = _pair(case, epsilon=eps)
    assert tuple(pt.noise_samples.shape) == tuple(jt.noise_samples.shape)
    pt.noise_samples = torch.from_numpy(np.array(jt.noise_samples))
    for it in (0, 5, 99, 250):
        ref = jt.get_noise(it)
        got = pt.get_noise(it)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_within_one_sample(case):
    jt, pt = _pair(case)
    w = _weights(jt)
    n_train, n_test = len(jt.x_train), len(jt.x_test)
    n_attack = len(jt.x_attack)
    assert abs(pt.train_error(w) - jt.train_error(w)) <= 1 / n_train + 1e-7
    assert abs(pt.test_error(w) - jt.test_error(w)) <= 1 / n_test + 1e-7
    assert abs(pt.attack_rate(w) - jt.attack_rate(w)) <= 1 / n_attack + 1e-7
    assert abs(pt.attack_success_rate(w) - jt.attack_success_rate(w)) \
        <= 1 / n_attack + 1e-7
    delta = jt.private_fun(w, 3)
    assert abs(pt.roni(w, delta) - jt.roni(w, delta)) <= 2 / n_train + 1e-7
    assert np.array_equal(pt.init_weights(), jt.init_weights())
    assert pt.init_weights().dtype == np.float64


def test_light_trainer_raises_where_the_reference_does():
    pt = ptrainer.Trainer("mnist", "mnist4", light=True, device=CPU)
    assert pt.x_train is None and pt.noise_samples is None
    w = pt.init_weights()
    for call in (lambda: pt.private_fun(w, 0), lambda: pt.get_noise(0),
                 lambda: pt.train_error(w), lambda: pt.roni(w, w),
                 lambda: pt.private_fun_from_batch(w, [0, 1])):
        with pytest.raises(RuntimeError, match="light=True"):
            call()
    assert 0.0 <= pt.test_error(w) <= 1.0 and 0.0 <= pt.attack_rate(w) <= 1.0


def test_default_seed_is_crc32_and_streams_are_pure():
    a = ptrainer.Trainer("mnist", "mnist6", device=CPU)
    b = ptrainer.Trainer("mnist", "mnist6", device=CPU)
    c = ptrainer.Trainer("mnist", "mnist7", device=CPU)
    assert a.seed == zlib.crc32(b"mnist6") == jtrainer.Trainer("mnist", "mnist6").seed
    assert c.seed == zlib.crc32(b"mnist7")
    assert torch.equal(a.noise_samples, b.noise_samples)
    assert not torch.equal(a.noise_samples, c.noise_samples)
    idx = a.batch_indices(4)
    assert torch.equal(idx, b.batch_indices(4))
    assert not torch.equal(idx, a.batch_indices(5))
    assert len(set(idx.tolist())) == a.batch_size
    w = np.zeros(a.num_params)
    assert np.array_equal(a.private_fun(w, 4), a.private_fun_from_batch(w, idx))
    # the eval splits are one copy per (dataset, device)
    assert a.x_test is c.x_test and a.x_attack is c.x_attack


def test_mcmc13_trainer_noise_bank():
    cfg = BiscottiConfig(dataset="creditcard", dp_mechanism="mcmc13",
                         noise_presample_iters=40)
    pt = ptrainer.Trainer("creditcard", "creditcard1", cfg=cfg, device=CPU)
    d = pt.num_params
    assert pt.noise_samples.shape == (40, d)
    assert 0.0 < pt.noise_accept_rate < 1.0
    # get_noise serves the bank row scaled by −α/b, as the Gaussian path
    np.testing.assert_allclose(
        pt.get_noise(41), (-cfg.logreg_alpha / cfg.batch_size)
        * pt.noise_samples[1].double().numpy(), rtol=1e-6)
    off = ptrainer.Trainer("creditcard", "creditcard1", device=CPU,
                           cfg=BiscottiConfig(dataset="creditcard",
                                              dp_mechanism="mcmc13",
                                              noising=False))
    assert off.noise_accept_rate is None and not off.noise_samples.any()
    gauss = ptrainer.Trainer("creditcard", "creditcard1", device=CPU)
    assert gauss.noise_accept_rate is None


def test_trainer_counts_steps_and_noise_draws():
    pt = ptrainer.Trainer("creditcard", "creditcard0", device=CPU)
    pt.metrics = MetricsRegistry()
    w = pt.init_weights()
    pt.private_fun(w, 0)
    pt.private_fun(w, 1)
    pt.get_noise(0)
    page = pt.metrics.render()
    assert "biscotti_trainer_steps_total 2" in page
    assert "biscotti_noise_draws_total 1" in page
