"""The port's share math (`biscotti_tpu_torch/ops/secretshare.py`) against
the JAX package's (`biscotti_tpu/ops/secretshare.py`) on the same seeded
numpy inputs.

Tolerance: exact everywhere. Quantized vectors, share matrices, aggregated
shares, recovered coefficients and reshare deals are int64 and must be
equal; recovered updates are the same int64 coefficients over the same
power of ten, so they are equal bit for bit too. `recover_coeffs` runs
disarmed (the numpy matmul) and with the device plane armed on the CPU
(`kernels.shamir_recover`, a torch float64 matmul): both round to the same
integers.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biscotti_tpu.config import BiscottiConfig as JConfig
from biscotti_tpu.ops import secretshare as rss
from biscotti_tpu_torch.config import BiscottiConfig
from biscotti_tpu_torch.crypto import kernels
from biscotti_tpu_torch.ops import secretshare as ss

SIGN_CASES = [1.23456789, -1.23456789, 0.00004, -0.00004, 0.0, 99.99999,
              -99.99999, 1e-4, -1e-4, 0.5, -0.5, 123.4567891]


@pytest.fixture
def armed_cpu():
    kernels.set_enabled(True, device="cpu")
    try:
        yield
    finally:
        kernels.set_enabled(False)


def _q(d, seed, scale=10**6):
    return np.random.default_rng(seed).integers(-scale, scale, d).astype(np.int64)


@pytest.mark.parametrize("kind", ["np64", "np32", "torch32", "torch64"])
def test_quantize_sign_cases_equal_reference(kind):
    vals = np.asarray(SIGN_CASES + list(np.random.default_rng(0).normal(
        0, 3, 20)), np.float64)
    arr = vals.astype(np.float32) if kind.endswith("32") else vals
    ref = np.asarray(rss.quantize(jnp.asarray(arr)))
    got = ss.quantize(torch.from_numpy(arr) if kind.startswith("torch") else arr)
    assert got.dtype == np.int64 and np.array_equal(got, ref)
    # truncated toward zero, like Go's int64()
    assert ss.quantize(np.array(SIGN_CASES[:5])).tolist() == [12345, -12345,
                                                              0, 0, 0]
    assert np.array_equal(ss.dequantize(got), np.asarray(rss.dequantize(
        jnp.asarray(ref))))


@pytest.mark.parametrize("kind", ["np64", "torch64", "torch32"])
def test_quantize_saturates_outside_int64_as_the_reference(kind):
    # ROADMAP C3: XLA's convert saturates and maps NaN to 0 (under x64, as
    # tests/conftest.py runs the reference); numpy's cast gave INT64_MIN
    # for all six with a RuntimeWarning
    assert jax.config.jax_enable_x64
    vals = np.array([np.inf, -np.inf, np.nan, 1e30, -1e30, 9.3e14])
    ref = np.asarray(rss.quantize(jnp.asarray(vals)))
    arg = vals if kind == "np64" else torch.from_numpy(vals).to(
        torch.float32 if kind == "torch32" else torch.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = ss.quantize(arg)
    i64 = np.iinfo(np.int64)
    assert got.tolist() == ref.tolist() == [i64.max, i64.min, 0, i64.max,
                                            i64.min, i64.max]


@pytest.mark.parametrize("d,poly,mult", [(23, 10, 1), (64, 5, 1), (7, 10, 4),
                                         (40, 10, 3)])
def test_chunking_and_points_equal_reference(d, poly, mult):
    q = _q(d, d)
    got = ss.to_chunks(q, poly, mult)
    assert np.array_equal(got, np.asarray(rss.to_chunks(jnp.asarray(q), poly,
                                                        mult)))
    assert np.array_equal(ss.from_chunks(got, d), q)
    assert ss.num_chunks(d, poly) == rss.num_chunks(d, poly)
    for total in (15, 20, 21):
        assert np.array_equal(ss.share_xs(total), np.asarray(rss.share_xs(total)))
        assert np.array_equal(ss.vandermonde(ss.share_xs(total), poly),
                              np.asarray(rss.vandermonde(rss.share_xs(total),
                                                         poly)))
    for m in (1, 3, 4, 7):
        assert ss.total_shares_for(m, poly) == rss.total_shares_for(m, poly)


@pytest.mark.parametrize("d,poly,total", [(64, 10, 20), (53, 10, 21),
                                          (30, 5, 15), (1, 10, 20)])
def test_make_shares_and_miner_rows_equal_reference(d, poly, total):
    q = _q(d, total)
    got = ss.make_shares(q, poly, total)
    assert got.dtype == np.int64
    assert np.array_equal(got, rss.make_shares(q, poly, total))
    for m in (1, 3):
        for i in range(m):
            assert ss.miner_rows(total, i, m) == rss.miner_rows(total, i, m)
    with pytest.raises(TypeError):
        ss.make_shares(q.astype(np.int32), poly, total)


@pytest.mark.parametrize("armed", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_and_recover_equal_reference(seed, armed, request):
    if armed:
        request.getfixturevalue("armed_cpu")
    rng = np.random.default_rng(seed)
    peers, d, total = 4, 57, 20
    deltas = rng.normal(0, 0.3, (peers, d))
    qs = np.stack([ss.quantize(x) for x in deltas])
    shares = np.stack([ss.make_shares(q, 10, total) for q in qs])
    agg = ss.aggregate_shares(shares)
    assert np.array_equal(agg, rss.aggregate_shares(shares))
    xs = ss.share_xs(total)
    got = ss.recover_coeffs(agg, xs, 10)
    assert got.dtype == np.int64
    assert np.array_equal(got, rss.recover_coeffs(agg, rss.share_xs(total), 10))
    assert np.array_equal(ss.from_chunks(got, d), qs.sum(axis=0))
    rec = ss.recover_update(agg, xs, d)
    assert np.array_equal(rec, rss.recover_update(agg, rss.share_xs(total), d))
    # a miner's row slices reassembled recover the same coefficients
    rows = [ss.miner_rows(21, m, 3) for m in range(3)]
    sh21 = ss.make_shares(qs[0], 10, 21)
    xs21 = ss.share_xs(21)
    part = np.concatenate([sh21[r] for r in rows])
    assert np.array_equal(ss.recover_coeffs(part, np.concatenate(
        [xs21[r] for r in rows])), ss.to_chunks(qs[0]))


def test_recover_coeffs_armed_counts_a_device_call(armed_cpu):
    from biscotti_tpu_torch.crypto.kernels import instrument

    instrument.reset_counters()
    q = _q(30, 3)
    ss.recover_coeffs(ss.make_shares(q, 10, 20), ss.share_xs(20))
    assert instrument.device_calls() == {"shamir_recover": 1}


def test_recover_coeffs_device_fault_raises(armed_cpu, monkeypatch):
    """No CPU failover: a fault in the armed plane raises out of the seam
    (the reference instead finishes on its host matmul)."""
    def fault(*a, **kw):
        raise RuntimeError("backend fault")

    monkeypatch.setattr(kernels, "shamir_recover", fault)
    q = _q(30, 4)
    with pytest.raises(RuntimeError, match="backend fault"):
        ss.recover_coeffs(ss.make_shares(q, 10, 20), ss.share_xs(20))


@pytest.mark.parametrize("k", [3, 5, 10])
def test_reshare_equal_reference(k):
    rows = _q(12, k, scale=10**9).reshape(3, 4)
    seed, ctx = b"reshare-seed" * 3, b"epoch-7"
    coeffs = ss.reshare_coeffs(rows, k, seed, ctx)
    assert np.array_equal(coeffs, rss.reshare_coeffs(rows, k, seed, ctx))
    xs_new = list(range(1, k + 2))  # int64-exact sub-shares up to k = 10
    sub = ss.reshare_subshares(coeffs, xs_new)
    assert np.array_equal(sub, rss.reshare_subshares(coeffs, xs_new))
    got = ss.reshare_recover_rows(sub, xs_new, poly_size=k)
    assert np.array_equal(got, rows)
    assert np.array_equal(got, rss.reshare_recover_rows(sub, xs_new, poly_size=k))
    bad = sub.copy()
    bad[0, 0, 2] += 1  # the Lagrange basis at x = 1 is non-integral
    for mod in (ss, rss):
        with pytest.raises(ValueError):
            mod.reshare_recover_rows(bad, xs_new, poly_size=k)
        with pytest.raises(ValueError, match="new holders"):
            mod.reshare_recover_rows(sub[:k - 1], xs_new, poly_size=k)


@pytest.mark.parametrize("r,m,k", [(1.5, 3, 10), (2.0, 3, 10), (1.5, 4, 10),
                                   (1.0, 1, 10), (2.0, 10, 10), (1.5, 10, 10),
                                   (0.5, 3, 10), (1.3, 7, 9)])
def test_config_share_layout_equals_reference(r, m, k):
    kw = dict(share_redundancy=r, num_miners=m, poly_size=k)
    cfg, ref = BiscottiConfig(**kw), JConfig(**kw)
    try:
        want = (ref.total_shares, ref.shares_per_miner)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            cfg.total_shares
        assert str(got.value) == str(e)
        return
    assert (cfg.total_shares, cfg.shares_per_miner) == want
    assert cfg.precision == ref.precision


def test_config_share_defaults_equal_reference():
    cfg, ref = BiscottiConfig(), JConfig()
    for name in ("precision", "poly_size", "share_redundancy",
                 "total_shares", "shares_per_miner"):
        assert getattr(cfg, name) == getattr(ref, name), name
