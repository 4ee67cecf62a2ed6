"""The port's robust aggregation (Multi-Krum, trimmed mean, median,
FoolsGold) against `biscotti_tpu/ops/robust_agg.py`, on seeded numpy
updates.

Tolerances: accept masks exact; floats within rtol 1e-5, atol 1e-6 (float32
sums in another order), and for the trimmed mean, whose sums cancel, atol
1e-5 of the largest input (times n for the sum-scale aggregate). The FoolsGold cases are those of
tests/test_robust_agg.py:112-152 plus seeded random rounds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from biscotti_tpu.ops import robust_agg as jra
from biscotti_tpu_torch.ops import robust_agg as pra
from biscotti_tpu_torch.ops.krum import default_num_adversaries

RTOL, ATOL = 1e-5, 1e-6


def _both(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _normal(seed, n, d, scale=1.0):
    return np.random.default_rng(seed).normal(0.0, scale, size=(n, d))


# ------------------------------------------------------------- Multi-Krum


def test_multikrum_m_matches():
    for n in range(1, 40):
        for f in range(0, n):
            assert pra.multikrum_m(n, f) == jra.multikrum_m(n, f)


@pytest.mark.parametrize("n,d,seed", [(8, 16, 0), (20, 64, 1), (70, 128, 2),
                                      (35, 7, 3)])
@pytest.mark.parametrize("m", [0, 3])
def test_multikrum_mask_matches(n, d, seed, m):
    x = _normal(seed, n, d)
    x[: n // 4] += 4.0  # a displaced group
    jx, px = _both(x)
    f = default_num_adversaries(n)
    ref = np.asarray(jra.multikrum_accept_mask(jx, f, m))
    got = pra.multikrum_accept_mask(px, f, m).numpy()
    assert np.array_equal(got, ref)
    assert got.sum() == min(m or pra.multikrum_m(n, f), n)


def test_multikrum_exact_ties_go_to_the_lower_index():
    # integer-valued rows: exact distances, duplicated rows tie exactly and
    # both frameworks keep the lower index first (lax.top_k, stable sort)
    rng = np.random.default_rng(4)
    x = rng.integers(-3, 4, size=(24, 6)).astype(np.float32)
    x[[2, 9, 15, 20, 23]] = x[2]
    x[[5, 11]] = x[5]
    jx, px = _both(x)
    for f in (2, 5, 9):
        for m in (0, 4, 13):
            ref = np.asarray(jra.multikrum_accept_mask(jx, f, m))
            assert np.array_equal(pra.multikrum_accept_mask(px, f, m).numpy(), ref)


@pytest.mark.parametrize("n", [7, 12, 40])
@pytest.mark.parametrize("seed,value", [(1, 2e19), (0, np.inf), (0, -np.inf),
                                        (1, 3e38), (1, 1.5e19), (0, np.nan)])
@pytest.mark.parametrize("m", [0, 3])
def test_multikrum_mask_on_nonfinite_updates(seed, value, n, m):
    # ROADMAP C1, inputs 1 (2e19) and 2 (inf) and their neighbours: an
    # overflowing squared norm, ±inf and a NaN input, ranked as the
    # reference ranks their NaN and inf scores
    x = np.random.default_rng(seed).normal(size=(n, 16)).astype(np.float32)
    x[2, 5] = value
    jx, px = _both(x)
    f = default_num_adversaries(n)
    ref = np.asarray(jra.multikrum_accept_mask(jx, f, m))
    assert np.array_equal(pra.multikrum_accept_mask(px, f, m).numpy(), ref)


@pytest.mark.parametrize("m", [0, 3])
def test_multikrum_mask_on_subnormal_distances(m):
    # ROADMAP C2: the reference flushes subnormals, so every distance of
    # its input is 0 and ties go to the lower index; the x1e-20 class of
    # the fuzz at n <= 13, d <= 8; and (64, 7850) with torch's default
    # intra-op threads
    x = np.random.default_rng(0).normal(size=(6, 8)) * 1e-20
    cases = [x]
    rng = np.random.default_rng(7)
    for _ in range(40):
        n, d = int(rng.integers(3, 14)), int(rng.integers(1, 9))
        cases.append(rng.normal(size=(n, d)) * 1e-20)
    cases.append(np.random.default_rng(0).normal(size=(64, 7850)) * 1e-20)
    for x in cases:
        jx, px = _both(x)
        f = default_num_adversaries(x.shape[0])
        ref = np.asarray(jra.multikrum_accept_mask(jx, f, m))
        assert np.array_equal(pra.multikrum_accept_mask(px, f, m).numpy(), ref)
    x = _both(cases[0])[1]
    assert np.flatnonzero(pra.multikrum_accept_mask(x, 3, m)).tolist() == \
        list(range(pra.multikrum_m(6, 3) if m == 0 else m))


# ------------------------------------------------ trimmed mean and median


@pytest.mark.parametrize("n", [1, 2, 5, 10, 20, 33])
@pytest.mark.parametrize("t", [0.0, 0.2, 0.35, 0.49])
def test_trimmed_mean_matches(n, t):
    # t = 0 keeps every value; 0.49 at small n is the degenerate case the
    # reference clamps to keep at least one value
    x = _normal(n, n, 17, 3.0)
    jx, px = _both(x)
    scale = float(np.abs(x).max())  # sums cancel: atol relative to the inputs
    _close(pra.trimmed_mean(px, t), jra.trimmed_mean(jx, t), atol=RTOL * scale)
    _close(pra.trimmed_mean_aggregate(px, t), jra.trimmed_mean_aggregate(jx, t),
           atol=RTOL * n * scale)


def test_trimmed_mean_known_values():
    x = torch.tensor([[10.0, 0.0], [1.0, 1.0], [2.0, 2.0], [3.0, 3.0],
                      [-50.0, 4.0]])
    assert torch.allclose(pra.trimmed_mean(x, 0.25), torch.tensor([2.0, 2.0]))
    assert torch.allclose(pra.trimmed_mean(torch.tensor([[1.0], [3.0]]), 0.49),
                          torch.tensor([2.0]))
    same = torch.tensor([[1.0, -2.0]]).repeat(10, 1)
    assert torch.allclose(pra.trimmed_mean_aggregate(same, 0.3),
                          torch.tensor([4.0, -8.0]))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 9, 10])
def test_median_aggregate_matches_jnp_median(n):
    # even n: jnp.median averages the two middle values; torch.median would
    # return the lower one
    x = _normal(20 + n, n, 11)
    jx, px = _both(x)
    _close(pra.median_aggregate(px), jra.median_aggregate(jx))
    _close(pra._median(px, 0), jnp.median(jx, axis=0))


def test_median_of_four_is_the_midpoint():
    v = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert float(pra._median(v)) == 2.5
    assert float(torch.median(v)) == 2.0  # the trap the port avoids


# ---------------------------------------------------------------- FoolsGold


def _near_duplicate_sybils():
    rng = np.random.default_rng(3)
    honest = rng.normal(0.0, 1.0, size=(7, 128))
    sybil = np.tile(rng.normal(0.0, 1.0, size=(1, 128)), (3, 1)) \
        + rng.normal(0, 0.01, size=(3, 128))
    return np.vstack([honest, sybil])


def _moderate_cluster():
    rng = np.random.default_rng(4)
    n, d, n_poison = 70, 512, 21
    honest = rng.normal(0.0, 1.0, size=(n - n_poison, d))
    direction = rng.normal(0.0, 1.0, size=(1, d))
    poison = np.tile(direction, (n_poison, 1)) \
        + rng.normal(0.0, 1.3, size=(n_poison, d))
    return np.vstack([honest, poison])


def _uniform_round():
    return np.random.default_rng(5).normal(0.0, 1.0, size=(20, 64))


def _with_zero_row():
    x = _normal(8, 12, 32)
    x[4] = 0.0  # its norm is clamped to 1e-12: every cosine is 0
    return x


def _small_pool_pair():
    x = _normal(9, 6, 40)
    x[3] = x[1] + 0.05 * _normal(10, 1, 40)[0]  # one similar honest pair
    return x


CASES = {"near_duplicate_sybils": _near_duplicate_sybils,
         "moderate_cluster": _moderate_cluster,
         "uniform_round": _uniform_round,
         "zero_row": _with_zero_row,
         "small_pool_pair": _small_pool_pair,
         **{f"random_{s}": (lambda s=s: _normal(100 + s, 30, 96)
                            + (np.arange(30)[:, None] >= 24) * _normal(200 + s, 1, 96))
            for s in range(4)}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cosine_statistics_match(case):
    jx, px = _both(CASES[case]())
    ref = np.asarray(jra._cosine_matrix(jx))
    got = pra._cosine_matrix(px).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    assert np.isneginf(np.diag(got)).all()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, atol=ATOL)
    _close(pra.max_mutual_cosine(px), jra.max_mutual_cosine(jx))


@pytest.mark.parametrize("case", sorted(CASES))
def test_foolsgold_weights_match(case):
    jx, px = _both(CASES[case]())
    got = pra.foolsgold_weights(px)
    _close(got, jra.foolsgold_weights(jx), atol=1e-5)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("min_cluster", [1, 3])
def test_foolsgold_mask_matches(case, min_cluster):
    jx, px = _both(CASES[case]())
    ref = np.asarray(jra.foolsgold_accept_mask(jx, min_cluster))
    got = pra.foolsgold_accept_mask(px, min_cluster).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, ref)


def test_foolsgold_behaviour_on_the_reference_cases():
    w = pra.foolsgold_weights(torch.from_numpy(
        _near_duplicate_sybils().astype(np.float32)))
    assert float(w[7:].max()) < 0.1 and float(w[:7].min()) > 0.9
    mask = pra.foolsgold_accept_mask(torch.from_numpy(
        _moderate_cluster().astype(np.float32)))
    assert not mask[49:].any() and float(mask[:49].float().mean()) > 0.9
    mask = pra.foolsgold_accept_mask(torch.from_numpy(
        _uniform_round().astype(np.float32)))
    assert float(mask.float().mean()) >= 0.8
