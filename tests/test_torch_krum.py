"""Port Krum (ops/krum.py, ops/krum_cuda.py) against the JAX reference.

The cases of tests/test_krum_pallas.py, held against both the reference's
XLA path (`krum_scores`) and its Pallas kernel (`krum_scores_pallas`, which
runs in interpret mode on the CPU, as that file runs it), at rtol 1e-4 on
scores; accept sets must be identical. On a CPU tensor the kernel wrapper
computes its plain version and never counts a launch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from biscotti_tpu.ops.krum import krum_accept_mask as jkrum_accept_mask
from biscotti_tpu.ops.krum import krum_scores as jkrum_scores
from biscotti_tpu.ops.krum_pallas import (
    PALLAS_MAX_N,
    PALLAS_MIN_N,
    krum_scores_pallas,
)
from biscotti_tpu_torch.ops import krum_cuda
from biscotti_tpu_torch.ops.krum import (
    collusion_accept_override,
    default_num_adversaries,
    krum_accept_mask,
    krum_scores,
    krum_select,
    pairwise_sq_dists,
)

RTOL = 1e-4


def _rel_err(a, b):
    return np.max(np.abs(a - b) / (np.abs(a) + 1e-6))


def _port_scores(x, f):
    """The port's three CPU routes to the scores: all must agree."""
    t = torch.from_numpy(x)
    return [krum_scores(t, f).numpy(), krum_cuda.krum_scores_plain(t, f).numpy(),
            krum_cuda.krum_scores_kernel(t, f).numpy()]


def _check_against_reference(x):
    f = default_num_adversaries(x.shape[0])
    refs = [np.asarray(jkrum_scores(jnp.asarray(x), f)),
            np.asarray(krum_scores_pallas(jnp.asarray(x), f))]
    for got in _port_scores(x, f):
        for ref in refs:
            assert _rel_err(ref, got) < RTOL


@pytest.mark.parametrize("n,d", [(8, 16), (100, 64), (130, 50), (160, 96)])
def test_scores_match_reference(n, d):
    x = np.random.default_rng(7).normal(size=(n, d)).astype(np.float32)
    _check_against_reference(x)


def test_scores_with_duplicate_updates_tie_handling():
    x = np.random.default_rng(1).normal(size=(96, 32)).astype(np.float32)
    x[10:40] = x[10]  # 30 identical rows: exact ties at the k-th threshold
    _check_against_reference(x)


def test_accept_set_matches_reference_on_poison_cluster():
    rng = np.random.default_rng(3)
    n, d = 140, 48
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[100:] += 25.0  # 40 outliers
    f = default_num_adversaries(n)
    ref = np.asarray(jkrum_accept_mask(jnp.asarray(x), f))
    got = krum_accept_mask(torch.from_numpy(x), f).numpy()
    assert np.array_equal(ref, got)
    assert not got[100:].any()


@pytest.mark.parametrize("dup_rows", [
    list(range(8)),                    # the tie group straddles the boundary
    [11, 3, 7, 0, 9, 5, 1, 10],        # scattered: lower indices win
    [2, 4, 6, 8, 10, 12, 13],
])
def test_exact_accept_set_on_duplicate_ties(dup_rows):
    # integer-valued updates make every distance and score exact in fp32,
    # so the tied scores are equal bit for bit on both sides and only the
    # tie order decides the accept set: lower index first, as lax.top_k
    rng = np.random.default_rng(11)
    n = 14
    x = rng.integers(-3, 4, size=(n, 24)).astype(np.float32)
    x[dup_rows] = x[dup_rows[0]]
    f = default_num_adversaries(n)
    scores = krum_scores(torch.from_numpy(x), f).numpy()
    assert np.sum(scores == scores[dup_rows[0]]) >= len(dup_rows)
    ref = np.asarray(jkrum_accept_mask(jnp.asarray(x), f))
    got = krum_accept_mask(torch.from_numpy(x), f)
    assert np.array_equal(ref, got.numpy())
    assert np.array_equal(krum_select(torch.from_numpy(x), f).numpy(),
                          np.nonzero(ref)[0])


def test_k_zero_accepts_lowest_indices():
    # n=4: f=2, k=0 -> all scores zero; the first n-f indices are accepted
    x = np.random.default_rng(2).normal(size=(4, 5)).astype(np.float32)
    ref = np.asarray(jkrum_accept_mask(jnp.asarray(x), 2))
    got = krum_accept_mask(torch.from_numpy(x), 2).numpy()
    assert np.array_equal(ref, got) and got.tolist() == [True, True, False, False]


def test_cpu_tensors_never_launch_the_kernel():
    krum_cuda.krum_scores_kernel.launches = 0
    rng = np.random.default_rng(5)
    for n in (40, krum_cuda.KERNEL_MIN_N, krum_cuda.KERNEL_MAX_N // 4):
        x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
        f = default_num_adversaries(n)
        ref = krum_scores(x, f).numpy()
        np.testing.assert_allclose(krum_cuda.krum_scores_auto(x, f).numpy(),
                                   ref, rtol=1e-6)
        np.testing.assert_allclose(krum_cuda.krum_scores_kernel(x, f).numpy(),
                                   ref, rtol=1e-6)
    assert krum_cuda.krum_scores_kernel.launches == 0


def test_window_mirrors_reference():
    assert (krum_cuda.KERNEL_MIN_N, krum_cuda.KERNEL_MAX_N) == (PALLAS_MIN_N, PALLAS_MAX_N)


def test_pairwise_and_helpers():
    x = np.random.default_rng(4).normal(size=(9, 6)).astype(np.float32)
    d = pairwise_sq_dists(torch.from_numpy(x)).numpy()
    want = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d, want, rtol=1e-4, atol=1e-4)
    assert default_num_adversaries(716) == 358
    assert not collusion_accept_override(19, 20, 0.0)
    assert collusion_accept_override(19, 20, 0.3)
    assert not collusion_accept_override(14, 20, 0.3)
