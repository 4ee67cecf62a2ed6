"""Port Krum (ops/krum.py, ops/krum_cuda.py) against the JAX reference.

The cases of tests/test_krum_pallas.py, held against both the reference's
XLA path (`krum_scores`) and its Pallas kernel (`krum_scores_pallas`, which
runs in interpret mode on the CPU, as that file runs it), at rtol 1e-4 on
scores; accept sets must be identical. On a CPU tensor the kernel wrapper
computes its plain version and never counts a launch. The Hopper kernel's own
arithmetic (its split-K partial Grams summed in split order, the clamp, the
31-step bisection select and the tie rule) is modelled on the CPU by
`_kernel_order_scores` and held to the same cases, a cancellation-heavy one
included.
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


def _kernel_order_scores(x: np.ndarray, f: int, sms: int = 132) -> np.ndarray:
    """csrc/krum_scores.cu's arithmetic on the CPU: fp32 partial Grams over
    `plan`'s split of the padded features, summed in split order; D =
    (sq_i + sq_j) - 2G kept where > 0, the diagonal +inf; the exact k-th
    smallest by the 31-step bisection on the float bits; the tie rule."""
    t = torch.from_numpy(x)
    n, d = t.shape
    _, d_pad, _, splits = krum_cuda.plan(n, d, sms)
    kt = d_pad // krum_cuda.K_TILE
    edges = [min(d, s * kt // splits * krum_cuda.K_TILE) for s in range(splits + 1)]
    g = sum((t[:, a:b] @ t[:, a:b].T for a, b in zip(edges, edges[1:])),
            torch.zeros(n, n))
    sq = (t * t).sum(-1)
    dist = (sq[:, None] + sq[None, :]) - 2 * g
    dist = torch.where(dist > 0, dist, torch.zeros(()))
    dist.fill_diagonal_(float("inf"))
    k = n - f - 2
    bits = dist.view(torch.int32)
    ans = torch.zeros(n, dtype=torch.int32)
    for step in range(31):
        cand = ans | (1 << (30 - step))
        ans = torch.where((bits < cand[:, None]).sum(-1) < k, cand, ans)
    below = bits < ans[:, None]
    kth = ans.view(torch.float32)
    return (torch.where(below, dist, torch.zeros(())).sum(-1)
            + (k - below.sum(-1)) * kth).numpy()


def _check_against_reference(x):
    f = default_num_adversaries(x.shape[0])
    refs = [np.asarray(jkrum_scores(jnp.asarray(x), f)),
            np.asarray(krum_scores_pallas(jnp.asarray(x), f))]
    for got in _port_scores(x, f) + [_kernel_order_scores(x, f)]:
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


def test_scores_on_cancellation_heavy_rows():
    # rows that share one large mean: sq_i + sq_j - 2G cancels most of its
    # digits; the kernel's split-K order keeps fp32 accuracy
    rng = np.random.default_rng(8)
    x = (0.05 * rng.normal(size=(300, 2000))
         + rng.normal(size=(1, 2000))).astype(np.float32)
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
    kernel = np.argsort(_kernel_order_scores(x, f), kind="stable")[:n - f]
    assert np.array_equal(np.sort(kernel), np.nonzero(ref)[0])


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
    assert np.array_equal(_kernel_order_scores(x, f), scores)  # exact
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


@pytest.mark.parametrize("n,d,plan", [
    (716, 7850, (768, 7856, 21, 12)),    # the main path: d split 12 ways
    (1024, 7850, (1024, 7856, 36, 7)),
    (4096, 7850, (4096, 7856, 528, 1)),  # 528 tiles fill the card unsplit
    (130, 50, (256, 64, 3, 4)),          # at most one k-tile a split
    (5, 3, (128, 16, 1, 1)),
])
def test_kernel_plan(n, d, plan):
    assert krum_cuda.plan(n, d, sms=132) == plan


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
