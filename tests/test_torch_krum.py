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
    accept_mask,
    collusion_accept_override,
    default_num_adversaries,
    krum_accept_mask,
    krum_scores,
    krum_select,
    pairwise_sq_dists,
    rank_scores,
    same_nonfinite,
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
    fma(-2G, sq_i + sq_j) kept where > 0, +inf added on the diagonal, each
    entry as its order key (a generated NaN 0, a propagated NaN after
    +inf, a number its bits + 1); the exact k-th smallest key by the
    31-step bisection; the score from the keys' values, or the NaN of its
    class; the tie rule; and the subnormal rule of the pre-pass (inputs
    below FLT_MIN as 0, row maxima) and the epilogue (G as 0 where the
    maxima's product or G itself is subnormal, a subnormal D as 0)."""
    tiny = torch.finfo(torch.float32).tiny
    t = torch.from_numpy(x)
    t = torch.where(t.abs() < tiny, 0.0, t)
    amax = t.abs().amax(-1)
    n, d = t.shape
    _, d_pad, _, splits = krum_cuda.plan(n, d, sms)
    kt = d_pad // krum_cuda.K_TILE
    edges = [min(d, s * kt // splits * krum_cuda.K_TILE) for s in range(splits + 1)]
    g = sum((t[:, a:b] @ t[:, a:b].T for a, b in zip(edges, edges[1:])),
            torch.zeros(n, n))
    g = torch.where((amax[:, None] * amax[None, :] < tiny) | (g.abs() < tiny),
                    0.0, g)
    sq = torch.where(t * t < tiny, 0.0, t * t).sum(-1)
    dist = ((sq[:, None] + sq[None, :]).double() - 2 * g.double()).float()
    nan_in = torch.isnan(sq)
    far = nan_in[:, None] | nan_in[None, :]
    near = torch.isnan(dist) & ~far
    dist = torch.where(dist >= tiny, dist, torch.zeros(()))
    dist.diagonal().add_(float("inf"))
    key = dist.view(torch.int32).long() + 1
    key[near], key[far] = 0, 0x7FC00001
    k = n - f - 2
    ans = torch.zeros(n, dtype=torch.long)
    for step in range(31):
        cand = ans | (1 << (30 - step))
        ans = torch.where((key < cand[:, None]).sum(-1) < k, cand, ans)
    below = (key < ans[:, None]) & (key != 0)
    vals = (key - 1).int().view(torch.float32)
    kth = (ans - 1).int().view(torch.float32)
    score = (torch.where(below, vals, torch.zeros(())).sum(-1)
             + (k - below.sum(-1)) * kth)
    score = torch.where(ans == 0x7FC00001, _bits(0x7FC00000), score)
    return torch.where(near.any(-1), _bits(0xFFC00000), score).numpy()


def _bits(u: int) -> torch.Tensor:
    return torch.tensor([u], dtype=torch.int64).int().view(torch.float32)[0]


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


# ----------------------------------------------- non-finite updates (C1)
# ROADMAP C1: an overflowing squared norm (input 1: default_rng(1),
# x[2, 5] = 2e19), ±inf (input 2: default_rng(0), x[2, 5] = inf), 3e38,
# a norm whose 2G alone overflows (1.5e19) and a NaN input, at n = 7, 12
# and 40. The scores' NaNs must carry the reference's bits (the class that
# ranks them), the infinities sit where the reference's do, the finite
# scores agree at RTOL, and the accept sets are identical.
C1_INPUTS = [(1, 2e19), (0, np.inf), (0, -np.inf), (1, 3e38), (1, 1.5e19),
             (0, np.nan)]


def c1_input(seed: int, value: float, n: int) -> np.ndarray:
    x = np.random.default_rng(seed).normal(size=(n, 16)).astype(np.float32)
    x[2, 5] = value
    return x


def assert_scores_match(ref: np.ndarray, got: np.ndarray) -> None:
    nan = np.isnan(ref)
    assert np.array_equal(nan, np.isnan(got))
    assert np.array_equal(ref.view(np.uint32)[nan], got.view(np.uint32)[nan])
    assert np.array_equal(np.isinf(ref), np.isinf(got))
    assert np.array_equal(ref[np.isinf(ref)], got[np.isinf(got)])
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL)


@pytest.mark.parametrize("n", [7, 12, 40])
@pytest.mark.parametrize("seed,value", C1_INPUTS)
def test_nonfinite_updates_match_reference(seed, value, n):
    x = c1_input(seed, value, n)
    f = default_num_adversaries(n)
    ref = np.asarray(jkrum_scores(jnp.asarray(x), f))
    for got in _port_scores(x, f) + [_kernel_order_scores(x, f)]:
        assert_scores_match(ref, got)
        assert same_nonfinite(torch.tensor(got), torch.tensor(ref))
    want = np.asarray(jkrum_accept_mask(jnp.asarray(x), f))
    assert np.array_equal(krum_accept_mask(torch.from_numpy(x), f).numpy(), want)
    kernel = accept_mask(torch.from_numpy(_kernel_order_scores(x, f)),
                                   n - f)
    assert np.array_equal(kernel.numpy(), want)


def test_overflowing_norm_is_accepted_as_the_reference_accepts_it():
    # input 1 of ROADMAP C1: row 2's self-distance is inf - inf, a NaN
    # generated with no NaN input, so its score is the NaN 0xffc00000 and
    # ranks first
    x = c1_input(1, 2e19, 7)
    scores = krum_scores(torch.from_numpy(x), 3).numpy()
    assert scores.view(np.uint32)[2] == 0xFFC00000
    assert np.isfinite(np.delete(scores, 2)).all()
    assert np.flatnonzero(krum_accept_mask(torch.from_numpy(x), 3)).tolist() \
        == [0, 2, 3, 5]
    # a NaN input propagates: its score is 0x7fc00000 and ranks last
    x = c1_input(0, np.nan, 7)
    scores = krum_scores(torch.from_numpy(x), 3).numpy()
    assert scores.view(np.uint32)[2] == 0x7FC00000
    assert not krum_accept_mask(torch.from_numpy(x), 3).numpy()[2]


def test_rank_scores_orders_nan_classes_around_the_numbers():
    nan_near, nan_far = float(_bits(0xFFC00000)), float(_bits(0x7FC00000))
    s = torch.tensor([3.0, nan_far, float("inf"), nan_near, 1.0, nan_near, 0.0,
                      1.0])
    assert rank_scores(s).tolist() == [3, 5, 6, 4, 7, 0, 2, 1]


def test_same_nonfinite_tells_the_classes_apart():
    near, far = float(_bits(0xFFC00000)), float(_bits(0x7FC00000))
    a = torch.tensor([1.0, near, float("inf"), 2.0])
    assert same_nonfinite(a, a.clone())
    assert same_nonfinite(torch.tensor([1.5, near, float("inf"), 2.5]), a)
    for b in ([1.0, far, float("inf"), 2.0], [1.0, near, 3.0, 2.0],
              [1.0, near, float("-inf"), 2.0], [near, near, float("inf"), 2.0]):
        assert not same_nonfinite(torch.tensor(b), a)


# ---------------------------------------------- ROADMAP C2: subnormals


def _c2_check(x: np.ndarray) -> None:
    """Port scores (all three CPU routes and the kernel's model) equal the
    reference's, and the accept masks are the reference's."""
    n = x.shape[0]
    f = default_num_adversaries(n)
    # k = n - f - 2 = 0 never reaches the kernel: its wrapper returns zeros
    model = [_kernel_order_scores(x, f)] if n - f - 2 > 0 else []
    ref = np.asarray(jkrum_scores(jnp.asarray(x), f))
    for got in _port_scores(x, f) + model:
        assert_scores_match(ref, got)
    want = np.asarray(jkrum_accept_mask(jnp.asarray(x), f))
    assert np.array_equal(krum_accept_mask(torch.from_numpy(x), f).numpy(), want)
    for scores in model:
        kernel = accept_mask(torch.from_numpy(scores), n - f)
        assert np.array_equal(kernel.numpy(), want)


def test_subnormal_distances_accept_as_the_reference():
    # ROADMAP C2's input: every product is subnormal, so the reference's
    # flush-to-zero makes every distance 0 and ties go to the lower index
    x = (np.random.default_rng(0).normal(size=(6, 8)) * 1e-20).astype(np.float32)
    assert np.flatnonzero(krum_accept_mask(torch.from_numpy(x), 3)).tolist() \
        == [0, 1, 2]
    assert not krum_scores(torch.from_numpy(x), 3).any()
    _c2_check(x)


@pytest.mark.parametrize("seed", range(8))
def test_subnormal_fuzz_class_matches_reference(seed):
    # the x1e-20 class of the differential fuzz, n <= 13, d <= 8; one row
    # of each case is scaled to 1e-30 (subnormal inputs) and, from seed 4
    # on, one is left at unit scale (normal next to flushed entries)
    rng = np.random.default_rng(100 + seed)
    for _ in range(12):
        n, d = int(rng.integers(3, 14)), int(rng.integers(1, 9))
        x = rng.normal(size=(n, d)) * 1e-20
        x[int(rng.integers(n))] *= 1e-10
        if seed >= 4:
            x[int(rng.integers(n))] *= 1e20
        _c2_check(x.astype(np.float32))


def test_subnormal_rows_at_mnist_width_with_default_threads():
    # (64, 7850) x 1e-20 with torch's default intra-op pool: the flush is
    # the port's own arithmetic, not the calling thread's FTZ state, which
    # torch.set_flush_denormal sets and the pool's threads do not share
    assert torch.get_num_threads() >= 1
    x = (np.random.default_rng(0).normal(size=(64, 7850)) * 1e-20).astype(np.float32)
    _c2_check(x)
