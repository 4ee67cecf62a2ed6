"""The port's CUDA kernels on the card (marker `cuda`; they skip without one).

Run on a machine with a GPU, where JAX is not installed, without the repo's
conftest (which imports JAX):

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py -q

Tolerance: rtol 1e-4 on Krum scores, as tests/test_krum_pallas.py holds the
TPU kernel (the kernel's fp32 Gram and the plain version's matmul sum in
other orders); integer-valued rows are exact on both, bit for bit. The crypto
plane is exact: on-curve masks equal, limb tensors equal bit for bit; its
seams (the VSS intake's triples, the batch verifiers' verdicts,
`recover_update`) are equal armed on the card, armed on the CPU and disarmed.
"""

import numpy as np
import pytest
import torch

from biscotti_tpu_torch.crypto import ed25519 as ed
from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
from biscotti_tpu_torch.crypto.kernels.cells import (edge_cells, grid_bytes,
                                                     random_cells)
from biscotti_tpu_torch.crypto.kernels import primitives as prim
from biscotti_tpu_torch.ops import krum_cuda
from biscotti_tpu_torch.ops.krum import (accept_mask, default_num_adversaries,
                                         krum_accept_mask, same_nonfinite)

pytestmark = pytest.mark.cuda

RTOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel_err(a, b):
    return float(((a - b).abs() / (b.abs() + 1e-6)).max())


@pytest.mark.parametrize("n,d", [(5, 3), (8, 16), (100, 64), (130, 50),
                                 (511, 33), (1056, 70), (2000, 257),
                                 (716, 7850), (4096, 7850)])
def test_kernel_matches_plain(dev, n, d):
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, d, generator=gen, device=dev)
    f = default_num_adversaries(n)
    before = krum_cuda.krum_scores_kernel.launches
    got = krum_cuda.krum_scores_kernel(x, f)
    torch.cuda.synchronize()
    assert krum_cuda.krum_scores_kernel.launches == before + 1
    assert _rel_err(got, krum_cuda.krum_scores_plain(x, f)) < RTOL


def test_kernel_duplicate_ties_and_accept_set(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(96, 32, generator=gen, device=dev)
    x[10:40] = x[10]
    f = default_num_adversaries(96)
    ref = krum_cuda.krum_scores_plain(x, f)
    assert _rel_err(krum_cuda.krum_scores_kernel(x, f), ref) < RTOL
    # integer-valued rows: exact distances, exact ties, index order decides
    xi = torch.randint(-3, 4, (600, 24), generator=gen, device=dev).float()
    xi[[7, 3, 500, 0, 9, 250, 1, 100]] = xi[7].clone()
    f = default_num_adversaries(600)
    got = krum_cuda.krum_scores_kernel(xi, f)
    assert torch.equal(got, krum_cuda.krum_scores_plain(xi, f))
    mask = krum_accept_mask(xi, f)
    assert torch.equal(mask.cpu(), krum_accept_mask(xi.cpu(), f))


@pytest.mark.parametrize("n,d", [(716, 7850), (4096, 7850)])
def test_kernel_is_bit_identical_across_calls(dev, n, d):
    # split-K partials sum in a fixed order, with no float atomics: the
    # verifiers of one cluster compute the same accept set
    gen = torch.Generator(device=dev).manual_seed(n + 1)
    x = torch.randn(n, d, generator=gen, device=dev)
    f = default_num_adversaries(n)
    first = krum_cuda.krum_scores_kernel(x, f)
    assert torch.equal(first, krum_cuda.krum_scores_kernel(x, f))


def test_kernel_on_cancellation_heavy_rows(dev):
    # rows that share one large mean: D = sq_i + sq_j - 2G cancels most of
    # its digits, and a Gram whose sums lose bits in one direction (the
    # tensor cores' truncation, even at 3xTF32) is 100x off. fp32 itself
    # barely resolves this accept boundary (the plain version's own error is
    # about the gap), so the kernel must give the plain accept set and be as
    # exact as the plain version against float64 (10 %: two summation orders)
    gen = torch.Generator(device=dev).manual_seed(3)
    n, d = 716, 7850
    x = 0.05 * torch.randn(n, d, generator=gen, device=dev) \
        + torch.randn(1, d, generator=gen, device=dev)
    f = default_num_adversaries(n)
    got = krum_cuda.krum_scores_kernel(x, f)
    ref = krum_cuda.krum_scores_plain(x, f)
    xd = x.double()
    sq = (xd * xd).sum(-1)
    dist = torch.clamp(sq[:, None] + sq[None, :] - 2 * xd @ xd.T, min=0)
    dist.fill_diagonal_(float("inf"))
    truth = torch.sort(dist, dim=-1).values[:, :n - f - 2].sum(-1)
    assert _rel_err(got, ref) < RTOL
    assert _rel_err(got.double(), truth) <= 1.1 * _rel_err(ref.double(), truth)
    order = lambda v: torch.sort(v, stable=True).indices[:n - f]
    assert set(order(got).tolist()) == set(order(ref).tolist())


def test_pad_kernel_copies_x_and_zero_pads(dev):
    # the Gram reads a 16-byte-aligned copy of x: a row at d = 7850 is
    # 31,400 bytes, not a multiple of 16; the padding must be zero
    from biscotti_tpu_torch import _build

    gen = torch.Generator(device=dev).manual_seed(4)
    for n, d in ((130, 50), (716, 7850)):
        x = torch.randn(n, d, generator=gen, device=dev)
        ws = krum_cuda.workspace(n, d, dev)
        ws["xp"].fill_(float("nan"))
        out = torch.empty(n, device=dev)
        rc = krum_cuda.launch(_build.load("krum_scores"), x, (x * x).sum(-1),
                              out, ws, n - default_num_adversaries(n) - 2)
        torch.cuda.synchronize()
        assert rc == 0
        assert ws["xp"].shape == (ws["n_pad"], ws["d_pad"])
        assert torch.equal(ws["xp"][:n, :d], x)
        assert not ws["xp"][n:].any() and not ws["xp"][:, d:].any()
        assert torch.equal(out, krum_cuda.krum_scores_kernel(
            x, default_num_adversaries(n)))


def test_auto_dispatch_window(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    for n, launched in ((krum_cuda.KERNEL_MIN_N - 1, False),
                        (krum_cuda.KERNEL_MIN_N, True),
                        (krum_cuda.KERNEL_MAX_N, True),
                        (krum_cuda.KERNEL_MAX_N + 1, False)):
        x = torch.randn(n, 8, generator=gen, device=dev)
        before = krum_cuda.krum_scores_kernel.launches
        krum_cuda.krum_scores_auto(x, default_num_adversaries(n))
        assert (krum_cuda.krum_scores_kernel.launches > before) == launched, n


def test_kernel_rejects_what_it_does_not_take(dev):
    x = torch.randn(20, 8, device=dev)
    with pytest.raises(ValueError):
        krum_cuda.krum_scores_kernel(x.double(), 10)
    with pytest.raises(ValueError):
        krum_cuda.krum_scores_kernel(x.t(), 4)
    assert not krum_cuda.krum_scores_kernel(x[:4], 2).any()  # k = 0


@pytest.mark.parametrize("case", ["overflow_2e19", "plus_inf", "minus_inf",
                                  "nan_input"])
def test_kernel_on_nonfinite_rows_matches_plain_on_the_cpu(dev, case):
    """ROADMAP C1 at the main path's n = 716: B1 on the card and the plain
    path on the card against the plain path on the CPU (the oracle the CPU
    tests hold to the reference): the same accept set, the same NaN bits
    and infinities, finite scores within RTOL."""
    x = torch.randn(716, 7850, generator=torch.Generator().manual_seed(6))
    row, value = {"overflow_2e19": (2, 2e19), "plus_inf": (2, float("inf")),
                  "minus_inf": (300, float("-inf")),
                  "nan_input": (9, float("nan"))}[case]
    x[row, 5] = value
    f = default_num_adversaries(716)
    oracle = krum_cuda.krum_scores_plain(x, f)
    want = accept_mask(oracle, 716 - f)
    for got in (krum_cuda.krum_scores_kernel(x.to(dev), f),
                krum_cuda.krum_scores_plain(x.to(dev), f)):
        got = got.cpu()
        assert same_nonfinite(got, oracle)
        fin = torch.isfinite(oracle)
        assert _rel_err(got[fin], oracle[fin]) < RTOL
        assert torch.equal(accept_mask(got, 716 - f), want)
    assert torch.equal(krum_accept_mask(x.to(dev), f).cpu(), want)


@pytest.mark.parametrize("case", ["all_subnormal_products", "mixed_scales"])
def test_kernel_on_subnormal_rows_matches_plain_on_the_cpu(dev, case):
    """ROADMAP C2 at n = 716, d = 7850: x1e-20 rows, whose products are all
    subnormal (the reference flushes them: every distance 0, ties to the
    lower index), alone and beside rows at unit scale and at 1e-30
    (subnormal inputs). B1 and the plain path on the card give the CPU
    plain path's scores and accept set."""
    x = torch.randn(716, 7850, generator=torch.Generator().manual_seed(7)) * 1e-20
    if case == "mixed_scales":
        x[::7] *= 1e20
        x[3::11] *= 1e-10
    f = default_num_adversaries(716)
    oracle = krum_cuda.krum_scores_plain(x, f)
    want = accept_mask(oracle, 716 - f)
    if case == "all_subnormal_products":
        assert not oracle.any()
        assert torch.equal(torch.nonzero(want)[:, 0], torch.arange(716 - f))
    for got in (krum_cuda.krum_scores_kernel(x.to(dev), f),
                krum_cuda.krum_scores_plain(x.to(dev), f)):
        got = got.cpu()
        assert torch.equal(got == 0, oracle == 0)
        assert _rel_err(got, oracle) < RTOL
        assert torch.equal(accept_mask(got, 716 - f), want)
    assert torch.equal(krum_accept_mask(x.to(dev), f).cpu(), want)


# ------------------------------------------------ kernel B2, the crypto plane


def _oncurve_against_plain(cells: np.ndarray, dev) -> np.ndarray:
    xy = torch.from_numpy(cells).to(dev)
    before = cv.oncurve_mask.launches
    got = cv.oncurve_mask(xy)
    torch.cuda.synchronize()
    assert cv.oncurve_mask.launches == before + 1
    assert got.device == xy.device and got.dtype == torch.bool
    assert torch.equal(got, cv.oncurve_mask_plain(xy))
    return got.cpu().numpy()


def test_oncurve_kernel_matches_plain_on_edges(dev):
    cells = edge_cells()
    got = _oncurve_against_plain(cells, dev)
    # the valid points, their +p twins, (0, -1) and (0, 1) lie on the curve
    assert got[49:].tolist() == [True, True, True, False, False] * 4 + [True, True]
    # numpy in, numpy out, on the default device
    assert np.array_equal(cv.oncurve_mask(cells), got)


def test_oncurve_kernel_matches_plain_on_100k_cells(dev):
    cells = random_cells(100_000, seed=3)
    valid = edge_cells()[49:69:5]  # four valid points
    cells[::7] = np.resize(valid, cells[::7].shape)
    got = _oncurve_against_plain(cells, dev)
    assert got[::7].all() and got.sum() == len(cells[::7])


def test_oncurve_kernel_rejects_what_it_does_not_take(dev):
    xy = torch.from_numpy(edge_cells()).to(dev)
    with pytest.raises(ValueError):
        cv.oncurve_mask(xy.to(torch.int32))
    with pytest.raises(ValueError):
        cv.oncurve_mask(xy[:, :, :8])
    with pytest.raises(ValueError):
        cv.oncurve_mask(xy.transpose(1, 2).contiguous().transpose(1, 2))
    assert cv.oncurve_mask(xy[:0]).shape == (0,)
    for limb in (-1, 1 << 17, 1 << 32):  # outside [0, 2^17): flagged
        bad = xy.clone()
        bad[3, 1, 5] = limb
        with pytest.raises(ValueError, match="limbs in"):
            cv.oncurve_mask(bad)
    top = xy.clone()
    top[:, :, 0] = (1 << 17) - 1  # the largest limb in contract
    assert torch.equal(cv.oncurve_mask(top), cv.oncurve_mask_plain(top))


def test_plane_card_matches_cpu_bit_for_bit(dev, monkeypatch):
    rng = np.random.default_rng(4)
    n = 40
    a = [int(v) for v in rng.integers(1, 2**62, n)]
    b = [int(v) for v in rng.integers(1, 2**62, n)]
    grid = grid_bytes(a, b, prim.fixed_base_mult)
    assert grid_bytes(a[:3], b[:3], prim.fixed_base_mult,
                      device="cpu").tobytes() == grid[:3].tobytes()
    bad = grid.copy()
    bad[7, 3] ^= 1
    wave = [grid, bad, grid]
    monkeypatch.setenv("BISCOTTI_PALLAS_CRYPTO", "1")
    before = cv.oncurve_mask.launches
    mask, summed = prim.grid_validate_sum(wave)
    assert cv.oncurve_mask.launches == before + 1
    cmask, csummed = prim.grid_validate_sum(wave, device="cpu")
    assert mask.tolist() == cmask.tolist() == [True, False, True]
    assert np.array_equal(summed, csummed)
    acc = prim.ext_add(summed, summed)
    assert np.array_equal(acc, prim.ext_add(summed, summed, device="cpu"))
    gam = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    rhs = prim.msm(gam, acc)
    assert rhs == prim.msm(gam, acc, device="cpu")
    m = 4  # two valid grids, summed twice
    lhs = prim.pedersen_commit_point(m * sum(g * x for g, x in zip(gam, a)),
                                     m * sum(g * y for g, y in zip(gam, b)))
    assert ed.point_equal(lhs, rhs)
    pinv = np.linalg.pinv(np.vander(np.arange(15) - 10, 10, increasing=True)
                          .astype(np.float64))
    coeffs = rng.integers(-1000, 1000, (785, 10))
    agg = np.vander(np.arange(15) - 10, 10, increasing=True) @ coeffs.T
    assert np.array_equal(prim.shamir_recover(pinv, agg), coeffs)


# --------------------------------- slice 3: CNNs and defenses on the card


def test_cnn_step_card_matches_cpu(dev):
    from biscotti_tpu_torch.models.base import fp32_math
    from biscotti_tpu_torch.models.trainer import local_step_fn
    from biscotti_tpu_torch.models.zoo import MODELS

    for family, dataset in (("mnist_cnn", "mnist"), ("cifar_cnn", "cifar"),
                            ("lfw_cnn", "lfw")):
        model = MODELS[family](dataset)
        w = model.flat_init(torch.Generator().manual_seed(1))
        gen = torch.Generator().manual_seed(2)
        x = torch.randn(4, 10, model.d_in, generator=gen)
        y = torch.randint(0, model.n_classes, (4, 10), generator=gen)
        step = torch.func.vmap(local_step_fn(model, "grad"), in_dims=(None, 0, 0))
        with fp32_math():
            got = step(w.to(dev), x.to(dev), y.to(dev)).cpu()
        ref = step(w, x, y)
        scale = float(ref.abs().max())
        assert torch.allclose(got, ref, rtol=RTOL, atol=RTOL * scale), family


def test_multikrum_runs_b1_in_the_window(dev):
    from biscotti_tpu_torch.ops.robust_agg import multikrum_accept_mask, multikrum_m

    gen = torch.Generator(device=dev).manual_seed(5)
    n, d = 716, 7850
    x = torch.randn(n, d, generator=gen, device=dev)
    x[:200] += 0.3  # a displaced group
    f = default_num_adversaries(n)
    before = krum_cuda.krum_scores_kernel.launches
    mask = multikrum_accept_mask(x, f)
    assert krum_cuda.krum_scores_kernel.launches == before + 1
    plain = krum_cuda.krum_scores_plain(x, f)
    keep = torch.sort(plain, stable=True).indices[:multikrum_m(n, f)]
    want = torch.zeros(n, dtype=torch.bool, device=dev)
    want[keep] = True
    assert torch.equal(mask, want)


def test_foolsgold_and_trimmed_mean_card_match_cpu(dev):
    from biscotti_tpu_torch.ops import robust_agg as ra

    rng = np.random.default_rng(6)
    x = rng.normal(0.0, 1.0, (70, 512)).astype(np.float32)
    x[49:] += rng.normal(0.0, 1.0, (1, 512)).astype(np.float32)  # a cluster
    cpu = torch.from_numpy(x)
    card = cpu.to(dev)
    assert torch.equal(ra.foolsgold_accept_mask(card).cpu(),
                       ra.foolsgold_accept_mask(cpu))
    assert torch.allclose(ra.foolsgold_weights(card).cpu(),
                          ra.foolsgold_weights(cpu), rtol=1e-5, atol=1e-5)
    for t in (0.0, 0.35, 0.49):
        assert torch.allclose(ra.trimmed_mean_aggregate(card, t).cpu(),
                              ra.trimmed_mean_aggregate(cpu, t),
                              rtol=1e-5, atol=1e-4)
    assert torch.allclose(ra.median_aggregate(card).cpu(),
                          ra.median_aggregate(cpu), rtol=1e-6, atol=1e-6)


def test_kernel_at_the_mnist_cnn_width_is_bit_identical(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    n, d = 716, 164_266
    x = torch.randn(n, d, generator=gen, device=dev)
    f = default_num_adversaries(n)
    first = krum_cuda.krum_scores_kernel(x, f)
    assert torch.equal(first, krum_cuda.krum_scores_kernel(x, f))
    assert _rel_err(first, krum_cuda.krum_scores_plain(x, f)) < RTOL


# ---------------------------- slice 4: the seams that call the crypto plane


def _armed_run(device, fn):
    """fn() with the crypto plane armed on `device` (None: disarmed)."""
    from biscotti_tpu_torch.crypto import kernels

    if device is not None:
        kernels.set_enabled(True, device=device)
    try:
        return fn()
    finally:
        kernels.set_enabled(False)


def _vss_instance(seed=7, k=5, c=6, s=4):
    from biscotti_tpu_torch.crypto import commitments as cm

    rng = np.random.default_rng(seed)
    chunks = rng.integers(-200, 200, (c, k)).astype(np.int64)
    comms, blinds = cm.vss_commit_chunks(chunks, b"seed" * 8, b"ctx")
    xs = list(range(1, s + 1))
    rows = np.stack([[cm.eval_poly(chunks[ci], x) for ci in range(c)]
                     for x in xs]).astype(np.int64)
    br = cm.vss_blind_rows(blinds, xs)
    ent = bytes(rng.integers(0, 256, 16 * s * c, dtype=np.uint8))
    return comms, rows, br, xs, ent, (s, c, k)


@pytest.mark.parametrize("case", ["honest", "off_curve", "bad_row", "waves"])
def test_vss_intake_card_matches_cpu(dev, case, monkeypatch):
    """The intake triples (rejected sids a fold, settle, members) armed on
    the card equal those armed on the CPU and disarmed; B2 once a fold."""
    from biscotti_tpu_torch.crypto import commitments as cm

    comms, rows, br, xs, ent, dims = _vss_instance()
    badc = comms.copy()
    badc[0, 0, 0] ^= 1
    rows_bad = rows.copy()
    rows_bad[0, 0] += 1
    good = (comms, rows, br)
    waves, want = {
        "honest": ([{1: good, 2: good}], ([[]], True, [1, 2])),
        "off_curve": ([{1: good, 2: (badc, rows, br)}], ([[2]], True, [1])),
        "bad_row": ([{1: (comms, rows_bad, br)}], ([[]], False, [1])),
        "waves": ([{1: good, 2: good}, {3: (badc, rows, br)}, {4: good}],
                  ([[], [3], []], True, [1, 2, 4]))}[case]

    def run():
        acc = cm.VssIntakeBatch(*dims, entropy=ent)
        rejected = []
        for wave in waves:
            for sid, member in wave.items():
                assert acc.add(sid, *member)
            rejected.append(acc.fold())
        return rejected, acc.verify(xs), sorted(acc.members())

    monkeypatch.setenv("BISCOTTI_PALLAS_CRYPTO", "1")
    before = cv.oncurve_mask.launches
    on_card = _armed_run(dev, run)
    assert cv.oncurve_mask.launches == before + len(waves)
    assert on_card == _armed_run("cpu", run) == _armed_run(None, run) == want


def test_batch_verifiers_card_match_cpu(dev):
    from biscotti_tpu_torch.crypto import commitments as cm

    rng = np.random.default_rng(5)
    key = cm.CommitKey.generate(30, label=b"cryptokernel-test")
    items = [(cm.commit_update(q, key), q) for q in (
        rng.integers(-500, 500, 30).astype(np.int64) for _ in range(4))]
    ent = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    bad = list(items)
    bad[2] = (bad[2][0], bad[2][1] + 1)
    seeds = [bytes([i]) * 32 for i in range(4)]
    trips = [(ed.public_key(s), b"m", cm.schnorr_sign(s, b"m")) for s in seeds]
    tampered = trips[:1] + [(trips[1][0], b"x", trips[1][2])] + trips[2:]

    def run():
        return (cm.batch_verify_commitments(items, key, entropy=ent),
                cm.batch_verify_commitments(bad, key, entropy=ent),
                cm.batch_schnorr_verify(trips),
                cm.batch_schnorr_verify(tampered))

    assert _armed_run(dev, run) == _armed_run(None, run) \
        == (True, False, True, False)


def test_recover_coeffs_card_matches_cpu(dev):
    from biscotti_tpu_torch.ops import secretshare as ss

    rng = np.random.default_rng(11)
    qs = rng.integers(-10**4, 10**4, (35, 7850)).astype(np.int64)
    agg = ss.aggregate_shares(np.stack([ss.make_shares(q, 10, 21)
                                        for q in qs]))
    xs = ss.share_xs(21)

    def run():
        return ss.recover_update(agg, xs, 7850)

    on_card = _armed_run(dev, run)
    assert np.array_equal(on_card, _armed_run("cpu", run))
    assert np.array_equal(on_card, _armed_run(None, run))
    assert np.array_equal(on_card, qs.sum(axis=0) / 10.0 ** 4)


@pytest.mark.parametrize("model", ["", "mnist_cnn"])
def test_hive_stepper_batch_card_matches_cpu(dev, model):
    """One HiveStepper batch on the card equals the CPU port's on the same
    draws (the card's own batch rows and normals), rtol 1e-4; the draws
    are pure in (seed, peer, iteration) on each device."""
    from biscotti_tpu_torch.config import BiscottiConfig
    from biscotti_tpu_torch.runtime.hive import HiveStepper

    cfg = BiscottiConfig(dataset="mnist", model_name=model, num_nodes=12,
                         noising=True, epsilon=1.0, batch_size=10, seed=3)
    ids = range(2, 10)
    card = HiveStepper(cfg, ids, device=dev)
    cpu = HiveStepper(cfg, ids, device="cpu")
    w = torch.from_numpy(np.random.default_rng(0).normal(
        0.0, 0.05, card.num_params).astype(np.float32))
    idx = card.draw_batches(1)
    assert torch.equal(idx, card.draw_batches(1))
    got = card.deltas_from_draws(w, idx).cpu()
    want = cpu.deltas_from_draws(w, idx.cpu())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * float(
        want.abs().max()))
    z = card.draw_noise(1)
    torch.testing.assert_close(card.noise_from_draws(z).cpu(),
                               cpu.noise_from_draws(z.cpu()), rtol=1e-6,
                               atol=0.0)
