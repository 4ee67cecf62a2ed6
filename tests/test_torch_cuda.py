"""The port's CUDA kernels on the card (marker `cuda`; they skip without one).

Run on a machine with a GPU, where JAX is not installed, without the repo's
conftest (which imports JAX):

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py -q

Tolerance: rtol 1e-4 on Krum scores, as tests/test_krum_pallas.py holds the
TPU kernel (the kernel and the plain version sum in other orders).
"""

import pytest
import torch

from biscotti_tpu_torch.ops import krum_cuda
from biscotti_tpu_torch.ops.krum import default_num_adversaries, krum_accept_mask

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
                                 (511, 33), (1056, 70), (2000, 257)])
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
