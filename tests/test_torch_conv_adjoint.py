"""The conv windows' adjoint (`models/zoo.py::_Windows`): one batched col2im
where autograd needs a conv input's gradient, with no per-contributor
fallback under `torch.func.vmap`.

Exactness: on integer-valued inputs every sum is exact in any order, so the
adjoint equals the gradient that autograd takes through the view unfold
(`zoo._columns`) bit for bit. The vmapped step against the unvmapped one,
contributor by contributor: rtol 1e-5, atol 1e-5 of the deltas' largest
entry (the batched and the per-contributor matmuls sum in other orders).
"""

import warnings

import pytest
import torch

from biscotti_tpu_torch.models import zoo
from biscotti_tpu_torch.models.trainer import local_step_fn

FAMILIES = [("softmax", "mnist"), ("logreg", "creditcard"), ("svm", "mnist"),
            ("mnist_cnn", "mnist"), ("cifar_cnn", "cifar"), ("lfw_cnn", "lfw")]

# (name, input [n, C, H, W], k): lfw's and cifar's c1 and c2, mnist's conv
# on its 4-padded input
CONVS = [("lfw_c1", (2, 3, 62, 47), 5), ("lfw_c2", (2, 6, 29, 21), 5),
         ("cifar_c1", (2, 3, 32, 32), 5), ("cifar_c2", (2, 6, 14, 14), 5),
         ("mnist_conv", (2, 1, 36, 36), 5)]


def _batch(model, s, b, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(s, b, model.d_in, generator=gen)
    y = torch.randint(0, model.n_classes, (s, b), generator=gen)
    return x, y


@pytest.mark.parametrize("family,dataset", FAMILIES)
def test_vmapped_step_runs_no_batching_fallback(family, dataset):
    model = zoo.MODELS[family](dataset)
    w = model.flat_init(torch.Generator().manual_seed(1))
    x, y = _batch(model, 3, 4, 2)
    step = torch.func.vmap(local_step_fn(model, "grad"), in_dims=(None, 0, 0))
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(w, x, y)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    fallbacks = [str(c.message) for c in caught if "batching rule" in str(c.message)]
    assert not fallbacks, fallbacks


@pytest.mark.parametrize("name,shape,k", CONVS)
def test_windows_adjoint_equals_view_unfold_gradient(name, shape, k):
    gen = torch.Generator().manual_seed(3)
    h = torch.randint(-8, 9, shape, generator=gen).float()
    cols_ref = zoo._columns(h, k)
    g = torch.randint(-8, 9, cols_ref.shape, generator=gen).float()
    a = h.clone().requires_grad_()
    cols = zoo._Windows.apply(a, k)
    (grad,) = torch.autograd.grad(cols, a, g)
    b = h.clone().requires_grad_()
    (grad_ref,) = torch.autograd.grad(zoo._columns(b, k), b, g)
    assert torch.equal(cols, cols_ref), name
    assert torch.equal(grad, grad_ref), name


@pytest.mark.parametrize("family,dataset", [("lfw_cnn", "lfw"), ("cifar_cnn", "cifar")])
def test_vmapped_cnn_step_equals_per_contributor_loop(family, dataset):
    model = zoo.MODELS[family](dataset)
    w = model.flat_init(torch.Generator().manual_seed(4))
    x, y = _batch(model, 5, 10, 5)
    step = local_step_fn(model, "grad")
    got = torch.func.vmap(step, in_dims=(None, 0, 0))(w, x, y)
    ref = torch.stack([step(w, x[i], y[i]) for i in range(x.shape[0])])
    scale = float(ref.abs().max())
    assert scale > 0
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * scale)
