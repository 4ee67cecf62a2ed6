"""Model zoo (counterpart of `biscotti_tpu/models/zoo.py`).

  softmax    linear d_in→k                (ref: softmax_model.py:7-24; mnist 7,850 params)
  logreg     L2 binary logistic, y∈{−1,1} (ref: ML/code/logistic_model.py:92-106)
  svm        linear + multiclass hinge     (ref: svm_model.py)
  mnist_cnn  conv(1→16,5,pad 4)+relu+fc   (ref: mnist_cnn_model.py:7-41; 164,266 params)
  cifar_cnn  LeNet-5 shape                 (ref: cifar_cnn_model.py; 62,006 params)
  lfw_cnn    small conv net over 62×47×3   (ref: lfw_cnn_model.py; 133,000 params)

Flat layouts follow the reference's `ravel_pytree` order (models/base.py):
softmax and svm are `b[k]` then `w[d_in, k]` row-major; logreg is its one
`w[d_in + 1]` leaf, the last entry weighting the bias column; the CNNs are
their layers in sorted-key order, each `b` then `w`, conv weights HWIO:

  mnist_cnn  conv.b[16], conv.w[5,5,1,16], fc.b[10], fc.w[16384,10]
  cifar_cnn  c1 [5,5,3,6], c2 [5,5,6,16], f1 [400→120], f2 [120→84], f3 [84→10]
  lfw_cnn    c1 [5,5,3,6], c2 [5,5,6,16], f1 [1536→84], f3 [84→12]

The reference computes in NHWC with HWIO kernels. Inside `apply` the input
becomes NCHW, each HWIO kernel OIHW (`permute(3, 2, 0, 1)`), and the last
feature map goes back to NHWC before it is flattened into the first dense
layer, so the dense rows keep the reference's order. Every function is
built from slices of the flat vector and `torch.nn.functional`, so
`torch.func.vmap(grad)` batches it.

A convolution is one matmul over its im2col columns, not
`F.conv2d`: under `vmap(grad)` each contributor's weight gradient becomes a
grouped convolution, and the algorithms cuDNN picks for those were 2e-4
(cifar_cnn) and 3e-3 (lfw_cnn) off float64 on the H100, TF32 off and
deterministic or not, where a matmul is 1e-7 off, as on the CPU
(`python -m biscotti_tpu_torch.tools.conv_precision`). So the forward and
both gradients run as cuBLAS fp32 GEMMs.

The columns are one copy of `Tensor.unfold` window views (`_columns`).
Where a conv reads an activation (the LeNets' c2), the gradient reaches
its input back through those windows. Autograd's adjoint of the views is
`unfold_backward`, which has no vmap batching rule, so `vmap(grad)` ran it
contributor by contributor (1,432 launches a round at 716 contributors).
Such a conv takes its columns through `_Windows`, whose adjoint is col2im
(`F.fold`): its batching rule folds the contributors into its batch, one
launch a conv, each input pixel the sum of its ≤ k² window entries in a
fixed order. A conv that reads the data needs no adjoint and takes
`_columns` alone. The forward stays the view unfold: `F.unfold` (im2col)
launches once a sample on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from biscotti_tpu_torch.data.datasets import base_name, spec as dspec
from biscotti_tpu_torch.models.base import (Leaf, Model, add_bias,
                                            cross_entropy, multiclass_hinge,
                                            unravel)


def _dense_leaves(name: str, d_in: int, d_out: int) -> Tuple[Leaf, ...]:
    prefix = f"{name}." if name else ""
    return (Leaf(prefix + "b", (d_out,)),
            Leaf(prefix + "w", (d_in, d_out), "uniform"))


def _conv_leaves(name: str, k: int, c_in: int, c_out: int) -> Tuple[Leaf, ...]:
    return (Leaf(f"{name}.b", (c_out,)),
            Leaf(f"{name}.w", (k, k, c_in, c_out), "normal"))


def _num(leaves: Tuple[Leaf, ...]) -> int:
    return sum(leaf.size for leaf in leaves)


def _dense_apply(d_in: int, k: int) -> Callable:
    def apply(flat_w, x):
        b = flat_w[:k]
        w = flat_w[k:].reshape(d_in, k)
        return add_bias(x.reshape(x.shape[0], d_in) @ w, b)

    return apply


def softmax_model(d_in: int, n_classes: int) -> Model:
    apply = _dense_apply(d_in, n_classes)

    def loss(flat_w, x, y):
        return cross_entropy(apply(flat_w, x), y)

    leaves = _dense_leaves("", d_in, n_classes)
    return Model("softmax", d_in, n_classes, _num(leaves), apply, loss, leaves)


def svm_model(d_in: int, n_classes: int) -> Model:
    apply = _dense_apply(d_in, n_classes)

    def loss(flat_w, x, y):
        return multiclass_hinge(apply(flat_w, x), y)

    leaves = _dense_leaves("", d_in, n_classes)
    return Model("svm", d_in, n_classes, _num(leaves), apply, loss, leaves)


def logreg_model(d_in: int, lammy: float = 0.01) -> Model:
    """Binary L2 logistic regression on ±1 labels with a bias feature
    (ref: logistic_model.py:8-13,92-106; bias column added by utils.py)."""

    def _with_bias(x):
        ones = torch.ones(x.shape[0], 1, dtype=x.dtype, device=x.device)
        return torch.cat([x, ones], dim=1)

    def apply(flat_w, x):
        # two-column logits so argmax-style error code works unchanged
        z = _with_bias(x) @ flat_w
        return torch.stack([-z, z], dim=-1)

    def loss(flat_w, x, y):
        # mean(logaddexp(0, −y·Xw)) + λ/2‖w‖², whose gradient is the
        # reference's (1/B)·Xᵀres + λw (data term batch-averaged, L2 not)
        ypm = 2.0 * y.to(torch.float32) - 1.0
        t = -ypm * (_with_bias(x) @ flat_w)
        return (torch.logaddexp(torch.zeros_like(t), t).mean()
                + 0.5 * lammy * torch.dot(flat_w, flat_w))

    leaves = (Leaf("w", (d_in + 1,)),)
    return Model("logreg", d_in, 2, d_in + 1, apply, loss, leaves)


# ------------------------------------------------------------------ CNNs


def _columns(h: torch.Tensor, k: int) -> torch.Tensor:
    """The im2col columns [n, C·k·k, L] of an NCHW batch (stride 1), rows in
    (c, i, j) order."""
    n, c_in = h.shape[:2]
    # [n, C, Ho, Wo, k, k] windows as a view, then one copy into columns
    return h.unfold(2, k, 1).unfold(3, k, 1).permute(0, 1, 4, 5, 2, 3) \
        .reshape(n, c_in * k * k, -1)


class _Windows(torch.autograd.Function):
    """`_columns` with col2im (`F.fold`) as its adjoint."""

    generate_vmap_rule = True
    forward = staticmethod(_columns)

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, k = inputs
        ctx.k, ctx.hw = k, tuple(h.shape[2:])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return F.fold(g, ctx.hw, ctx.k), None


def _conv(h: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
          padding: int = 0) -> torch.Tensor:
    """NCHW activations through the reference's HWIO kernel and bias (stride
    1), as a matmul of the OIHW kernel, flattened in (c, i, j) order, with
    the im2col columns [n, C·k·k, L] in the same row order."""
    w = p[f"{name}.w"]
    k, c_out = w.shape[0], w.shape[3]
    if padding:
        h = F.pad(h, (padding,) * 4)
    n, _, height, width = h.shape
    # the Function's dispatch costs the host ~1 ms a call under vmap(grad):
    # only a conv whose input takes a gradient pays it
    cols = _Windows.apply(h, k) if h.requires_grad else _columns(h, k)
    out = w.permute(3, 2, 0, 1).reshape(c_out, -1) @ cols + p[f"{name}.b"][:, None]
    return out.reshape(n, c_out, height - k + 1, width - k + 1)


def _nchw(x: torch.Tensor, hw: Tuple[int, int], chans: int) -> torch.Tensor:
    """The reference's flat NHWC input rows as an NCHW batch."""
    return x.reshape(x.shape[0], hw[0], hw[1], chans).permute(0, 3, 1, 2)


def _flat_nhwc(h: torch.Tensor) -> torch.Tensor:
    """An NCHW feature map flattened in the reference's NHWC order."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def _dense(h: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return add_bias(h @ p[f"{name}.w"], p[f"{name}.b"])


def _cnn_model(name: str, d_in: int, n_classes: int, leaves: Tuple[Leaf, ...],
               body: Callable, act_floats: int) -> Model:
    def apply(flat_w, x):
        return body(unravel(leaves, flat_w), x)

    def loss(flat_w, x, y):
        return cross_entropy(apply(flat_w, x), y)

    return Model(name, d_in, n_classes, _num(leaves), apply, loss, leaves,
                 act_floats)


def mnist_cnn_model() -> Model:
    """conv(1→16, 5×5, stride 1, pad 4) + relu + fc(16·32·32→10)
    (ref: mnist_cnn_model.py:12-16,31-41, the "ONE LAYER" branch;
    MaxPool2d(1) is the identity, so it is omitted)."""
    leaves = _conv_leaves("conv", 5, 1, 16) + _dense_leaves("fc", 16 * 32 * 32, 10)

    def body(p, x):
        h = torch.relu(_conv(_nchw(x, (28, 28), 1), p, "conv", padding=4))
        return _dense(_flat_nhwc(h), p, "fc")

    return _cnn_model("mnist_cnn", 784, 10, leaves, body, 1 * 25 * 32 * 32)


def _lenet_features(p, x, hw, chans):
    """Two VALID 5×5 convs, each with relu and a floor 2×2 max pool (the
    reference's reduce_window VALID), flattened in NHWC order."""
    h = _nchw(x, hw, chans)
    for name in ("c1", "c2"):
        h = F.max_pool2d(torch.relu(_conv(h, p, name)), 2, 2)
    return _flat_nhwc(h)


def cifar_cnn_model() -> Model:
    """LeNet-5: conv(3→6,5) pool conv(6→16,5) pool fc120 fc84 fc10
    (ref: cifar_cnn_model.py; BASELINE.md row "CIFAR LeNet")."""
    leaves = (_conv_leaves("c1", 5, 3, 6) + _conv_leaves("c2", 5, 6, 16)
              + _dense_leaves("f1", 16 * 5 * 5, 120)
              + _dense_leaves("f2", 120, 84) + _dense_leaves("f3", 84, 10))

    def body(p, x):
        h = _lenet_features(p, x, (32, 32), 3)
        for name in ("f1", "f2"):
            h = torch.relu(_dense(h, p, name))
        return _dense(h, p, "f3")

    return _cnn_model("cifar_cnn", 3072, 10, leaves, body, 3 * 25 * 28 * 28)


def lfw_cnn_model() -> Model:
    """Small LeNet-shape net over 62×47×3 gender/face classes
    (ref: lfw_cnn_model.py): 62×47 → conv5 58×43 → pool 29×21 → conv5
    25×17 → pool 12×8 (the pool floors), so f1 takes 16·12·8 = 1,536."""
    leaves = (_conv_leaves("c1", 5, 3, 6) + _conv_leaves("c2", 5, 6, 16)
              + _dense_leaves("f1", 16 * 12 * 8, 84)
              + _dense_leaves("f3", 84, 12))

    def body(p, x):
        h = torch.relu(_dense(_lenet_features(p, x, (62, 47), 3), p, "f1"))
        return _dense(h, p, "f3")

    return _cnn_model("lfw_cnn", 8742, 12, leaves, body, 3 * 25 * 58 * 43)


MODELS: Dict[str, Callable[[str], Model]] = {
    "softmax": lambda ds: softmax_model(dspec(ds).d_in, dspec(ds).n_classes),
    "logreg": lambda ds: logreg_model(dspec(ds).d_in),
    "svm": lambda ds: svm_model(dspec(ds).d_in, dspec(ds).n_classes),
    "mnist_cnn": lambda ds: mnist_cnn_model(),
    "cifar_cnn": lambda ds: cifar_cnn_model(),
    "lfw_cnn": lambda ds: lfw_cnn_model(),
}


def model_for_dataset(dataset: str, model: str = "") -> Model:
    """Default model per dataset, as the reference pairs them (softmax for
    the image sets, logreg for creditcard)."""
    if model:
        return MODELS[model](dataset)
    if base_name(dataset) == "creditcard":
        return logreg_model(dspec(dataset).d_in)
    return softmax_model(dspec(dataset).d_in, dspec(dataset).n_classes)
