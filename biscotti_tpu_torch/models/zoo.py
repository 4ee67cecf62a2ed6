"""Model zoo, linear families (counterpart of `biscotti_tpu/models/zoo.py`).

  softmax  linear d_in→k                (ref: softmax_model.py:7-24; mnist 7,850 params)
  logreg   L2 binary logistic, y∈{−1,1} (ref: ML/code/logistic_model.py:92-106)
  svm      linear + multiclass hinge     (ref: svm_model.py)

Flat layouts follow the reference's `ravel_pytree` order (models/base.py):
softmax and svm are `b[k]` then `w[d_in, k]` row-major; logreg is its one
`w[d_in + 1]` leaf, the last entry weighting the bias column.

The CNN families (mnist_cnn, cifar_cnn, lfw_cnn) are not ported yet
(ROADMAP.md Queue A, item A2).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from biscotti_tpu_torch.data.datasets import base_name, spec as dspec
from biscotti_tpu_torch.models.base import Model, cross_entropy, multiclass_hinge


def _dense_apply(d_in: int, k: int) -> Callable:
    def apply(flat_w, x):
        b = flat_w[:k]
        w = flat_w[k:].reshape(d_in, k)
        return x.reshape(x.shape[0], d_in) @ w + b

    return apply


def softmax_model(d_in: int, n_classes: int) -> Model:
    apply = _dense_apply(d_in, n_classes)

    def loss(flat_w, x, y):
        return cross_entropy(apply(flat_w, x), y)

    return Model("softmax", d_in, n_classes, d_in * n_classes + n_classes,
                 apply, loss)


def svm_model(d_in: int, n_classes: int) -> Model:
    apply = _dense_apply(d_in, n_classes)

    def loss(flat_w, x, y):
        return multiclass_hinge(apply(flat_w, x), y)

    return Model("svm", d_in, n_classes, d_in * n_classes + n_classes,
                 apply, loss)


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

    return Model("logreg", d_in, 2, d_in + 1, apply, loss)


def _not_ported(name: str) -> Callable:
    def build(dataset):
        raise NotImplementedError(
            f"model {name!r} is not ported to biscotti_tpu_torch yet "
            "(ROADMAP.md Queue A, item A2: the CNN families)")

    return build


MODELS: Dict[str, Callable[[str], Model]] = {
    "softmax": lambda ds: softmax_model(dspec(ds).d_in, dspec(ds).n_classes),
    "logreg": lambda ds: logreg_model(dspec(ds).d_in),
    "svm": lambda ds: svm_model(dspec(ds).d_in, dspec(ds).n_classes),
    "mnist_cnn": _not_ported("mnist_cnn"),
    "cifar_cnn": _not_ported("cifar_cnn"),
    "lfw_cnn": _not_ported("lfw_cnn"),
}


def model_for_dataset(dataset: str, model: str = "") -> Model:
    """Default model per dataset, as the reference pairs them (softmax for
    the image sets, logreg for creditcard)."""
    if model:
        return MODELS[model](dataset)
    if base_name(dataset) == "creditcard":
        return logreg_model(dspec(dataset).d_in)
    return softmax_model(dspec(dataset).d_in, dspec(dataset).n_classes)
