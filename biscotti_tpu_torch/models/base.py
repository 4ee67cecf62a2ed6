"""Flat-vector model abstraction (counterpart of `biscotti_tpu/models/base.py`).

The framework's wire unit is one flat float32 vector. The reference flattens
its parameter dict with `ravel_pytree`, which orders dict leaves by sorted
key and ravels each leaf row-major. The port reads and writes exactly that
layout: a dense layer `{"b": [k], "w": [d_in, k]}` is `b` followed by `w`,
row-major, `[d_in, d_out]`.

Every function here is pure in its tensors, so `torch.func.vmap` and
`torch.func.grad` batch it over contributors (see models/trainer.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Model:
    name: str
    d_in: int
    n_classes: int
    num_params: int
    # (flat_w[num_params], x[B, d_in]) -> logits[B, n_classes]
    apply_flat: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    # (flat_w, x[B, d_in], y[B]) -> mean scalar loss
    loss_flat: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

    def error_flat(self, flat_w: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
        """1 − accuracy (ref: ML/Pytorch/client.py:136-160). Ties in the
        logits go to the first class, as `jnp.argmax` sends them."""
        pred = torch.argmax(self.apply_flat(flat_w, x), dim=-1)
        return (pred != y).to(torch.float32).mean()


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch (ref: nn.CrossEntropyLoss, client.py:29)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, y[:, None].long()).mean()


def multiclass_hinge(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Crammer–Singer hinge for the SVM model (ref: ML/Pytorch/svm_model.py).
    The true class's own margin is zeroed, as the reference's `.at[].set(0)`."""
    yi = torch.gather(logits, -1, y[:, None].long())
    margins = torch.clamp(1.0 + logits - yi, min=0.0)
    own = torch.arange(logits.shape[-1], device=logits.device) == y[:, None]
    margins = torch.where(own, torch.zeros_like(margins), margins)
    return margins.sum(dim=-1).mean()
