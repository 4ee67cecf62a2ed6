"""Per-contributor step rules (counterpart of `biscotti_tpu/models/trainer.py`).

Two step rules, matching the reference's two stacks:

  * "grad": delta = −clip₁₀₀(∇CE(w; minibatch))   (ref: client.py:38-65)
  * "sgd":  delta = −α·∇f(w; minibatch), f the L2-regularized logistic
            loss (ref: logistic_model.py:113-140)

`local_step_fn` returns the step of ONE contributor. The simulator batches it
over contributors with `torch.func.vmap`, so each contributor gets the
gradient of its own minibatch loss (never the gradient of a summed loss,
which would be the sum of the gradients).
"""

from __future__ import annotations

from typing import Callable

import torch

from biscotti_tpu_torch.models.base import Model

GRAD_CLIP = 100.0  # ref: client.py:56; cfg.grad_clip overrides
LOGREG_ALPHA = 1e-2  # ref: logistic_model.py:12; cfg.logreg_alpha overrides


def clip_by_global_norm(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    n = torch.linalg.vector_norm(g)
    return g * torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)


def local_step_fn(model: Model, mode: str = "grad", clip: float = GRAD_CLIP,
                  alpha: float = LOGREG_ALPHA) -> Callable:
    """Pure per-contributor rule: (flat_w, x_batch, y_batch) -> flat_delta."""
    grad = torch.func.grad(model.loss_flat)
    if mode == "grad":

        def step(flat_w, x, y):
            return -clip_by_global_norm(grad(flat_w, x, y), clip)

    elif mode == "sgd":

        def step(flat_w, x, y):
            return -alpha * grad(flat_w, x, y)

    else:
        raise ValueError(f"unknown step mode {mode!r}")
    return step


def sample_batch(gen: torch.Generator, n: int, batch_size: int,
                 count: int) -> torch.Tensor:
    """`count` minibatches of min(batch_size, n) row indices, each drawn
    without replacement from range(n) (ref: logistic_model.py:121-125, torch
    DataLoader shuffle). Row r is the first entries of a uniform random
    permutation: the order of `count` iid uniform keys."""
    keys = torch.rand(count, n, generator=gen, device=gen.device)
    return torch.argsort(keys, dim=1)[:, :min(batch_size, n)]
