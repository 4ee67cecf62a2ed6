"""RONI (Reject On Negative Influence) validation, batched over the round's
updates (counterpart of `biscotti_tpu/ops/roni.py`).

score_i = err(w + δ_i) − err(w) on the validation split; an update is
rejected when its score exceeds the threshold (ref:
ML/Pytorch/client_obj.py:100-112, DistSys/main.go:203-231).

The reference vmaps all n evaluations at once, which at CNN widths would
hold [n, |val|, activations] (~94 GB for mnist_cnn at n = 716 and 2,000
validation rows). The port scores the updates in chunks sized from the
device's free memory; each update's error is the same either way.
"""

from __future__ import annotations

from typing import Optional

import torch

from biscotti_tpu_torch.models.base import Model, fp32_math

RONI_THRESHOLD = 0.02  # ref: DistSys/main.go:203-231
# a layer's output, its activation and the next layer's input can be alive
# at once
_LIVE_COPIES = 3
_CPU_BUDGET_BYTES = 1 << 30


def roni_chunk(model: Model, n_val: int, n: int, device: torch.device) -> int:
    """Updates scored at once: half the card's free memory (1 GiB on the
    CPU) over one update's widest activation on the validation split."""
    per_update = 4 * n_val * max(model.act_floats, model.n_classes) * _LIVE_COPIES
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] // 2
    else:
        budget = _CPU_BUDGET_BYTES
    return max(1, min(n, budget // per_update))


def roni_scores(model: Model, flat_w: torch.Tensor, deltas: torch.Tensor,
                x_val: torch.Tensor, y_val: torch.Tensor,
                chunk: Optional[int] = None) -> torch.Tensor:
    """scores[i] = err(w + δ_i) − err(w) on the validation split, `chunk`
    updates at a time (`roni_chunk` when not given)."""
    n = deltas.shape[0]
    if chunk is None:
        chunk = roni_chunk(model, x_val.shape[0], n, deltas.device)
    per_update = torch.func.vmap(
        lambda d: model.error_flat(flat_w + d, x_val, y_val))
    with fp32_math():
        base = model.error_flat(flat_w, x_val, y_val)
        per = torch.cat([per_update(deltas[i:i + chunk])
                         for i in range(0, n, chunk)])
    return per - base


def roni_accept_mask(model: Model, flat_w: torch.Tensor, deltas: torch.Tensor,
                     x_val: torch.Tensor, y_val: torch.Tensor,
                     threshold: float = RONI_THRESHOLD,
                     chunk: Optional[int] = None) -> torch.Tensor:
    """Accept iff the update does not worsen validation error by more than
    the threshold."""
    return roni_scores(model, flat_w, deltas, x_val, y_val, chunk) <= threshold


def make_roni_kernel(model: Model, threshold: float = RONI_THRESHOLD):
    """(flat_w, deltas[n, d], x_val, y_val) -> mask[n], the reference's
    jitted kernel's signature."""

    def kernel(flat_w, deltas, x_val, y_val):
        return roni_accept_mask(model, flat_w, deltas, x_val, y_val, threshold)

    return kernel
