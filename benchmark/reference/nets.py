"""Plain PyTorch pieces of the reference's models, in one precision.

`Precision` names the arithmetic: "fp64" is the reference (float64
throughout); "tf32" is its control, float32 whose every matrix product
takes its operands rounded to TF32's 10-bit mantissa and sums in float32,
forward and backward, as the card's TF32 tensor cores do. The rounding is
written out (`tf32_round`), so the control reads the same on the CPU and
on the card.

The models' weights arrive per contributor: each leaf is [S, *shape], and
one call computes S contributors' logits on their own rows x[S, B, d_in].
The backward of a contributor's own loss is the gradient of the sum over
contributors, since no weight is shared between them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits), ties to
    even; inf and NaN are not expected here."""
    i = t.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + 0x0FFF + lsb, ~0x1FFF)
    return i.view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """a @ b with TF32 operands in the forward and in both backward
    products; batch dimensions of a and b must be equal (no broadcast)."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg


@dataclass(frozen=True)
class Precision:
    name: str

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == "fp64" else torch.float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return _Tf32Matmul.apply(a, b)
        return a @ b


FP64 = Precision("fp64")
TF32 = Precision("tf32")

Leaf = Tuple[str, Tuple[int, ...], str]  # (name, shape, init law)


def leaf_size(leaf: Leaf) -> int:
    return math.prod(leaf[1])


def num_params(leaves: List[Leaf]) -> int:
    return sum(leaf_size(leaf) for leaf in leaves)


def unflatten(leaves: List[Leaf], flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """flat[S, d] in the flat layout to {name: [S, *shape]}."""
    out, at = {}, 0
    for name, shape, _ in leaves:
        n = math.prod(shape)
        out[name] = flat[:, at:at + n].reshape((flat.shape[0],) + shape)
        at += n
    return out


def flatten(leaves: List[Leaf], parts: Dict[str, torch.Tensor]) -> torch.Tensor:
    s = parts[leaves[0][0]].shape[0]
    return torch.cat([parts[name].reshape(s, -1) for name, _, _ in leaves], 1)


def leaf_slices(leaves: List[Leaf]) -> List[Tuple[str, slice]]:
    out, at = [], 0
    for leaf in leaves:
        out.append((leaf[0], slice(at, at + leaf_size(leaf))))
        at += leaf_size(leaf)
    return out


def nchw(x: torch.Tensor, hw: Tuple[int, int], chans: int) -> torch.Tensor:
    """Rows x[S, B, H·W·C] in NHWC order as an [S·B, C, H, W] batch."""
    s, b = x.shape[:2]
    return x.reshape(s * b, hw[0], hw[1], chans).permute(0, 3, 1, 2)


def conv(prec: Precision, h: torch.Tensor, s: int, w: torch.Tensor,
         bias: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """Stride-1 convolution of h[S·B, C, H, W] by each contributor's HWIO
    kernel w[S, k, k, C, O] and bias[S, O], as one product of the kernel
    with its im2col columns. Returns [S·B, O, Ho, Wo]."""
    k, c_in, c_out = w.shape[1], w.shape[3], w.shape[4]
    if padding:
        h = F.pad(h, (padding,) * 4)
    sb, _, height, width = h.shape
    b = sb // s
    ho, wo = height - k + 1, width - k + 1
    cols = F.unfold(h, k)  # [S·B, C·k·k, L], rows in (c, i, j) order
    cols = cols.reshape(s, b, c_in * k * k, ho * wo).permute(0, 2, 1, 3) \
        .reshape(s, c_in * k * k, b * ho * wo)
    kern = w.permute(0, 4, 3, 1, 2).reshape(s, c_out, c_in * k * k)
    out = prec.mm(kern, cols) + bias[:, :, None]  # [S, O, B·L]
    return out.reshape(s, c_out, b, ho, wo).permute(0, 2, 1, 3, 4) \
        .reshape(sb, c_out, ho, wo)


def flat_nhwc(h: torch.Tensor, s: int) -> torch.Tensor:
    """[S·B, C, H, W] flattened in NHWC order as [S, B, H·W·C]."""
    sb = h.shape[0]
    return h.permute(0, 2, 3, 1).reshape(s, sb // s, -1)


def dense(prec: Precision, h: torch.Tensor, w: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """h[S, B, F] @ w[S, F, K] + bias[S, K]."""
    return prec.mm(h, w) + bias[:, None, :]


def cross_entropy_sum(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ over contributors of each one's mean cross-entropy: logits[S, B, K],
    y[S, B]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, y[..., None]).squeeze(-1).mean(dim=1).sum()
