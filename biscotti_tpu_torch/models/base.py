"""Flat-vector model abstraction (counterpart of `biscotti_tpu/models/base.py`).

The framework's wire unit is one flat float32 vector. The reference flattens
its parameter dict with `ravel_pytree`, which orders dict leaves by sorted
key and ravels each leaf row-major. The port reads and writes exactly that
layout: a dense layer `{"b": [k], "w": [d_in, k]}` is `b` followed by `w`,
row-major, `[d_in, d_out]`; a conv layer is `b[O]` then `w[H, W, I, O]`
(HWIO), and nested layers come in sorted-key order (`c1.b, c1.w, c2.b, ...`).
A `Model` lists those leaves (`Leaf`: dotted name, shape, init law), so
`flat_init` and `unravel` read one table.

Every function here is pure in its tensors, so `torch.func.vmap` and
`torch.func.grad` batch it over contributors (see models/trainer.py).
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch


@dataclass(frozen=True)
class Leaf:
    """One parameter leaf of the reference's pytree, in ravel order. `law`
    is its init (`biscotti_tpu/models/zoo.py`): "zeros" (biases, logreg),
    "uniform" (dense weights, U(±1/√d_in), d_in = shape[0]) or "normal"
    (HWIO conv weights, N(0, 1)/√fan_in, fan_in = H·W·I)."""

    name: str
    shape: Tuple[int, ...]
    law: str = "zeros"

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def unravel(leaves: Tuple[Leaf, ...], flat_w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{name: view of flat_w in the leaf's shape}: slices of the one flat
    vector, so `torch.func.grad` and `vmap` see through them."""
    out, at = {}, 0
    for leaf in leaves:
        out[leaf.name] = flat_w[at:at + leaf.size].reshape(leaf.shape)
        at += leaf.size
    return out


# fp32_math's flags are process-wide and the live peer enters it from
# several worker threads at once (the speculative step, the serial step,
# the test error): the first thread in saves and clears them, the last one
# out restores them, so no thread's step runs on flags another thread
# restored (ROADMAP C9).
_FP32_LOCK = threading.Lock()
_FP32_DEPTH = 0
_FP32_SAVED = (False, False)


@contextlib.contextmanager
def fp32_math():
    """A context in which float32 math stays float32 on the card: TF32 off
    for matmuls, which is where the CNNs' convolutions run (models/zoo.py),
    and for cuDNN. Entry points wrap whole steps and evaluations in it, so
    the backward passes that `torch.func.grad` runs are covered too; the
    caller's settings come back once the last thread inside has left."""
    global _FP32_DEPTH, _FP32_SAVED
    with _FP32_LOCK:
        if _FP32_DEPTH == 0:
            _FP32_SAVED = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _FP32_DEPTH += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _FP32_DEPTH -= 1
            if _FP32_DEPTH == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _FP32_SAVED


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
    # the reference's leaves in ravel order (sizes sum to num_params)
    leaves: Tuple[Leaf, ...] = ()
    # floats one input row holds in the forward's widest tensor (0: the
    # logits; a CNN's first im2col columns); sizes batched evaluations such
    # as RONI's
    act_floats: int = 0

    def flat_init(self, gen: torch.Generator) -> torch.Tensor:
        """Random weights under the reference's init laws, in the flat
        layout (counterpart of `biscotti_tpu/models/base.py:36-37`), drawn
        from `gen` on its device. The draws are the port's own: the laws
        match the reference's, the numbers do not."""
        parts = []
        for leaf in self.leaves:
            if leaf.law == "zeros":
                v = torch.zeros(leaf.size, device=gen.device)
            elif leaf.law == "uniform":
                s = 1.0 / math.sqrt(leaf.shape[0])
                v = (2.0 * torch.rand(leaf.size, generator=gen,
                                      device=gen.device) - 1.0) * s
            elif leaf.law == "normal":
                fan_in = math.prod(leaf.shape[:-1])
                v = torch.randn(leaf.size, generator=gen,
                                device=gen.device) / math.sqrt(fan_in)
            else:
                raise ValueError(f"unknown init law {leaf.law!r}")
            parts.append(v)
        return torch.cat(parts)

    def error_flat(self, flat_w: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
        """1 − accuracy (ref: ML/Pytorch/client.py:136-160). Ties in the
        logits go to the first class, as `jnp.argmax` sends them."""
        pred = torch.argmax(self.apply_flat(flat_w, x), dim=-1)
        return (pred != y).to(torch.float32).mean()


class _BiasAdd(torch.autograd.Function):
    """y + b over the batch rows of y; b's gradient is the rows' sum in
    their order, one float32 add a row, as the reference's XLA reduce
    gives it. `torch.sum` over the rows (and `torch.cumsum`, which
    accumulates in double) rounds such a sum otherwise: at a zero-
    initialized model's first step the bias gradients are exact decimals
    (4 × 0.0125 − 4 × 0.1125 is −0.4f in order, −0.39999998 in torch's),
    whose quantization then parts (ROADMAP C15)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(y, b):
        return y + b

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        s = g[0]
        for r in range(1, g.shape[0]):
            s = s + g[r]
        return g, s


def add_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A dense layer's y [rows, k] + b [k]: on the CPU through `_BiasAdd`,
    the reference's order; on the card torch's own add, whose sums follow
    the card's order as its matrix products do (ROADMAP C10)."""
    if y.device.type == "cpu":
        return _BiasAdd.apply(y, b)
    return y + b


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """On the CPU `jax.nn.log_softmax` written out, so that autograd takes
    the reference's backward: shifted − log Σ exp(shifted), the max held
    constant. Its gradient is g − exp(shifted)·Σg/Σexp(shifted);
    `torch.log_softmax`'s is g − exp(log p)·Σg, and exp(log 0.1) is 0.1f
    less one ulp. At a zero-initialized CNN's first step the bias deltas
    are such exact decimals (−0.1f), whose quantization truncates to −999
    instead of the reference's −1000 (ROADMAP C15). On the card,
    `torch.log_softmax` (see `add_bias`)."""
    if logits.device.type != "cpu":
        return torch.log_softmax(logits, dim=-1)
    shifted = logits - logits.max(dim=-1, keepdim=True).values.detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch (ref: nn.CrossEntropyLoss, client.py:29)."""
    logp = log_softmax(logits)
    return -torch.gather(logp, -1, y[:, None].long()).mean()


def multiclass_hinge(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Crammer–Singer hinge for the SVM model (ref: ML/Pytorch/svm_model.py).
    The true class's own margin is zeroed, as the reference's `.at[].set(0)`."""
    yi = torch.gather(logits, -1, y[:, None].long())
    margins = torch.clamp(1.0 + logits - yi, min=0.0)
    own = torch.arange(logits.shape[-1], device=logits.device) == y[:, None]
    margins = torch.where(own, torch.zeros_like(margins), margins)
    return margins.sum(dim=-1).mean()
