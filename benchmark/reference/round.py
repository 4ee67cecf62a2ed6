"""One federated round of Biscotti's simulator, plain.

    deltas_i = −clip₁₀₀(∇ CE(w; contributor i's minibatch))
    noised_i = deltas_i + noise_i          (what the verifiers see)
    mask     = the committee's decision over the noised updates
    w'       = w + the miner's aggregate of the raw deltas
    stake'   = stake ± 5 for each contributor, by its verdict
    errors   = test rows that w' puts in the wrong class

`Model` binds one of the reference's model files to its flat layout.
The local steps run in blocks of contributors, so the reference fits on
the card beside nothing else at the timed sizes.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from . import defense
from .draws import sigma
from .nets import Leaf, Precision, cross_entropy_sum, leaf_slices, num_params

STAKE_UNIT = 5
GRAD_CLIP = 100.0


@dataclass(frozen=True)
class Model:
    name: str
    leaves: List[Leaf]
    logits: Callable
    block: int  # contributors a block of the local step

    @property
    def d(self) -> int:
        return num_params(self.leaves)


def model(name: str, block: int) -> Model:
    mod = importlib.import_module(f"benchmark.reference.{name}")
    return Model(name, mod.LEAVES, mod.logits, block)


def local_deltas(m: Model, prec: Precision, w: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """deltas[S, d]: each contributor's clipped, negated gradient of its
    own mean loss at w, on its rows x[S, B, d_in], y[S, B]."""
    out = []
    slices = leaf_slices(m.leaves)
    for a in range(0, x.shape[0], m.block):
        xb = x[a:a + m.block].to(prec.dtype)
        sb = xb.shape[0]
        p = {name: w[sl].reshape(shape).expand((sb,) + shape).clone()
             .requires_grad_(True)
             for (name, sl), (_, shape, _) in zip(slices, m.leaves)}
        with torch.enable_grad():
            loss = cross_entropy_sum(m.logits(prec, p, xb), y[a:a + m.block])
            grads = torch.autograd.grad(loss, list(p.values()))
        g = torch.cat([gi.reshape(sb, -1) for gi in grads], dim=1)
        norm = torch.linalg.vector_norm(g, dim=1, keepdim=True)
        out.append(-g * torch.clamp(GRAD_CLIP / norm.clamp_min(1e-12), max=1.0))
    return torch.cat(out)


def wrong_rows(m: Model, prec: Precision, w: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor, block: int = 500) -> int:
    """Test rows whose largest logit (the first, on ties) is not their
    label."""
    p = {name: w[sl].reshape((1,) + shape)
         for (name, sl), (_, shape, _) in zip(leaf_slices(m.leaves), m.leaves)}
    wrong = 0
    for a in range(0, x.shape[0], block):
        z = m.logits(prec, p, x[None, a:a + block].to(prec.dtype))[0]
        wrong += int((torch.argmax(z, dim=-1) != y[a:a + block]).sum())
    return wrong


@dataclass
class RoundOut:
    w: torch.Tensor  # w' [d]
    stake: torch.Tensor  # stake' [N]
    mask: torch.Tensor  # the decision this precision takes [S]
    margin: torch.Tensor  # each update's distance from its threshold [S]
    wrong: int  # test rows w' gets wrong


def round_from_draws(m: Model, prec: Precision, settings: dict, w, stake,
                     cidx, x, y, normals, x_test, y_test,
                     follow: Optional[torch.Tensor] = None) -> RoundOut:
    """One round from its draws (contributors cidx, their rows x, y, the
    noise's normals or None) under the program's `settings` (the cell's).
    `follow`, where given, is the accept mask the aggregate and the
    stakes take instead of this precision's own: the judged program's,
    once the comparison has judged it."""
    deltas = local_deltas(m, prec, w, x, y)
    noised = deltas
    if normals is not None:
        b = settings["batch_size"]
        scale = sigma(settings["epsilon"], settings["delta"]) * b ** 0.5 * (-1.0 / b)
        noised = deltas + normals.to(prec.dtype) * scale
    rule = defense.rule(settings["defense"])
    mask, margin = rule.decide(prec, noised)
    used = mask if follow is None else follow.to(mask.device)
    w_next = w + rule.aggregate(used, deltas, settings)
    unit = torch.where(used, STAKE_UNIT, -STAKE_UNIT).to(stake.dtype)
    stake_next = stake.index_add(0, cidx.to(stake.device), unit.to(stake.device))
    return RoundOut(w_next, stake_next, mask, margin,
                    wrong_rows(m, prec, w_next, x_test, y_test))
