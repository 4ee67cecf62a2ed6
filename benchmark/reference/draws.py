"""The round's random draws, restated.

A round's draws are defined by the simulator's published rule: a
`torch.Generator` on the round's device, seeded with the first 8 bytes of
sha256("biscotti_tpu_torch/<seed>/round/<it>") shifted right by one, from
which come, in this order: the contributors (the first S of a random
permutation of the N peers, or every peer when S >= N), each
contributor's minibatch (the first B rows of the order of its own
uniform keys over the shard's rows) and the DP noise (standard normals
[S, d], scaled by σ·√B·(−1/B)). The reference draws them again by that
rule, on the same device.
"""

from __future__ import annotations

import hashlib
import math

import torch


def stream_seed(*parts) -> int:
    h = hashlib.sha256("/".join(("biscotti_tpu_torch",) + tuple(map(str, parts)))
                       .encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def sigma(epsilon: float, delta: float) -> float:
    """The Gaussian mechanism's σ = √(2 ln(1.25/δ)) / ε."""
    if epsilon <= 0:
        return 0.0
    return math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def round_draws(device, seed: int, it: int, n: int, s: int, rows: int,
                batch: int, d: int, noise: bool):
    """(cidx[S], batch_idx[S, B], normals[S, d] or None) of round `it`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "round", it))
    if s >= n:
        cidx = torch.arange(n, device=device)
    else:
        cidx = torch.randperm(n, generator=gen, device=device)[:s]
    s = cidx.shape[0]
    keys = torch.rand(s, rows, generator=gen, device=device)
    bidx = torch.argsort(keys, dim=1)[:, :min(batch, rows)]
    normals = (torch.randn(s, d, generator=gen, device=device)
               if noise else None)
    return cidx, bidx, normals
