# The port's counterpart of eval/eval_inversion.py; it imports nothing of biscotti_tpu.
"""Gradient-inversion privacy attack: reconstruct a peer's training inputs
from its submitted update, with and without DP noise.

    python -m biscotti_tpu_torch.eval.eval_inversion [--dataset mnist] \
        [--batch 4] [--steps 400] [--platform cuda] [--out DIR]

The attack that motivates Biscotti's noising committee: a raw gradient of
the linear softmax model leaks its inputs, and gradient matching recovers
them for small batches (ref: CentralBlockML/code/inversion.py:1-8). The
attacker optimizes dummy inputs, labels known (its best case), with Adam
(lr 0.1; torch's defaults β = 0.9 / 0.999, ε = 1e-8 and bias correction
are optax.adam's) to match the observed update (`match_loss`), at
ε ∈ {∞, 1.0, 0.1}: the observed update is the clean gradient plus
σ(ε)·z / batch, σ from `ops/dp_noise.sigma_for`. The dummy start and the
noise are drawn from one seeded `torch.Generator` (seed 7), not from the
reference's `jax.random` stream.

Metric: the mean best-match cosine similarity between reconstructed and
true inputs, per ε. Artifacts: inversion.json and inversion.csv, the
reference's keys plus `device`/`nvidia_smi`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Tuple

import numpy as np
import torch

from biscotti_tpu_torch.data import datasets as ds
from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.eval import RESULTS, device_fields
from biscotti_tpu_torch.models.base import Model
from biscotti_tpu_torch.models.zoo import model_for_dataset
from biscotti_tpu_torch.ops import dp_noise

SEED = 7


def match_loss(model: Model, w: torch.Tensor, y: torch.Tensor,
               observed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The gradient-matching objective: |∇_w loss(w; x, y) − observed|²."""
    g = torch.func.grad(model.loss_flat)(w, x, y)
    diff = g - observed
    return torch.sum(diff * diff)


def reconstruct(model: Model, w: torch.Tensor, y: torch.Tensor,
                observed: torch.Tensor, x0: torch.Tensor,
                steps: int) -> Tuple[np.ndarray, float]:
    """`steps` Adam steps (lr 0.1) on dummy inputs from x0; returns the
    inputs and the objective at the last step's start, as the reference's
    jitted step reports it."""
    x = x0.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=0.1)
    step = torch.func.grad_and_value(
        lambda xx: match_loss(model, w, y, observed, xx))
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        g, loss = step(x.detach())
        x.grad = g
        opt.step()
    return x.detach().cpu().numpy(), float(loss)


def best_cosine(x_true: np.ndarray, recon: np.ndarray) -> float:
    """Mean over the true inputs of |cos| to their best-matching
    reconstruction."""
    sims = []
    for i in range(x_true.shape[0]):
        t = x_true[i] / (np.linalg.norm(x_true[i]) + 1e-12)
        sims.append(max(
            float(np.abs(np.dot(t, r / (np.linalg.norm(r) + 1e-12))))
            for r in recon))
    return float(np.mean(sims))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--platform", default="cuda",
                    help="torch device: 'cuda' (raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

    model = model_for_dataset(args.dataset)
    shard = ds.load_shard(args.dataset, ds.shard_name(args.dataset, 0, False))
    x_np = np.asarray(shard["x_train"][: args.batch], np.float32)
    x_true = torch.from_numpy(x_np).to(dev)
    y_true = torch.from_numpy(shard["y_train"][: args.batch]).to(dev)
    w = torch.zeros(model.num_params, dtype=torch.float32, device=dev)
    g_clean = torch.func.grad(model.loss_flat)(w, x_true, y_true)

    sigma_ref = {"inf": 0.0, "1.0": dp_noise.sigma_for(1.0),
                 "0.1": dp_noise.sigma_for(0.1)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for label, sigma in sigma_ref.items():
        observed = g_clean
        if sigma > 0:
            observed = g_clean + sigma * torch.randn(
                g_clean.shape, generator=gen, device=dev) / args.batch
        x0 = 0.01 * torch.randn(x_true.shape, generator=gen, device=dev)
        recon, final_loss = reconstruct(model, w, y_true, observed, x0,
                                        args.steps)
        row = {"epsilon": label,
               "cosine_similarity": round(best_cosine(x_np, recon), 4),
               "match_loss": round(final_loss, 6)}
        rows.append(row)
        print(json.dumps(row))

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "inversion.csv"), "w") as f:
        f.write("epsilon,cosine_similarity\n")
        for r in rows:
            f.write(f"{r['epsilon']},{r['cosine_similarity']}\n")
    with open(os.path.join(args.out, "inversion.json"), "w") as f:
        json.dump({"experiment": "gradient_inversion", **device_fields(dev),
                   "dataset": args.dataset, "batch": args.batch,
                   "steps": args.steps, "rows": rows,
                   "data_note": "synthetic shards (zero-egress env)"},
                  f, indent=1)
    # DP must measurably degrade reconstruction
    by = {r["epsilon"]: r["cosine_similarity"] for r in rows}
    ok = by["inf"] > by["0.1"]
    print(json.dumps({"summary": "dp_degrades_inversion", "ok": ok,
                      "clean": by["inf"], "eps0.1": by["0.1"]}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
