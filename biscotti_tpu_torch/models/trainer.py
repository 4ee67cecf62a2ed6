"""Step rules and the per-peer `Trainer` (counterpart of
`biscotti_tpu/models/trainer.py`).

Two step rules, matching the reference's two stacks:

  * "grad": delta = −clip₁₀₀(∇CE(w; minibatch))   (ref: client.py:38-65)
  * "sgd":  delta = −α·∇f(w; minibatch), f the L2-regularized logistic
            loss (ref: logistic_model.py:113-140)

`local_step_fn` returns the step of ONE contributor. The simulator batches it
over contributors with `torch.func.vmap`, so each contributor gets the
gradient of its own minibatch loss (never the gradient of a summed loss,
which would be the sum of the gradients).

`Trainer` is one peer's bridge API (init / privateFun / getNoise / roni /
getTestErr / get17AttackRate; ref: ML/Pytorch/client_obj.py,
DistSys/honest.go:204-324), which the live runtime embeds. Its batch and
noise streams come from `torch.Generator`s seeded purely from (config seed,
peer seed, stream, iteration); `private_fun_from_batch` is the pure step
that the tests feed the reference's own batch indices.
"""

from __future__ import annotations

import hashlib
import zlib
from typing import Callable, Optional, Union

import numpy as np
import torch

from biscotti_tpu_torch.data import datasets as ds
from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.models.base import Model, fp32_math
from biscotti_tpu_torch.models.zoo import model_for_dataset
from biscotti_tpu_torch.ops import dp_noise

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


def stream_seed(*parts) -> int:
    """A 63-bit generator seed, pure in `parts` (seeds, a stream's name, an
    iteration): the port's stand-in for the reference's fold_in keys."""
    h = hashlib.sha256("/".join(("biscotti_tpu_torch",) + tuple(map(str, parts)))
                       .encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


# The test and attack splits are the same for every peer of a dataset, so
# the peers of one process share one copy on each device.
_EVAL_CACHE: dict = {}


def _shared_eval_tensors(dataset: str, device: torch.device):
    key = (dataset, str(device))
    if key not in _EVAL_CACHE:
        test = ds.load_shard(dataset, f"{dataset}_test")
        attack = ds.load_shard(dataset, f"{dataset}_digit1")
        _EVAL_CACHE[key] = tuple(
            torch.from_numpy(a).to(device) for a in (
                test["x_test"], test["y_test"], attack["x_test"], attack["y_test"]))
    return _EVAL_CACHE[key]


class Trainer:
    """One peer's ML state: its train shard on the device, the shared eval
    splits, its DP-noise bank and the step rule.

    `light=True` (the reference's co-hosted hive mode) holds no train shard
    and no noise bank: `private_fun`, `get_noise`, `train_error` and `roni`
    raise, the eval metrics work."""

    def __init__(self, dataset: str, shard: str, cfg=None,
                 model: Optional[Model] = None, seed: Optional[int] = None,
                 light: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        from biscotti_tpu_torch.config import BiscottiConfig

        self.device = resolve_device(device)
        self.cfg = cfg or BiscottiConfig(dataset=dataset)
        self.dataset = dataset
        self.model = model or model_for_dataset(dataset, self.cfg.model_name)
        self.mode = "sgd" if self.model.name == "logreg" else "grad"
        self.batch_size = self.cfg.batch_size
        # the shard name is the peer's identity: peers built with default
        # arguments still draw independent batches and noise
        if seed is None:
            seed = zlib.crc32(shard.encode())
        self.seed = seed
        # optional telemetry registry (telemetry.MetricsRegistry), armed by
        # the embedding runtime: steps and noise draws are counted
        self.metrics = None

        self.light = bool(light)
        if self.light:
            self.x_train = self.y_train = None
        else:
            data = ds.load_shard(dataset, shard)
            self.x_train = torch.from_numpy(data["x_train"]).to(self.device)
            self.y_train = torch.from_numpy(data["y_train"]).to(self.device)
        (self.x_test, self.y_test,
         self.x_attack, self.y_attack) = _shared_eval_tensors(dataset, self.device)

        self.num_params = self.model.num_params
        eps_live = (self.cfg.epsilon
                    if self.cfg.noising or self.cfg.dp_in_model else 0.0)
        self.noise_accept_rate = None
        if self.light:
            self.noise_samples = None
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(stream_seed("trainer", self.cfg.seed, self.seed,
                                        "noise", 0))
            if self.cfg.dp_mechanism == "mcmc13":
                # Song&Sarwate'13 (ref: client_obj.py:44-57), served through
                # the same get_noise as the Gaussian bank
                self.noise_samples, acc = dp_noise.mcmc_presample(
                    gen, eps_live, self.cfg.noise_presample_iters,
                    self.num_params)
                self.noise_accept_rate = float(acc) if eps_live > 0 else None
            else:
                self.noise_samples = dp_noise.presample(
                    gen, eps_live, self.cfg.delta, self.batch_size,
                    self.cfg.noise_presample_iters, self.num_params)

        self._step = local_step_fn(self.model, self.mode,
                                   clip=self.cfg.grad_clip,
                                   alpha=self.cfg.logreg_alpha)

    # ---- the reference's bridge API (honest.go:204-324) ----

    def init_weights(self) -> np.ndarray:
        """Zero init, the genesis global model (ref: block.go:46-52)."""
        return np.zeros(self.num_params, dtype=np.float64)

    def _require_full(self, what: str) -> None:
        if self.light:
            raise RuntimeError(
                f"Trainer(light=True) holds no {what}: a co-hosted peer's "
                "SGD and noise are served by the shared stepper; construct a "
                "full Trainer for per-agent dispatch")

    def _w(self, flat_w) -> torch.Tensor:
        """A flat weight vector (numpy, as the bridge passes it, or a
        tensor) as float32 on the trainer's device."""
        if isinstance(flat_w, torch.Tensor):
            return flat_w.to(self.device, torch.float32)
        return torch.from_numpy(np.asarray(flat_w, np.float32)).to(self.device)

    def batch_indices(self, iteration: int) -> torch.Tensor:
        """Round `iteration`'s minibatch rows of the train shard, without
        replacement, pure in (config seed, peer seed, iteration).

        Each call seeds a generator of its own (ROADMAP C9): the live peer
        runs a speculative step and the serial step of one round in two
        worker threads at once, and a generator shared between them let
        one thread's draw continue the stream the other had just seeded.
        The rows are the same as those of the one shared generator."""
        self._require_full("train shard")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed("trainer", self.cfg.seed, self.seed,
                                    "batch", iteration))
        rows = int(self.x_train.shape[0])
        return sample_batch(gen, rows, min(self.batch_size, rows), 1)[0]

    def private_fun_from_batch(self, flat_w, idx) -> np.ndarray:
        """The step on the train rows `idx`: pure in (flat_w, idx)."""
        self._require_full("train shard")
        if not isinstance(idx, torch.Tensor):
            idx = torch.from_numpy(np.array(idx, np.int64))
        idx = idx.to(self.device)
        with fp32_math():
            delta = self._step(self._w(flat_w), self.x_train[idx],
                               self.y_train[idx])
        return delta.cpu().numpy().astype(np.float64)

    def private_fun(self, flat_w, iteration: int) -> np.ndarray:
        self._require_full("train shard")
        if self.metrics is not None:
            self.metrics.counter("biscotti_trainer_steps_total",
                                 "local SGD steps computed").inc()
        return self.private_fun_from_batch(flat_w, self.batch_indices(iteration))

    def get_noise(self, iteration: int) -> np.ndarray:
        self._require_full("noise bank")
        if self.metrics is not None:
            self.metrics.counter("biscotti_noise_draws_total",
                                 "DP noise vectors served/consumed").inc()
        alpha = self.cfg.logreg_alpha if self.mode == "sgd" else 1.0
        return dp_noise.noise_at(self.noise_samples, iteration, self.batch_size,
                                 alpha).cpu().numpy().astype(np.float64)

    def _error(self, flat_w, x, y) -> float:
        with fp32_math():
            return float(self.model.error_flat(self._w(flat_w), x, y))

    def train_error(self, flat_w) -> float:
        self._require_full("train shard")
        return self._error(flat_w, self.x_train, self.y_train)

    def test_error(self, flat_w) -> float:
        return self._error(flat_w, self.x_test, self.y_test)

    def attack_rate(self, flat_w) -> float:
        """1 − accuracy on the attack-source split (ref: client.py:163-172
        get17AttackRate)."""
        return self._error(flat_w, self.x_attack, self.y_attack)

    def attack_success_rate(self, flat_w) -> float:
        """Fraction of attack-source samples predicted as exactly the attack
        target class (the 1→7 rate)."""
        target = ds.spec(self.dataset).attack_target
        with fp32_math():
            logits = self.model.apply_flat(self._w(flat_w), self.x_attack)
        pred = torch.argmax(logits, dim=-1)
        return float((pred == target).to(torch.float32).mean())

    def roni(self, flat_w, delta) -> float:
        """err(w + δ) − err(w) on the train shard (ref: client_obj.py:100-112;
        rejected above 0.02, main.go:203-231)."""
        self._require_full("train shard")
        w = self._w(flat_w)
        with fp32_math():
            before = self.model.error_flat(w, self.x_train, self.y_train)
            after = self.model.error_flat(w + self._w(delta), self.x_train,
                                          self.y_train)
        return float(after - before)
