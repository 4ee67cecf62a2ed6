"""How exact the per-contributor CNN step is on the card, by convolution
route: the port's im2col matmuls (`models/zoo.py`) against `F.conv2d`
through cuDNN (its default algorithms, its deterministic ones) and with
cuDNN off, each held against the CPU port's step in float64.

    python -m biscotti_tpu_torch.tools.conv_precision [--device cpu]

One round's contributors of each CNN row of the bench (N = 100, S = 70,
batch 10) from flat_init weights; prints one JSON line per family with each
route's largest absolute error, how many contributors carry an error above
1e-5, whether two calls are bit-identical and the step's time. It is the
measurement behind the port's choice of im2col matmuls.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace

import torch
import torch.nn.functional as F

from biscotti_tpu_torch import bench
from biscotti_tpu_torch.device import resolve_device, synchronize
from biscotti_tpu_torch.models import zoo
from biscotti_tpu_torch.models.trainer import local_step_fn
from biscotti_tpu_torch.parallel.sim import Simulator

ROWS = ("cifar_lenet_100_krum_secagg", "lfw_cnn_100_krum_secagg",
        "mnist_cnn_100_krum_secagg")
CUDNN = {"cudnn_default": dict(enabled=True, deterministic=False),
         "cudnn_deterministic": dict(enabled=True, deterministic=True),
         "cudnn_off": dict(enabled=False, deterministic=False)}


def _conv2d(h, p, name, padding=0):
    """`zoo._conv` as torch's convolution (HWIO -> OIHW)."""
    return F.conv2d(h, p[f"{name}.w"].permute(3, 2, 0, 1), p[f"{name}.b"],
                    padding=padding)


def _route_model(model, conv):
    """The model with its convolutions routed through `conv`."""
    def loss(w, x, y):
        saved, zoo._conv = zoo._conv, conv
        try:
            return model.loss_flat(w, x, y)
        finally:
            zoo._conv = saved

    return replace(model, loss_flat=loss)


def _measure(step, w, x, y, truth) -> dict:
    a, b = step(w, x, y), step(w, x, y)
    synchronize(w.device)
    t0 = time.perf_counter()
    step(w, x, y)
    synchronize(w.device)
    err = (a.cpu().double() - truth).abs()
    return {"max_abs_err": float(err.max()),
            "contributors_over_1e-5": int((err.max(dim=1).values > 1e-5).sum()),
            "bit_identical": bool(torch.equal(a, b)),
            "step_ms": 1e3 * (time.perf_counter() - t0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when not given")
    dev = resolve_device(ap.parse_args(argv).device)
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in ROWS:
        cfg = bench.config(name)
        cpu = Simulator(cfg, device="cpu")
        w = cpu.model.flat_init(torch.Generator().manual_seed(4))
        cidx, bidx, _, _ = cpu.draw_round(cpu.gen, 0)
        x, y = cpu.x[cidx[:, None], bidx], cpu.y[cidx[:, None], bidx]

        def vstep(model):
            return torch.func.vmap(local_step_fn(model, "grad"), in_dims=(None, 0, 0))

        truth = vstep(cpu.model)(w.double(), x.double(), y)
        on = [t.to(dev) for t in (w, x, y)]
        routes = {"im2col_matmul": _measure(vstep(cpu.model), *on, truth)}
        conv2d = vstep(_route_model(cpu.model, _conv2d))
        for route, flags in CUDNN.items():
            with torch.backends.cudnn.flags(benchmark=False, allow_tf32=False,
                                            **flags):
                routes[route] = _measure(conv2d, *on, truth)
        print(json.dumps({"config": name, "model": cpu.model.name,
                          "contributors": int(cidx.shape[0]),
                          "batch": cfg.batch_size, "routes": routes}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
