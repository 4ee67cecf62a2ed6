"""lfw_cnn, plain: the LeNet shape of Biscotti's ML/Pytorch/lfw_cnn_model.py
over 62×47×3 inputs: conv(3→6, 5×5) relu maxpool 2 → conv(6→16, 5×5) relu
maxpool 2 (floors: 58×43 → 29×21 → 25×17 → 12×8) → fc(1,536 → 84) relu →
fc(84 → 12). Inputs in NHWC order; the flat layout is the leaves below in
order, conv weights HWIO, dense weights [in, out]."""

from __future__ import annotations

import torch.nn.functional as F

from .nets import Precision, conv, dense, flat_nhwc, nchw

LEAVES = [
    ("c1.b", (6,), "zeros"),
    ("c1.w", (5, 5, 3, 6), "normal"),
    ("c2.b", (16,), "zeros"),
    ("c2.w", (5, 5, 6, 16), "normal"),
    ("f1.b", (84,), "zeros"),
    ("f1.w", (16 * 12 * 8, 84), "uniform"),
    ("f3.b", (12,), "zeros"),
    ("f3.w", (84, 12), "uniform"),
]
D_IN = 8742
CLASSES = 12


def logits(prec: Precision, p, x):
    """p: {leaf: [S, *shape]}; x: [S, B, 8742]. Returns [S, B, 12]."""
    s = x.shape[0]
    h = nchw(x, (62, 47), 3)
    for name in ("c1", "c2"):
        h = F.max_pool2d(conv(prec, h, s, p[f"{name}.w"], p[f"{name}.b"]).relu(),
                         2, 2)
    h = dense(prec, flat_nhwc(h, s), p["f1.w"], p["f1.b"]).relu()
    return dense(prec, h, p["f3.w"], p["f3.b"])
