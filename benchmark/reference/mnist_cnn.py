"""mnist_cnn, plain: conv(1→16, 5×5, stride 1, pad 4) + relu +
fc(16·32·32 → 10), the "ONE LAYER" branch of Biscotti's
ML/Pytorch/mnist_cnn_model.py (MaxPool2d(1) is the identity). Inputs are
28×28×1 rows in NHWC order; the flat layout is the leaves below in order,
conv weights HWIO, dense weights [in, out]."""

from __future__ import annotations

from .nets import Precision, conv, dense, flat_nhwc, nchw

LEAVES = [
    ("conv.b", (16,), "zeros"),
    ("conv.w", (5, 5, 1, 16), "normal"),
    ("fc.b", (10,), "zeros"),
    ("fc.w", (16 * 32 * 32, 10), "uniform"),
]
D_IN = 784
CLASSES = 10


def logits(prec: Precision, p, x):
    """p: {leaf: [S, *shape]}; x: [S, B, 784]. Returns [S, B, 10]."""
    s = x.shape[0]
    h = conv(prec, nchw(x, (28, 28), 1), s, p["conv.w"], p["conv.b"], padding=4)
    h = flat_nhwc(h.relu(), s)
    return dense(prec, h, p["fc.w"], p["fc.b"])
