"""FLOPs of lfw_cnn a sample (multiply and add counted as 2), from its
shapes: conv(3→6, 5×5) over 58×43, conv(6→16, 5×5) over 25×17,
fc(1,536 → 84), fc(84 → 12); pools and activations are not counted. The
backward counts every weight gradient and every activation gradient
except the input's, which no step needs."""

C1 = 2 * 6 * (3 * 5 * 5) * (58 * 43)
C2 = 2 * 16 * (6 * 5 * 5) * (25 * 17)
F1 = 2 * (16 * 12 * 8) * 84
F3 = 2 * 84 * 12


def forward_flops() -> int:
    return C1 + C2 + F1 + F3


def step_flops() -> int:
    """Forward and backward of one sample's loss."""
    return forward_flops() + C1 + 2 * (C2 + F1 + F3)
