"""FLOPs of mnist_cnn a sample (multiply and add counted as 2), from its
shapes: conv(1→16, 5×5) over 32×32 outputs, fc(16,384 → 10). The
backward counts every weight gradient and every activation gradient
except the input's, which no step needs."""

CONV = 2 * 16 * (1 * 5 * 5) * (32 * 32)
FC = 2 * (16 * 32 * 32) * 10


def forward_flops() -> int:
    return CONV + FC


def step_flops() -> int:
    """Forward and backward of one sample's loss."""
    return forward_flops() + CONV + 2 * FC
