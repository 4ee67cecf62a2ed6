"""NONE: every update accepted, and the miner sums them."""

from .defense import accept_all as decide  # noqa: F401
from .defense import masked_sum as aggregate  # noqa: F401
