"""The poisoned-membership formula, copied from
`biscotti_tpu/tools/verdicts.py::poisoned_ids` (stdlib only)."""

from __future__ import annotations

import math
from typing import Set


def poisoned_ids(num_nodes: int, poison_fraction: float) -> Set[int]:
    """Top `poison_fraction` of node ids load bad shards
    (ref: DistSys/main.go:836-845)."""
    if poison_fraction <= 0:
        return set()
    poisoning_index = math.ceil(num_nodes * (1.0 - poison_fraction))
    return {i for i in range(num_nodes) if i > poisoning_index}
