"""The port's eval drivers: one module for each reference script under
`eval/`, with the same file name, run as

    python -m biscotti_tpu_torch.eval.<name> [--platform cuda|cpu] ...

Each keeps its reference's flags and artifact keys. `--platform` names the
torch device and defaults to `cuda` (it raises without a GPU); the CPU is
only ever asked for. Artifacts go to `--out`, by default this package's
`results/` directory (git-ignored); no driver reads or writes under the
repo's `eval/`, which stays the reference's. Every artifact carries
`device` and the card's `nvidia-smi --query-gpu=name,power.limit` line
(`nvidia_smi`, null on the CPU).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")


def device_fields(dev: torch.device) -> Dict[str, Optional[str]]:
    """The artifact's device keys: the card's name and its nvidia-smi
    `name, power.limit` line, or "cpu" and null."""
    if dev.type != "cuda":
        return {"device": "cpu", "nvidia_smi": None}
    from biscotti_tpu_torch.bench import card_line

    return {"device": torch.cuda.get_device_name(dev), "nvidia_smi": card_line()}
