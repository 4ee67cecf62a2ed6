"""Device choice for the port's entry points.

The port runs on the GPU. The CPU is only ever an explicit choice
(`device="cpu"`, as the tests make it): with no GPU and no such choice an
entry point raises instead of quietly carrying on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the GPU; a CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller asks for the CPU explicitly (device='cpu')")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so a host
    clock read after it covers that work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
