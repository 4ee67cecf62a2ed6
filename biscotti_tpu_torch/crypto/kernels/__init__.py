"""The device crypto plane in torch (counterpart of
`biscotti_tpu/crypto/kernels/`).

Limb-decomposed Edwards25519 arithmetic (`field.py` → `group.py` →
`primitives.py`), whose ladders run as hand-written CUDA kernels on the card
(`cuda_ladder.py`, kernel B3: the msm ladder, the fixed-base walk, the grid
validation and the point add) beside the on-curve validator
(`cuda_validate.py`, kernel B2), and as the same formulas in int64 torch
ops on the CPU, behind the reference's process-wide arming switch:

    from biscotti_tpu_torch.crypto import kernels
    kernels.set_enabled(True)               # the GPU
    kernels.set_enabled(True, device="cpu") # the CPU tests
    kernels.active()                        # armed

Arming records the device that the seams pass to every entry point
(`armed_device()`): `commitments.py`'s batch verifiers and
`VssIntakeBatch`, and `secretshare.recover_coeffs`. `device=None` means the
GPU, and arming without one raises (`device.resolve_device`): the plane
never runs quietly on the CPU. Unlike the reference, a device fault in a
seam raises out of it; no seam finishes on the CPU after one.

Importing this package builds and loads nothing: the CUDA kernels are
built by `_build.py` at their first launch (or in `prewarm`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from biscotti_tpu_torch.crypto.kernels.instrument import (  # noqa: F401
    device_calls, device_seconds, release_hooks, reset_counters,
    set_metrics_registry, set_span_hook)
from biscotti_tpu_torch.crypto.kernels.primitives import (  # noqa: F401
    ext_add, fixed_base_mult, grid_validate_sum, msm, pedersen_commit_point,
    point_neg_limbs, prewarm, shamir_recover)
from biscotti_tpu_torch.device import resolve_device

_device: Optional[torch.device] = None


def set_enabled(on: bool,
                device: Optional[Union[str, torch.device]] = None) -> None:
    """Arm the plane on `device` (None: the GPU; raises without one), or
    disarm it, process-wide (the reference's --device-crypto switch)."""
    global _device
    _device = resolve_device(device) if on else None


def armed_device() -> Optional[torch.device]:
    """The device the seams pass to the plane's entry points (None while
    disarmed)."""
    return _device


def active() -> bool:
    """Armed — the one predicate every CPU/device dispatch seam
    consults (arming has already resolved the device)."""
    return _device is not None


def active_module():
    """This package when `active()`, else None — the shared body of the
    per-seam `_device_mod()` probes, so the dispatch predicate lives in
    exactly one place."""
    import biscotti_tpu_torch.crypto.kernels as _k

    return _k if active() else None
