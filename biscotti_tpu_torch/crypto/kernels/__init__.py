"""The device crypto plane in torch (counterpart of
`biscotti_tpu/crypto/kernels/`).

Limb-decomposed Edwards25519 arithmetic (`field.py` → `group.py` →
`primitives.py`) as eager int64 torch ops, with the on-curve validator as a
hand-written CUDA kernel (`cuda_validate.py`, kernel B2), behind the
reference's process-wide arming switch:

    from biscotti_tpu_torch.crypto import kernels
    kernels.set_enabled(True)          # what --device-crypto does
    kernels.active()                   # armed AND runnable here

`available()` means that `device.resolve_device()` finds a CUDA device.
The seams that consult the switch (`commitments.py`'s batch verifiers and
`VssIntakeBatch`, `secretshare.recover_coeffs`) and `prewarm` are not
ported yet; the entry points below are called directly, each with
`device=None` (the GPU) or an explicit `device="cpu"`.

Importing this package builds and loads nothing: the CUDA kernel is built
by `_build.py` at its first launch.
"""

from __future__ import annotations

import sys

from biscotti_tpu_torch.crypto.kernels.instrument import (  # noqa: F401
    device_calls, device_seconds, release_hooks, reset_counters,
    set_metrics_registry, set_span_hook)
from biscotti_tpu_torch.crypto.kernels.primitives import (  # noqa: F401
    ext_add, fixed_base_mult, grid_validate_sum, msm, pedersen_commit_point,
    point_neg_limbs, shamir_recover)
from biscotti_tpu_torch.device import resolve_device

_enabled = False
_warned = False


def set_enabled(on: bool) -> None:
    """Arm/disarm the device-crypto plane process-wide (the
    --device-crypto switch). Arming while unavailable degrades loudly —
    one stderr note naming why — and the seams keep their CPU path."""
    global _enabled, _warned
    _enabled = bool(on)
    if _enabled and not available() and not _warned:
        _warned = True
        print(f"[crypto/kernels] --device-crypto requested but the device "
              f"plane is unavailable ({availability_reason()}); all crypto "
              f"stays on the CPU path", file=sys.stderr)


def enabled() -> bool:
    return _enabled


def availability_reason() -> str:
    """Why the plane cannot run here ("" when it can)."""
    try:
        resolve_device()
    except RuntimeError as e:
        return str(e)
    return ""


def available() -> bool:
    """True when the plane can run here: a CUDA device is present."""
    return availability_reason() == ""


def active() -> bool:
    """Armed AND runnable — the one predicate every CPU/device dispatch
    seam consults."""
    return _enabled and available()


def active_module():
    """This package when `active()`, else None — the shared body of the
    per-seam `_device_mod()` probes, so the dispatch predicate lives in
    exactly one place."""
    import biscotti_tpu_torch.crypto.kernels as _k

    return _k if active() else None
