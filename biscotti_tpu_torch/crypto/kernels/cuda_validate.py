"""On-curve validation of affine cells as a hand-written Hopper kernel
(counterpart of `biscotti_tpu/crypto/kernels/pallas_validate.py`).

`oncurve_mask` launches `csrc/oncurve.cu` (built by `_build.py`) on a CUDA
tensor; the source's head comment gives the design and its bound. On a CPU
tensor it computes the kernel's plain PyTorch version, `oncurve_mask_plain`,
which is the TPU kernel's own arithmetic (xx, yy, lhs = yy − xx,
rhs = 1 + d·xx·yy, canonical forms compared) written with the port's
`field.py`. A build or launch error raises; nothing falls back to the plain
version on the card. Both take limbs in [0, 2¹⁷) only (wire limbs are below
2¹⁶), the range in which the kernel's verdict is proven exact, and raise on
any other: the kernel flags such a limb as it loads it, the CPU checks the
tensor.

The TPU kernel pads N up to its 128-cell tile with the affine identity
(0, 1); the CUDA kernel masks its last block's tail instead, which gives
the same [N] mask without copying the input.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from biscotti_tpu_torch import _build
from biscotti_tpu_torch.crypto.kernels import field as fe
from biscotti_tpu_torch.device import resolve_device

# limbs of the cells oncurve_mask takes lie in [0, LIMB_BOUND)
LIMB_BOUND = 1 << 17


def oncurve_mask_plain(xy: torch.Tensor) -> torch.Tensor:
    """[N, 2, 16] int64 limb cells → [N] bool on-curve mask (mod p), as
    `pallas_validate._kernel` computes it."""
    x = xy[:, 0, :]
    y = xy[:, 1, :]
    xx = fe.fmul(x, x)
    yy = fe.fmul(y, y)
    lhs = fe.fsub(yy, xx)
    one = torch.zeros_like(x)
    one[:, 0] = 1
    rhs = fe.carry(one + fe.fmul(fe.const("D_LIMBS", x.device),
                                 fe.fmul(xx, yy)), passes=1)
    return (fe.canonical(lhs) == fe.canonical(rhs)).all(dim=-1)


_OUT_OF_CONTRACT = ("oncurve_mask takes limbs in [0, 2**17); got a limb "
                    "outside it")


def _launch(xy: torch.Tensor) -> torch.Tensor:
    if xy.dtype != torch.int64 or not xy.is_contiguous() \
            or xy.data_ptr() % 16:
        raise ValueError("oncurve_mask takes a contiguous, 16-byte aligned "
                         f"int64 [N, 2, 16] tensor, got {xy.dtype} "
                         f"{tuple(xy.shape)}")
    n = xy.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=xy.device)
    if n == 0:
        return out
    lib = _build.load("oncurve")
    bad = torch.zeros(1, dtype=torch.int32, device=xy.device)
    with torch.cuda.device(xy.device):
        rc = lib.oncurve_mask_i64(xy.data_ptr(), out.data_ptr(), bad.data_ptr(),
                                  n, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"oncurve kernel launch failed at n={n}: "
                           f"{lib.oncurve_error_string(rc).decode()} ({rc})")
    oncurve_mask.launches += 1
    if bad.item():
        raise ValueError(_OUT_OF_CONTRACT)
    return out


def oncurve_mask(xy: Union[np.ndarray, torch.Tensor],
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Union[np.ndarray, torch.Tensor]:
    """[N, 2, 16] limb cells (limbs in [0, 2¹⁷), else ValueError) → [N]
    bool on-curve mask (mod p — canonicity is the caller's separate check).

    A numpy array goes to `device` (the GPU unless the caller asks for the
    CPU) and the mask comes back as numpy, as the reference returns it; a
    tensor is computed where it lies and the mask stays a tensor there. On
    the CPU this is `oncurve_mask_plain`; on a CUDA device it launches the
    kernel, counted in `oncurve_mask.launches`."""
    as_numpy = not isinstance(xy, torch.Tensor)
    if as_numpy:
        xy = torch.from_numpy(np.ascontiguousarray(xy, dtype=np.int64)).to(
            resolve_device(device))
    if xy.dim() != 3 or tuple(xy.shape[1:]) != (2, fe.LIMBS):
        raise ValueError(f"oncurve_mask takes [N, 2, 16] cells, got "
                         f"{tuple(xy.shape)}")
    if xy.device.type == "cpu":
        if xy.numel() and (int(xy.min()) < 0 or int(xy.max()) >= LIMB_BOUND):
            raise ValueError(_OUT_OF_CONTRACT)
        mask = oncurve_mask_plain(xy)
    elif xy.device.type == "cuda":
        mask = _launch(xy)
    else:
        raise ValueError(f"oncurve_mask: no kernel for device {xy.device}")
    return mask.cpu().numpy() if as_numpy else mask


oncurve_mask.launches = 0
