"""Fused Krum scores as a hand-written Hopper kernel (counterpart of
`biscotti_tpu/ops/krum_pallas.py`).

`krum_scores_kernel` launches `csrc/krum_scores.cu` (built by `_build.py`) on
a CUDA tensor; the source's head comment gives the design and its bound. On a
CPU tensor it computes the kernel's plain PyTorch version, `krum_scores_plain`
(D from one matmul, the diagonal at +inf, an ascending sort, the first k
summed). A build or launch error raises; nothing falls back to the plain
version on the card.

`krum_scores_auto` mirrors the reference's dispatch: inside the window
[KERNEL_MIN_N, KERNEL_MAX_N] a CUDA tensor goes to the kernel, everything
else (and every CPU tensor) to the plain torch path, as the reference sends
it to XLA.
"""

from __future__ import annotations

import torch

from biscotti_tpu_torch import _build
from biscotti_tpu_torch.ops.krum import krum_scores

# The window is the TPU's (biscotti_tpu/ops/krum_pallas.py PALLAS_MIN_N,
# PALLAS_MAX_N), kept so that the port's accept sets switch backend at the
# same committee sizes as the reference's, until H100 measurements set the
# port's own window.
KERNEL_MIN_N = 512
KERNEL_MAX_N = 4096

krum_scores_plain = krum_scores


def krum_scores_kernel(x: torch.Tensor, num_adversaries: int) -> torch.Tensor:
    """Krum scores of x[n, d] (float32, contiguous) by the Hopper kernel;
    `krum_scores_kernel.launches` counts its launches."""
    if x.device.type == "cpu":
        return krum_scores_plain(x, num_adversaries)
    if x.device.type != "cuda":
        raise ValueError(f"krum_scores_kernel: no kernel for device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("krum_scores_kernel takes a contiguous float32 "
                         f"[n, d] tensor, got {x.dtype} {tuple(x.shape)}")
    n, d = x.shape
    k = max(n - num_adversaries - 2, 0)
    if k == 0:
        return torch.zeros(n, dtype=torch.float32, device=x.device)
    if k >= n:
        raise ValueError(f"num_adversaries={num_adversaries} leaves k={k} "
                         f">= n={n}")
    lib = _build.load("krum_scores")
    with torch.cuda.device(x.device):
        sq = (x * x).sum(dim=-1)
        out = torch.empty(n, dtype=torch.float32, device=x.device)
        rc = lib.krum_scores_f32(x.data_ptr(), sq.data_ptr(), out.data_ptr(),
                                 n, d, k, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"krum_scores kernel launch failed at n={n}, d={d}: "
                           f"{lib.krum_error_string(rc).decode()} ({rc})")
    krum_scores_kernel.launches += 1
    return out


krum_scores_kernel.launches = 0


def krum_scores_auto(deltas: torch.Tensor, num_adversaries: int) -> torch.Tensor:
    """Kernel for CUDA committees inside the window, plain torch otherwise.
    As in the reference, accept sets inside the window depend on the backend
    (kernel and plain scores agree to ~1e-4 rtol), so all verifiers of one
    cluster share a backend (docs/RUNTIME.md)."""
    n = deltas.shape[0]
    if deltas.device.type == "cuda" and KERNEL_MIN_N <= n <= KERNEL_MAX_N:
        return krum_scores_kernel(deltas, num_adversaries)
    return krum_scores(deltas, num_adversaries)
