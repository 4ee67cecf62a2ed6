"""Fused Krum scores as a hand-written Hopper kernel (counterpart of
`biscotti_tpu/ops/krum_pallas.py`).

`krum_scores_kernel` launches `csrc/krum_scores.cu` (built by `_build.py`) on
a CUDA tensor: three CUDA kernels (copy x into a zero-padded buffer, the
upper Gram tiles in fp32 FMAs with a deterministic split-K, the exact row
select); the source's head comment gives the design, its bound and why the
tensor cores are not used. On a CPU tensor it computes the kernel's
plain PyTorch version, `krum_scores_plain` (D from one matmul, +inf added
on the diagonal, an ascending sort, the first k summed; non-finite rows
ranked and scored by ops/krum.py's rule, which the kernel's order keys
reproduce). A build or launch error raises; nothing falls back to the
plain version on the card. Scores from either rank for acceptance through
`ops/krum.py::rank_scores`.

`krum_scores_auto` mirrors the reference's dispatch: inside the window
[KERNEL_MIN_N, KERNEL_MAX_N] a CUDA tensor goes to the kernel, everything
else (and every CPU tensor) to the plain torch path, as the reference sends
it to XLA.
"""

from __future__ import annotations

import torch

from biscotti_tpu_torch import _build
from biscotti_tpu_torch.ops.krum import krum_scores, square_norms

# The window is the TPU's (biscotti_tpu/ops/krum_pallas.py PALLAS_MIN_N,
# PALLAS_MAX_N), kept so that the port's accept sets switch backend at the
# same committee sizes as the reference's, until H100 measurements set the
# port's own window.
KERNEL_MIN_N = 512
KERNEL_MAX_N = 4096

# the kernel's Gram tile (rows, each side), k-tile (features) and resident
# blocks an SM: csrc/krum_scores.cu kTile, kK, __launch_bounds__
TILE = 128
K_TILE = 16
BLOCKS_PER_SM = 2

krum_scores_plain = krum_scores


def plan(n: int, d: int, sms: int) -> tuple[int, int, int, int]:
    """(n_pad, d_pad, tiles, splits) of the kernel at x[n, d] on a card of
    `sms` SMs: rows padded to whole Gram tiles, features to whole k-tiles,
    the tiles I <= J of the upper triangle, and d split across as many
    blocks a tile as fill the card once, at least 1 and at most one k-tile
    a split."""
    n_pad = -(-n // TILE) * TILE
    d_pad = -(-d // K_TILE) * K_TILE
    t = n_pad // TILE
    tiles = t * (t + 1) // 2
    splits = max(1, min(d_pad // K_TILE, BLOCKS_PER_SM * sms // tiles))
    return n_pad, d_pad, tiles, splits


def workspace(n: int, d: int, device: torch.device) -> dict:
    """The kernel's scratch at x[n, d], allocated on `device`, with its
    plan: xp [n_pad, d_pad]; amax [n_pad], the rows' max |x| after the
    flush of subnormal inputs (ops/krum.py's subnormal rule); dist
    [n, n_pad] (4 bytes an entry, which the kernel fills with the order
    keys of D); partials and counters of the split-K (empty when d is not
    split)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_pad, d_pad, tiles, splits = plan(n, d, sms)
    f32 = {"dtype": torch.float32, "device": device}
    return {"n_pad": n_pad, "d_pad": d_pad, "splits": splits,
            "xp": torch.empty(n_pad, d_pad, **f32),
            "amax": torch.empty(n_pad, **f32),
            "dist": torch.empty(n, n_pad, **f32),
            "partials": torch.empty(tiles * splits * TILE * TILE
                                    if splits > 1 else 0, **f32),
            "counters": torch.empty(tiles if splits > 1 else 0,
                                    dtype=torch.int32, device=device)}


def launch(lib, x: torch.Tensor, sq: torch.Tensor, out: torch.Tensor,
           ws: dict, k: int) -> int:
    """One call of the library's C interface on the current stream; returns
    its cudaError_t. Counts nothing: `krum_scores_kernel` does."""
    n, d = x.shape
    return lib.krum_scores_f32(
        x.data_ptr(), sq.data_ptr(), out.data_ptr(), ws["xp"].data_ptr(),
        ws["amax"].data_ptr(), ws["dist"].data_ptr(), ws["partials"].data_ptr(),
        ws["counters"].data_ptr(), n, d, ws["n_pad"], ws["d_pad"],
        ws["splits"], k, torch.cuda.current_stream().cuda_stream)


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
        # the plain version's own sums of squares (subnormal products
        # flushed), bit for bit: the cancellation in sq_i + sq_j - 2G then
        # cancels alike
        sq = square_norms(x)
        out = torch.empty(n, dtype=torch.float32, device=x.device)
        rc = launch(lib, x, sq, out, workspace(n, d, x.device), k)
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
