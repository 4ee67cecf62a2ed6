"""Weights across the package boundary, in the reference's flat layout.

The reference flattens a parameter dict with `ravel_pytree`: leaves in
sorted-key order (recursively), each raveled row-major. These helpers read
such a dict, or an already flat array, into the port's flat float32 tensor,
and write it back out as numpy. They take anything numpy can read (a JAX
array included) and import nothing of JAX.

The CNN families nest their layers: mnist_cnn is `conv.b[16],
conv.w[5,5,1,16], fc.b[10], fc.w[16384,10]`; cifar_cnn `c1, c2, f1, f2, f3`
and lfw_cnn `c1, c2, f1, f3`, each layer `b` then `w`, conv weights HWIO and
dense weights [d_in, d_out]. The recursive sorted-key walk below reads them
as it reads the linear families (`models/zoo.py` lists each layout).

The device crypto plane (`crypto/kernels/`) needs no converter of its own:
its whole state is the reference's int64 limb arrays (a field element
[..., 16], a point batch [..., 4, 16], an affine cell [..., 2, 16]) and
python-int points, the same numpy arrays in both packages. Its entry points
take and return those, and carry them across with
`torch.from_numpy(...).to(device)` and `.cpu().numpy()`.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import numpy as np
import torch

from biscotti_tpu_torch.device import resolve_device


def _leaves(tree: Any, out: List[np.ndarray]) -> None:
    if isinstance(tree, dict):
        for key in sorted(tree):
            _leaves(tree[key], out)
    else:
        out.append(np.asarray(tree, dtype=np.float32).reshape(-1))


def params_from_jax(tree_or_flat: Any,
                    device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """A parameter dict (or flat array) of the reference -> flat float32
    tensor on `device` (the GPU unless the caller asks for the CPU)."""
    leaves: List[np.ndarray] = []
    _leaves(tree_or_flat, leaves)
    flat = np.concatenate(leaves) if leaves else np.zeros(0, np.float32)
    return torch.from_numpy(flat).to(resolve_device(device))


def params_to_jax(flat: torch.Tensor) -> np.ndarray:
    """The port's flat tensor -> float32 numpy in the same layout, ready for
    `jnp.asarray` or the reference's `unravel`."""
    return flat.detach().to("cpu", torch.float32).numpy().copy()
