"""The reference's frozen copy of the peers' data.

The simulator under test synthesises every peer's shard on the host from
(dataset, peer): a fixed mixture of Gaussian class clusters, each stream
seeded by sha256 of a name, an 80/20 train cut, and label-flipped shards
for the top `poison_fraction` of peer ids. This file restates that rule
for the synthetic datasets the benchmark's configurations use, so the
reference rebuilds the rows it needs without calling the program. Shards
are drawn on a pool of threads (numpy's generators release the GIL while
they fill an array).
"""

from __future__ import annotations

import hashlib
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Tuple

import numpy as np

# name: (d_in, classes, shard rows, test rows, attack source, attack target)
SPECS = {
    "mnist": (784, 10, 600, 2000, 1, 7),
    "lfw": (8742, 12, 200, 1000, 1, 7),
}


def _rng(dataset: str, tag: str) -> np.random.Generator:
    seed = int.from_bytes(
        hashlib.sha256(f"biscotti_tpu/{dataset}/{tag}".encode()).digest()[:8],
        "little")
    return np.random.default_rng(seed)


def class_means(dataset: str) -> np.ndarray:
    d_in, classes = SPECS[dataset][:2]
    means = _rng(dataset, "means").normal(0.0, 1.0, size=(classes, d_in))
    return (means / np.linalg.norm(means, axis=1, keepdims=True)
            ).astype(np.float32) * 6.0


def poisoned(num_nodes: int, poison_fraction: float) -> set:
    """Peers above ceil(N·(1 − p)) hold label-flipped shards."""
    if poison_fraction <= 0:
        return set()
    cut = math.ceil(num_nodes * (1.0 - poison_fraction))
    return {i for i in range(num_nodes) if i > cut}


def test_split(dataset: str, means: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    d_in, classes, _, test_rows = SPECS[dataset][:4]
    rng = _rng(dataset, "test")
    y = rng.integers(0, classes, size=test_rows)
    x = means[y] + rng.normal(0.0, 1.0, size=(test_rows, d_in)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int64)


def train_rows(dataset: str, peer: int, bad: bool,
               means: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Peer `peer`'s train cut (the first 80 % of its shard)."""
    d_in, classes, rows, _, source, target = SPECS[dataset]
    if bad:
        rng = _rng(dataset, f"badshard{peer}")
        y = np.full(rows, source, dtype=np.int64)
        x = means[y] + rng.normal(0.0, 1.0, size=(rows, d_in))
        y[:] = target
    else:
        rng = _rng(dataset, f"shard{peer}")
        y = rng.integers(0, classes, size=rows)
        x = means[y] + rng.normal(0.0, 1.0, size=(rows, d_in)).astype(np.float32)
    cut = int(0.8 * rows)
    return x[:cut].astype(np.float32), y[:cut].astype(np.int64)


def peer_rows(dataset: str, num_nodes: int, poison_fraction: float,
              peers: Iterable[int], threads: int = 8
              ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """{peer: (x_train, y_train)} for `peers`, drawn on `threads` threads."""
    means = class_means(dataset)
    bad = poisoned(num_nodes, poison_fraction)
    peers = sorted(set(int(p) for p in peers))
    with ThreadPoolExecutor(threads) as pool:
        got = list(pool.map(lambda p: train_rows(dataset, p, p in bad, means),
                            peers))
    return dict(zip(peers, got))
