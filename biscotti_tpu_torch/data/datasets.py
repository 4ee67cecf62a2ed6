"""Dataset registry and deterministic per-peer shards.

The port's own copy of `biscotti_tpu/data/datasets.py` (pure numpy, so it
imports nothing of the JAX package). It must give bit-identical shards: the
sha256-keyed `_rng` below keeps the JAX package's seed strings unchanged.

Capability parity with the reference's registry (ref: ML/Pytorch/datasets.py:6-52
— mnist 784/10, lfw 8742/12, cifar 3072/10, creditcard 24/2) and its per-peer
`.npy` shard loader with an 80/20 train cut (ref: ML/Pytorch/mnist_dataset.py:16-31).

This environment has zero egress, so the reference-dimension shards (mnist /
cifar / lfw / creditcard) are *synthesized*: each dataset is a fixed mixture of
Gaussian class clusters drawn from a dataset-specific threefry key. Generation
is fully deterministic in (dataset, shard_name), so every peer process
regenerates bit-identical shards — the property the reference gets from
shipping `.npy` files, and the chain-equality oracle implicitly relies on.

Two REAL datasets ship alongside them, loaded from scikit-learn's bundled
(offline) data so accuracy claims are falsifiable on real distributions:

  "digits"  1,797 real 8×8 handwritten digit scans (UCI optical digits,
            the small real sibling of MNIST) — 64 features, 10 classes
  "cancer"  569 real tabular diagnostic records (Wisconsin breast cancer) —
            30 standardized features, 2 classes, the real sibling of the
            reference's creditcard tabular task

Real shards are disjoint slices of a deterministic dataset-keyed shuffle, so
they are bit-identical across peer processes exactly like the synthetic ones.

Poisoned shards follow the reference's generate_poisoned exactly
(ref: ML/Pytorch/data/mnist/parse_mnist.py:295-301): ALL-source-class
data relabeled as the target (1 → 7 for mnist) — every row carries the
attack, which is both its damage and the geometric signal Krum separates
on. The reference calls these `mnist_bad` / `creditbad`, here uniformly
`<dataset>_bad<i>` — use `shard_name()` to construct names. Real-corpus
bad shards draw from the TRAIN slice only (never the held-out rows the
attack-rate metric scores). The attack split (`<dataset>_digit1`) is
all-source-class data for the attack-rate metric. Malformed shard names
raise instead of silently resolving.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    d_in: int
    n_classes: int
    shard_size: int  # samples per peer shard
    test_size: int
    attack_source: int = 1  # label-flip source class (1→7 for mnist)
    attack_target: int = 7
    cluster_scale: float = 1.0  # intra-class spread
    real: bool = False  # backed by a bundled real dataset (see module doc)


DATASETS: Dict[str, DatasetSpec] = {
    "mnist": DatasetSpec("mnist", 784, 10, 600, 2000),
    "cifar": DatasetSpec("cifar", 3072, 10, 500, 2000),
    "lfw": DatasetSpec("lfw", 8742, 12, 200, 1000),
    "creditcard": DatasetSpec("creditcard", 24, 2, 400, 1000,
                              attack_source=0, attack_target=1),
    # real data (scikit-learn bundled, offline): shard/test sizes chosen so
    # a 10-peer run consumes the whole corpus with a held-out test pool
    "digits": DatasetSpec("digits", 64, 10, 140, 397, real=True),
    "cancer": DatasetSpec("cancer", 30, 2, 40, 169,
                          attack_source=0, attack_target=1, real=True),
}


def base_name(dataset: str) -> str:
    """Strip the heterogeneity suffix: "mnist@dir0.3" → "mnist"."""
    return dataset.split("@dir", 1)[0]


def dirichlet_alpha(dataset: str) -> "float | None":
    """Per-peer class-skew knob (VERDICT r3 #2). A dataset named
    "<base>@dir<alpha>" draws every SYNTHETIC peer shard's class
    distribution from Dirichlet(alpha·1): small alpha ⇒ each peer holds a
    few dominant classes — the natural heterogeneity real federated
    shards have, and the geometry Krum needs to separate label-flip
    poisoners from honest peers (homogeneous shards make every honest
    update near-identical, so poisoned ones hide inside the cluster; see
    eval/results/poison.json separation_note). Test/attack splits stay
    balanced and IDENTICAL to the base dataset, so error columns remain
    comparable."""
    if "@dir" not in dataset:
        return None
    raw = dataset.split("@dir", 1)[1]
    try:
        alpha = float(raw)
    except ValueError:
        raise ValueError(f"malformed heterogeneity suffix in {dataset!r}; "
                         f"expected <base>@dir<float>")
    if alpha <= 0:
        raise ValueError(f"dirichlet alpha must be positive, got {alpha}")
    return alpha


def _spec(dataset: str) -> DatasetSpec:
    alpha = dirichlet_alpha(dataset)  # validates the suffix shape
    dataset = base_name(dataset)
    if dataset not in DATASETS:
        raise KeyError(f"dataset {dataset!r} not defined; have {sorted(DATASETS)}")
    spec = DATASETS[dataset]
    if alpha is not None and spec.real:
        raise ValueError("@dir heterogeneity applies to synthetic datasets "
                         "only (real corpora carry their own skew)")
    return spec


def num_features(dataset: str) -> int:
    return _spec(dataset).d_in


def num_classes(dataset: str) -> int:
    return _spec(dataset).n_classes


def num_params(dataset: str) -> int:
    """Reference-registry parity value: the *softmax* parameter count
    d_in·k + k (ref: datasets.py:19-20 — mnist 7850, creditcard 50).

    NOTE: the authoritative wire size for any run is
    `model_for_dataset(ds).num_params` — e.g. creditcard's default model is
    the numpy-parity logreg (25 params), while this registry reports the
    softmax value 50, exactly as the reference registry does even though
    its creditcard runs use the d=25 logreg stack. Size buffers from the
    model, not from here."""
    s = _spec(dataset)
    return s.d_in * s.n_classes + s.n_classes


def _rng(dataset: str, tag: str) -> np.random.Generator:
    seed = int.from_bytes(
        hashlib.sha256(f"biscotti_tpu/{dataset}/{tag}".encode()).digest()[:8], "little"
    )
    return np.random.default_rng(seed)


@lru_cache(maxsize=None)
def _class_means(dataset: str) -> np.ndarray:
    """Fixed class-cluster means. Separation 6.0 makes a linear model's
    reachable test error ≈7% from a few hundred samples — the same band as
    the reference's real-MNIST finals (BASELINE.md: 0.065–0.113) — while
    smaller separations drown the signal in 784-dim noise."""
    s = _spec(dataset)
    rng = _rng(dataset, "means")
    means = rng.normal(0.0, 1.0, size=(s.n_classes, s.d_in))
    return (means / np.linalg.norm(means, axis=1, keepdims=True)).astype(np.float32) * 6.0


@lru_cache(maxsize=None)
def _real_corpus(dataset: str) -> Tuple[np.ndarray, np.ndarray]:
    """Full real corpus, standardized, in a deterministic dataset-keyed
    shuffle order (identical in every peer process). sklearn's bundled
    datasets load from files inside the installed package — no network."""
    from sklearn.datasets import load_breast_cancer, load_digits

    if dataset == "digits":
        raw = load_digits()
        x = (raw.data / 16.0).astype(np.float32)  # pixel range 0..16
    elif dataset == "cancer":
        raw = load_breast_cancer()
        x = raw.data.astype(np.float32)
        x = (x - x.mean(axis=0)) / (x.std(axis=0) + 1e-8)
    else:
        raise KeyError(f"no real corpus for dataset {dataset!r}")
    y = raw.target.astype(np.int32)
    order = _rng(dataset, "corpus-shuffle").permutation(len(x))
    return np.ascontiguousarray(x[order]), np.ascontiguousarray(y[order])


def disjoint_shard_capacity(dataset: str) -> "int | None":
    """How many peers can hold fully DISJOINT shards of a REAL corpus
    (None for synthetic datasets, which generate per-peer data freely).
    Beyond this count `_draw`'s wrap-around reuses overlapping slices —
    callers reporting defense statistics should disclose that (a poisoned
    peer's shard may coincide with an honest peer's). Single source of
    truth for the slicing math in `_draw` below."""
    s = _spec(dataset)
    if not s.real:
        return None
    corpus_n = len(_real_corpus(dataset)[0])
    return max(1, (corpus_n - s.test_size) // s.shard_size)


def _draw(dataset: str, tag: str, n: int) -> Tuple[np.ndarray, np.ndarray]:
    s = _spec(dataset)
    if s.real:
        x, y = _real_corpus(dataset)
        if tag in ("test", "attack"):
            return x[-s.test_size:], y[-s.test_size:]
        assert tag.startswith("shard")
        peer = int(tag[len("shard"):])
        train_n = len(x) - s.test_size
        # disjoint slices while the corpus lasts; peers beyond capacity wrap
        # around (real corpora are small — a 100-peer digits run reuses
        # slices rather than failing, and the wrap is deterministic)
        start = (peer * s.shard_size) % max(1, train_n - s.shard_size + 1)
        return x[start:start + n], y[start:start + n]
    alpha = dirichlet_alpha(dataset)
    if tag in ("test", "attack"):
        # shared splits are balanced and IDENTICAL across @dir variants
        dataset = base_name(dataset)
        alpha = None
    rng = _rng(dataset, tag)
    means = _class_means(base_name(dataset))
    if alpha is not None:
        # per-peer class skew: the shard's own tag-seeded stream draws its
        # Dirichlet class distribution, so every peer's skew is distinct
        # and deterministic
        p = rng.dirichlet(np.full(s.n_classes, alpha))
        y = rng.choice(s.n_classes, size=n, p=p)
    else:
        y = rng.integers(0, s.n_classes, size=n)
    x = means[y] + rng.normal(0.0, s.cluster_scale, size=(n, s.d_in)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)


@lru_cache(maxsize=None)
def load_shard(dataset: str, shard: str) -> Dict[str, np.ndarray]:
    """Load a named shard, mirroring the reference file names:

      "<dataset><i>"      honest shard of peer i  (ref: mnistN.npy)
      "<dataset>_bad<i>"  label-flipped shard     (ref: mnist_bad)
      "<dataset>_test"    shared held-out split
      "<dataset>_digit1"  attack split (all source-class samples)

    Returns {"x_train","y_train","x_test","y_test"} with an 80/20 cut for
    per-peer shards (ref: mnist_dataset.py:16-31).
    """
    s = _spec(dataset)
    if shard == f"{dataset}_test":
        x, y = _draw(dataset, "test", s.test_size)
        return {"x_train": x, "y_train": y, "x_test": x, "y_test": y}
    if shard == f"{dataset}_digit1":
        x, y = _draw(dataset, "attack", s.test_size)
        keep = y == s.attack_source
        return {"x_train": x[keep], "y_train": y[keep],
                "x_test": x[keep], "y_test": y[keep]}

    bad = shard.startswith(f"{dataset}_bad")
    prefix = f"{dataset}_bad" if bad else dataset
    if not shard.startswith(prefix):
        raise ValueError(f"shard {shard!r} does not belong to dataset {dataset!r}")
    idx = shard[len(prefix):]
    if idx and not idx.isdigit():
        raise ValueError(f"malformed shard name {shard!r} for dataset {dataset!r}")
    peer = int(idx) if idx else 0
    x, y = _draw(dataset, f"shard{peer}", s.shard_size)
    if bad:
        # The reference's poisoned shard is ALL-source-class data labeled
        # as the target (parse_mnist.py generate_poisoned: mnist_digit1
        # with y := 7 saved as mnist_bad) — NOT an honest shard with its
        # source rows flipped. Every poisoned minibatch row pushes the
        # 1→7 direction, which is both the attack's damage and the
        # geometric signal Krum separates on. Mirror it: keep the peer's
        # own deterministic stream but condition every row on the source
        # class, then relabel. (Round 1-3 flipped ~10% of an honest
        # shard — a 10× weaker attack than the reference's.)
        if s.real:
            cx, cy = _real_corpus(dataset)
            # TRAIN slice only: the corpus tail is the held-out test/
            # attack split — letting poisoned peers train on the exact
            # rows attack_rate is measured on would inflate the
            # undefended attack into a memorization artifact
            train_n = len(cx) - s.test_size
            keep = cy[:train_n] == s.attack_source
            sx, sy = cx[:train_n][keep], cy[:train_n][keep]
            if len(sx) == 0:
                raise ValueError(
                    f"corpus train slice for {dataset!r} has no "
                    f"attack-source (class {s.attack_source}) rows — "
                    f"cannot build a poisoned shard")
            start = (peer * s.shard_size) % max(1, len(sx))
            idxs = (start + np.arange(s.shard_size)) % len(sx)
            x, y = sx[idxs], sy[idxs].copy()
        else:
            rng = _rng(dataset, f"badshard{peer}")
            means = _class_means(base_name(dataset))
            y = np.full(s.shard_size, s.attack_source, dtype=np.int32)
            x = (means[y] + rng.normal(0.0, s.cluster_scale,
                                       size=(s.shard_size, s.d_in))
                 ).astype(np.float32)
        y = y.copy()
        y[:] = s.attack_target
    cut = int(0.8 * len(x))
    return {"x_train": x[:cut], "y_train": y[:cut],
            "x_test": x[cut:], "y_test": y[cut:]}


def shard_name(dataset: str, peer_id: int, poisoned: bool) -> str:
    """Reference naming: top `poison_fraction` of node ids get bad shards
    (ref: DistSys/main.go:836-845)."""
    return f"{dataset}_bad{peer_id}" if poisoned else f"{dataset}{peer_id}"


def spec(dataset: str) -> DatasetSpec:
    """Public spec accessor — resolves @dir heterogeneity suffixes, so
    callers never index DATASETS directly with a runtime dataset name."""
    return _spec(dataset)
