"""The port's copy of the dataset module gives bit-identical shards."""

import numpy as np
import pytest

from biscotti_tpu.data import datasets as ref
from biscotti_tpu_torch.data import datasets as port

SHARDS = [
    ("mnist", "mnist3"), ("mnist", "mnist_bad7"), ("mnist", "mnist_test"),
    ("mnist", "mnist_digit1"),
    ("creditcard", "creditcard2"), ("creditcard", "creditcard_bad9"),
    ("creditcard", "creditcard_test"), ("creditcard", "creditcard_digit1"),
    ("digits", "digits1"), ("digits", "digits_bad4"),
    ("mnist@dir0.3", "mnist@dir0.35"),
]


@pytest.mark.parametrize("dataset,shard", SHARDS)
def test_shards_bit_equal(dataset, shard):
    a = ref.load_shard(dataset, shard)
    b = port.load_shard(dataset, shard)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert a[key].shape == b[key].shape, key
        assert a[key].tobytes() == b[key].tobytes(), key


@pytest.mark.parametrize("name", sorted(ref.DATASETS))
def test_registry_matches(name):
    assert vars(port.spec(name)) == vars(ref.spec(name))
    assert port.num_params(name) == ref.num_params(name)
    if not ref.spec(name).real:
        assert np.array_equal(port._class_means(name), ref._class_means(name))
