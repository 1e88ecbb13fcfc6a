"""Port parity: synthetic data, partitions and stacked batches are identical."""
import numpy as np
import pytest

import repro.data as jdata
import repro_torch.data as tdata


@pytest.mark.parametrize("name", ["mnist_like", "cifar_like"])
def test_synthetic_identical(name):
    j = getattr(jdata, name)(300, seed=3)
    t = getattr(tdata, name)(300, seed=3)
    np.testing.assert_array_equal(t.x, j.x)
    np.testing.assert_array_equal(t.y, j.y)
    assert t.y.dtype == np.int32 and t.x.dtype == np.float32


@pytest.mark.parametrize("name,kwargs", [
    ("iid_partition", {}),
    ("skewed_label_partition", {"classes_per_client": 2}),
    ("dirichlet_partition", {"beta": 0.5}),
])
def test_partitions_identical(name, kwargs):
    labels = jdata.mnist_like(600, seed=1).y
    j = getattr(jdata, name)(labels, 20, seed=4, **kwargs)
    t = getattr(tdata, name)(labels, 20, seed=4, **kwargs)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_stacked_batch_identical():
    data = jdata.mnist_like(400, seed=0)
    parts = jdata.skewed_label_partition(data.y, 8, seed=0)
    jds = jdata.FederatedDataset(data, parts)
    tds = tdata.FederatedDataset(tdata.SyntheticClassification(data.x, data.y, 10), parts)
    assert tds.data_sizes() == jds.data_sizes()
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        jb, tb = jds.stacked_batch(5, jr), tds.stacked_batch(5, tr)
        np.testing.assert_array_equal(tb["x"], jb["x"])
        np.testing.assert_array_equal(tb["y"], jb["y"])
    np.testing.assert_array_equal(
        tds.stacked_batch(5, tr, clients=[3, 1])["y"], jds.stacked_batch(5, jr, clients=[3, 1])["y"]
    )
