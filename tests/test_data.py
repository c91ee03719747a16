"""Dataset registry, synthetic generators, binary IO tests."""

import numpy as np
import pytest

from maxk_gnn.data.datasets import DATASETS, load_dataset
from maxk_gnn.data.io import (
    list_graph_binaries,
    load_graph_binary,
    save_graph_binary,
)
from maxk_gnn.data.synthetic import rmat_graph
from maxk_gnn.sparse.csr import csr_to_scipy


def test_rmat_graph_structure():
    g = rmat_graph(500, 4000, seed=1)
    a = csr_to_scipy(g)
    assert a.shape == (500, 500)
    # undirected + self loops
    assert (abs(a - a.T)).nnz == 0
    assert np.all(a.toarray().diagonal() == 1)
    # power-law-ish: max degree well above mean
    deg = np.diff(np.asarray(g.indptr))
    assert deg.max() > 4 * deg.mean()


def test_rmat_deterministic():
    g1 = rmat_graph(200, 1000, seed=5)
    g2 = rmat_graph(200, 1000, seed=5)
    np.testing.assert_array_equal(np.asarray(g1.indices), np.asarray(g2.indices))


@pytest.mark.parametrize("name", ["flickr", "yelp"])
def test_load_dataset_scaled(name):
    data = load_dataset(name, scale=0.01)
    spec = DATASETS[name]
    assert data.features.shape[1] == spec.feat_dim
    assert data.num_classes == spec.num_classes
    assert data.multilabel == spec.multilabel
    if data.multilabel:
        assert data.labels.shape == (data.csr.num_nodes, spec.num_classes)
    else:
        assert data.labels.max() < spec.num_classes
    # masks partition the nodes
    total = data.train_mask | data.val_mask | data.test_mask
    assert total.all()
    assert not (data.train_mask & data.val_mask).any()


def test_graph_binary_roundtrip(tmp_path, small_graph):
    prefix = str(tmp_path / "g")
    save_graph_binary(
        prefix,
        np.asarray(small_graph.indptr),
        np.asarray(small_graph.indices),
        np.asarray(small_graph.values),
    )
    g2 = load_graph_binary(prefix)
    np.testing.assert_array_equal(
        np.asarray(small_graph.indices), np.asarray(g2.indices)
    )
    assert list_graph_binaries(str(tmp_path)) == [prefix]


def test_graph_binary_no_values(tmp_path, small_graph):
    prefix = str(tmp_path / "g")
    save_graph_binary(
        prefix, np.asarray(small_graph.indptr), np.asarray(small_graph.indices)
    )
    g2 = load_graph_binary(prefix)
    assert np.all(np.asarray(g2.values) == 1.0)
