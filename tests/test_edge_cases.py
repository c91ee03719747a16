"""Edge-case and robustness tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maxk_gnn.ops.dispatch import KernelMode, resolve_mode
from maxk_gnn.ops.spgemm import maxk_spgemm, spmm
from maxk_gnn.ops.spmm_xla import spmm_segsum, spmm_tiles_xla
from maxk_gnn.sparse.cbsr import maxk_cbsr
from maxk_gnn.sparse.csr import CSRGraph, csr_from_coo
from maxk_gnn.sparse.graph import build_graph
from maxk_gnn.sparse.meta import build_edge_tiles


def test_resolve_mode_explicit_and_auto():
    assert resolve_mode("segsum", True) == KernelMode.SEGSUM
    assert resolve_mode("tiles_scan", True) == KernelMode.TILES_SCAN
    # auto runs whatever schedule the graph was built with
    # (`ops/dispatch.choose_mode` decided before the build)
    assert resolve_mode("auto", False) == KernelMode.SEGSUM
    assert resolve_mode("auto", True) == KernelMode.TILES_SCAN
    assert resolve_mode("auto", False, True) == KernelMode.HYBRID


def test_graph_symmetric_autodetect(small_graph):
    # undirected graph + "both" norm → symmetric: csc shares csr arrays
    g = build_graph(small_graph, norm="both", build_tiles=False)
    assert g.csc is g.csr
    # "right" norm breaks value symmetry → separate transpose
    g2 = build_graph(small_graph, norm="right", build_tiles=False)
    assert g2.csc is not g2.csr


def test_graph_with_isolated_nodes():
    """Rows with no edges at all (beyond what the pipeline adds)."""
    rows = np.array([0, 1])
    cols = np.array([1, 0])
    g = csr_from_coo(rows, cols, 10)  # nodes 2..9 isolated
    x = jnp.ones((10, 8), jnp.float32)
    y = np.asarray(spmm_segsum(g, x))
    assert np.all(y[2:] == 0)
    tiles = build_edge_tiles(g, 8, 16)
    y2 = np.asarray(spmm_tiles_xla(tiles, x))
    np.testing.assert_allclose(y2, y, atol=1e-6)


def test_maxk_k_equals_dim(small_graph):
    """k == D keeps everything: spgemm equals dense spmm."""
    graph = build_graph(small_graph, norm="right", build_tiles=False)
    rng = np.random.default_rng(6)
    d = 16
    x = jnp.asarray(rng.standard_normal((small_graph.num_nodes, d)), jnp.float32)
    cbsr = maxk_cbsr(x, d)
    y1 = maxk_spgemm(graph, cbsr, dim=d, mode="segsum")
    y2 = spmm(graph, x, mode="segsum")
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-4, atol=1e-5)


def test_single_node_graph():
    g = csr_from_coo(np.array([0]), np.array([0]), 1)
    x = jnp.ones((1, 4), jnp.float32)
    np.testing.assert_allclose(np.asarray(spmm_segsum(g, x)), x, atol=1e-6)


def test_spgemm_jit_and_grad_composition(small_graph):
    """jit(grad(loss)) over the full composite: top-k → spgemm → loss."""
    graph = build_graph(small_graph, norm="right", build_tiles=True)
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.standard_normal((small_graph.num_nodes, 32)), jnp.float32)

    @jax.jit
    def gradfn(x, graph):
        def loss(x):
            cbsr = maxk_cbsr(x, 4)
            return jnp.sum(maxk_spgemm(graph, cbsr, dim=32, mode="tiles_scan") ** 2)

        return jax.grad(loss)(x)

    g1 = gradfn(x, graph)
    assert np.isfinite(np.asarray(g1)).all()

    def loss_ref(x):
        from maxk_gnn.sparse.cbsr import cbsr_densify

        cbsr = maxk_cbsr(x, 4)
        return jnp.sum(spmm_segsum(graph.csr, cbsr_densify(cbsr, 32)) ** 2)

    g2 = jax.grad(loss_ref)(x)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-3, atol=1e-3)


def test_lookahead_chain_with_weight_decay(tiny_data):
    from maxk_gnn.train.loop import train
    from maxk_gnn.train.config import TrainConfig

    cfg = TrainConfig(
        dataset="flickr", model="sage", epochs=10, lr=0.01,
        weight_decay=1e-4, hidden_dim=32, hidden_layers=2, maxk=8,
        dropout=0.0, kernel_mode="segsum", enable_lookahead=True,
    )
    state = train(cfg, tiny_data)
    assert np.isfinite(state.best_val)
