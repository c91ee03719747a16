"""Aggregation op tests: XLA paths vs dense oracle, gradients vs jax.grad.

Mirrors the reference validation strategy (kernel output vs cuSPARSE,
`direct_kernel_interface.py:221-372`) with the dense matmul as ground
truth, plus the gradient checks the reference never had (SURVEY §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maxk_gnn.ops.spgemm import maxk_spgemm, spmm
from maxk_gnn.ops.spmm_xla import spmm_dense, spmm_segsum, spmm_tiles_xla
from maxk_gnn.sparse.cbsr import cbsr_densify, maxk_cbsr
from maxk_gnn.sparse.csr import csr_to_scipy, with_norm
from maxk_gnn.sparse.graph import build_graph
from maxk_gnn.sparse.meta import build_edge_tiles

D = 64


def _x(small_graph, d=D, seed=3):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        rng.standard_normal((small_graph.num_nodes, d)), jnp.float32
    )


def test_spmm_segsum_matches_scipy(small_graph):
    x = _x(small_graph)
    y = spmm_segsum(small_graph, x)
    expect = csr_to_scipy(small_graph) @ np.asarray(x)
    np.testing.assert_allclose(np.asarray(y), expect, rtol=1e-4, atol=1e-4)


def test_spmm_segsum_scan_matches_oneshot(small_graph):
    from maxk_gnn.ops.spmm_xla import spmm_segsum_scan

    g = with_norm(small_graph, "right")
    x = _x(small_graph)
    # edge_chunk far below E so the scan really splits rows across chunks
    y = spmm_segsum_scan(g, x, edge_chunk=32)
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(spmm_segsum(g, x)), rtol=1e-4, atol=1e-4
    )


def test_spmm_tiles_matches_segsum(small_graph):
    g = with_norm(small_graph, "right")
    x = _x(small_graph)
    tiles = build_edge_tiles(g, 8, 64)
    y1 = spmm_tiles_xla(tiles, x)
    y2 = spmm_segsum(g, x)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-4, atol=1e-4)


def test_spmm_dense_oracle(small_graph):
    x = _x(small_graph)
    np.testing.assert_allclose(
        np.asarray(spmm_dense(small_graph, x)),
        csr_to_scipy(small_graph) @ np.asarray(x),
        rtol=1e-4,
        atol=1e-4,
    )


@pytest.mark.parametrize("mode", ["segsum", "tiles_xla"])
def test_spmm_custom_vjp_matches_autodiff(small_graph, mode):
    graph = build_graph(small_graph, norm="right", build_tiles=True)
    x = _x(small_graph)
    ct = _x(small_graph, seed=11)

    def f(x):
        return jnp.vdot(spmm(graph, x, mode=mode), ct)

    def f_ref(x):
        return jnp.vdot(spmm_segsum(graph.csr, x), ct)

    gx = jax.grad(f)(x)
    gref = jax.grad(f_ref)(x)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(gref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["segsum", "tiles_xla"])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_maxk_spgemm_forward(small_graph, mode, k):
    graph = build_graph(small_graph, norm="right", build_tiles=True)
    x = _x(small_graph)
    cbsr = maxk_cbsr(x, k)
    y = maxk_spgemm(graph, cbsr, dim=D, mode=mode)
    expect = csr_to_scipy(graph.csr) @ np.asarray(cbsr_densify(cbsr, D))
    np.testing.assert_allclose(np.asarray(y), expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("norm", ["right", "both", "none"])
def test_maxk_spgemm_grad_vs_oracle(small_graph, norm):
    """custom_vjp gradient == jax.grad of the naturally-differentiable
    oracle composition (the check the reference's buggy save/unpack
    autograd needed, SURVEY §7 'known defects')."""
    graph = build_graph(small_graph, norm=norm, build_tiles=True)
    x = _x(small_graph)
    ct = _x(small_graph, seed=13)
    k = 8

    def f(x):
        cbsr = maxk_cbsr(x, k)
        return jnp.vdot(maxk_spgemm(graph, cbsr, dim=D, mode="segsum"), ct)

    def f_ref(x):
        cbsr = maxk_cbsr(x, k)
        dense = cbsr_densify(cbsr, D)
        return jnp.vdot(spmm_segsum(graph.csr, dense), ct)

    gx = jax.grad(f)(x)
    gref = jax.grad(f_ref)(x)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(gref), rtol=1e-4, atol=1e-4)


def test_maxk_spgemm_directed_transpose():
    """On a *directed* graph with right-norm, backward must use the true
    transpose (the bug class the reference hit with CSR-metadata-fed
    backward, SURVEY §7)."""
    from maxk_gnn.sparse.csr import csr_from_coo

    rng = np.random.default_rng(5)
    v, e = 50, 300
    rows, cols = rng.integers(0, v, e), rng.integers(0, v, e)
    g = csr_from_coo(rows, cols, v)
    graph = build_graph(g, norm="right", build_tiles=True)
    x = jnp.asarray(rng.standard_normal((v, D)), jnp.float32)
    ct = jnp.asarray(rng.standard_normal((v, D)), jnp.float32)
    k = 4

    def f(x):
        return jnp.vdot(maxk_spgemm(graph, maxk_cbsr(x, k), dim=D, mode="segsum"), ct)

    def f_ref(x):
        dense = cbsr_densify(maxk_cbsr(x, k), D)
        return jnp.vdot(spmm_segsum(graph.csr, dense), ct)

    np.testing.assert_allclose(
        np.asarray(jax.grad(f)(x)),
        np.asarray(jax.grad(f_ref)(x)),
        rtol=1e-4,
        atol=1e-4,
    )


def test_bf16_compute_dtype_close(small_graph):
    graph = build_graph(small_graph, norm="right", build_tiles=True)
    x = _x(small_graph)
    cbsr = maxk_cbsr(x, 8)
    y32 = maxk_spgemm(graph, cbsr, dim=D, mode="segsum")
    y16 = maxk_spgemm(
        graph, cbsr, dim=D, mode="segsum", compute_dtype=jnp.bfloat16
    )
    assert y16.dtype == jnp.float32
    err = np.abs(np.asarray(y32) - np.asarray(y16)).mean()
    scale = np.abs(np.asarray(y32)).mean() + 1e-6
    assert err / scale < 0.03


def test_spmm_tiles_scan_matches_segsum(small_graph):
    from maxk_gnn.ops.spmm_xla import spmm_tiles_scan

    g = with_norm(small_graph, "right")
    x = _x(small_graph)
    tiles = build_edge_tiles(g, 8, 64)
    y1 = spmm_tiles_scan(tiles, x, chunk=7)
    y2 = spmm_segsum(g, x)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-4, atol=1e-4)


def test_spmm_custom_vjp_tiles_scan(small_graph):
    graph = build_graph(small_graph, norm="right", build_tiles=True)
    x = _x(small_graph)
    ct = _x(small_graph, seed=11)

    def f(x):
        return jnp.vdot(spmm(graph, x, mode="tiles_scan"), ct)

    def f_ref(x):
        return jnp.vdot(spmm_segsum(graph.csr, x), ct)

    np.testing.assert_allclose(
        np.asarray(jax.grad(f)(x)),
        np.asarray(jax.grad(f_ref)(x)),
        rtol=1e-4,
        atol=1e-4,
    )


@pytest.mark.parametrize("accumulate", ["matmul", "scatter"])
def test_spmm_tiles_scan_accumulate_variants(small_graph, accumulate):
    from maxk_gnn.ops.spmm_xla import spmm_tiles_scan

    g = with_norm(small_graph, "right")
    x = _x(small_graph)
    tiles = build_edge_tiles(g, 8, 64)
    y1 = spmm_tiles_scan(tiles, x, chunk=7, accumulate=accumulate)
    y2 = spmm_segsum(g, x)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-4, atol=1e-4)


def test_spmm_tiles_scan_row_block_1(small_graph):
    from maxk_gnn.ops.spmm_xla import spmm_tiles_scan

    g = with_norm(small_graph, "right")
    x = _x(small_graph)
    tiles = build_edge_tiles(g, 1, 16)
    y1 = spmm_tiles_scan(tiles, x, chunk=13)
    y2 = spmm_segsum(g, x)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-4, atol=1e-4)
