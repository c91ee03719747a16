"""Sparse container + metadata tests (oracle: scipy / dense numpy)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from maxk_gnn.sparse.cbsr import CBSR, cbsr_densify, cbsr_sample, maxk_cbsr, maxk_mask
from maxk_gnn.sparse.csr import (
    add_self_loops,
    csr_from_coo,
    csr_to_scipy,
    csr_transpose,
    symmetrize,
    with_norm,
)
from maxk_gnn.sparse.meta import build_edge_tiles


def test_csr_from_coo_dedup():
    rows = np.array([0, 0, 1, 2, 2, 2])
    cols = np.array([1, 1, 2, 0, 0, 1])
    g = csr_from_coo(rows, cols, 3)
    m = csr_to_scipy(g).toarray()
    expect = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 0]], dtype=np.float32)
    np.testing.assert_array_equal(m, expect)


def test_row_ids_with_empty_rows():
    # rows 1 and 3 empty
    rows = np.array([0, 2, 2, 4])
    cols = np.array([1, 0, 3, 4])
    g = csr_from_coo(rows, cols, 5)
    np.testing.assert_array_equal(np.asarray(g.row_ids()), [0, 2, 2, 4])


def test_transpose_roundtrip(small_graph):
    gt = csr_transpose(small_graph)
    a = csr_to_scipy(small_graph).toarray()
    at = csr_to_scipy(gt).toarray()
    np.testing.assert_allclose(a.T, at, rtol=1e-6)


def test_with_norm_right(small_graph):
    g = with_norm(small_graph, "right")
    a = csr_to_scipy(g).toarray()
    sums = a.sum(1)
    nonzero = np.asarray(small_graph.in_degrees()) > 0
    np.testing.assert_allclose(sums[nonzero], 1.0, rtol=1e-5)


def test_with_norm_both_symmetric(small_graph):
    g = with_norm(small_graph, "both")
    a = csr_to_scipy(g).toarray()
    np.testing.assert_allclose(a, a.T, rtol=1e-5)


def test_self_loops_and_symmetrize():
    rows, cols = np.array([0, 1]), np.array([1, 2])
    g = symmetrize(csr_from_coo(rows, cols, 3))
    a = csr_to_scipy(g).toarray()
    np.testing.assert_array_equal(a, a.T)
    g2 = add_self_loops(g)
    assert np.all(csr_to_scipy(g2).toarray().diagonal() == 1)


def test_maxk_cbsr_and_densify():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((17, 16)), jnp.float32)
    cbsr = maxk_cbsr(x, 4)
    dense = cbsr_densify(cbsr, 16)
    # matches mask formulation
    masked = maxk_mask(x, 4)
    np.testing.assert_allclose(np.asarray(dense), np.asarray(masked), atol=1e-6)
    # exactly k nonzeros per row (generic values)
    assert np.all((np.asarray(dense) != 0).sum(1) == 4)


def test_cbsr_densify_blocked_matches():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((1000, 32)), jnp.float32)
    cbsr = maxk_cbsr(x, 8)
    d1 = cbsr_densify(cbsr, 32)
    # the same scatter built row block by row block on the host
    d2 = np.zeros((1000, 32), np.float32)
    vals, sel = np.asarray(cbsr.values), np.asarray(cbsr.selector)
    for r0 in range(0, 1000, 128):
        rows = np.arange(r0, min(r0 + 128, 1000))[:, None]
        d2[rows, sel[rows[:, 0]]] = vals[rows[:, 0]]
    np.testing.assert_array_equal(np.asarray(d1), d2)


def test_cbsr_sample_inverts_densify():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((64, 32)), jnp.float32)
    cbsr = maxk_cbsr(x, 8)
    dense = cbsr_densify(cbsr, 32)
    vals = cbsr_sample(dense, cbsr.selector)
    np.testing.assert_allclose(np.asarray(vals), np.asarray(cbsr.values), atol=1e-6)


@pytest.mark.parametrize("row_block,edge_tile", [(8, 64), (8, 256), (16, 128)])
def test_edge_tiles_cover_all_edges(small_graph, row_block, edge_tile):
    tiles = build_edge_tiles(small_graph, row_block, edge_tile)
    # total real (nonzero-valued) edges preserved
    assert int((np.asarray(tiles.vals) != 0).sum()) == small_graph.nnz
    # every tile's block id is sorted ascending
    blk = np.asarray(tiles.block)
    assert np.all(np.diff(blk) >= 0)
    # every row-block appears at least once
    assert set(range(tiles.num_row_blocks)) == set(blk.tolist())
    # localrow within range
    assert np.asarray(tiles.localrow).max() < row_block


def test_edge_tiles_reconstruct_matrix(small_graph):
    """Tiles → dense matrix equals the original (the tile-table oracle)."""
    tiles = build_edge_tiles(small_graph, 8, 64)
    v = small_graph.num_nodes
    dense = np.zeros((tiles.num_row_blocks * 8, v), dtype=np.float32)
    blk = np.asarray(tiles.block)
    cols = np.asarray(tiles.cols)
    vals = np.asarray(tiles.vals)
    lrow = np.asarray(tiles.localrow)
    for t in range(tiles.num_tiles):
        for e in range(tiles.edge_tile):
            if vals[t, e] != 0:
                dense[blk[t] * 8 + lrow[t, e], cols[t, e]] += vals[t, e]
    np.testing.assert_allclose(
        dense[:v], csr_to_scipy(small_graph).toarray(), rtol=1e-6
    )


def test_device_tiles_spmm_matches(small_graph):
    """On-device tile construction agrees with the host path via SpMM."""
    import jax.numpy as jnp

    from maxk_gnn.ops.spmm_xla import spmm_tiles_xla, spmm_segsum
    from maxk_gnn.sparse.meta import build_edge_tiles_device

    tiles = build_edge_tiles_device(small_graph, 8, 64)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((small_graph.num_nodes, 32)), jnp.float32)
    y1 = spmm_tiles_xla(tiles, x)
    y2 = spmm_segsum(small_graph, x)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-4, atol=1e-4)


def test_device_tiles_exact_count():
    """Device builder emits EXACTLY the host builder's tables — the
    ceil(E/T)+NB bound used to append up to NB all-padding surplus tiles
    that the tail scan then gathered for nothing."""
    from maxk_gnn.data.device_gen import rmat_graph_device
    from maxk_gnn.sparse.meta import build_edge_tiles_device

    g = rmat_graph_device(700, 9000, seed=11)
    for r, t in [(8, 64), (32, 32), (8, 256)]:
        th = build_edge_tiles(g, r, t)
        td = build_edge_tiles_device(g, r, t)
        assert td.num_tiles == th.num_tiles
        np.testing.assert_array_equal(np.asarray(td.block), np.asarray(th.block))
        np.testing.assert_array_equal(np.asarray(td.cols), np.asarray(th.cols))
        np.testing.assert_allclose(np.asarray(td.vals), np.asarray(th.vals))
        np.testing.assert_array_equal(
            np.asarray(td.localrow), np.asarray(th.localrow)
        )


def test_device_rmat_valid_csr():
    from maxk_gnn.data.device_gen import rmat_graph_device
    from maxk_gnn.sparse.csr import with_norm

    g = rmat_graph_device(300, 2000, seed=3)
    indptr = np.asarray(g.indptr)
    # duplicates are compacted into an inert tail past indptr[-1]
    nnz = int(indptr[-1])
    cols = np.asarray(g.indices)[:nnz]
    vals = np.asarray(g.values)[:nnz]
    assert indptr[0] == 0 and nnz <= np.asarray(g.indices).shape[0]
    assert np.all(vals == 1.0)  # live region has no zero-weight slots
    assert np.all(np.asarray(g.values)[nnz:] == 0.0)
    assert (np.diff(indptr) >= 0).all()
    # within-row columns sorted
    for r in range(0, 300, 37):
        c = cols[indptr[r] : indptr[r + 1]]
        assert (np.diff(c) >= 0).all()
    # live edges form a symmetric matrix with a full diagonal
    import scipy.sparse as sp

    m = sp.csr_matrix((vals, cols, indptr), shape=(300, 300))
    assert (abs(m - m.T)).nnz == 0
    assert np.all(m.toarray().diagonal() == 1)
    # soft-dedup: no duplicate live entries — scipy sum_duplicates view
    live = vals != 0
    pairs = set()
    rows = np.repeat(np.arange(300), np.diff(indptr))
    for r, c in zip(rows[live], cols[live]):
        assert (r, c) not in pairs
        pairs.add((r, c))
    # degree-normalization counts only live edges
    gn = with_norm(g, "right")
    sums = sp.csr_matrix(
        (np.asarray(gn.values)[:nnz], cols, indptr), shape=(300, 300)
    ).sum(1).A1
    np.testing.assert_allclose(sums, 1.0, rtol=1e-5)


def test_reorder_rcm_preserves_spmm(small_graph):
    """RCM-permuted SpMM equals permuted original output."""
    from maxk_gnn.ops.spmm_xla import spmm_segsum
    from maxk_gnn.sparse.csr import reorder_rcm

    g2, perm = reorder_rcm(small_graph)
    rng = np.random.default_rng(4)
    x = jnp.asarray(
        rng.standard_normal((small_graph.num_nodes, 16)), jnp.float32
    )
    y = np.asarray(spmm_segsum(small_graph, x))
    y2 = np.asarray(spmm_segsum(g2, x[perm]))
    np.testing.assert_allclose(y2, y[perm], rtol=1e-4, atol=1e-4)
    # bandwidth actually reduced (column spread within rows shrinks)
    def mean_span(g):
        ip = np.asarray(g.indptr)
        ix = np.asarray(g.indices)
        spans = [
            np.ptp(ix[ip[r] : ip[r + 1]])
            for r in range(g.num_nodes)
            if ip[r + 1] - ip[r] > 1
        ]
        return np.mean(spans)

    assert mean_span(g2) < mean_span(small_graph)


def test_tiles_scan_window_exact():
    """Shrunk RMW window (build-time max_block_span) is numerically
    identical to the full-chunk window, including the padded final
    chunk whose inert tiles alias block nb-1 outside the window."""
    import jax.numpy as jnp

    from maxk_gnn.data.device_gen import rmat_graph_device
    from maxk_gnn.ops.spmm_xla import spmm_segsum, spmm_tiles_scan
    from maxk_gnn.sparse.meta import build_edge_tiles, max_block_span

    g = rmat_graph_device(900, 12000, seed=13)
    tiles = build_edge_tiles(g, 8, 64)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((900, 64)), jnp.float32)
    ref = np.asarray(spmm_segsum(g, x))
    for chunk in (16, 64):
        w = max_block_span(tiles.block, chunk)
        assert w <= chunk
        y = np.asarray(spmm_tiles_scan(tiles, x, chunk=chunk, window=w))
        np.testing.assert_allclose(y, ref, rtol=2e-4, atol=2e-4)
        yf = np.asarray(spmm_tiles_scan(tiles, x, chunk=chunk))
        np.testing.assert_allclose(y, yf, rtol=1e-6, atol=1e-6)
