"""C++ native preprocessing vs the numpy reference implementation."""

import numpy as np
import pytest

from maxk_gnn.sparse import _native
from maxk_gnn.sparse.csr import csr_to_scipy

pytestmark = pytest.mark.skipif(
    not _native.available(), reason="native lib unavailable (no toolchain)"
)


def test_native_edge_tiles_match_numpy(small_graph):
    indptr = np.asarray(small_graph.indptr, dtype=np.int64)
    indices = np.asarray(small_graph.indices)
    values = np.asarray(small_graph.values)
    tb, tc, tv, tl = _native.edge_tiles_native(indptr, indices, values, 8, 64)

    # numpy reference (the vectorized path in meta.py)
    import maxk_gnn.sparse.meta as meta

    orig = _native.edge_tiles_native
    try:
        _native.edge_tiles_native = lambda *a, **k: None  # force numpy path
        tiles = meta.build_edge_tiles(small_graph, 8, 64)
    finally:
        _native.edge_tiles_native = orig
    # build_edge_tiles pads both paths to meta.TILE_PAD (raw native
    # output is unpadded): real prefix must match exactly, padding must
    # be inert (last real block id, zero values)
    nt = tb.shape[0]
    np.testing.assert_array_equal(tb, np.asarray(tiles.block)[:nt])
    np.testing.assert_array_equal(tc, np.asarray(tiles.cols)[:nt])
    np.testing.assert_array_equal(tl, np.asarray(tiles.localrow)[:nt])
    np.testing.assert_allclose(tv, np.asarray(tiles.vals)[:nt], rtol=1e-6)
    assert tiles.num_tiles % meta.TILE_PAD == 0
    np.testing.assert_array_equal(np.asarray(tiles.block)[nt:], tb[-1])
    assert not np.asarray(tiles.vals)[nt:].any()


def test_native_transpose_matches_scipy(small_graph):
    indptr = np.asarray(small_graph.indptr, dtype=np.int64)
    indices = np.asarray(small_graph.indices)
    values = np.asarray(small_graph.values)
    oip, oix, ovl = _native.csr_transpose_native(indptr, indices, values)
    t = csr_to_scipy(small_graph).T.tocsr()
    t.sort_indices()
    np.testing.assert_array_equal(oip, t.indptr)
    np.testing.assert_array_equal(oix, t.indices)
    np.testing.assert_allclose(ovl, t.data, rtol=1e-6)
