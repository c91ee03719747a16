"""Graph operator bundle: everything the aggregation ops need per graph.

The reference threads four things into every layer: CSR arrays, CSC arrays,
degree vectors, and the warp4 metadata tensor, loaded once at model setup
(`maxk_models_integrated.py:118-165` `set_graph_data` +
`MaxKSpmmWrapper.load_metadata`, `maxk_spgemm_function.py:214-267`).
`Graph` is the equivalent here: one pytree built once per dataset, carrying
the forward CSR, the transpose (CSC-as-CSR of A^T) for the backward
aggregation, and the edge-tile schedules of the tile-scan SpMM.

For undirected graphs (all the reference's training graphs after
`dataset_gen.py` symmetrization) A == A^T and the transpose shares the
forward arrays — the reference reached the same conclusion in its v4
autograd (`spgemmfunction_v4:26-44`).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np
from maxk_gnn.pytree import pytree_dataclass

from maxk_gnn.sparse.csr import CSRGraph, csr_to_scipy, csr_transpose, with_norm
from maxk_gnn.sparse.meta import EdgeTiles, build_edge_tiles, EDGE_TILE, ROW_BLOCK


@pytree_dataclass
class Graph:
    csr: CSRGraph
    csc: CSRGraph  # CSR of A^T (== csr for symmetric A with symmetric norm)
    tiles: Optional[EdgeTiles] = None  # forward schedule
    tiles_t: Optional[EdgeTiles] = None  # backward (A^T) schedule
    # degree-sorted symmetric-strip schedule (ops/spmm_hybrid); when set,
    # csr/tiles are in PERMUTED node space and `perm` maps new→old ids
    hybrid: Optional["HybridSchedule"] = None  # noqa: F821
    perm: Optional[object] = None  # (V,) int32 new→old node ids (pytree leaf)

    @property
    def num_nodes(self) -> int:
        return self.csr.num_nodes

    @property
    def nnz(self) -> int:
        return self.csr.nnz


def build_graph(
    csr: CSRGraph,
    norm: str = "none",
    build_tiles: bool = True,
    symmetric: Optional[bool] = None,
    row_block: int = ROW_BLOCK,
    edge_tile: int = EDGE_TILE,
    hybrid: bool = False,
    strip_cols: Optional[int] = None,  # None → auto (HBM-budget-capped)
    tail_band_cols: int = -1,  # -1 → auto rule; 0 → single band
    dim: int = 256,  # model feature width — sizes the strip HBM budget
    strip_dtype=None,  # None → auto (int8 where exact, else bf16)
) -> Graph:
    """Build the operator bundle. `norm` folds degree normalization into edge
    values (see `maxk_gnn.sparse.csr.with_norm`).

    symmetric=None autodetects A == A^T *after normalization* (true for
    "none"/"both" on undirected graphs) and shares arrays when possible.

    With `hybrid=True` (and a raw-value-symmetric graph) the nodes are
    permuted by descending degree and the symmetric-strip schedule is
    built (`sparse/hybrid.py`); the returned Graph is entirely in
    permuted space and carries `perm` so callers can permute node data
    (`features[perm]` etc.). Falls back silently for directed graphs.
    """
    hyb = None
    perm = None
    if hybrid:
        from maxk_gnn.sparse.hybrid import (
            auto_strip_cols,
            auto_strip_dtype,
            auto_tail_band_cols,
            build_hybrid_device,
            check_hybrid_ok,
            degree_perm_device,
            permute_csr_device,
        )

        if check_hybrid_ok(csr):
            if strip_dtype is None:
                # int8 where exact: the same memory buys 2× the strip
                # width, moving tail edges off the gather path
                strip_dtype = auto_strip_dtype(csr)
            if strip_cols is None:
                strip_cols = auto_strip_cols(
                    csr.num_nodes,
                    e_live=int(np.asarray(csr.indptr[-1])),
                    dim=dim,
                    strip_itemsize=jnp.dtype(strip_dtype).itemsize,
                )
            if tail_band_cols < 0:
                tail_band_cols = auto_tail_band_cols(csr.num_nodes, strip_cols)
            # built on the device: the strip is several GB at reddit scale
            perm = degree_perm_device(csr)
            csr = permute_csr_device(csr, perm)
            # NOTE: the hybrid TAIL keeps its own tile shape
            # (sparse/hybrid.TAIL_EDGE_TILE) — `edge_tile` here sizes the
            # dense-path tile schedule (T=256)
            hyb = build_hybrid_device(
                csr, s_cols=strip_cols, norm=norm,
                tail_band_cols=tail_band_cols,
                strip_dtype=strip_dtype,
            )
    g = with_norm(csr, norm)
    gt = csr_transpose(g)
    if symmetric is None:
        a, b = csr_to_scipy(g), csr_to_scipy(gt)
        d = abs(a - b)
        symmetric = d.nnz == 0 or float(d.max()) < 1e-6
    if symmetric:
        gt = g
    tiles = tiles_t = None
    if build_tiles:
        tiles = build_edge_tiles(g, row_block, edge_tile)
        tiles_t = tiles if symmetric else build_edge_tiles(gt, row_block, edge_tile)
    return Graph(csr=g, csc=gt, tiles=tiles, tiles_t=tiles_t, hybrid=hyb, perm=perm)
