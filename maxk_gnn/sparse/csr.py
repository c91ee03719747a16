"""CSR sparse-adjacency container for graph aggregation.

Re-design of the reference's raw CSR arrays + degree handling
(reference: `graph_loader.py:41-100`, `maxk_models_integrated.py:118-165`
`set_graph_data` which extracts CSR+CSC via `graph.adj_tensors`, builds
uniform edge values and clamped degrees). Here the graph is a JAX pytree,
normalization is folded into *edge values* once at setup (the cleanest of
the reference's normalization experiments — `model_v3.py:104-120` computes
per-edge `1/in_deg[dst]` weights so the kernel aggregates pre-normalized),
and the CSC twin is built host-side with scipy.

All arrays are device arrays (jnp); shapes are static under jit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from maxk_gnn.pytree import pytree_dataclass


@pytree_dataclass
class CSRGraph:
    """Compressed-sparse-row adjacency.

    indptr:  (V+1,) int32 row pointers
    indices: (E,)   int32 column indices
    values:  (E,)   float32 edge weights (normalization folded in)
    """

    indptr: jax.Array
    indices: jax.Array
    values: jax.Array

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    def in_degrees(self) -> jax.Array:
        """Number of nonzeros per row (clamped to >=1 like the reference's
        `torch.clamp(degrees, min=1)` in `maxk_models_integrated.py:147`)."""
        deg = self.indptr[1:] - self.indptr[:-1]
        return jnp.maximum(deg, 1)

    def row_ids(self) -> jax.Array:
        """(E,) row id of every nonzero — segment ids for segment_sum."""
        e = self.nnz
        seg = jnp.zeros((e,), dtype=jnp.int32)
        # mark row starts (skip row 0 and empty trailing rows), then prefix-max
        starts = self.indptr[1:-1]
        seg = seg.at[starts].add(1, mode="drop")
        return jnp.cumsum(seg)


def rows_from_indptr(indptr: jax.Array, e: int, num_rows: int) -> jax.Array:
    """(e,) row id of every CSR slot, inside jit: ones scattered at row
    starts then cumsum (same trick as `CSRGraph.row_ids`).

    Replaces `searchsorted(indptr, arange(e), 'right') - 1`, which
    needs E·log V work and large temporaries at ogbn-products scale
    (E≈126M needles over a V≈2.45M haystack); the cumsum form is linear. Dead-tail slots
    (past indptr[-1]) map to num_rows-1 — callers mask with a live bit.
    """
    marks = (
        jnp.zeros((max(e, 1),), jnp.int32)
        .at[indptr[1:num_rows]]
        .add(1, mode="drop")
    )
    return jnp.cumsum(marks)


def csr_from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    num_nodes: int,
    values: Optional[np.ndarray] = None,
    dedup: bool = True,
) -> CSRGraph:
    """Host-side COO → CSR (sorted, optionally deduplicated).

    Mirrors the reference dataset pipeline semantics (`dataset_gen.py:44-118`:
    sort + dedupe multi-edges) without DGL.
    """
    import scipy.sparse as sp

    if values is None:
        values = np.ones(rows.shape[0], dtype=np.float32)
    m = sp.coo_matrix(
        (values, (rows.astype(np.int64), cols.astype(np.int64))),
        shape=(num_nodes, num_nodes),
    ).tocsr()
    if dedup:
        m.sum_duplicates()
        # dedup means "keep one", not "sum": reset weights to 1
        m.data[:] = 1.0
    m.sort_indices()
    return CSRGraph(
        indptr=jnp.asarray(m.indptr, dtype=jnp.int32),
        indices=jnp.asarray(m.indices, dtype=jnp.int32),
        values=jnp.asarray(m.data, dtype=jnp.float32),
    )


def csr_to_scipy(g: CSRGraph):
    import scipy.sparse as sp

    v = g.num_nodes
    indptr = np.asarray(g.indptr)
    nnz = int(indptr[-1])
    # device-built graphs may carry an inert tail past indptr[-1]
    # (soft-dedup compaction, data/device_gen.py) — trim it
    return sp.csr_matrix(
        (np.asarray(g.values)[:nnz], np.asarray(g.indices)[:nnz], indptr),
        shape=(v, v),
    )


def csr_transpose(g: CSRGraph) -> CSRGraph:
    """Host-side CSR → CSC-of-same-matrix, returned as the CSR of A^T.

    Role of the reference's CSC extraction (`maxk_models_integrated.py:126-137`)
    feeding the backward SSpMM (`kernels/spmm_maxk_backward.cu`): the backward
    aggregation is `A^T @ dY`, which we run through the *same* SpMM kernel on
    the transposed CSR.
    """
    m = csr_to_scipy(g).tocsc()
    return CSRGraph(
        indptr=jnp.asarray(m.indptr, dtype=jnp.int32),
        indices=jnp.asarray(m.indices, dtype=jnp.int32),
        values=jnp.asarray(m.data, dtype=jnp.float32),
    )


def csr_transpose_device(g: CSRGraph) -> CSRGraph:
    """On-device CSR → CSR-of-A^T (jit, static shapes).

    Device twin of `csr_transpose` for graphs that live on the device
    (device-generated benchmarks, device-built schedules). Dead entries
    (the inert weight-0 dedup tail past `indptr[-1]`) are re-sorted to
    the tail of the transpose with values 0, preserving the invariant.
    """
    n = g.num_nodes

    @jax.jit
    def t(indptr, indices, values):
        e = indices.shape[0]
        ar = jnp.arange(e, dtype=jnp.int32)
        rows = rows_from_indptr(indptr, e, n)
        live = ar < indptr[-1]
        tr = jnp.where(live, indices, n).astype(jnp.int32)
        tc = jnp.where(live, rows, n).astype(jnp.int32)
        tr, tc, tv = jax.lax.sort((tr, tc, values), num_keys=2)
        new_indptr = jnp.searchsorted(
            tr, jnp.arange(n + 1, dtype=jnp.int32)
        ).astype(jnp.int32)
        return new_indptr, tc, jnp.where(tr < n, tv, 0.0)

    indptr, indices, values = t(g.indptr, g.indices, g.values)
    return CSRGraph(indptr=indptr, indices=indices, values=values)


def with_norm(g: CSRGraph, mode: str = "right") -> CSRGraph:
    """Fold degree normalization into edge values.

    Modes follow the reference conv semantics:
      - "right": mean aggregation, `y_i = (1/indeg_i) * sum_j a_ij x_j`
        (SAGE mean: post-SpMM `output / in_degrees`,
        `maxk_spgemm_function.py:85-88`)
      - "both":  symmetric GCN norm `D^-1/2 A D^-1/2`
        (`all_model.py:167-176,263-272`)
      - "left":  `sum_j a_ij x_j / outdeg_j`
      - "none":  raw sum aggregation (GIN)
    """
    if mode == "none":
        return g
    row = g.row_ids()
    # count only REAL edges: weight-0 entries (soft-dedup duplicates,
    # padding) must not inflate degrees
    live = (g.values != 0).astype(jnp.float32)
    indeg = jax.ops.segment_sum(
        live, row, num_segments=g.num_nodes, indices_are_sorted=True
    )
    indeg = jnp.maximum(indeg, 1.0)
    # out-degree of column j = occurrences of j in indices
    outdeg = jnp.zeros((g.num_nodes,), dtype=jnp.float32).at[g.indices].add(
        live, mode="drop"
    )
    outdeg = jnp.maximum(outdeg, 1.0)
    if mode == "right":
        vals = g.values / indeg[row]
    elif mode == "left":
        vals = g.values / outdeg[g.indices]
    elif mode == "both":
        vals = g.values / jnp.sqrt(indeg[row]) / jnp.sqrt(outdeg[g.indices])
    else:
        raise ValueError(f"unknown norm mode: {mode}")
    return dataclasses.replace(g, values=vals)


def add_self_loops(g: CSRGraph) -> CSRGraph:
    """Add i→i edges (dedup keeps existing ones) — `dataset_gen.py` semantics."""
    sp = csr_to_scipy(g).tocoo()
    v = g.num_nodes
    rows = np.concatenate([sp.row, np.arange(v)])
    cols = np.concatenate([sp.col, np.arange(v)])
    return csr_from_coo(rows, cols, v)


def symmetrize(g: CSRGraph) -> CSRGraph:
    """Make undirected by adding reverse edges (`dataset_gen.py:44-118`)."""
    sp = csr_to_scipy(g).tocoo()
    rows = np.concatenate([sp.row, sp.col])
    cols = np.concatenate([sp.col, sp.row])
    return csr_from_coo(rows, cols, g.num_nodes)


def reorder_rcm(g: CSRGraph):
    """Reverse-Cuthill-McKee bandwidth-reducing reordering.

    Returns (reordered graph, perm) with perm[i] = old id of new row i.
    A locality optimization with no reference counterpart (warp
    scheduling made GPU gathers order-insensitive); the XLA SpMM gather
    is cache-sensitive, so clustering columns helps. Apply the
    same perm to features/labels/masks: `x_new = x[perm]`.
    """
    import scipy.sparse.csgraph as csgraph

    m = csr_to_scipy(g)
    perm = np.asarray(csgraph.reverse_cuthill_mckee(m, symmetric_mode=True))
    m2 = m[perm][:, perm].tocsr()
    m2.sort_indices()
    return (
        CSRGraph(
            indptr=jnp.asarray(m2.indptr, dtype=jnp.int32),
            indices=jnp.asarray(m2.indices, dtype=jnp.int32),
            values=jnp.asarray(m2.data, dtype=jnp.float32),
        ),
        perm,
    )
