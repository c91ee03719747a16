"""ogbn-proteins-style edge-feature handling.

Re-design of `utils/proteins_loader.py:26-58`: the proteins graph has
8-dim *edge* features and no node features; node features are initialized
as the sum of incident edge features (`update_all(copy_e, sum)` in DGL).
Here that's one segment_sum over the CSR edge order.
"""

from __future__ import annotations

import jax
import numpy as np

from maxk_gnn.sparse.csr import CSRGraph


def node_features_from_edges(g: CSRGraph, edge_feats: jax.Array) -> jax.Array:
    """(E, F) edge features → (V, F) node features by incident-edge sum."""
    return jax.ops.segment_sum(
        edge_feats,
        g.row_ids(),
        num_segments=g.num_nodes,
        indices_are_sorted=True,
    )


def synthetic_edge_features(
    g: CSRGraph, feat_dim: int = 8, seed: int = 123
) -> np.ndarray:
    """Random nonnegative edge features (the proteins regime: association
    scores in [0,1])."""
    rng = np.random.default_rng(seed)
    return rng.random((g.nnz, feat_dim)).astype(np.float32)
