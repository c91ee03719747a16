from maxk_gnn.sparse.csr import CSRGraph, csr_from_coo, csr_transpose
from maxk_gnn.sparse.cbsr import CBSR, maxk_cbsr, cbsr_densify, cbsr_sample
from maxk_gnn.sparse.meta import EdgeTiles, build_edge_tiles

__all__ = [
    "CSRGraph",
    "csr_from_coo",
    "csr_transpose",
    "CBSR",
    "maxk_cbsr",
    "cbsr_densify",
    "cbsr_sample",
    "EdgeTiles",
    "build_edge_tiles",
]
