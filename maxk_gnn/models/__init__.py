from maxk_gnn.models.models import (
    MaxKSAGE,
    MaxKGCN,
    MaxKGIN,
    SAGE,
    GCN,
    GIN,
    GNNRes,
    build_model,
)

__all__ = [
    "MaxKSAGE",
    "MaxKGCN",
    "MaxKGIN",
    "SAGE",
    "GCN",
    "GIN",
    "GNNRes",
    "build_model",
]
