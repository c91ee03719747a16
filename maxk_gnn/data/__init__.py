from maxk_gnn.data.datasets import DATASETS, GraphData, load_dataset
from maxk_gnn.data.synthetic import rmat_graph, planted_partition_data
from maxk_gnn.data.io import save_graph_binary, load_graph_binary

__all__ = [
    "DATASETS",
    "GraphData",
    "load_dataset",
    "rmat_graph",
    "planted_partition_data",
    "save_graph_binary",
    "load_graph_binary",
]
