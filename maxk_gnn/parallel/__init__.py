from maxk_gnn.parallel.mesh import make_mesh
from maxk_gnn.parallel.shard import ShardedGraph, build_sharded_graph, shard_rows
from maxk_gnn.parallel.train import make_sharded_train_step, sharded_setup

__all__ = [
    "make_mesh",
    "ShardedGraph",
    "build_sharded_graph",
    "shard_rows",
    "make_sharded_train_step",
    "sharded_setup",
]
