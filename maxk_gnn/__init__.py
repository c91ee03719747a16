"""maxk_gnn — sparse GNN training framework in JAX (MaxK-GNN capabilities).

A from-scratch JAX/XLA re-design of the capabilities of
``julius-sk/spgemm-prunning`` (MaxK-GNN, ASPLOS'24): GCN/GraphSAGE/GIN
training on large graphs with the MaxK top-k nonlinearity, graph
aggregation running over CBSR-compressed (top-k-pruned) feature matrices,
a Triton (Pallas) MaxK mask kernel, custom_vjp forward/backward wiring,
and multi-device scaling via row-partitioned adjacency + compressed-feature
collectives over a `jax.sharding.Mesh`.

Layout:
    maxk_gnn.sparse    CSR/CSC/CBSR containers, tile scheduling metadata
    maxk_gnn.ops       XLA SpMM ops, the Triton MaxK mask, dispatch
    maxk_gnn.models    MaxK layers + models (SAGE/GCN/GIN + baselines)
    maxk_gnn.parallel  mesh / sharded training step
    maxk_gnn.data      dataset registry, synthetic graphs, binary IO
    maxk_gnn.train     config, training loop, metrics, optim, checkpointing
    maxk_gnn.bench     kernel benchmark harness (main.cu protocol analog)
"""

__version__ = "0.1.0"

from maxk_gnn.sparse.csr import CSRGraph  # noqa: F401
from maxk_gnn.sparse.cbsr import CBSR  # noqa: F401
