"""Binary graph IO — the reference's on-disk kernel format.

The reference stores each benchmark graph as two flat little-endian int32
files, `<name>.indptr` and `<name>.indices` (written by `dataset_gen.py:
44-118`, read by `kernels/data.h:8-37` `cuda_read_array` and
`graph_loader.py:41-85`). We keep that format for interoperability (any
graph downloaded for the reference drops straight into this framework)
and add a `.values` float32 sidecar (optional; absent → uniform 1.0).
"""

from __future__ import annotations

import os

import numpy as np


def save_graph_binary(path_prefix: str, indptr, indices, values=None) -> None:
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    np.asarray(indptr, dtype=np.int32).tofile(path_prefix + ".indptr")
    np.asarray(indices, dtype=np.int32).tofile(path_prefix + ".indices")
    if values is not None:
        np.asarray(values, dtype=np.float32).tofile(path_prefix + ".values")


def load_graph_binary(path_prefix: str):
    """Returns a CSRGraph from `<prefix>.indptr/.indices[/.values]`."""
    import jax.numpy as jnp

    from maxk_gnn.sparse.csr import CSRGraph

    indptr = np.fromfile(path_prefix + ".indptr", dtype=np.int32)
    indices = np.fromfile(path_prefix + ".indices", dtype=np.int32)
    vpath = path_prefix + ".values"
    if os.path.exists(vpath):
        values = np.fromfile(vpath, dtype=np.float32)
    else:
        values = np.ones(indices.shape[0], dtype=np.float32)
    assert indptr[-1] == indices.shape[0], (
        f"corrupt graph binary {path_prefix}: indptr[-1]={indptr[-1]} "
        f"!= nnz={indices.shape[0]}"
    )
    return CSRGraph(
        indptr=jnp.asarray(indptr),
        indices=jnp.asarray(indices),
        values=jnp.asarray(values),
    )


def list_graph_binaries(directory: str):
    """All graph prefixes in a directory (analog of main.cu:196-218 glob)."""
    names = []
    for f in sorted(os.listdir(directory)):
        if f.endswith(".indptr"):
            names.append(os.path.join(directory, f[: -len(".indptr")]))
    return names
