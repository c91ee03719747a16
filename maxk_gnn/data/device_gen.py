"""On-device synthetic graph generation — no host↔device transfer.

Role of `kernels/main.cu:74-146` (random benchmark inputs, seed 123) and
`dataset_gen.py` (symmetrize + self-loops + dedup), but computed entirely
on the accelerator with static shapes:

  - R-MAT edges via a `lax.scan` over address bits;
  - symmetrization by concatenation (E stays static);
  - CSR via a 2-key lexicographic `lax.sort`;
  - dedup by *zeroing* duplicate edge values instead of removing them —
    shapes stay static and weight-0 edges are inert in every kernel
    (the same trick the edge-tile padding uses);
  - `indptr` via searchsorted.

Generating reddit-scale inputs on the device takes seconds and leaves
the host out of the benchmarks' set-up entirely.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from maxk_gnn.sparse.csr import CSRGraph


def rmat_graph_device(
    num_nodes: int,
    num_edges: int,
    seed: int = 123,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> CSRGraph:
    """Undirected, self-looped, (soft-)deduplicated CSR on device."""
    scale = max(1, int(np.ceil(np.log2(max(num_nodes, 2)))))
    e0 = num_edges // 2 + num_edges % 2

    @jax.jit
    def gen():
        key = jax.random.PRNGKey(seed)

        def level(carry, key):
            r, cl = carry
            u = jax.random.uniform(key, (e0,))
            right = ((u >= a + b) & (u < a + b + c)) | (u >= a + b + c)
            down = ((u >= a) & (u < a + b)) | (u >= a + b + c)
            return ((r << 1) | down.astype(jnp.int32),
                    (cl << 1) | right.astype(jnp.int32)), None

        keys = jax.random.split(key, scale)
        (r, cl), _ = jax.lax.scan(
            level, (jnp.zeros(e0, jnp.int32), jnp.zeros(e0, jnp.int32)), keys
        )
        r = r % num_nodes
        cl = cl % num_nodes
        perm = jax.random.permutation(jax.random.fold_in(key, 7), num_nodes)
        r, cl = perm[r], perm[cl]
        loops = jnp.arange(num_nodes, dtype=jnp.int32)
        rows = jnp.concatenate([r, cl, loops])
        cols = jnp.concatenate([cl, r, loops])
        # CSR order: lexicographic (row, col) sort
        rows, cols = jax.lax.sort((rows, cols), num_keys=2)
        dup = jnp.concatenate(
            [jnp.zeros((1,), bool), (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])]
        )
        # compact duplicates to an inert tail: re-sort with duplicates'
        # row key pushed past the last node; indptr then only spans live
        # edges and the tile schedules never touch the tail (shapes stay
        # static — R-MAT hub collisions would otherwise waste ~30% of
        # kernel slots as weight-0 edges)
        rows = jnp.where(dup, num_nodes, rows)
        rows, cols = jax.lax.sort((rows, cols), num_keys=2)
        values = jnp.where(rows < num_nodes, 1.0, 0.0).astype(jnp.float32)
        indptr = jnp.searchsorted(rows, jnp.arange(num_nodes + 1, dtype=jnp.int32)).astype(
            jnp.int32
        )
        return indptr, cols, values

    indptr, cols, values = gen()
    return CSRGraph(indptr=indptr, indices=cols, values=values)
