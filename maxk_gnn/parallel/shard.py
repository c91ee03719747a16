"""Row-partitioned graph sharding for multi-device aggregation.

New capability over the single-GPU reference (SURVEY §2.3). Partitioning
scheme (the multi-device analog of warp-level row chunking):

  - adjacency rows are block-partitioned over the mesh axis: device i owns
    rows [i·Vs, (i+1)·Vs) of A and of the node features;
  - **forward**: each device `all_gather`s the *compressed* CBSR features
    (V·k values + selectors — 8× less interconnect traffic than dense at
    k=32/256, the multi-device payoff of MaxK compression), densifies
    locally, and
    aggregates its row block: no halo bookkeeping, no atomics;
  - **backward**: each device runs its transposed block A_i^T (V rows,
    local columns) over its local dY partial, then `psum_scatter` reduces
    partials and re-partitions rows in one collective; sampling at the
    local selectors yields the compact (Vs, k) gradient.

Edges are padded per shard to the max shard nnz (col 0, value 0 — inert).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from maxk_gnn.pytree import pytree_dataclass, static_field

from maxk_gnn.parallel.mesh import GRAPH_AXIS
from maxk_gnn.sparse.csr import CSRGraph, with_norm


@pytree_dataclass
class ShardedGraph:
    """Stacked per-shard CSR blocks; leading axis is the mesh axis.

    fwd_*: A row block     — (n, Vs+1) / (n, Em): local rows, global cols
    bwd_*: A_i^T           — (n, Vp+1) / (n, Em): global rows, local cols
    *_tiles: optional stacked edge-tile schedules per shard (production
    kernel path; see `sparse/meta.EdgeTiles`), padded with inert tiles.
    """

    fwd_indptr: jax.Array
    fwd_indices: jax.Array
    fwd_values: jax.Array
    bwd_indptr: jax.Array
    bwd_indices: jax.Array
    bwd_values: jax.Array
    fwd_tiles: Optional[dict] = None  # {block, cols, vals, localrow} stacked
    bwd_tiles: Optional[dict] = None
    # row-partitioned strip-hybrid schedule (undirected high-degree
    # graphs); when set, aggregation goes through `spmm_hybrid_sharded`
    hybrid: Optional["ShardedHybrid"] = None
    axis: str = static_field(GRAPH_AXIS)
    num_shards: int = static_field(1)
    num_nodes: int = static_field(0)
    padded_nodes: int = static_field(0)
    row_block: int = static_field(8)

    @property
    def shard_nodes(self) -> int:
        return self.padded_nodes // self.num_shards

    def local_fwd(self) -> CSRGraph:
        """Local row-block CSR as seen inside shard_map (leading axis 1)."""
        return CSRGraph(
            indptr=self.fwd_indptr.reshape(-1),
            indices=self.fwd_indices.reshape(-1),
            values=self.fwd_values.reshape(-1),
        )

    def local_bwd(self) -> CSRGraph:
        return CSRGraph(
            indptr=self.bwd_indptr.reshape(-1),
            indices=self.bwd_indices.reshape(-1),
            values=self.bwd_values.reshape(-1),
        )

    def _local_tiles(self, stacked: dict, num_rows: int):
        return _local_tiles_from_stacked(stacked, num_rows, self.row_block)

    def local_fwd_tiles(self):
        return self._local_tiles(self.fwd_tiles, self.shard_nodes)

    def local_bwd_tiles(self):
        return self._local_tiles(self.bwd_tiles, self.padded_nodes)


def _pad_to(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    if x.shape[0] == n:
        return x
    pad = np.full((n - x.shape[0],) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad])


def _local_tiles_from_stacked(stacked: dict, num_rows: int, row_block: int):
    """EdgeTiles view of one shard's stacked tile tables (leading axis 1,
    as seen inside shard_map)."""
    from maxk_gnn.sparse.meta import EdgeTiles

    nt, t = stacked["cols"].shape[-2:]
    return EdgeTiles(
        block=stacked["block"].reshape(nt),
        cols=stacked["cols"].reshape(nt, t),
        vals=stacked["vals"].reshape(nt, t),
        localrow=stacked["localrow"].reshape(nt, t),
        row_block=row_block,
        num_row_blocks=-(-num_rows // row_block),
        num_nodes=num_rows,
    )


def _stack_tiles(blocks, rows: int, row_block: int, edge_tile: int) -> dict:
    """Per-shard edge-tile schedules from scipy CSR blocks, padded with
    inert tiles to the max shard tile count and stacked on a leading
    mesh axis."""
    from maxk_gnn.sparse.meta import build_edge_tiles

    tiles = []
    for b in blocks:
        gb = CSRGraph(
            indptr=jnp.asarray(b.indptr.astype(np.int32)),
            indices=jnp.asarray(b.indices.astype(np.int32)),
            values=jnp.asarray(b.data.astype(np.float32)),
        )
        tiles.append(build_edge_tiles(gb, row_block, edge_tile))
    ntm = max(t.num_tiles for t in tiles)
    nb = -(-rows // row_block)

    def padt(t):
        pad = ntm - t.num_tiles
        return {
            "block": np.pad(np.asarray(t.block), (0, pad), constant_values=nb - 1),
            "cols": np.pad(np.asarray(t.cols), ((0, pad), (0, 0))),
            "vals": np.pad(np.asarray(t.vals), ((0, pad), (0, 0))),
            "localrow": np.pad(np.asarray(t.localrow), ((0, pad), (0, 0))),
        }

    stacked = [padt(t) for t in tiles]
    return {
        k: jnp.asarray(np.stack([s[k] for s in stacked])) for k in stacked[0]
    }


@pytree_dataclass
class ShardedHybrid:
    """Row-partitioned symmetric-strip schedule (multi-chip twin of
    `sparse.hybrid.HybridSchedule`).

    Device i owns output rows [i·Vs, (i+1)·Vs):
      strip:      (n, Vs, S)  its row block W_i of the hub strip
      pre/post:   (n, Vp)     FULL diagonal scales, broadcast-stacked —
                              the forward scales the gathered full
                              features, so every device needs all of pre
      tail_tiles: stacked     edge tiles of its tail block (local rows
                              ≥S, global cols ≥S)

    The tail submatrix of a value-symmetric S is itself symmetric, so the
    same schedule serves A and A^T (swap the scales) — exactly like the
    single-chip hybrid, per shard.
    """

    strip: jax.Array
    pre: jax.Array
    post: jax.Array
    tail_tiles: dict
    axis: str = static_field(GRAPH_AXIS)
    s_cols: int = static_field(0)
    num_nodes: int = static_field(0)
    padded_nodes: int = static_field(0)
    num_shards: int = static_field(1)
    row_block: int = static_field(8)
    tail_chunk: int = static_field(256)
    # exact tail-scan RMW window, max over shards (0 = full chunk)
    tail_window: int = static_field(0)

    @property
    def shard_nodes(self) -> int:
        return self.padded_nodes // self.num_shards

    def local_strip(self) -> jax.Array:
        return self.strip.reshape(self.shard_nodes, self.s_cols)

    def local_pre(self) -> jax.Array:
        return self.pre.reshape(-1)

    def local_post(self) -> jax.Array:
        return self.post.reshape(-1)

    def local_tail_tiles(self):
        return _local_tiles_from_stacked(
            self.tail_tiles, self.shard_nodes, self.row_block
        )


def build_sharded_hybrid(
    csr: CSRGraph,
    num_shards: int,
    s_cols: Optional[int] = None,
    norm: str = "none",
    strip_dtype=None,  # None → production rule (int8 where exact)
    row_block: int = 8,
    edge_tile: Optional[int] = None,  # None → per-dtype production tile
    tail_chunk: int = 256,
    dim: int = 256,
) -> ShardedHybrid:
    """Host build of the row-partitioned strip hybrid.

    `csr` must already be degree-permuted and raw-value-symmetric (the
    `build_hybrid` contract); `norm` only sets the diagonal scales. The
    strip — the memory-dominant piece (Vp·S) — is what actually shards:
    each device holds Vp·S/n of it, so graphs whose strip busts one
    device's memory become feasible at n devices.
    """
    import scipy.sparse as sp

    from maxk_gnn.sparse.hybrid import (
        TAIL_EDGE_TILE,
        TAIL_EDGE_TILE_INT8,
        _scales,
        auto_strip_cols,
        auto_strip_dtype,
    )

    if strip_dtype is None:
        # same rule as the single-device builder: int8 where exact buys
        # 2× the width at the same per-device memory
        strip_dtype = auto_strip_dtype(csr)
    strip_itemsize = jnp.dtype(strip_dtype).itemsize
    if edge_tile is None:
        # per-dtype default tail tile (sparse/hybrid.py)
        edge_tile = (
            TAIL_EDGE_TILE_INT8 if strip_itemsize == 1 else TAIL_EDGE_TILE
        )

    v = csr.num_nodes
    vs = -(-v // num_shards)
    vp = vs * num_shards
    # sharded budget: each device holds V/n of the strip's rows, so the
    # per-device memory fit is computed over V/n rows while the width cap
    # stays bounded by the full V
    if s_cols is None:
        from maxk_gnn.sparse.hybrid import STRIP_COLS, STRIP_COLS_INT8

        cap = STRIP_COLS_INT8 if strip_itemsize == 1 else STRIP_COLS
        s = auto_strip_cols(
            -(-v // max(num_shards, 1)), s_cols=min(cap, v), dim=dim,
            strip_itemsize=strip_itemsize,
        )
    else:
        s = s_cols
    s = min(s, v)
    s = max(128, (s // 128) * 128) if v >= 128 else v

    indptr = np.asarray(csr.indptr, dtype=np.int64)
    nnz = int(indptr[-1])
    cols = np.asarray(csr.indices, dtype=np.int64)[:nnz]
    vals = np.asarray(csr.values, dtype=np.float32)[:nnz]
    rows = np.repeat(
        np.arange(v, dtype=np.int64), np.diff(indptr[: v + 1])
    )
    live = vals != 0

    # built in its storage dtype: an f32 host strip would be 4x the bytes
    strip = np.zeros((vp, s), dtype=jnp.dtype(strip_dtype))
    m = (cols < s) & live
    strip[rows[m], cols[m]] = vals[m]

    deg = np.zeros(vp, np.float32)
    np.add.at(deg, rows[live], 1.0)
    pre, post = _scales(jnp.asarray(deg), norm)

    mt = (cols >= s) & (rows >= s) & live
    tr, tc, tv = rows[mt], cols[mt], vals[mt]
    blocks = []
    for i in range(num_shards):
        inb = (tr >= i * vs) & (tr < (i + 1) * vs)
        b = sp.csr_matrix((tv[inb], (tr[inb] - i * vs, tc[inb])), shape=(vs, vp))
        b.sort_indices()
        blocks.append(b)
    tail_tiles = _stack_tiles(blocks, vs, row_block, edge_tile)
    from maxk_gnn.sparse.meta import max_block_span

    tail_window = max(
        max_block_span(b, tail_chunk)
        for b in np.asarray(tail_tiles["block"])
    )

    n = num_shards
    return ShardedHybrid(
        strip=jnp.asarray(strip.reshape(n, vs, s)),
        pre=jnp.broadcast_to(pre, (n, vp)).copy(),
        post=jnp.broadcast_to(post, (n, vp)).copy(),
        tail_tiles=tail_tiles,
        axis=GRAPH_AXIS,
        s_cols=s,
        num_nodes=v,
        padded_nodes=vp,
        num_shards=n,
        row_block=row_block,
        tail_chunk=tail_chunk,
        tail_window=tail_window,
    )


def build_sharded_graph(
    csr: CSRGraph,
    num_shards: int,
    norm: str = "none",
    build_tiles: bool = False,
    row_block: int = 8,
    edge_tile: int = 256,
    hybrid: bool = False,
    strip_cols: Optional[int] = None,
    tail_edge_tile: Optional[int] = None,  # None → per-dtype production tile
    strip_dtype=None,  # None → production rule (int8 where exact)
    dim: int = 256,
) -> ShardedGraph:
    """Host-side partition of a (normalized) CSR over `num_shards` devices.

    With `build_tiles`, per-shard edge-tile schedules are built for both
    the local row block and its transpose, so the sharded path runs the
    same production tile kernels as single-chip (`ops/spgemm`).

    With `hybrid`, `csr` must already be degree-permuted and
    raw-value-symmetric (the `build_hybrid` contract — callers permute
    node data by the same permutation); the row-partitioned strip
    schedule is attached and aggregation routes through
    `spmm_hybrid_sharded`. The CSR blocks are still built as the
    fallback path; a production deployment tight on HBM could skip them.
    """
    import scipy.sparse as sp

    shyb = None
    if hybrid:
        shyb = build_sharded_hybrid(
            csr,
            num_shards,
            s_cols=strip_cols,
            norm=norm,
            strip_dtype=strip_dtype,
            row_block=row_block,
            edge_tile=tail_edge_tile,
            dim=dim,
        )
    g = with_norm(csr, norm)
    v = g.num_nodes
    vs = -(-v // num_shards)
    vp = vs * num_shards
    indptr = _pad_to(np.asarray(g.indptr, dtype=np.int64), vp + 1, fill=int(g.nnz))
    m = sp.csr_matrix(
        (np.asarray(g.values), np.asarray(g.indices), indptr), shape=(vp, vp)
    )

    fwd_blocks, bwd_blocks = [], []
    for i in range(num_shards):
        blk = m[i * vs : (i + 1) * vs]  # (Vs, Vp) local rows, global cols
        fwd_blocks.append(blk)
        bwd_blocks.append(blk.T.tocsr())  # (Vp, Vs) global rows, local cols

    em = max(max(b.nnz for b in fwd_blocks), 1)

    def stack(blocks, rows):
        ip = np.stack(
            [_pad_to(b.indptr.astype(np.int32), rows + 1, fill=b.nnz) for b in blocks]
        )
        ix = np.stack([_pad_to(b.indices.astype(np.int32), em) for b in blocks])
        vl = np.stack([_pad_to(b.data.astype(np.float32), em) for b in blocks])
        return ip, ix, vl

    fip, fix, fvl = stack(fwd_blocks, vs)
    bip, bix, bvl = stack(bwd_blocks, vp)

    fwd_tiles = bwd_tiles = None
    if build_tiles:
        fwd_tiles = _stack_tiles(fwd_blocks, vs, row_block, edge_tile)
        bwd_tiles = _stack_tiles(bwd_blocks, vp, row_block, edge_tile)

    return ShardedGraph(
        fwd_indptr=jnp.asarray(fip),
        fwd_indices=jnp.asarray(fix),
        fwd_values=jnp.asarray(fvl),
        bwd_indptr=jnp.asarray(bip),
        bwd_indices=jnp.asarray(bix),
        bwd_values=jnp.asarray(bvl),
        fwd_tiles=fwd_tiles,
        bwd_tiles=bwd_tiles,
        hybrid=shyb,
        axis=GRAPH_AXIS,
        num_shards=num_shards,
        num_nodes=v,
        padded_nodes=vp,
        row_block=row_block,
    )


def shard_rows(x: np.ndarray, num_shards: int, fill=0) -> np.ndarray:
    """Pad a per-node array to the sharded row count (Vp)."""
    v = x.shape[0]
    vs = -(-v // num_shards)
    return _pad_to(np.asarray(x), vs * num_shards, fill=fill)


def halo_stats(csr: CSRGraph, num_shards: int, k: int = 32,
               s_cols: int = 0) -> dict:
    """Per-shard halo analysis for the row-partitioned aggregation —
    quantifies the SURVEY §2.3 'halo feature-row exchange' design against
    the current full compressed all_gather.

    For shard i, the halo is the set of distinct off-shard rows referenced
    as columns by its local block (excluding the hub strip [0, s), which
    every shard needs and which a (s, k) psum serves). Returns per-step
    receive bytes per device for three collective designs at CBSR width k:

      all_gather:  (n-1)/n · Vp · k · 6 B   (values f32 + selector int16)
      hub_psum + halo all_to_all: 2·s·k·6/n·(n-1)  +  halo_i · k · 6

    The degree-sorted ordering (`hybrid.degree_perm`) concentrates hot
    columns in the hub strip, which is exactly what shrinks the halo.
    """
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    nnz = int(indptr[-1])
    cols = np.asarray(csr.indices, dtype=np.int64)[:nnz]
    vals = np.asarray(csr.values, dtype=np.float32)[:nnz]
    v = csr.num_nodes
    vs = -(-v // num_shards)
    rows = np.repeat(np.arange(v, dtype=np.int64), np.diff(indptr[: v + 1]))
    live = vals != 0
    s = int(s_cols)

    bytes_per_row = k * 6  # f32 value + int16 selector
    full_ag = (num_shards - 1) / num_shards * vs * num_shards * bytes_per_row
    shards = []
    for i in range(num_shards):
        m = live & (rows >= i * vs) & (rows < (i + 1) * vs) & (cols >= s)
        c = np.unique(cols[m])
        halo = c[(c < i * vs) | (c >= (i + 1) * vs)]
        shards.append(int(halo.shape[0]))
    hub_bytes = 2 * s * bytes_per_row * (num_shards - 1) / max(num_shards, 1)
    return {
        "num_shards": num_shards,
        "k": k,
        "s_cols": s,
        "halo_rows_per_shard": shards,
        "allgather_recv_bytes_per_device": int(full_ag),
        "halo_recv_bytes_per_device_max": int(
            hub_bytes + max(shards) * bytes_per_row
        ),
        "reduction_vs_allgather": round(
            full_ag / max(hub_bytes + max(shards) * bytes_per_row, 1), 2
        ),
    }
