"""Edge-tile scheduling tables — the analog of the reference's warp4 files.

The reference precomputes, per graph, a flat int32 stream
`[warp_row, warp_loc, warp_len, pad] × num_warps` that splits every CSR row
into chunks of ≤64 nonzeros for warp-level scheduling
(`kernels/generate_meta.py:30-48`, consumed by `kernels/spmm_maxk.cu:40-47`).

Here the scheduling unit is a step of a `lax.scan` over tiles
(`ops/spmm_xla.spmm_tiles_scan`), not a warp, and ragged per-warp chunks
become **rectangular edge tiles**:

  - output rows are grouped into row-blocks of R rows;
  - each row-block's edge span is padded to a multiple of T edges and cut
    into (T,)-tiles; a tile never crosses a row-block boundary, so the
    output block touched by tile t is a pure function of `tile_block[t]`
    — this replaces the GPU's atomicAdd flush (`spmm_maxk.cu:104`) with
    a reduction over consecutive tiles of the same block (no atomics).

Padding uses column 0 with edge value 0 (gather reads row 0, multiplies by
zero). Blocks with no edges still get one all-padding tile so every output
block is written (zeroed) exactly once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from maxk_gnn.pytree import pytree_dataclass, static_field

from maxk_gnn.sparse.csr import CSRGraph, rows_from_indptr

# Defaults (tunable per-kernel): R rows per block, T edges per tile
# amortize per-tile overheads while bounding the gather scratch.
ROW_BLOCK = 8
EDGE_TILE = 256

# tile tables are padded (with inert tiles aliasing the LAST real block:
# zero values accumulate nothing, and the block id preserves every
# aligned-chunk span, so tuned scan windows stay valid) to a multiple of
# this at BUILD time. The scan paths reshape tables into
# (n_chunks, chunk, T); when the tile count isn't a chunk multiple, XLA
# pads+copies ALL tables as HLO temps EVERY call — ~3.8 GB of temps at
# ogbn-products scale, the difference between products fitting and not.
# 512 covers both production chunk sizes (256, 512).
TILE_PAD = 512


def _round_tiles(nt: int) -> int:
    return max(-(-nt // TILE_PAD) * TILE_PAD, TILE_PAD)


@pytree_dataclass
class EdgeTiles:
    """Rectangular edge-tile tables for the tile-scan SpMM.

    block:    (NT,)   int32  row-block id per tile
    cols:     (NT, T) int32  column index per edge (0 for padding)
    vals:     (NT, T) f32    edge weight (0 for padding)
    localrow: (NT, T) int32  row within the block, in [0, R)
    """

    block: jax.Array
    cols: jax.Array
    vals: jax.Array
    localrow: jax.Array
    row_block: int = static_field(ROW_BLOCK)
    num_row_blocks: int = static_field(0)
    num_nodes: int = static_field(0)

    @property
    def num_tiles(self) -> int:
        return self.block.shape[0]

    @property
    def edge_tile(self) -> int:
        return self.cols.shape[1]


def build_edge_tiles(
    g: CSRGraph,
    row_block: int = ROW_BLOCK,
    edge_tile: int = EDGE_TILE,
    elide_empty: bool = False,
) -> EdgeTiles:
    """Host-side CSR → edge tiles (vectorized numpy; C++ fast path in
    `maxk_gnn.sparse._native` when built).

    Role of `kernels/generate_meta.py` but emitting rectangular tensors
    instead of a ragged quadruple stream.

    `elide_empty`: blocks with no edges get NO tile (instead of one
    all-padding tile). Only valid for consumers whose accumulator is
    seeded/zero-initialized independently of tile coverage (the scan
    paths); the banded hybrid tail relies on it — without elision each
    band pays one pad tile per empty (block, band) combination.
    """
    indptr = np.asarray(g.indptr, dtype=np.int64)
    # trim any inert tail past indptr[-1] (device soft-dedup compaction)
    nnz = int(indptr[-1])
    cols = np.asarray(g.indices, dtype=np.int32)[:nnz]
    vals = np.asarray(g.values, dtype=np.float32)[:nnz]
    v = indptr.shape[0] - 1
    nb = -(-v // row_block)

    from maxk_gnn.sparse import _native

    native = (
        None
        if elide_empty
        else _native.edge_tiles_native(indptr, cols, vals, row_block, edge_tile)
    )
    if native is not None:
        tb, tc, tv, tl = native
        ntp = _round_tiles(tb.shape[0])
        if ntp != tb.shape[0]:
            pad = ntp - tb.shape[0]
            tb = np.pad(tb, (0, pad), mode="edge")
            tc = np.pad(tc, ((0, pad), (0, 0)))
            tv = np.pad(tv, ((0, pad), (0, 0)))
            tl = np.pad(tl, ((0, pad), (0, 0)))
        return EdgeTiles(
            block=jnp.asarray(tb),
            cols=jnp.asarray(tc),
            vals=jnp.asarray(tv),
            localrow=jnp.asarray(tl),
            row_block=row_block,
            num_row_blocks=nb,
            num_nodes=v,
        )

    # pad indptr so every block has exactly row_block rows
    if nb * row_block + 1 > indptr.shape[0]:
        indptr = np.concatenate(
            [indptr, np.full(nb * row_block + 1 - indptr.shape[0], indptr[-1])]
        )

    block_start = indptr[0 :: row_block][:nb]
    block_end = indptr[row_block :: row_block]
    block_end = np.concatenate([block_end, [indptr[-1]]])[:nb]
    counts = block_end - block_start  # edges per row-block
    ntiles = (-(-counts // edge_tile)).astype(np.int64)
    if not elide_empty:
        ntiles = np.maximum(ntiles, 1)
    elif ntiles.sum() == 0:
        ntiles[0] = 1  # degenerate empty graph: keep one inert tile
    nt = int(ntiles.sum())

    tile_block = np.repeat(np.arange(nb, dtype=np.int32), ntiles)

    # destination slot of every edge inside the flat (nt*T) padded stream
    tile_offset = np.concatenate([[0], np.cumsum(ntiles)])  # tiles before block b
    e_total = cols.shape[0]
    edge_block = np.repeat(np.arange(nb), counts)  # block of each edge
    local_off = np.arange(e_total) - np.repeat(block_start, counts)
    dest = tile_offset[edge_block] * edge_tile + local_off

    flat_cols = np.zeros(nt * edge_tile, dtype=np.int32)
    flat_vals = np.zeros(nt * edge_tile, dtype=np.float32)
    flat_lrow = np.zeros(nt * edge_tile, dtype=np.int32)
    flat_cols[dest] = cols
    flat_vals[dest] = vals
    # row of each edge, relative to its block
    deg = indptr[1:] - indptr[:-1]
    edge_row = np.repeat(np.arange(nb * row_block), deg)
    flat_lrow[dest] = (edge_row - edge_block * row_block).astype(np.int32)

    ntp = _round_tiles(nt)
    pad = ntp - nt
    return EdgeTiles(
        block=jnp.asarray(np.pad(tile_block, (0, pad), mode="edge")),
        cols=jnp.asarray(
            np.pad(flat_cols.reshape(nt, edge_tile), ((0, pad), (0, 0)))
        ),
        vals=jnp.asarray(
            np.pad(flat_vals.reshape(nt, edge_tile), ((0, pad), (0, 0)))
        ),
        localrow=jnp.asarray(
            np.pad(flat_lrow.reshape(nt, edge_tile), ((0, pad), (0, 0)))
        ),
        row_block=row_block,
        num_row_blocks=nb,
        num_nodes=v,
    )


def max_block_span(block, chunk: int) -> int:
    """Exact max row-block span of any aligned `chunk` of tiles.

    `spmm_tiles_scan(..., window=w)` is correct iff w ≥ this value for
    the same chunk size; computing it at schedule-build time lets the
    scan shrink its accumulator read-modify-write slice from `chunk`
    blocks to the actual span (block-sorted tail tables average many
    tiles per block, so the span is far below the worst case).
    """
    b = np.asarray(block)
    nt = b.shape[0]
    if nt == 0:
        return 1
    nc = -(-nt // chunk)
    bp = np.pad(b, (0, nc * chunk - nt), mode="edge").reshape(nc, chunk)
    span = int((bp[:, -1] - bp[:, 0]).max()) + 1
    # NOT clamped to chunk: elided-empty tables (gaps in block ids) can
    # legitimately span more than `chunk` blocks per chunk of tiles
    return -(-span // 8) * 8


def build_edge_tiles_device(
    g: CSRGraph,
    row_block: int = ROW_BLOCK,
    edge_tile: int = EDGE_TILE,
    elide_empty: bool = False,
) -> EdgeTiles:
    """On-device tile construction (pure jnp, jittable body, static shapes).

    The BASELINE north-star asks for the generate_meta analog "built
    on-device". Shapes: the tile count is bounded statically by
    ceil(E/T) + NB (each block adds ≤1 padding tile); surplus tail tiles
    alias the LAST block with zero values — they are ordered after its
    real tiles, so they only re-accumulate zero (never re-zero an output).

    Scatter-free: each destination slot *gathers* its edge (slot→edge
    index arithmetic), keeping the build a pure gather.
    """
    v = g.num_nodes
    # live edge count (excludes any compacted inert tail): one scalar
    # fetch — keeps the static tile count tight so padding tiles don't
    # burn gather slots
    e = int(np.asarray(g.indptr[-1]))
    nb = -(-v // row_block)

    # EXACT tile count (second scalar fetch at build time): the bound
    # ceil(E/T)+NB wastes up to NB surplus tiles — at reddit scale with
    # R=8 that is ~29K all-padding tiles the tail scan then gathers
    # (0.75 M dead slots ≈ 10% of the tail arm's time)
    @functools.partial(jax.jit, static_argnums=(1,))
    def exact_nt(indptr, elide):
        ip = indptr.astype(jnp.int32)
        full = jnp.full((nb * row_block + 1 - ip.shape[0],), ip[-1], jnp.int32)
        ipp = jnp.concatenate([ip, full])
        bstart = ipp[0 :: row_block][:nb]
        bend = jnp.concatenate([ipp[row_block :: row_block], ipp[-1:]])[:nb]
        counts = bend - bstart
        per = -(-counts // edge_tile)
        return jnp.sum(per if elide else jnp.maximum(per, 1))

    # rounded to the build-time pad multiple: surplus tiles alias the
    # LAST block (jnp.repeat total_repeat_length pads with the final
    # value) with valid=False → zero cols/vals — the scan reshape to
    # (n_chunks, chunk, T) then needs no in-graph pad+copy of the tables
    nt = _round_tiles(int(np.asarray(exact_nt(g.indptr, elide_empty))))

    @jax.jit
    def build(indptr, cols, vals):
        ip = indptr.astype(jnp.int32)
        # pad row pointers to block multiple
        full = jnp.full((nb * row_block + 1 - ip.shape[0],), e, jnp.int32)
        ipp = jnp.concatenate([ip, full])
        bstart = ipp[0 :: row_block][:nb]
        bend = jnp.concatenate([ipp[row_block :: row_block], ipp[-1:]])[:nb]
        counts = bend - bstart
        ntiles = -(-counts // edge_tile)
        if not elide_empty:
            ntiles = jnp.maximum(ntiles, 1)
        toffset = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(ntiles).astype(jnp.int32)]
        )
        # tile -> block (pad tail repeats the last block)
        tile_block = jnp.repeat(
            jnp.arange(nb, dtype=jnp.int32), ntiles, total_repeat_length=nt
        )
        # slot -> source edge (gather formulation)
        t_ix = jnp.arange(nt, dtype=jnp.int32)[:, None]
        off = jnp.arange(edge_tile, dtype=jnp.int32)[None, :]
        blk = tile_block[:, None]
        within = (t_ix - toffset[blk]) * edge_tile + off
        src = bstart[blk] + within
        valid = within < counts[blk]
        srcc = jnp.clip(src, 0, e - 1)
        tcols = jnp.where(valid, cols[srcc], 0).astype(jnp.int32)
        tvals = jnp.where(valid, vals[srcc], 0.0).astype(jnp.float32)
        # edge -> row, via the O(E) scan form (searchsorted with E-sized
        # needles crashes the worker at products scale — see
        # csr.rows_from_indptr); srcc is a gather of precomputed slot rows
        erow = rows_from_indptr(ipp, max(e, 1), nb * row_block)[srcc]
        tlrow = jnp.where(valid, erow - blk * row_block, 0).astype(jnp.int32)
        return tile_block, tcols, tvals, tlrow

    tb, tc, tv, tl = build(g.indptr, g.indices, g.values)
    return EdgeTiles(
        block=tb,
        cols=tc,
        vals=tv,
        localrow=tl,
        row_block=row_block,
        num_row_blocks=nb,
        num_nodes=v,
    )
