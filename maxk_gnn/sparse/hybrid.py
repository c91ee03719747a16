"""Degree-sorted symmetric-strip hybrid schedule — dense-matmul SpMM.

The reference's aggregation kernel streams E edges through per-warp
scatter loops (`kernels/spmm_maxk.cu:17-106`). The hybrid
instead reshapes the problem so most edges ride dense matrix products and
only a tail touches the gather path:

  1. nodes are permuted by descending live degree (hubs first). On
     reddit-scale R-MAT the first 16K columns then hold ~70% of edges, and
     rows<16K ∪ cols<16K hold ~93%.
  2. every reference training graph is undirected, so the normalized
     adjacency factors as A = D_post · S · D_pre with S VALUE-SYMMETRIC
     (raw weights + self loops); the op computes
     Y = post ⊙ (S @ (pre ⊙ x)) and A^T just swaps the scales.
  3. S splits into two statically-shaped parts:
       strip  W = S[:, :S_cols]   materialized DENSE (int8 or bf16,
                                  (Vp, S)); symmetric ⇒ S[:S_cols, :] = W^T,
                                  so one array serves the hub rows (y[:S] =
                                  W^T @ x, all columns by symmetry) AND
                                  the non-hub rows' hub columns
                                  (y[S:] = W[S:] @ x_hub) — disjoint row
                                  ranges, no corner double-count
       tail   rows≥S ∧ cols≥S     edge tiles for the gather path
  4. aggregation = 2 dense matmuls + one small tile-scan; everything is
     plain differentiable XLA (the VJP of a symmetric operator is itself,
     so no custom_vjp and no CSC twin is needed).

Schedules are built twice: numpy on the host (tests, the sharded builder)
and pure-jnp on the device (`build_hybrid_device`, what `build_graph` and
the benchmarks use: a reddit strip is several GB).

Planning: `auto_strip_cols` sizes the strip from the device's memory
(`ops/dispatch.memory_bytes`) and `hybrid_profitable` weighs it against
the gather with the device's measured constants
(`ops/dispatch.DEVICE_CONSTANTS`). Of the defaults below, the int8 strip
width was measured on the card at reddit scale (PERF.md); the bf16 width
and the tail tiles are untuned.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from maxk_gnn.pytree import pytree_dataclass, static_field
from maxk_gnn.sparse.csr import CSRGraph, rows_from_indptr
from maxk_gnn.sparse.meta import (
    EDGE_TILE,
    ROW_BLOCK,
    EdgeTiles,
    build_edge_tiles,
    build_edge_tiles_device,
)

STRIP_COLS = 16384  # default hub-strip width, bf16 strip (untuned)
# default width of the exact int8 strip: fastest of 16384/24576/32768/
# 49152 for the reddit fwd+bwd SpMM on one H100 (PERF.md)
STRIP_COLS_INT8 = 32768
# tail tiles (untuned defaults): the post-strip remainder is low-degree,
# so the dense path's 256-edge tiles would be mostly padding
TAIL_EDGE_TILE = 64
TAIL_EDGE_TILE_INT8 = 32
# memory kept free beside the strip and the SpMM working set
RESERVE_FRACTION = 0.1


def auto_strip_cols(
    v: int,
    s_cols: Optional[int] = None,
    e_live: Optional[int] = None,
    dim: int = 256,
    io_itemsize: int = 4,
    strip_itemsize: int = 2,
    memory: Optional[int] = None,
) -> int:
    """Strip width for a V-node graph: the default, shrunk to fit device
    memory, lane-aligned.

    `s_cols=None` → the default per strip itemsize (STRIP_COLS for bf16,
    STRIP_COLS_INT8 for int8). `memory` is the device's usable bytes
    (default: `ops/dispatch.memory_bytes()`); half of what remains after
    the reserve goes to the strip.

    With `e_live` the budget also subtracts the SpMM working set: at
    ogbn-products scale (V=2.45M) the (V, dim) output/accumulator/
    cotangent buffers plus the tail tables are ~12 GB.

    `io_itemsize` sizes the (V, dim) output/cotangent buffers: 4 for the
    f32-valued op surface (default, conservative), 2 when the caller
    keeps every (V, dim) tensor except the scan accumulator in bf16."""
    if s_cols is None:
        s_cols = STRIP_COLS_INT8 if strip_itemsize == 1 else STRIP_COLS
    if memory is None:
        from maxk_gnn.ops.dispatch import memory_bytes

        memory = memory_bytes()
    vp = -(-v // 128) * 128
    budget = memory * (1.0 - RESERVE_FRACTION) / 2
    if e_live is not None:
        # 1 × (V, dim) f32 scan accumulator
        # + 2 × (V, dim) io_itemsize (output, backward cotangent)
        # + 2 × (V, dim) bf16 (densified x, pre-scaled xs)
        # + ~17 B/edge (CSR arrays + padded tail tile tables)
        working = (
            v * dim * 4
            + 2 * v * dim * io_itemsize
            + 2 * v * dim * 2
            + 17 * e_live
        )
        budget = min(budget, memory * (1.0 - RESERVE_FRACTION) - working)
    # strip_itemsize: 2 for the bf16 strip (default), 1 for the exact
    # int8 strip (integer-valued graphs) — half the bytes per column
    # buys twice the width at the same budget
    fit = int(max(budget, 0.0) // (vp * strip_itemsize)) // 128 * 128
    return max(min(s_cols, v, fit), 0)


def strip_int8_exact(csr: CSRGraph) -> bool:
    """True iff an int8 strip is EXACT for this graph: every live value
    is an integer with |v| ≤ 127. True for every reference training
    graph (uniform weight 1.0 + small dedup counts — `dataset_gen.py`
    semantics). One jitted pass over E, two scalar fetches."""

    @jax.jit
    def gate(indptr, values):
        e = values.shape[0]
        ar = jnp.arange(e, dtype=jnp.int32)
        live = (ar < indptr[-1]) & (values != 0)
        frac = jnp.where(live, jnp.abs(values - jnp.round(values)), 0.0).max()
        mag = jnp.where(live, jnp.abs(values), 0.0).max()
        return frac, mag

    frac, mag = gate(csr.indptr, csr.values)
    return float(frac) == 0.0 and float(mag) <= jnp.iinfo(jnp.int8).max


def auto_strip_dtype(csr: CSRGraph):
    """Strip dtype: int8 where exact, bf16 otherwise. The int8 strip
    converts to bf16 at matmul read, and at an equal memory budget holds
    twice the columns, absorbing tail edges that would otherwise ride the
    gather path."""
    return jnp.int8 if strip_int8_exact(csr) else jnp.bfloat16


def auto_tail_band_cols(v: int, s_cols: int) -> int:
    """Tail-banding rule. 0 = single band (no banding): splitting the
    tail into column bands pads more tile slots than the narrower gather
    tables recover, so banding stays an explicit option."""
    return 0


def hybrid_profitable(
    v: int,
    e_live: int,
    *,
    constants,
    dim: int = 256,
    io_itemsize: int = 4,
    strip_itemsize: int = 2,
    memory: Optional[int] = None,
) -> bool:
    """Planning rule: build the strip hybrid only where its dense
    products beat the gather every live edge would otherwise pay.

    strip cost ≈ 3·vp·s·dim·2 / matmul_flops; gather cost ≈ E·gather_s.
    The 0.5 margin covers the tail arm and coverage uncertainty (the
    hub-strip fraction isn't known until the schedule is built). High
    average-degree graphs pass; sparse ones stay on the gather path —
    mirroring the reference's own claim territory (`README.md:136`
    restricts the kernel speedups to graphs with avg degree > 50).

    `constants` is an `ops/dispatch.DeviceConstants`.
    `io_itemsize`/`strip_itemsize` must match what the caller will build
    with (`auto_strip_cols` kwargs)."""
    s = auto_strip_cols(
        v, e_live=e_live, dim=dim,
        io_itemsize=io_itemsize, strip_itemsize=strip_itemsize,
        memory=memory,
    )
    if s < 256:
        return False  # strip too narrow to hold the hub mass
    vp = -(-v // 128) * 128
    strip_time = 3.0 * vp * s * dim * 2 / constants.matmul_flops
    gather_time = e_live * constants.gather_s_per_edge
    return strip_time < 0.5 * gather_time


def tail_slot_stats(
    csr: CSRGraph,
    s_cols: int,
    band_cols: int = 0,
    row_block: int = ROW_BLOCK,
    edge_tile: int = TAIL_EDGE_TILE,
    presorted: bool = False,
) -> dict:
    """Host planning: tail size and tile-slot padding for a candidate
    (strip width, band width) — WITHOUT building anything on device.

    The tail arm's cost is slot-bound, so the two schedule levers trade
    directly in slots: widening the strip removes tail edges outright,
    while column banding narrows the gather table at the price of
    splitting each row block's edges across bands (more partially-filled
    tiles). This computes the exact slot
    counts the real builders would produce (same ceil(count/edge_tile)
    rule, empty (block, band) cells elided), so the profitability rule
    is auditable: banding pays iff slot_inflation < locality gain.

    `presorted`: csr is already degree-permuted (builders' contract);
    otherwise ranks are computed here.
    """
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    nnz = int(indptr[-1])
    cols = np.asarray(csr.indices, dtype=np.int64)[:nnz]
    v = indptr.shape[0] - 1
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(v, dtype=np.int64), deg)
    if presorted:
        rr, cr = rows, cols
    else:
        rank = np.empty(v, dtype=np.int64)
        rank[np.argsort(-deg, kind="stable")] = np.arange(v)
        rr, cr = rank[rows], rank[cols]
    t = (rr >= s_cols) & (cr >= s_cols)
    rt, ct = rr[t], cr[t]
    live = int(t.sum())
    blk = rt // row_block
    if band_cols > 0:
        band = _effective_band(v - s_cols, band_cols)
        key = blk * np.int64(1 << 20) + (ct - s_cols) // band
        n_bands = -(-(v - s_cols) // band)
    else:
        key = blk
        n_bands = 1
    from maxk_gnn.sparse.meta import _round_tiles

    keys, counts = np.unique(key, return_counts=True)
    if band_cols <= 0:
        tiles = int(np.ceil(counts / edge_tile).sum())
        # the single-band builder emits one all-padding tile per EMPTY
        # row block (build_edge_tiles elide_empty=False); only the
        # banded path elides empty (block, band) cells
        tiles += -(-v // row_block) - len(counts)
        # build-time chunk-multiple rounding (meta.TILE_PAD)
        tiles = _round_tiles(tiles)
    else:
        # each band is its own EdgeTiles, rounded independently
        band_of = keys % np.int64(1 << 20)
        per_cell = np.ceil(counts / edge_tile).astype(np.int64)
        tiles = sum(
            _round_tiles(int(per_cell[band_of == b].sum()))
            for b in np.unique(band_of)
        )
    slots = tiles * edge_tile
    return {
        "s_cols": s_cols,
        "band_cols": band_cols,
        "n_bands": n_bands,
        "tail_live": live,
        "tiles": tiles,
        "slots": slots,
        "pad_ratio": slots / max(live, 1),
        "strip_gb": (-(-v // 128) * 128) * s_cols * 2 / 1e9,
    }


@pytree_dataclass
class HybridSchedule:
    """Materialized symmetric-strip decomposition of one graph.

    strip:      (Vp, S) strip dtype   W = S[:, :S] (raw symmetric values)
    pre/post:   (V,)    f32           diagonal norm factors (none → ones)
    tail_tiles: EdgeTiles             rows≥S ∧ cols≥S remainder
    """

    strip: jax.Array
    pre: jax.Array
    post: jax.Array
    tail_tiles: EdgeTiles
    num_nodes: int = static_field(0)
    s_cols: int = static_field(STRIP_COLS)
    # tiles per scan step of the tail arm (spmm_hybrid)
    tail_chunk: int = static_field(256)
    # exact accumulator RMW window for the tail scan (0 = full chunk);
    # computed at build time from the block table (`meta.max_block_span`)
    tail_window: int = static_field(0)
    # column-banded tail (optional): per-band tile tables whose column
    # indices are REBASED to the band start, so each scan gathers from a
    # narrow (band, D) slice of x. Empty tuple = single-band (tail_tiles). Bands chain through the
    # scan accumulator, so the result is bit-identical either way.
    tail_bands: tuple = ()
    # per-band (col_start, col_width, window) — static schedule metadata
    tail_band_meta: tuple = static_field(())

    @property
    def padded_nodes(self) -> int:
        return self.strip.shape[0]


def degree_perm(csr: CSRGraph) -> np.ndarray:
    """Host: permutation sorting nodes by descending live degree."""
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    deg = np.diff(indptr)
    return np.argsort(-deg, kind="stable").astype(np.int32)


def permute_csr(csr: CSRGraph, perm: np.ndarray) -> CSRGraph:
    """Host: relabel nodes so new node i is old node perm[i]."""
    import scipy.sparse as sp

    from maxk_gnn.sparse.csr import csr_to_scipy

    m = csr_to_scipy(csr).tocoo()
    v = m.shape[0]
    rank = np.empty(v, dtype=np.int64)
    rank[perm] = np.arange(v)
    out = sp.csr_matrix(
        (m.data, (rank[m.row], rank[m.col])), shape=(v, v)
    )
    out.sort_indices()
    return CSRGraph(
        indptr=jnp.asarray(out.indptr.astype(np.int32)),
        indices=jnp.asarray(out.indices.astype(np.int32)),
        values=jnp.asarray(out.data.astype(np.float32)),
    )


def _scales(deg: jax.Array, norm: str) -> Tuple[jax.Array, jax.Array]:
    ones = jnp.ones_like(deg)
    d = jnp.maximum(deg, 1.0)
    if norm == "none":
        return ones, ones
    if norm == "right":
        return ones, 1.0 / d
    if norm == "left":
        return 1.0 / d, ones
    if norm == "both":
        inv = 1.0 / jnp.sqrt(d)
        return inv, inv
    raise ValueError(f"unknown norm mode: {norm}")


def check_hybrid_ok(csr: CSRGraph, tol: float = 1e-6) -> bool:
    """Host: the hybrid needs raw value symmetry (undirected graph)."""
    from maxk_gnn.sparse.csr import csr_to_scipy

    m = csr_to_scipy(csr)
    d = abs(m - m.T)
    return d.nnz == 0 or float(d.max()) < tol


def build_hybrid(
    csr: CSRGraph,
    s_cols: int = STRIP_COLS,
    norm: str = "none",
    strip_dtype=jnp.bfloat16,
    row_block: int = ROW_BLOCK,
    edge_tile: Optional[int] = None,
    tail_chunk: int = 256,
    tail_band_cols: int = 0,
) -> HybridSchedule:
    """Host (numpy) build. `csr` must already be degree-permuted
    (`permute_csr(csr, degree_perm(csr))`) and RAW-value-symmetric; `norm`
    only sets the diagonal scales. `tail_band_cols` > 0 splits the tail
    into column bands of that width (see HybridSchedule.tail_bands).
    `edge_tile=None` → the default for the strip dtype
    (TAIL_EDGE_TILE / TAIL_EDGE_TILE_INT8)."""
    if edge_tile is None:
        edge_tile = (
            TAIL_EDGE_TILE_INT8
            if jnp.issubdtype(jnp.dtype(strip_dtype), jnp.integer)
            else TAIL_EDGE_TILE
        )
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    nnz = int(indptr[-1])
    v = csr.num_nodes
    s = min(s_cols, v)
    s = max(128, (s // 128) * 128) if v >= 128 else v
    cols = np.asarray(csr.indices, dtype=np.int64)[:nnz]
    vals = np.asarray(csr.values, dtype=np.float32)[:nnz]
    rows = np.repeat(np.arange(v, dtype=np.int64), np.diff(indptr))

    vp = -(-v // 128) * 128
    live = vals != 0
    in_strip = (cols < s) & live
    if jnp.issubdtype(jnp.dtype(strip_dtype), jnp.integer):
        # integer strips are EXACT only for integer-valued graphs (raw
        # symmetric weights after dedup: 1.0 + duplicate-sum counts);
        # the diagonal scales carry all normalization
        iinfo = jnp.iinfo(strip_dtype)
        bad = (vals[in_strip] != np.round(vals[in_strip])) | (
            np.abs(vals[in_strip]) > iinfo.max
        )
        if bad.any():
            raise ValueError(
                f"strip_dtype={jnp.dtype(strip_dtype).name} requires "
                f"integer strip values in [{iinfo.min}, {iinfo.max}]; "
                f"{int(bad.sum())} edges violate this"
            )
    strip = np.zeros((vp, s), dtype=np.float32)
    strip[rows[in_strip], cols[in_strip]] = vals[in_strip]

    in_tail = (cols >= s) & (rows >= s) & live
    tail = _subgraph_host(v, rows[in_tail], cols[in_tail], vals[in_tail])
    tail_tiles = build_edge_tiles(tail, row_block, edge_tile)
    from maxk_gnn.sparse.meta import max_block_span

    tail_window = max_block_span(tail_tiles.block, tail_chunk)

    tail_bands: tuple = ()
    band_meta: tuple = ()
    if tail_band_cols > 0 and v - s > tail_band_cols:
        tail_band_cols = _effective_band(v - s, tail_band_cols)
        bands = []
        meta = []
        for c0 in range(s, v, tail_band_cols):
            width = min(tail_band_cols, v - c0)
            m = in_tail & (cols >= c0) & (cols < c0 + width)
            if not m.any():
                continue  # empty band would still cost one pad tile/block
            # columns REBASED to the band start: the scan gathers from
            # x[c0 : c0+width]
            sub = _subgraph_host(v, rows[m], cols[m] - c0, vals[m])
            # empty blocks elided: every band scan is acc0-seeded, so
            # untouched output blocks are already correct
            tb = build_edge_tiles(sub, row_block, edge_tile, elide_empty=True)
            bands.append(tb)
            meta.append((c0, width, max_block_span(tb.block, tail_chunk)))
        tail_bands, band_meta = tuple(bands), tuple(meta)

    deg = jax.ops.segment_sum(
        jnp.asarray(live.astype(np.float32)),
        jnp.asarray(rows.astype(np.int32)),
        num_segments=v,
    )
    pre, post = _scales(deg, norm)
    return HybridSchedule(
        strip=jnp.asarray(strip).astype(strip_dtype),
        pre=pre,
        post=post,
        tail_tiles=tail_tiles,
        num_nodes=v,
        s_cols=s,
        tail_chunk=tail_chunk,
        tail_window=tail_window,
        tail_bands=tail_bands,
        tail_band_meta=band_meta,
    )


def _effective_band(span: int, band: int, max_bands: int = 12) -> int:
    """Widen the requested band so the tail splits into ≤ max_bands
    pieces: every band is a separately-compiled scan (distinct static
    tile count)."""
    if span > band * max_bands:
        band = -(-span // max_bands)
        band = -(-band // 128) * 128
    return band


def _subgraph_host(v, rows, cols, vals) -> CSRGraph:
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.searchsorted(rows, np.arange(v + 1)).astype(np.int32)
    return CSRGraph(
        indptr=jnp.asarray(indptr),
        indices=jnp.asarray(cols.astype(np.int32)),
        values=jnp.asarray(vals.astype(np.float32)),
    )


# ---------------------------------------------------------------------------
# device builders (the graph never leaves the device)
# ---------------------------------------------------------------------------


def degree_perm_device(csr: CSRGraph) -> jax.Array:
    @jax.jit
    def p(indptr):
        deg = indptr[1:] - indptr[:-1]
        return jnp.argsort(-deg, stable=True).astype(jnp.int32)

    return p(csr.indptr)


def permute_csr_device(csr: CSRGraph, perm: jax.Array) -> CSRGraph:
    """Device twin of `permute_csr`; keeps the inert dead tail invariant
    (dead entries re-sorted past row V with value 0)."""
    v = csr.num_nodes

    @jax.jit
    def p(indptr, indices, values, perm):
        e = indices.shape[0]
        ar = jnp.arange(e, dtype=jnp.int32)
        rows = rows_from_indptr(indptr, e, v)
        live = ar < indptr[-1]
        rank = jnp.zeros((v,), jnp.int32).at[perm].set(
            jnp.arange(v, dtype=jnp.int32)
        )
        nr = jnp.where(live, rank[rows], v)
        nc = jnp.where(live, rank[indices], v)
        nr, nc, nv = jax.lax.sort((nr, nc, values), num_keys=2)
        new_indptr = jnp.searchsorted(
            nr, jnp.arange(v + 1, dtype=jnp.int32)
        ).astype(jnp.int32)
        return new_indptr, nc, jnp.where(nr < v, nv, 0.0)

    indptr, indices, values = p(csr.indptr, csr.indices, csr.values, perm)
    return CSRGraph(indptr=indptr, indices=indices, values=values)


def build_hybrid_device(
    csr: CSRGraph,
    s_cols: int = STRIP_COLS,
    norm: str = "none",
    strip_dtype=jnp.bfloat16,
    row_block: int = ROW_BLOCK,
    edge_tile: Optional[int] = None,
    tail_chunk: int = 256,
    tail_band_cols: int = 0,
) -> HybridSchedule:
    """On-device build (jit; one-time per graph). Same semantics as
    `build_hybrid`."""
    if edge_tile is None:
        edge_tile = (
            TAIL_EDGE_TILE_INT8
            if jnp.issubdtype(jnp.dtype(strip_dtype), jnp.integer)
            else TAIL_EDGE_TILE
        )
    v = csr.num_nodes
    s = min(s_cols, v)
    s = max(128, (s // 128) * 128) if v >= 128 else v
    vp = -(-v // 128) * 128

    if jnp.issubdtype(jnp.dtype(strip_dtype), jnp.integer):
        # same exactness gate as the host builder (`build_hybrid`): an
        # integer strip silently truncates non-integer or out-of-range
        # values in strip_chunk's astype, so check BEFORE scattering.
        # One jitted pass over E, two scalar fetches.
        iinfo = jnp.iinfo(strip_dtype)

        @jax.jit
        def _int_gate(indptr, indices, values):
            e = indices.shape[0]
            ar = jnp.arange(e, dtype=jnp.int32)
            live = (ar < indptr[-1]) & (values != 0) & (indices < s)
            frac = jnp.where(
                live, jnp.abs(values - jnp.round(values)), 0.0
            ).max()
            mag = jnp.where(live, jnp.abs(values), 0.0).max()
            return frac, mag

        frac, mag = _int_gate(csr.indptr, csr.indices, csr.values)
        if float(frac) != 0.0 or float(mag) > iinfo.max:
            raise ValueError(
                f"strip_dtype={jnp.dtype(strip_dtype).name} requires "
                f"integer strip values in [{iinfo.min}, {iinfo.max}]; "
                f"max |v - round(v)| = {float(frac)}, max |v| = "
                f"{float(mag)}"
            )

    # Phased build (separate jits, donated buffers): a reddit-scale strip
    # is several GB, and a single-jit build would hold it next to the
    # sort scratch and per-chunk scatter temps. Phase 1 extracts the tail
    # (sort scratch freed after); phase 2 scatters the strip
    # chunk-by-chunk into a donated buffer.

    @jax.jit
    def tail_phase(indptr, indices, values):
        e = indices.shape[0]
        ar = jnp.arange(e, dtype=jnp.int32)
        rows = rows_from_indptr(indptr, e, v)
        live = (ar < indptr[-1]) & (values != 0)
        deg = jax.ops.segment_sum(
            live.astype(jnp.float32), rows, num_segments=v,
            indices_are_sorted=True,
        )
        # tail: re-sort non-tail edges past row V (inert-tail trick)
        in_tail = live & (indices >= s) & (rows >= s)
        tr = jnp.where(in_tail, rows, v)
        tc = jnp.where(in_tail, indices, v)
        tr, tc, tv = jax.lax.sort((tr, tc, values), num_keys=2)
        tail_indptr = jnp.searchsorted(
            tr, jnp.arange(v + 1, dtype=jnp.int32)
        ).astype(jnp.int32)
        return (
            deg,
            tail_indptr,
            jnp.where(tr < v, tc, 0).astype(jnp.int32),
            jnp.where(tr < v, tv, 0.0),
        )

    # scatter straight into the strip dtype: a f32 intermediate would
    # double the peak memory; each (row, col) occurs once (dedup'd), so no
    # accumulation precision is at stake — only the value's own rounding.
    # 1D flat indices, chunked over columns: a 2D .at[rows, cols] scatter
    # stacks an (E, 2) index array, and a single flat index overflows
    # int32 when vp*s > 2^31. Chunk width caps both the flat index range
    # and the per-chunk temps (~2 chunk copies live at once), at 1.2 GB
    # per chunk.
    w_bytes = int(1.2e9) // (vp * jnp.dtype(strip_dtype).itemsize)
    w = min(s, 2048, max(128, min((2**31 - 1) // vp, w_bytes) // 128 * 128))

    # c0 is TRACED (only the chunk width is static): all full-width
    # chunks share one executable, where a static c0 would compile
    # ceil(s/w) copies of this scatter
    @functools.partial(jax.jit, donate_argnums=(0,), static_argnums=(5,))
    def strip_chunk(strip, indptr, indices, values, c0, wc):
        e = indices.shape[0]
        ar = jnp.arange(e, dtype=jnp.int32)
        rows = rows_from_indptr(indptr, e, v)
        live = (ar < indptr[-1]) & (values != 0)
        in_chunk = live & (indices >= c0) & (indices < c0 + wc)
        idx = jnp.where(in_chunk, rows * wc + (indices - c0), -1)
        chunk = (
            jnp.zeros((vp * wc,), strip_dtype)
            .at[idx]
            .add(
                jnp.where(in_chunk, values, 0.0).astype(strip_dtype),
                mode="drop",
            )
        )
        return jax.lax.dynamic_update_slice(
            strip, chunk.reshape(vp, wc), (0, c0)
        )

    deg, tail_indptr, tail_cols, tail_vals = tail_phase(
        csr.indptr, csr.indices, csr.values
    )
    strip = jnp.zeros((vp, s), strip_dtype)
    for c0 in range(0, s, w):
        strip = strip_chunk(
            strip, csr.indptr, csr.indices, csr.values,
            jnp.int32(c0), min(w, s - c0),
        )
    # trim the tail arrays to the live tail (one scalar fetch) so the tile
    # tables are sized for ~7% of E, not all of it
    tl = int(np.asarray(tail_indptr[-1]))
    tl_pad = max(-(-tl // edge_tile) * edge_tile, edge_tile)
    tail = CSRGraph(
        indptr=tail_indptr,
        indices=tail_cols[:tl_pad],
        values=tail_vals[:tl_pad],
    )
    tail_tiles = build_edge_tiles_device(tail, row_block, edge_tile)
    from maxk_gnn.sparse.meta import max_block_span

    # one ~400 KB block-table download at build time buys the exact
    # RMW window for every subsequent tail scan
    tail_window = max_block_span(tail_tiles.block, tail_chunk)

    tail_bands: tuple = ()
    band_meta: tuple = ()
    if tail_band_cols > 0 and v - s > tail_band_cols:
        tail_band_cols = _effective_band(v - s, tail_band_cols)
        # per-band extraction from the (already row/col-sorted) trimmed
        # tail stream: filtering a col range preserves CSR order, so one
        # 2-key sort per band over ~7% of E suffices
        @functools.partial(jax.jit, static_argnums=(3,))
        def band_extract(indptr, cols_, vals_, width, c0):
            e2 = cols_.shape[0]
            ar = jnp.arange(e2, dtype=jnp.int32)
            rows2 = rows_from_indptr(indptr, e2, v)
            live2 = (ar < indptr[-1]) & (vals_ != 0)
            inb = live2 & (cols_ >= c0) & (cols_ < c0 + width)
            br = jnp.where(inb, rows2, v)
            bc = jnp.where(inb, cols_ - c0, v)
            br, bc, bv = jax.lax.sort((br, bc, vals_), num_keys=2)
            ip = jnp.searchsorted(
                br, jnp.arange(v + 1, dtype=jnp.int32)
            ).astype(jnp.int32)
            return (
                ip,
                jnp.where(br < v, bc, 0).astype(jnp.int32),
                jnp.where(br < v, bv, 0.0),
            )

        bands = []
        meta = []
        for c0 in range(s, v, tail_band_cols):
            width = min(tail_band_cols, v - c0)
            ip, bc, bv = band_extract(
                tail.indptr, tail.indices, tail.values, width, jnp.int32(c0)
            )
            bl = int(np.asarray(ip[-1]))
            if bl == 0:
                continue  # empty band would still cost one pad tile/block
            bl_pad = max(-(-bl // edge_tile) * edge_tile, edge_tile)
            # empty blocks elided: band scans are acc0-seeded
            tb = build_edge_tiles_device(
                CSRGraph(indptr=ip, indices=bc[:bl_pad], values=bv[:bl_pad]),
                row_block, edge_tile, elide_empty=True,
            )
            bands.append(tb)
            meta.append((c0, width, max_block_span(tb.block, tail_chunk)))
        tail_bands, band_meta = tuple(bands), tuple(meta)

    pre, post = _scales(deg, norm)
    return HybridSchedule(
        strip=strip,
        pre=pre,
        post=post,
        tail_tiles=tail_tiles,
        num_nodes=v,
        s_cols=s,
        tail_chunk=tail_chunk,
        tail_window=tail_window,
        tail_bands=tail_bands,
        tail_band_meta=band_meta,
    )
