"""Pure-XLA sparse aggregation ops — the validation oracle / fallback path.

These play the role cuSPARSE plays in the reference: a trusted, simple
implementation used as (a) numerical ground truth for kernel validation
(`kernels/main.cu:19-48` `check_err`, `direct_kernel_interface.py:221-372`
`validate_against_cusparse`) and (b) the baseline arm of the speedup
benchmarks (`kernels/spmm_cusparse.cu`). They are also the CPU-runnable
path for tests, like the reference's torch.sparse fallback chain
(`maxk_spgemm_function.py:96-130`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from maxk_gnn.sparse.csr import CSRGraph
from maxk_gnn.sparse.meta import EdgeTiles


def spmm_segsum(g: CSRGraph, x: jax.Array) -> jax.Array:
    """Exact CSR SpMM: y = A @ x via gather + segment_sum.

    Sums in f32 whatever x.dtype (a bf16 sum over a hub's thousands of
    edges loses bits), then casts back. Fully differentiable
    (segment_sum transposes to a gather, gather to a scatter-add), so
    baselines built on it need no custom_vjp.
    """
    gathered = x.astype(jnp.float32)[g.indices] * g.values[:, None]
    return jax.ops.segment_sum(
        gathered, g.row_ids(), num_segments=g.num_nodes, indices_are_sorted=True
    ).astype(x.dtype)


def spmm_segsum_scan(
    g: CSRGraph, x: jax.Array, edge_chunk: int = 1 << 20
) -> jax.Array:
    """Memory-bounded exact oracle: `spmm_segsum` with the O(E·D) gather
    intermediate chunked to `edge_chunk` edges via lax.scan.

    Independent of the tile tables (it reads raw CSR), so it validates
    the tile/hybrid builders too — the full-graph-scale role of
    `check_err` / `validate_against_cusparse` (`kernels/main.cu:19-48`,
    `direct_kernel_interface.py:221-372`), where the one-shot oracle's
    (E, D) intermediate would not fit (reddit: 114M edges × 256 f32).
    Accumulates in f32 regardless of x.dtype.
    """
    e = g.nnz
    v = g.num_nodes
    rows = g.row_ids()
    nc = -(-e // edge_chunk)
    pad = nc * edge_chunk - e
    # padded slots scatter to segment id V → dropped by segment_sum
    rows = jnp.pad(rows, (0, pad), constant_values=v)
    cols = jnp.pad(g.indices, (0, pad))
    vals = jnp.pad(g.values, (0, pad))

    def step(acc, inp):
        r, c, w = inp
        gathered = x[c] * w[:, None].astype(x.dtype)
        part = jax.ops.segment_sum(
            gathered.astype(jnp.float32), r, num_segments=v,
            indices_are_sorted=True,
        )
        return acc + part, None

    acc = jnp.zeros((v, x.shape[1]), dtype=jnp.float32)
    acc, _ = jax.lax.scan(
        step,
        acc,
        (
            rows.reshape(nc, edge_chunk),
            cols.reshape(nc, edge_chunk),
            vals.reshape(nc, edge_chunk),
        ),
    )
    return acc.astype(x.dtype)


def spmm_tiles_xla(tiles: EdgeTiles, x: jax.Array) -> jax.Array:
    """CSR SpMM over the edge-tile schedule, in plain XLA.

    Per-tile (T,D) gather, edge-weighting, one-hot local-row contraction
    to (R,D), tile→row-block reduction in one shot — it doubles as the
    tile-table validator.
    O(NT·R·D) partials; use on small/medium graphs.
    """
    r = tiles.row_block
    nb = tiles.num_row_blocks
    gathered = x[tiles.cols]  # (NT, T, D)
    # edge weights ride in the (NT, T, R) one-hot (R ≪ D ⇒ less traffic
    # than weighting the gathered rows; same contraction algebraically)
    onehot = jax.nn.one_hot(tiles.localrow, r, dtype=x.dtype) * tiles.vals[
        ..., None
    ].astype(x.dtype)
    # cross-tile accumulation stays f32 even under bf16 compute
    partial = jnp.einsum(
        "ntr,ntd->nrd",
        onehot,
        gathered,
        precision="highest",
        preferred_element_type=jnp.float32,
    )
    out = jax.ops.segment_sum(
        partial, tiles.block, num_segments=nb, indices_are_sorted=True
    )
    return out.reshape(nb * r, -1)[: tiles.num_nodes].astype(x.dtype)


def spmm_tiles_scan(
    tiles: EdgeTiles,
    x: jax.Array,
    chunk: int = 256,
    accumulate: str = "matmul",
    acc0: jax.Array | None = None,
    window: int | None = None,
) -> jax.Array:
    """Memory-bounded tile SpMM: lax.scan over tile chunks.

    Same math as `spmm_tiles_xla` but the (·, T, D) gather intermediate is
    bounded to `chunk` tiles. This is the full-graph-scale tile path.

    Accumulation of per-chunk (chunk, R, D) partials into the (NB, R, D)
    output:
      - "matmul" (default): tiles within a chunk map to a ≤chunk-wide
        contiguous block window (tiles are block-sorted), so the
        tile→block reduction is a (chunk, chunk)·(chunk, R·D) matmul and
        the window is added back with one dynamic slice read-modify-write
        — entirely scatter-free.
      - "scatter": per-chunk `.at[b].add` (simpler; measurably slower).

    `acc0` (optional, (num_nodes, D) f32) seeds the accumulator — callers
    that add the scan result to an existing partial (the hybrid's strip
    output) pass it here instead of materializing result + partial + sum
    as three (V, D) f32 buffers; at ogbn-products scale each such buffer
    is 2.5 GB and the separate-add form OOMs.

    `window` (matmul mode): static width of the accumulator read-modify-
    write slice, in row-blocks. Correct iff every aligned chunk of tiles
    spans < window blocks — callers with concrete tile tables compute the
    exact max span at build time (`max_block_span`); None keeps the safe
    upper bound `chunk` (tiles are block-sorted and each block has ≥1
    tile, so a chunk of `chunk` tiles can never span more). Shrinking the
    window cuts the dominant per-step HBM traffic when R is large: the
    RMW moves window·R·D f32 twice per step.
    """
    r = tiles.row_block
    nb = tiles.num_row_blocks
    nt = tiles.num_tiles
    t = tiles.edge_tile
    d = x.shape[1]
    nc = -(-nt // chunk)
    pad = nc * chunk - nt
    # pad with inert tiles aliasing the last block (value-0 edges)
    blocks = jnp.pad(tiles.block, (0, pad), constant_values=nb - 1)
    cols = jnp.pad(tiles.cols, ((0, pad), (0, 0)))
    vals = jnp.pad(tiles.vals, ((0, pad), (0, 0)))
    lrow = jnp.pad(tiles.localrow, ((0, pad), (0, 0)))
    blocks = blocks.reshape(nc, chunk)
    # scan operands reshape to (nc, chunk·T) — NOT (nc, chunk, T): with a
    # small T as the minor dim, a compiler that pads the minor dim copies
    # the whole scanned table as a temp every call. (nc, chunk·T) is a
    # bitcast of the compact at-rest table; each step unpacks only its own
    # (chunk·T,) slice.
    cols = cols.reshape(nc, chunk * t)
    vals = vals.reshape(nc, chunk * t)
    lrow = lrow.reshape(nc, chunk * t)

    def partial_of(c, v, lr):
        c = c.reshape(chunk, t)
        v = v.reshape(chunk, t)
        lr = lr.reshape(chunk, t)
        # chunk-window matmuls may run in x.dtype, but the partial
        # handed to the cross-chunk accumulator is always f32 — bf16
        # accumulation over high-degree rows (reddit ~490) loses bits
        gathered = x[c]  # (chunk, T, D)
        if r == 1:
            # one tile == one row: the reduction is a weighted sum — no
            # (chunk, T, R) one-hot materialization at all
            return jnp.einsum(
                "ct,ctd->cd",
                v.astype(x.dtype),
                gathered,
                preferred_element_type=jnp.float32,
            )[:, None, :]
        # fold the edge weights into the (chunk, T, R) one-hot, NOT the
        # (chunk, T, D) gathered rows: with R ≪ D this removes the
        # full-width `weighted` intermediate entirely (one fewer
        # (chunk, T, D) HBM round-trip per scan step; the tail arm is
        # intermediate-traffic-bound above the raw gather floor)
        onehot = jax.nn.one_hot(lr, r, dtype=x.dtype) * v[..., None].astype(
            x.dtype
        )
        return jnp.einsum(
            "ctr,ctd->crd", onehot, gathered, preferred_element_type=jnp.float32
        )

    def seed(acc):
        if acc0 is None:
            return acc
        a0 = jnp.pad(
            acc0.astype(jnp.float32),
            ((0, acc.shape[0] * r - acc0.shape[0]), (0, 0)),
        )
        return a0.reshape(acc.shape)

    if accumulate == "scatter":

        def step(acc, inp):
            b, c, v, lr = inp
            return acc.at[b].add(partial_of(c, v, lr)), None

        acc = seed(jnp.zeros((nb, r, d), dtype=jnp.float32))
        acc, _ = jax.lax.scan(step, acc, (blocks, cols, vals, lrow))
        out = acc.reshape(nb * r, d)[: tiles.num_nodes]
        return out if acc0 is not None else out.astype(x.dtype)

    # w may exceed chunk for elided-empty tile tables (block-id gaps);
    # window=None assumes the dense-coverage invariant (span ≤ chunk)
    w = chunk if window is None else max(window, 1)

    def step(acc, inp):
        b, c, v, lr = inp
        partial = partial_of(c, v, lr)  # (chunk, R, D) f32
        b0 = b[0]
        rel = b - b0  # ascending, in [0, w)
        seg_oh = (
            rel[None, :]
            == jax.lax.broadcasted_iota(jnp.int32, (w, chunk), 0)
        ).astype(jnp.float32)
        win = (seg_oh @ partial.reshape(chunk, r * d)).reshape(w, r, d)
        cur = jax.lax.dynamic_slice(acc, (b0, 0, 0), (w, r, d))
        return jax.lax.dynamic_update_slice(acc, cur + win, (b0, 0, 0)), None

    # pad the accumulator so the window never clamps at the end;
    # accumulator is f32 regardless of compute dtype
    acc = seed(jnp.zeros((nb + w, r, d), dtype=jnp.float32))
    acc, _ = jax.lax.scan(step, acc, (blocks, cols, vals, lrow))
    out = acc.reshape((nb + w) * r, d)[: tiles.num_nodes]
    # seeded calls are mid-accumulation: stay f32 (the caller casts once)
    return out if acc0 is not None else out.astype(x.dtype)


def spmm_dense(g: CSRGraph, x: jax.Array) -> jax.Array:
    """Densified A @ x — brute-force oracle for tiny test graphs only."""
    v = g.num_nodes
    a = jnp.zeros((v, v), dtype=x.dtype)
    a = a.at[g.row_ids(), g.indices].add(g.values.astype(x.dtype))
    return jnp.dot(a, x, precision="highest")
