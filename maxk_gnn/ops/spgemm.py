"""Core aggregation ops with custom VJPs.

This is the re-design of the reference's autograd stack
(`maxk_spgemm_function.py` v1 … `spgemmfunction_v4`): one `jax.custom_vjp`
pair instead of six torch.autograd.Function variants.

Math (identical to the reference kernels):

  forward  (ref `kernels/spmm_maxk.cu`):  Y = A @ densify(CBSR)
  backward (ref `kernels/spmm_maxk_backward.cu`):
           dVals[v, l] = (A^T @ dY)[v, sel[v, l]]

The reference fuses the CBSR expansion into the per-edge inner loop
(shared-memory scatter) and the sampling into a per-edge atomicAdd. Here
both are hoisted out of the E-sized loop into O(V·k) row operations
(`cbsr_densify` / `cbsr_sample`), leaving a dense-feature SpMM. Normalization is
pre-folded into edge values (`csr.with_norm`), which makes the VJP exactly
`A^T` — avoiding the in/out-degree bookkeeping bugs of the reference
(save/unpack mismatch, `maxk_spgemm_function.py:66` vs `:144`).

The saved residuals are O(V·k): no E-sized or (V,D)-sized tensor is kept
alive between forward and backward.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from maxk_gnn.ops.dispatch import KernelMode, resolve_mode
from maxk_gnn.ops.spmm_xla import spmm_segsum, spmm_tiles_xla
from maxk_gnn.sparse.cbsr import CBSR, cbsr_densify, cbsr_sample
from maxk_gnn.sparse.graph import Graph


def _zero_cotangent(tree):
    """Symbolic-zero cotangents for a pytree with integer leaves (graphs)."""

    def z(x):
        if jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.zeros_like(x)
        return np.zeros(x.shape, jax.dtypes.float0)

    return jax.tree.map(z, tree)


def _sharded_spmm(graph, x: jax.Array, transpose: bool) -> jax.Array:
    """Row-partitioned SpMM inside shard_map (see `parallel.shard`).

    forward: all_gather x rows → local row-block aggregation → local rows
    backward: local A_i^T partials → psum_scatter (reduce + re-partition)

    Uses the production tile kernel when the shard carries tile
    schedules, else the segment-sum path. Sharded hybrid graphs route
    both directions through `spmm_hybrid_sharded` (full-feature input:
    forward gathers x, backward gathers the cotangent — the same bytes
    the psum_scatter of (Vp, D) partials would move).
    """
    from maxk_gnn.ops.spmm_xla import spmm_tiles_scan

    if graph.hybrid is not None:
        from maxk_gnn.ops.spmm_hybrid import spmm_hybrid_sharded

        xg = jax.lax.all_gather(x, graph.axis, axis=0, tiled=True)
        return spmm_hybrid_sharded(graph.hybrid, xg, transpose=transpose)
    if transpose:
        if graph.bwd_tiles is not None:
            z = spmm_tiles_scan(graph.local_bwd_tiles(), x)
        else:
            z = spmm_segsum(graph.local_bwd(), x)  # (Vp, D) partials
        return jax.lax.psum_scatter(
            z, graph.axis, scatter_dimension=0, tiled=True
        )
    xg = jax.lax.all_gather(x, graph.axis, axis=0, tiled=True)  # (Vp, D)
    if graph.fwd_tiles is not None:
        return spmm_tiles_scan(graph.local_fwd_tiles(), xg)
    return spmm_segsum(graph.local_fwd(), xg)


def _spmm_impl(graph: Graph, x: jax.Array, mode: KernelMode, transpose: bool):
    """Dispatch one SpMM (forward A or backward A^T) to an implementation."""
    from maxk_gnn.parallel.shard import ShardedGraph

    if isinstance(graph, ShardedGraph):
        return _sharded_spmm(graph, x, transpose)
    csr = graph.csc if transpose else graph.csr
    tiles = graph.tiles_t if transpose else graph.tiles
    mode = resolve_mode(mode, tiles is not None, graph.hybrid is not None)
    if mode in (KernelMode.HYBRID, KernelMode.HYBRID_INT8):
        if graph.hybrid is None:
            raise ValueError(
                f"kernel_mode='{mode.value}' needs a graph built with "
                "build_graph(hybrid=True) (undirected graphs only)"
            )
        from maxk_gnn.ops.spmm_hybrid import spmm_hybrid

        return spmm_hybrid(
            graph.hybrid, x, transpose=transpose,
            feat_int8=(mode == KernelMode.HYBRID_INT8),
        )
    if mode == KernelMode.TILES_XLA:
        return spmm_tiles_xla(tiles, x)
    if mode == KernelMode.TILES_SCAN:
        from maxk_gnn.ops.spmm_xla import spmm_tiles_scan

        return spmm_tiles_scan(tiles, x)
    return spmm_segsum(csr, x)


# ---------------------------------------------------------------------------
# spmm: dense-feature aggregation (baseline/ReLU models, cuSPARSE role)
# ---------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _spmm(mode: str, graph: Graph, x: jax.Array) -> jax.Array:
    return _spmm_impl(graph, x, KernelMode(mode), transpose=False)


def _spmm_fwd(mode, graph, x):
    return _spmm(mode, graph, x), graph


def _spmm_bwd(mode, graph, g):
    dx = _spmm_impl(graph, g, KernelMode(mode), transpose=True)
    return _zero_cotangent(graph), dx


_spmm.defvjp(_spmm_fwd, _spmm_bwd)


def spmm(graph: Graph, x: jax.Array, mode: str = "auto") -> jax.Array:
    """y = A @ x (edge weights already carry any normalization)."""
    return _spmm(KernelMode(mode).value, graph, x)


# ---------------------------------------------------------------------------
# maxk_spgemm: CBSR-feature aggregation with sampled backward
# ---------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _maxk_spgemm(dim, mode, compute_dtype, graph, vals, sel):
    from maxk_gnn.parallel.shard import ShardedGraph

    if isinstance(graph, ShardedGraph):
        # gather COMPRESSED features between devices (V·k ≪ V·dim), then densify
        # and aggregate the local row block (x is already full — no second
        # gather inside the spmm). compute_dtype is applied to the VALUES
        # before the gather: densify is placement-only, so the numerics
        # are identical and the gathered bytes halve
        out_dtype = vals.dtype
        if compute_dtype is not None:
            vals = vals.astype(compute_dtype)
        vals = jax.lax.all_gather(vals, graph.axis, axis=0, tiled=True)
        sel = jax.lax.all_gather(sel, graph.axis, axis=0, tiled=True)
        if graph.hybrid is not None:
            from maxk_gnn.ops.spmm_hybrid import spmm_hybrid_sharded

            # fold the pre-scale into the (Vp, k) values before densify:
            # identical math (non-selected entries are 0 either way),
            # one fewer (Vp, D) transient per device
            h = graph.hybrid
            vals = vals * h.local_pre()[:, None].astype(vals.dtype)
            x = cbsr_densify(CBSR(values=vals, selector=sel), dim)
            return spmm_hybrid_sharded(h, x, pre_applied=True).astype(
                out_dtype
            )
        x = cbsr_densify(CBSR(values=vals, selector=sel), dim)
        if graph.fwd_tiles is not None:
            from maxk_gnn.ops.spmm_xla import spmm_tiles_scan

            return spmm_tiles_scan(graph.local_fwd_tiles(), x).astype(out_dtype)
        return spmm_segsum(graph.local_fwd(), x).astype(out_dtype)
    out_dtype = vals.dtype
    if compute_dtype is not None:
        # densify is placement-only: casting the values first gives the
        # same (V, dim) array as casting after
        vals = vals.astype(compute_dtype)
    resolved = resolve_mode(
        KernelMode(mode), graph.tiles is not None, graph.hybrid is not None
    )
    if (
        resolved in (KernelMode.HYBRID, KernelMode.HYBRID_INT8)
        and graph.hybrid is not None
    ):
        from maxk_gnn.ops.spmm_hybrid import spmm_hybrid

        # fold the pre-scale into the (V, k) values (see sharded branch)
        h = graph.hybrid
        vals = vals * h.pre[:, None].astype(vals.dtype)
        x = cbsr_densify(CBSR(values=vals, selector=sel), dim)
        return spmm_hybrid(
            h, x, pre_applied=True,
            feat_int8=(resolved == KernelMode.HYBRID_INT8),
        ).astype(out_dtype)
    x = cbsr_densify(CBSR(values=vals, selector=sel), dim)
    y = _spmm_impl(graph, x, KernelMode(mode), transpose=False)
    return y.astype(out_dtype)


def _maxk_spgemm_fwd(dim, mode, compute_dtype, graph, vals, sel):
    y = _maxk_spgemm(dim, mode, compute_dtype, graph, vals, sel)
    # zero-size residual carries the primal values dtype (residual trees
    # must hold arrays, not dtypes)
    return y, (graph, sel, jnp.zeros((0,), vals.dtype))


def _maxk_spgemm_bwd(dim, mode, compute_dtype, res, g):
    graph, sel, vals_proto = res
    if compute_dtype is not None:
        g = g.astype(compute_dtype)
    z = _spmm_impl(graph, g, KernelMode(mode), transpose=True)
    dvals = cbsr_sample(z, sel).astype(vals_proto.dtype)
    return (
        _zero_cotangent(graph),
        dvals,
        np.zeros(sel.shape, jax.dtypes.float0),
    )


_maxk_spgemm.defvjp(_maxk_spgemm_fwd, _maxk_spgemm_bwd)


def maxk_spgemm(
    graph: Graph,
    cbsr: CBSR,
    dim: int,
    mode: str = "auto",
    compute_dtype=None,
) -> jax.Array:
    """Y = A @ densify(CBSR), gradient sampled at the CBSR coordinates.

    `dim` is the dense feature width (the reference hard-codes 256,
    `kernels/maxk_kernel.cu:12`; here it is a static parameter).
    `compute_dtype=jnp.bfloat16` halves SpMM gather traffic; accumulation
    stays f32 inside the kernels.
    """
    return _maxk_spgemm(
        dim, KernelMode(mode).value, compute_dtype, graph, cbsr.values, cbsr.selector
    )
