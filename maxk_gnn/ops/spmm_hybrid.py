"""Symmetric-strip hybrid SpMM — dense-matmul aggregation over a
`HybridSchedule` (see `maxk_gnn.sparse.hybrid` for the decomposition).

    Y = post ⊙ ( W @ xh  +  1_{rows<S}(W^T @ xs − W[:S] @ xh)
                 + tail_scan(xs) ),   xs = pre ⊙ x,  xh = xs[:S]

Role of the reference's forward kernel (`kernels/spmm_maxk.cu:17-106`)
AND its backward (`spmm_maxk_backward.cu:15-115`): the operator core S is
value-symmetric, so A^T = D_pre S D_post is the same computation with the
diagonal scales swapped — `transpose=True` is free, and under jax
autodiff the whole thing differentiates natively (every piece is dense
XLA or the differentiable tile-scan).

Everything is static-shaped; the three matmuls run in the strip dtype
(bf16 by default) with f32 accumulation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from maxk_gnn.ops.spmm_xla import spmm_tiles_scan
from maxk_gnn.sparse.hybrid import HybridSchedule


def _strip_operand(strip: jax.Array):
    """(matmul-ready strip, feature compute dtype). Integer strips
    convert to bf16 at read time (fused into the matmul by XLA); float
    strips pass through and set the feature dtype as before."""
    if jnp.issubdtype(strip.dtype, jnp.integer):
        return strip.astype(jnp.bfloat16), jnp.bfloat16
    return strip, strip.dtype


def _quant_cols(x: jax.Array, bound: int = 127):
    """Per-column symmetric int8 quantization: x ≈ x_q · scale.

    Returns (x_q int8, scale (1, D) f32). The column (= feature-dim)
    axis is the non-contracted axis of both strip matmuls, so the
    de-scale is a single (1, D) broadcast multiply on the outputs.
    Zero columns get scale tiny (x_q = 0 exactly)."""
    xf = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(xf), axis=0, keepdims=True)
    scale = jnp.maximum(absmax, jnp.finfo(jnp.float32).tiny) / bound
    xq = jnp.clip(jnp.round(xf / scale), -bound, bound).astype(jnp.int8)
    return xq, scale


def spmm_hybrid(
    h: HybridSchedule,
    x: jax.Array,
    transpose: bool = False,
    pre_applied: bool = False,
    feat_int8: bool = False,
) -> jax.Array:
    """y = A @ x (or A^T @ x) via the symmetric-strip decomposition.

    `pre_applied`: the caller already folded the pre-scale into x — the
    CBSR path scales the (V, k) values before densify (identical math,
    and one fewer (V, D) transient: 1.25 GB at ogbn-products scale).

    `feat_int8` (LOSSY, off by default): per-column int8-quantize the
    features for the two strip matmuls so they run int8×int8.
    Requires an integer strip (`strip_dtype=int8`, exact 0/1 values) so
    the int32 accumulation is exact given the quantized operand — the
    ONLY error is the feature quantization (~0.5% mean relative at
    reddit shapes). The tail gather arm still consumes the
    unquantized features, so tail rows are unaffected."""
    v = h.num_nodes
    s = h.s_cols
    pre, post = (h.post, h.pre) if transpose else (h.pre, h.post)
    xs = x if pre_applied else x * pre[:, None].astype(x.dtype)

    # int8 strip (exact on integer-valued graphs): features stay bf16 and
    # the strip converts at matmul-read time — XLA fuses the int8→bf16
    # convert into the contraction, so the strip's memory traffic is HALF
    # the bf16 form's, buying a 2× wider strip at the same budget.
    # (_strip_operand is called only on the branch that uses its result:
    # an EAGER call on an int8 strip materializes the full bf16 copy —
    # 11.5 GB at s=24576)
    cdt = (
        jnp.bfloat16
        if jnp.issubdtype(h.strip.dtype, jnp.integer) else h.strip.dtype
    )
    xc = xs.astype(cdt)
    vp = h.padded_nodes
    if vp != v:
        xc = jnp.pad(xc, ((0, vp - v), (0, 0)))

    if feat_int8:
        if not jnp.issubdtype(h.strip.dtype, jnp.integer):
            raise ValueError(
                "feat_int8 requires an integer strip (strip_dtype=int8): "
                "a float strip would make the int32 accumulation lossy "
                "on BOTH operands"
            )
        xq, qscale = _quant_cols(xc)
        yh = jnp.einsum(
            "vs,vd->sd", h.strip, xq, preferred_element_type=jnp.int32
        ).astype(jnp.float32) * qscale
        yt = jnp.dot(
            h.strip[s:], xq[:s], preferred_element_type=jnp.int32
        ).astype(jnp.float32) * qscale
    else:
        w, _ = _strip_operand(h.strip)
        xh = xc[:s]
        # rows<S: symmetry covers ALL their columns via W^T @ xs, and the
        # corner term W[:S] @ xh cancels exactly against the hub-columns
        # arm there — so compute the two disjoint row ranges directly
        # instead of the add-then-subtract form (saves the (S, S, D)
        # corner matmul and S wasted rows of W @ xh)
        yh = jnp.einsum(
            "vs,vd->sd", w, xc, preferred_element_type=jnp.float32
        )
        # rows≥S: hub-columns arm only
        yt = jnp.dot(w[s:], xh, preferred_element_type=jnp.float32)
    y = jnp.concatenate([yh, yt])

    # tail arm: rows≥S × cols≥S leftover edges on the gather path, in the
    # input dtype (measured at reddit scale: bf16 gather is NOT faster —
    # the row gather is issue-rate-bound there, and the extra cast loses).
    # The strip output seeds the scan accumulator (acc0) so only one
    # (V, D) f32 buffer lives — at products scale the separate-add form
    # is 2×2.5 GB and OOMs next to the 5.6 GB strip.
    if h.tail_band_meta:
        # column-banded tail: each band gathers from a narrow x slice
        # (cols are rebased at build time); bands chain through acc0
        y = y[:v]
        for tiles_b, (c0, width, win) in zip(h.tail_bands, h.tail_band_meta):
            xb = jax.lax.slice_in_dim(xs, c0, c0 + width)
            y = spmm_tiles_scan(
                tiles_b, xb, chunk=h.tail_chunk, acc0=y, window=win or None
            )
    else:
        y = spmm_tiles_scan(
            h.tail_tiles, xs, chunk=h.tail_chunk, acc0=y[:v],
            window=h.tail_window or None,
        )
    return (y * post[:, None]).astype(x.dtype)


def spmm_hybrid_sharded(
    h, x: jax.Array, transpose: bool = False, pre_applied: bool = False
) -> jax.Array:
    """Row-partitioned hybrid SpMM inside shard_map.

    `h` is a `parallel.shard.ShardedHybrid`; `x` is the FULL (Vp, D)
    feature matrix (the caller has already all_gathered — compressed
    CBSR in the MaxK path, dense rows otherwise). Returns this device's
    (Vs, D) output rows.

    Derivation (matches the single-chip operator): for global row r,
      r <  S:  y[r] = (Wᵀ @ xs)[r]     — symmetry covers ALL columns
      r >= S:  y[r] = (W_i @ xh)[r]  + tail_i(xs)[r]
    so the only cross-device term is the (S, D) psum of Wᵀ@xs partials —
    S·D·4 bytes between devices, independent of V and E. A^T swaps the diagonal
    scales, exactly as on one chip (the tail submatrix of a symmetric S
    is itself symmetric).
    """
    s = h.s_cols
    vs = h.shard_nodes
    pre, post = (h.local_post(), h.local_pre()) if transpose else (
        h.local_pre(), h.local_post()
    )
    xs = x if pre_applied else x * pre[:, None].astype(x.dtype)
    w, cdt = _strip_operand(h.local_strip())  # (Vs, S)
    xc = xs.astype(cdt)
    xh = xc[:s]

    idx = jax.lax.axis_index(h.axis)
    r0 = idx * vs
    # hub-columns arm — final value for local rows ≥ S
    y = jnp.dot(w, xh, preferred_element_type=jnp.float32)
    # hub-rows arm: Wᵀ @ xs reduced over the row shards
    x_loc = jax.lax.dynamic_slice_in_dim(xc, r0, vs)
    hub = jax.lax.psum(
        jnp.einsum("vs,vd->sd", w, x_loc, preferred_element_type=jnp.float32),
        h.axis,
    )
    # local slice of the hub rows (zero-padded; masked to global row < S)
    hp_rows = max(-(-s // vs) * vs, vs)
    hub = jnp.pad(hub, ((0, hp_rows - s), (0, 0)))
    start = jnp.minimum(r0, hp_rows - vs)
    hslice = jax.lax.dynamic_slice(hub, (start, 0), (vs, hub.shape[1]))
    grow = r0 + jnp.arange(vs, dtype=jnp.int32)
    y = jnp.where((grow < s)[:, None], hslice, y)

    y = spmm_tiles_scan(
        h.local_tail_tiles(), xs, chunk=h.tail_chunk, acc0=y,
        window=h.tail_window or None,
    )
    post_loc = jax.lax.dynamic_slice_in_dim(post, r0, vs)
    return (y * post_loc[:, None]).astype(x.dtype)
