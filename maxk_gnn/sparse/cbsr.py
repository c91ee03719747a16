"""CBSR — Compressed Balanced Sparse Row feature format, and the MaxK
nonlinearity that produces it.

The reference stores the output of the MaxK nonlinearity as a `(V, k)`
value matrix plus a `(V, k)` uint8 column-selector matrix
(`kernels/maxk_kernel.cu:23-96` builds it on device; the uint8 index is a
known defect — lossy float→uint8 quantization and an illegal-memory-access
bug for k<19, `test_bug.py`). Here values keep their float dtype and the
selector is int32.

Every primitive here is plain `jax.numpy`/`lax`:

  mask:    x ⊙ take(x), exactly k survivors per row — the reference for
           the Triton kernel in `ops/mask.py`, which models use
  densify: X[v, sel[v,l]] = vals[v,l]      (row scatter)
  sample:  out[v, l] = Z[v, sel[v,l]]      (backward sampling, a gather)

Densify and sample stay plain: on the card XLA's scatter and gather beat
hand-written Triton versions of both (PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from maxk_gnn.pytree import pytree_dataclass


@pytree_dataclass
class CBSR:
    """values: (V, k) float; selector: (V, k) int32 in [0, D)."""

    values: jax.Array
    selector: jax.Array

    @property
    def k(self) -> int:
        return self.values.shape[-1]

    @property
    def num_rows(self) -> int:
        return self.values.shape[0]


def maxk_cbsr(x: jax.Array, k: int) -> CBSR:
    """Top-k per row → CBSR (role of `kernels/maxk_kernel.cu` `topk`).

    `lax.top_k` is differentiable (its VJP scatters the cotangent back to
    the selected positions), so gradient flows to `x` automatically. Ties
    go to the lower column, the same rule as `maxk_take`.
    """
    vals, sel = jax.lax.top_k(x, k)
    return CBSR(values=vals, selector=sel.astype(jnp.int32))


def maxk_take(x: jax.Array, k: int) -> jax.Array:
    """Boolean top-k mask with exactly k True per row.

    Everything above the k-th largest value is kept; of the values equal
    to it, the first ones in column order fill the remaining slots — the
    set `lax.top_k` selects.
    """
    x = jax.lax.stop_gradient(x)
    thr = jax.lax.top_k(x, k)[0][..., -1:]
    gt = x > thr
    eq = x == thr
    need = k - jnp.sum(gt, axis=-1, keepdims=True, dtype=jnp.int32)
    eq_i = eq.astype(jnp.int32)
    before = jnp.cumsum(eq_i, axis=-1) - eq_i  # exclusive count of ties
    return gt | (eq & (before < need))


def maxk_mask(x: jax.Array, k: int) -> jax.Array:
    """MaxK activation: keep the top k of each row, zero the rest.

    Role of `MaxK(Function)` (`maxk_models_integrated.py:28-43`): the VJP
    JAX derives multiplies the cotangent by the same mask. Equal to
    `cbsr_densify(maxk_cbsr(x, k), D)`.
    """
    return jnp.where(maxk_take(x, k), x, jnp.zeros_like(x))


def cbsr_densify(cbsr: CBSR, dim: int) -> jax.Array:
    """CBSR → dense (V, dim): one row scatter of the (V, k) values.

    Selectors within a row are distinct, so the scatter is a plain set
    and its VJP is `cbsr_sample`. Equivalent of the densified copy the
    reference builds for its cuSPARSE baseline (`kernels/main.cu:135-146`).

    The scatter runs in f32 whatever the values' dtype, and the result is
    cast back. On the GPU a 16-bit scatter output let XLA lay the (V, dim)
    array out column-major, so the SpMM's row gather that reads it next
    went strided: 501 ms against 18.8 ms for reddit at k=32 (PERF.md).
    """
    v = cbsr.num_rows
    rows = jnp.broadcast_to(
        jnp.arange(v, dtype=jnp.int32)[:, None], cbsr.selector.shape
    )
    return (
        jnp.zeros((v, dim), jnp.float32)
        .at[rows, cbsr.selector]
        .set(cbsr.values.astype(jnp.float32), unique_indices=True)
        .astype(cbsr.values.dtype)
    )


def cbsr_sample(z: jax.Array, selector: jax.Array) -> jax.Array:
    """Sample dense rows at selector coordinates: out[v,l] = z[v, sel[v,l]].

    Backward-pass primitive: the reference's SSpMM
    (`kernels/spmm_maxk_backward.cu:15-115`) fuses `A^T @ dY` with this
    sampling per *edge*; here the dense `A^T @ dY` runs first and is
    sampled per *row* (V·k reads, independent of E).
    """
    return jnp.take_along_axis(z, selector, axis=-1)
