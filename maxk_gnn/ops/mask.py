"""MaxK activation `x ⊙ take(x)` — a Triton kernel on CUDA GPUs, the plain
`lax` form everywhere else (role of `kernels/maxk_kernel.cu`).

The reference runs a warp-per-row 8-iteration binary search on a uint8
threshold (`maxk_kernel.cu:37-88`) — lossy and broken for k<19
(`test_bug.py`). The kernel here is exact in f32: each program owns a
block of ROWS rows held in registers and

  1. maps f32 to order-preserving uint32 keys (flip the sign bit of
     positives, all bits of negatives);
  2. finds the k-th largest key of every row with a 32-step radix
     search (one (ROWS, D) compare + row sum per bit);
  3. keeps everything above it, and of the keys equal to it the first
     (k − #greater) in column order — the set `lax.top_k` selects.

One read of x, one write of the output and of the int8 mask. On the card
it is several times faster than `lax.top_k`'s sort (PERF.md), which is
why it exists; `sparse.cbsr.maxk_take` is the plain reference it is
tested against, in interpret mode on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from maxk_gnn.sparse.cbsr import maxk_take

ROWS = 16  # rows per program: a (16, 256) f32 tile fits the registers
NUM_WARPS = 4


def _mask_kernel(k, v, x_ref, y_ref, t_ref):
    r0 = pl.program_id(0) * ROWS
    m = ((r0 + jnp.arange(ROWS)) < v)[:, None]
    x = plt.load(x_ref.at[pl.ds(r0, ROWS), :], mask=m, other=0.0)
    x = x.astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    keys = jnp.where((bits >> 31) == 1, ~bits, bits | jnp.uint32(0x80000000))
    thr = jnp.zeros((ROWS,), jnp.uint32)
    for b in range(31, -1, -1):
        cand = thr | jnp.uint32(1 << b)
        cnt = jnp.sum((keys >= cand[:, None]).astype(jnp.int32), axis=1)
        thr = jnp.where(cnt >= k, cand, thr)
    gt = keys > thr[:, None]
    eq = (keys == thr[:, None]).astype(jnp.int32)
    need = k - jnp.sum(gt.astype(jnp.int32), axis=1)
    before = jnp.cumsum(eq, axis=1) - eq  # ties to the left of each column
    take = gt | ((eq == 1) & (before < need[:, None]))
    plt.store(y_ref.at[pl.ds(r0, ROWS), :],
              jnp.where(take, x, 0.0).astype(y_ref.dtype), mask=m)
    plt.store(t_ref.at[pl.ds(r0, ROWS), :], take.astype(jnp.int8), mask=m)


@functools.partial(jax.jit, static_argnums=(1, 2))
def mask_triton(x: jax.Array, k: int, interpret: bool = False):
    """(x ⊙ take, take as int8) for a (V, D) array, D a power of two."""
    v, d = x.shape
    return pl.pallas_call(
        functools.partial(_mask_kernel, k, v),
        grid=(pl.cdiv(v, ROWS),),
        out_shape=(jax.ShapeDtypeStruct((v, d), x.dtype),
                   jax.ShapeDtypeStruct((v, d), jnp.int8)),
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        backend="triton",
        name="maxk_mask",
    )(x)


def mask_plain(x: jax.Array, k: int):
    take = maxk_take(x, k)
    return jnp.where(take, x, jnp.zeros_like(x)), take.astype(jnp.int8)


def _mask_and_take(x, k):
    if x.ndim != 2 or x.shape[1] & (x.shape[1] - 1):
        return mask_plain(x, k)
    # chosen per platform at lowering: the Triton branch is never
    # lowered for the CPU
    return jax.lax.platform_dependent(
        x,
        cuda=functools.partial(mask_triton, k=k),
        default=functools.partial(mask_plain, k=k),
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def maxk_activation(x: jax.Array, k: int) -> jax.Array:
    """MaxK activation (`MaxK(Function)`, `maxk_models_integrated.py:28-43`):
    the top k of each row kept, the rest zero; the VJP masks the
    cotangent the same way."""
    return _mask_and_take(x, k)[0]


def _fwd(x, k):
    return _mask_and_take(x, k)


def _bwd(k, take, g):
    return (g * take.astype(g.dtype),)


maxk_activation.defvjp(_fwd, _bwd)
