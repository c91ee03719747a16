"""Microbenchmarks for the primitives underlying the SpMM, and the timing
helper every benchmark in this package uses.

Run on the card (`python -m maxk_gnn.bench.micro`):

  A. XLA row gather:       x[(E,)] of a (V, D) table
  B. lax.top_k vs a full sort (the `maxk_kernel.cu` role)
  C. XLA segment_sum scatter rate (the backward scatter role)
  D. bf16 matrix product rate (the strip matmuls' ceiling)

Timing: inputs are generated on the device with `jax.random`; each call
ends in `jax.block_until_ready`, after `warmup` calls that compile.
"""

from __future__ import annotations

import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, iters=8, warmup=2):
    """Median wall time of one call, each ended by `block_until_ready`."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples))


def card_name_and_power() -> str:
    """`name, power.limit` of the first GPU as nvidia-smi reports them,
    or "" where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def device_info() -> dict:
    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "card": card_name_and_power(),
    }


def _rand(shape, dtype=jnp.float32, seed=0):
    return jax.jit(
        lambda: jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32).astype(
            dtype
        )
    )()


def _randint(shape, hi, seed=1):
    return jax.jit(
        lambda: jax.random.randint(jax.random.PRNGKey(seed), shape, 0, hi, jnp.int32)
    )()


def bench_xla_gather(v=262144, d=256, e=4_000_000, dtype=jnp.float32):
    x = _rand((v, d), dtype)
    idx = _randint((e,), v)
    # .max not .sum: XLA can rewrite sum∘gather as histogram @ table
    f = jax.jit(lambda x, i: jnp.take(x, i, axis=0).max(0))
    t = timeit(f, x, idx)
    bytes_moved = e * d * x.dtype.itemsize
    print(
        f"A. XLA gather  (V={v}, D={d}, E={e}, {x.dtype}): {t*1e3:.3f} ms  "
        f"{e/t/1e9:.3f} Grow/s  {bytes_moved/t/1e9:.1f} GB/s",
        flush=True,
    )
    return e / t


def bench_topk(v=262144, d=256, k=32):
    x = _rand((v, d))
    f = jax.jit(lambda x: jax.lax.top_k(x, k)[0].max(0))
    t = timeit(f, x)
    print(
        f"B. lax.top_k (V={v}, D={d}, k={k}): {t*1e3:.3f} ms  "
        f"{v/t/1e6:.1f} Mrow/s",
        flush=True,
    )
    f2 = jax.jit(lambda x: jax.lax.sort(x, dimension=-1).max(0))
    t2 = timeit(f2, x)
    print(f"   full sort baseline: {t2*1e3:.3f} ms", flush=True)
    return v / t


def bench_segment_sum(v=262144, d=256, e=4_000_000):
    data = _rand((e, d))
    seg = jax.jit(lambda: jnp.sort(_randint((e,), v)))()
    f = jax.jit(
        lambda d_, s: jax.ops.segment_sum(
            d_, s, num_segments=v, indices_are_sorted=True
        ).max(0)
    )
    t = timeit(f, data, seg)
    print(
        f"C. segment_sum (E={e}, D={d}): {t*1e3:.3f} ms  {e/t/1e9:.3f} Grow/s",
        flush=True,
    )
    return e / t


def bench_matmul(m=16384, n=16384, kdim=16384, dtype=jnp.bfloat16):
    a = _rand((m, kdim), dtype)
    b = _rand((kdim, n), dtype, seed=3)
    f = jax.jit(lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32))
    t = timeit(f, a, b)
    rate = 2 * m * n * kdim / t
    print(f"D. {dtype.__name__} matmul {m}x{kdim}x{n}: {t*1e3:.3f} ms  "
          f"{rate/1e12:.1f} TFLOP/s", flush=True)
    return rate


def main():
    print(f"device: {device_info()}", flush=True)
    bench_xla_gather()
    bench_xla_gather(dtype=jnp.bfloat16)
    bench_topk()
    bench_segment_sum()
    bench_matmul()


if __name__ == "__main__":
    main()
