#!/usr/bin/env python
"""Kernel benchmark — the `kernels/main.cu` protocol.

Protocol (mirrors the reference): reddit-scale graph, dim_origin=256,
random CBSR features at k (seeded, `main.cu:75`), warmup + timed runs
per kernel (`kernels/spmm_base.h:34-63`), dense baseline timed alongside
(the cuSPARSE role, `kernels/spmm_cusparse.cu`).

Inputs are generated on the device (`maxk_gnn.data.device_gen`). Each
timed call ends in `block_until_ready` (`maxk_gnn.bench.micro.timeit`).
The kernel is the one the dispatch rule (`ops/dispatch.choose_mode`)
picks for the device, unless `--mode` names one. The default is the
published scale on every device; `--scale` cuts it (for a CPU run).

Headline metric: forward effective nnz/s = E / t_fwd at k=32.
vs_baseline compares against the A100 spmm_maxk estimate derived in
BASELINE.md: cuSPARSE CSR-SpMM f32 D=256 on A100 ≈ 1KB/edge at ~1.6 TB/s
≈ 1.55 Gnnz/s, × the published 2.55× speedup @k=32 (`README.md:136`)
≈ 4.0 Gnnz/s.

Prints ONE JSON line to stdout, naming the device kind and the card's
power limit; everything else goes to stderr.
"""

import argparse
import json
import sys

import numpy as np

A100_MAXK_K32_NNZ_S = 4.0e9  # derived estimate, see module docstring


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--graph", default="reddit")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--k", type=int, default=32)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--mode", default="auto")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from maxk_gnn.bench.micro import device_info, timeit
    from maxk_gnn.data.datasets import DATASETS
    from maxk_gnn.data.device_gen import rmat_graph_device
    from maxk_gnn.ops.dispatch import choose_mode
    from maxk_gnn.ops.spgemm import maxk_spgemm, spmm
    from maxk_gnn.runtime import enable_compile_cache
    from maxk_gnn.sparse.cbsr import CBSR, cbsr_densify
    from maxk_gnn.sparse.csr import csr_transpose_device, with_norm
    from maxk_gnn.sparse.graph import Graph
    from maxk_gnn.sparse.meta import build_edge_tiles_device

    enable_compile_cache()
    device = device_info()
    scale = args.scale
    spec = DATASETS[args.graph]
    v = max(int(spec.num_nodes * scale), 64)
    e_target = max(int(spec.num_edges * scale), 256)
    g = rmat_graph_device(v, e_target, seed=123)
    e_real = int(np.asarray(jnp.sum(g.values != 0)))
    log(f"graph {args.graph} x{scale}: V={v} E={g.nnz} (live {e_real})")

    # the one dispatch rule, at the dtypes the benchmark runs
    mode = choose_mode(args.mode, g, args.dim, jnp.bfloat16).value
    log(f"device={device} mode={mode} scale={scale}")

    hybrid = None
    if mode == "hybrid":
        from maxk_gnn.sparse.hybrid import (
            auto_strip_cols,
            auto_strip_dtype,
            auto_tail_band_cols,
            build_hybrid_device,
            degree_perm_device,
            permute_csr_device,
        )

        g = permute_csr_device(g, degree_perm_device(g))
        # int8 where exact: the same memory holds twice the strip width
        strip_dtype = auto_strip_dtype(g)
        s_cols = auto_strip_cols(
            v, e_live=e_real, dim=args.dim, io_itemsize=2,
            strip_itemsize=jnp.dtype(strip_dtype).itemsize,
        )
        hybrid = build_hybrid_device(
            g, s_cols=s_cols, norm="right",
            tail_band_cols=auto_tail_band_cols(v, s_cols),
            strip_dtype=strip_dtype,
        )
        log(f"hybrid strip {hybrid.strip.shape} {hybrid.strip.dtype}")
    g = with_norm(g, "right")
    # right-norm breaks value symmetry even on symmetric structure, so the
    # backward (A^T) arm gets a real device transpose + its own schedule
    # (the hybrid needs neither: its symmetric core self-transposes)
    gt = g if mode == "hybrid" else csr_transpose_device(g)
    # the baseline arm is the plain gather + segment-sum SpMM (the
    # library role of main.cu's cuSPARSE comparison)
    base_mode = "segsum"
    tiles = tiles_t = None
    if mode in ("tiles_xla", "tiles_scan"):
        tiles = build_edge_tiles_device(g)
        tiles_t = build_edge_tiles_device(gt)
    graph = Graph(csr=g, csc=gt, tiles=tiles, tiles_t=tiles_t, hybrid=hybrid)

    v_pad = v
    k, dim = args.k, args.dim
    key = jax.random.PRNGKey(123)
    vals = jax.jit(lambda: jax.random.normal(key, (v_pad, k), jnp.float32))()
    sel = jax.jit(
        lambda: jax.random.randint(
            jax.random.fold_in(key, 1), (v_pad, k), 0, dim, jnp.int32
        )
    )()
    cbsr = CBSR(values=vals, selector=sel)
    x_dense = jax.jit(lambda c: cbsr_densify(c, dim))(cbsr)

    # NOTE: the graph is a jit ARGUMENT, never a closure — closures embed
    # the (GB-scale) tile tables as HLO constants in every executable
    fwd = jax.jit(
        lambda g_, c: maxk_spgemm(g_, c, dim=dim, mode=mode,
                                  compute_dtype=jnp.bfloat16)
    )
    t_fwd = timeit(fwd, graph, cbsr, iters=8)
    log(f"maxk fwd k={k}: {t_fwd*1e3:.3f} ms -> {e_real/t_fwd/1e9:.3f} Gnnz/s")

    # component split: maxk_spgemm = densify(CBSR) + SpMM-with-norm-
    # scales, measured so the record explains its own headline
    densify_f = jax.jit(lambda c: cbsr_densify(c, dim).astype(jnp.bfloat16))
    t_densify = timeit(densify_f, cbsr, iters=8)
    xb = densify_f(cbsr)
    spmm_only = jax.jit(lambda g_, x: spmm(g_, x, mode=mode))
    t_spmm = timeit(spmm_only, graph, xb, iters=8)
    log(
        f"components: densify {t_densify*1e3:.3f} + spmm(normed) "
        f"{t_spmm*1e3:.3f} = {(t_densify+t_spmm)*1e3:.3f} ms "
        f"vs maxk_spgemm {t_fwd*1e3:.3f} ms"
    )
    if hasattr(xb, "delete"):
        xb.delete()

    baseline = jax.jit(lambda g_, x: spmm(g_, x, mode=base_mode))
    t_base = timeit(baseline, graph, x_dense, iters=8)
    log(f"dense f32 baseline ({base_mode}): {t_base*1e3:.3f} ms "
        f"({e_real/t_base/1e9:.3f} Gnnz/s)")

    # fwd+bwd (SSpMM role): value_and_grad at a random cotangent. grad()
    # alone would let XLA dead-code-eliminate the forward (the custom-vjp
    # residuals are (graph, sel) only, so the primal output feeds
    # nothing); returning the loss keeps the forward live.
    ct = jax.jit(
        lambda: jax.random.normal(jax.random.fold_in(key, 2), (v_pad, dim))
    )()
    vg_fn = jax.jit(
        jax.value_and_grad(
            lambda va, g_, s_, c_: jnp.vdot(
                maxk_spgemm(g_, CBSR(va, s_), dim=dim, mode=mode,
                            compute_dtype=jnp.bfloat16),
                c_,
            )
        )
    )
    t_bwd = timeit(vg_fn, vals, graph, sel, ct, iters=8)
    log(f"maxk fwd+bwd: {t_bwd*1e3:.3f} ms")

    nnz_s = e_real / t_fwd
    print(
        json.dumps(
            {
                "metric": f"spmm_maxk fwd nnz/s ({args.graph} x{scale}, "
                f"k={k}, {mode})",
                "value": nnz_s / 1e9,
                "unit": "Gnnz/s",
                "vs_baseline": nnz_s / A100_MAXK_K32_NNZ_S,
                "t_fwd_ms": t_fwd * 1e3,
                "t_fwd_bwd_ms": t_bwd * 1e3,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
