"""SpGEMM-pruning study — the analog of the reference's nsparse benchmarks.

The reference's "spgemm-prunning" study (`spgemm_comparison_test_2.cu:
348-409`, `spgemm_compare_baseline_2.cu:193-259`) measures the OUTPUT-
SPARSE product adjacency × pruned feature matrix at feature sparsity
∈ {0.5, 0.25, 0.125, 0.0625}, dim 256, across multiple strategies
(hash-SpGEMM without AIA, with AIA, cusparseSpGEMM) with PER-PHASE
timing (symbolic/numeric; workEstimation/compute/copy) and GFLOPS
accounting `flop = Σ_(i,j)∈A 2·nnz(X[j,:])`.

Translation: dynamic-nnz sparse outputs are alien to XLA's static
shapes, so the output-sparse format is row-wise top-k CBSR — exactly the
structure a fused MaxK layer consumes (output pruned to k = s·dim). The
"symbolic phase" analog is output-structure determination (the top-k
threshold search); "numeric" is value computation. Strategies:

  segsum_topk  — gather+segment_sum then prune (cuSPARSE-role library arm)
  dense_topk   — densify → tile/hybrid SpMM → prune (two-phase)
  cbsr_fused   — compressed CBSR in, SpMM, prune (hash-SpGEMM role: input
                 sparsity exploited end-to-end, compact intermediates)
  hybrid_topk  — degree-sorted symmetric-strip SpMM → prune (the AIA
                 role: adaptive arm selection by band density)

Usage: python -m maxk_gnn.bench.spgemm_study [--graph reddit --scale 0.02]
Emits per-(sparsity, strategy) phase times + effective GFLOPS, JSON to
stdout, and cross-validates all arms against the segsum oracle.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SPARSITIES = [0.5, 0.25, 0.125, 0.0625]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--graph", default="reddit")
    p.add_argument("--scale", type=float, default=0.02)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--mode", default="tiles_scan",
                   help="SpMM mode for the dense_topk arm")
    p.add_argument("--validate", action="store_true", default=True)
    p.add_argument("--no-validate", dest="validate", action="store_false")
    p.add_argument("--json_out", default="",
                   help="persist results incrementally (timeout-safe)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from maxk_gnn.runtime import enable_compile_cache

    enable_compile_cache()

    from maxk_gnn.bench.micro import timeit
    from maxk_gnn.data.datasets import DATASETS
    from maxk_gnn.data.device_gen import rmat_graph_device
    from maxk_gnn.ops.spgemm import maxk_spgemm, spmm
    from maxk_gnn.sparse.cbsr import CBSR, cbsr_densify, maxk_cbsr
    from maxk_gnn.sparse.csr import with_norm
    from maxk_gnn.sparse.graph import Graph
    from maxk_gnn.sparse.hybrid import (
        build_hybrid_device,
        degree_perm_device,
        permute_csr_device,
    )

    spec = DATASETS[args.graph]
    v = max(int(spec.num_nodes * args.scale), 64)
    e_target = max(int(spec.num_edges * args.scale), 256)
    graw = rmat_graph_device(v, e_target, seed=123)
    # degree-permute ONCE so every arm sees the same (permuted) problem
    graw = permute_csr_device(graw, degree_perm_device(graw))
    from maxk_gnn.sparse.hybrid import auto_strip_cols

    e_live0 = int(np.asarray(graw.indptr[-1]))
    hybrid = build_hybrid_device(
        graw, s_cols=auto_strip_cols(v, e_live=e_live0), norm="none"
    )
    g = with_norm(graw, "none")
    e_real = int(np.asarray(jnp.sum(g.values != 0)))
    tiles = None
    if args.mode in ("tiles_xla", "tiles_scan"):
        from maxk_gnn.sparse.meta import build_edge_tiles_device

        tiles = build_edge_tiles_device(g)
    graph = Graph(csr=g, csc=g, tiles=tiles, tiles_t=tiles)
    hgraph = Graph(csr=g, csc=g, hybrid=hybrid)
    log(f"{args.graph} x{args.scale}: V={v} E(live)={e_real} dim={args.dim}")

    key = jax.random.PRNGKey(123)
    dim = args.dim
    results = []
    for sp in SPARSITIES:
        k = max(int(dim * sp), 1)
        vals = jax.jit(
            lambda: jax.random.normal(jax.random.fold_in(key, k), (v, k))
        )()
        sel = jax.jit(
            lambda: jax.random.randint(
                jax.random.fold_in(key, 1000 + k), (v, k), 0, dim, jnp.int32
            )
        )()
        cbsr = CBSR(values=vals, selector=sel)
        flops = 2.0 * e_real * k  # reference accounting (input sparsity)

        densify = jax.jit(lambda c: cbsr_densify(c, dim))
        x_dense = densify(cbsr)
        prune = jax.jit(lambda y: maxk_cbsr(y, k))

        arms = {}

        # --- segsum_topk (library arm) --------------------------------
        # one-shot segsum while its (E, D) gather intermediate fits;
        # edge-chunked twin beyond (same math — `spmm_segsum_scan`)
        if e_real * dim * 4 < 2**31:
            seg_fn = jax.jit(lambda g_, x: spmm(g_, x, mode="segsum"))
        else:
            from maxk_gnn.ops.spmm_xla import spmm_segsum_scan

            seg_fn = jax.jit(lambda g_, x: spmm_segsum_scan(g_.csr, x))
        t_num = timeit(seg_fn, graph, x_dense, iters=4)
        y_ref = seg_fn(graph, x_dense)
        t_sym = timeit(prune, y_ref, iters=4)
        arms["segsum_topk"] = {"numeric_ms": t_num * 1e3,
                               "symbolic_ms": t_sym * 1e3}

        # --- dense_topk (densify + tile SpMM + prune) -----------------
        t_d = timeit(densify, cbsr, iters=4)
        t_num = timeit(
            jax.jit(lambda g_, x: spmm(g_, x.astype(jnp.bfloat16),
                                       mode=args.mode)),
            graph, x_dense, iters=4,
        )
        arms["dense_topk"] = {"densify_ms": t_d * 1e3,
                              "numeric_ms": t_num * 1e3,
                              "symbolic_ms": t_sym * 1e3}

        # --- cbsr_fused (compressed in, fused densify) ----------------
        t_num = timeit(
            jax.jit(lambda g_, c: maxk_spgemm(g_, c, dim=dim, mode=args.mode,
                                              compute_dtype=jnp.bfloat16)),
            graph, cbsr, iters=4,
        )
        arms["cbsr_fused"] = {"numeric_ms": t_num * 1e3,
                              "symbolic_ms": t_sym * 1e3}

        # --- hybrid_topk (degree-sorted strip arm) --------------------
        t_num = timeit(
            jax.jit(lambda g_, c: maxk_spgemm(g_, c, dim=dim, mode="hybrid",
                                              compute_dtype=jnp.bfloat16)),
            hgraph, cbsr, iters=4,
        )
        arms["hybrid_topk"] = {"numeric_ms": t_num * 1e3,
                               "symbolic_ms": t_sym * 1e3}

        if args.validate:
            y_h = jax.jit(
                lambda g_, c: maxk_spgemm(g_, c, dim=dim, mode="hybrid")
            )(hgraph, cbsr)
            err = float(jnp.mean(jnp.abs(y_h - y_ref)))
            scale_ = float(jnp.maximum(jnp.max(jnp.abs(y_ref)), 1e-6))
            ok = err / scale_ < 1e-3
            if not ok:
                log(f"  VALIDATION FAILED sparsity={sp}: mean_rel {err/scale_:.2e}")
                sys.exit(1)

        rec = {"sparsity": sp, "k": k, "flop": flops}
        for name, ph in arms.items():
            total = sum(ph.values())
            rec[name] = {**ph, "total_ms": total,
                         "gflops": flops / total / 1e6}
        results.append(rec)
        log(f"  s={sp} (k={k}): " + " | ".join(
            f"{n} {sum(ph.values()):.2f}ms" for n, ph in arms.items()))
        if args.json_out:
            # persist after every sparsity point (timeout/wedge safety)
            with open(args.json_out, "w") as f:
                json.dump({"graph": args.graph, "V": v, "E": e_real,
                           "results": results}, f, indent=1)

    best = {}
    for rec in results:
        arm = min(
            (a for a in rec if isinstance(rec[a], dict)),
            key=lambda a: rec[a]["total_ms"],
        )
        best[rec["sparsity"]] = arm
    print(json.dumps({"graph": args.graph, "V": v, "E": e_real,
                      "results": results, "best_arm": best}))
    return results


if __name__ == "__main__":
    main()
