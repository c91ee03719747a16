"""Three-way scheduling comparison — the GNNAdvisor-role artifact.

The reference benchmarks THREE independent schedules of the same SpMM:
its own warp4 kernel, cuSPARSE, and GNNAdvisor's neighbor-group kernel
(`kernels/spmm_gnna.cu:20-176`, `README.md:136`). This framework's three
independent schedules are:

  hybrid      symmetric-strip dense-matmul decomposition
  tiles_scan  blocked-gather XLA tile schedule (library role)
  segsum      per-edge gather + segment-sum over the raw CSR

Emits one JSON with per-graph forward times of all three arms on the
same bf16 input, each validated against the segment-sum oracle.

Usage: python -m maxk_gnn.bench.three_arms --out THREE_ARMS.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    # claim shape (`README.md:136`): per-degree-class averages over a
    # graph set spanning the avg-degree-50 boundary — reddit (~493) and
    # proteins (~30→x1.0 here ~15) above/below, flickr (~10) below
    p.add_argument(
        "--graphs", nargs="+", default=["reddit", "ogbn-proteins", "flickr"]
    )
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--out", default="")
    p.add_argument("--platform", default="")
    p.add_argument(
        "--arms", nargs="+", default=["tiles_scan", "hybrid", "segsum"],
    )
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from maxk_gnn.runtime import enable_compile_cache

    enable_compile_cache()

    from maxk_gnn.bench.micro import timeit
    from maxk_gnn.data.datasets import DATASETS
    from maxk_gnn.data.device_gen import rmat_graph_device
    from maxk_gnn.ops.spmm_hybrid import spmm_hybrid
    from maxk_gnn.ops.spmm_xla import spmm_segsum_scan, spmm_tiles_scan
    from maxk_gnn.sparse.csr import with_norm
    from maxk_gnn.sparse.hybrid import (
        auto_strip_cols,
        build_hybrid_device,
        degree_perm_device,
        permute_csr_device,
    )
    from maxk_gnn.sparse.meta import build_edge_tiles_device

    results = []

    def persist():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(assemble(), f, indent=1)

    def assemble():
        # per-degree-class geomean speedups of each schedule vs the
        # library arm — the shape of the reference's claim table
        # (`README.md:136`: per-k averages over the degree>50 class)
        classes = {"avg_deg_ge_50": [], "avg_deg_lt_50": []}
        for r in results:
            if "tiles_scan_ms" not in r:
                continue
            cls = (
                "avg_deg_ge_50"
                if r["E"] / max(r["V"], 1) >= 50 else "avg_deg_lt_50"
            )
            classes[cls].append(r)
        summary = {}
        for cls, rows in classes.items():
            if not rows:
                continue
            ent = {"n_graphs": len(rows)}
            for arm in ("hybrid", "segsum"):
                sp = [
                    r["tiles_scan_ms"] / r[f"{arm}_ms"]
                    for r in rows
                    if r.get(f"{arm}_ms") and r.get(f"{arm}_valid")
                ]
                if sp:
                    ent[f"{arm}_geomean_speedup"] = float(
                        np.exp(np.mean(np.log(sp)))
                    )
                    ent[f"{arm}_n"] = len(sp)
            summary[cls] = ent
        return {
            "protocol": {
                "scale": args.scale, "dim": args.dim,
                "note": "three independent schedules of the same SpMM on "
                        "the same bf16 input (GNNAdvisor-comparison role, "
                        "README.md:136); each validated vs the tile "
                        "oracle. The forward is k-independent by design "
                        "(masked dense input), so the per-k axis lives in "
                        "BENCH_SUITE; this artifact carries the per-"
                        "degree-class schedule comparison.",
            },
            "results": results,
            "geomean_by_degree_class": summary,
        }

    for name in args.graphs:
        spec = DATASETS[name]
        v = max(int(spec.num_nodes * args.scale), 256)
        e = max(int(spec.num_edges * args.scale), 1024)
        g = rmat_graph_device(v, e, seed=123)
        live = int(np.asarray(g.indptr[-1]))
        log(f"=== {name} x{args.scale}: V={v} live={live}")
        g = permute_csr_device(g, degree_perm_device(g))
        x = jax.jit(
            lambda: jax.random.normal(
                jax.random.PRNGKey(0), (v, args.dim), jnp.float32
            ).astype(jnp.bfloat16)
        )()
        rec = {"graph": name, "V": v, "E": live, "dim": args.dim}

        # arm 1: tiles_scan (library role) — also the oracle for the rest
        gn = with_norm(g, "none")
        tiles = build_edge_tiles_device(gn)
        ft = jax.jit(lambda tt, xx: spmm_tiles_scan(tt, xx))
        y_ref = ft(tiles, x)
        t_tiles = timeit(ft, tiles, x, iters=4)
        rec["tiles_scan_ms"] = t_tiles * 1e3
        log(f"tiles_scan: {t_tiles*1e3:.2f} ms")

        @jax.jit
        def rel_err(y, ref):
            d = jnp.abs(y.astype(jnp.float32) - ref.astype(jnp.float32))
            sc = jnp.maximum(jnp.max(jnp.abs(ref.astype(jnp.float32))), 1e-6)
            return d.max() / sc, d.mean() / sc

        # arm 2: hybrid (production rule: int8 strip where exact, with
        # the matching width cap — measuring the bf16 point would
        # undersell the schedule this framework actually ships)
        from maxk_gnn.sparse.hybrid import auto_strip_dtype

        strip_dtype = auto_strip_dtype(g)
        s_cols = auto_strip_cols(
            v, e_live=live, dim=args.dim,
            strip_itemsize=jnp.dtype(strip_dtype).itemsize,
        )
        if "hybrid" in args.arms and s_cols >= 256:
            t0 = time.time()
            h = build_hybrid_device(
                g, s_cols=s_cols, norm="none", strip_dtype=strip_dtype
            )
            log(f"hybrid build {time.time()-t0:.0f}s "
                f"(s={h.s_cols} {jnp.dtype(strip_dtype).name})")
            fh = jax.jit(lambda hh, xx: spmm_hybrid(hh, xx))
            yh = fh(h, x)
            mx, mn = (float(q) for q in rel_err(yh, y_ref))
            rec["hybrid_valid"] = mn < 1e-3
            rec["hybrid_rel_err"] = {"max": mx, "mean": mn}
            if hasattr(yh, "delete"):
                yh.delete()
            t_h = timeit(fh, h, x, iters=4)
            rec["hybrid_ms"] = t_h * 1e3
            log(f"hybrid: {t_h*1e3:.2f} ms (rel err mean {mn:.2e})")
            jax.tree.map(
                lambda a: a.delete() if hasattr(a, "delete") else None, h
            )

        # arm 3: segsum over the raw CSR
        if "segsum" in args.arms:
            fs = jax.jit(spmm_segsum_scan)
            ys = fs(gn, x)
            mx, mn = (float(q) for q in rel_err(ys, y_ref))
            rec["segsum_valid"] = mn < 1e-3
            rec["segsum_rel_err"] = {"max": mx, "mean": mn}
            if hasattr(ys, "delete"):
                ys.delete()
            t_s = timeit(fs, gn, x, iters=4)
            rec["segsum_ms"] = t_s * 1e3
            log(f"segsum: {t_s*1e3:.2f} ms (rel err mean {mn:.2e})")
        results.append(rec)
        persist()  # per-graph: a wedge costs the current graph only
        # free this graph's schedules before the next one's build (full
        # reddit: tiles + x + sched would otherwise co-reside)
        jax.tree.map(
            lambda a: a.delete() if hasattr(a, "delete") else None,
            (g, gn, tiles, x, y_ref),
        )

    doc = assemble()
    out = json.dumps(doc, indent=1)
    if args.out:
        persist()
        log(f"wrote {args.out}")
    print(out)
    return results


if __name__ == "__main__":
    main()
