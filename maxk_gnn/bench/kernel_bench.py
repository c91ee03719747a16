"""Kernel benchmark suite — re-design of the reference benchmark stack:

  - `kernels/main.cu:50-222` (C++ driver: per-graph, per-k timing with
    the `n graph dim_origin dim_k kernel time(ms)` print protocol)
  - `main_runner_direct.py` / `direct_kernel_interface.py` (Python
    harness with validation-against-cuSPARSE and error forensics)

Usage:
  python -m maxk_gnn.bench.kernel_bench                 # default suite
  python -m maxk_gnn.bench.kernel_bench --graphs reddit flickr --k 16 32
  python -m maxk_gnn.bench.kernel_bench --validate      # oracle check
  python -m maxk_gnn.bench.kernel_bench --dir DIR       # real binaries

The suite runs every graph × k ∈ {16,32,64} (reference protocol), timing
the maxk forward, the fwd+bwd VJP, and the dense baseline (cuSPARSE
role), and emits both the reference-format text lines and a JSON report.
Graphs come from real `.indptr/.indices` binaries when `--dir` is given
(`kernels/graphs` drop-in), else on-device synthetic at dataset scale.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# default synthetic suite: the 5 training graphs at benchmark scale
DEFAULT_GRAPHS = ["flickr", "yelp", "reddit", "ogbn-proteins", "ogbn-products"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_suite(args):
    import jax.numpy as jnp

    from maxk_gnn.data.datasets import DATASETS
    from maxk_gnn.data.device_gen import rmat_graph_device
    from maxk_gnn.data.io import list_graph_binaries, load_graph_binary

    if args.dir:
        for prefix in list_graph_binaries(args.dir):
            name = prefix.rsplit("/", 1)[-1]
            yield name, load_graph_binary(prefix)
        return
    for name in args.graphs:
        if name.startswith("rmat_"):
            # degree-spread family approximating the reference's 24-graph
            # suite axis (`kernels/main.cu:196-218`; speedup claims are
            # conditioned on avg degree > 50, `README.md:136`). Spec:
            # rmat_v<nodes>_d<avg_degree>, scaled like named datasets.
            parts = dict(
                (p[0], int(p[1:])) for p in name.split("_")[1:]
            )
            v = max(int(parts.get("v", 262144) * args.scale), 64)
            e = max(int(parts.get("v", 262144) * parts.get("d", 50)
                        * args.scale), 256)
            yield name, rmat_graph_device(v, e, seed=123)
            continue
        spec = DATASETS[name]
        v = max(int(spec.num_nodes * args.scale), 64)
        e = max(int(spec.num_edges * args.scale), 256)
        yield name, rmat_graph_device(v, e, seed=123)


def validate_graph(graph, cbsr, dim, mode, tol=1e-3, compute_dtype=None):
    """Kernel output vs the segment-sum oracle — the role of
    `validate_against_cusparse` (`direct_kernel_interface.py:221-372`),
    including its max-error forensics. `compute_dtype` should match the
    timed kernel's (the oracle itself stays f32): an f32 validation pass
    at products scale also doubles the transient memory and OOMs."""
    import jax
    import jax.numpy as jnp

    from maxk_gnn.ops.spgemm import maxk_spgemm
    from maxk_gnn.ops.spmm_xla import spmm_segsum, spmm_segsum_scan
    from maxk_gnn.sparse.cbsr import CBSR, cbsr_densify

    # one-shot oracle while its (E, D) gather intermediate fits; the
    # edge-chunked scan oracle (same math, raw CSR — independent of the
    # tile/hybrid schedules) at full graph scale
    e = graph.csr.nnz
    oracle = (
        spmm_segsum if e * dim * 4 < 2**31 else jax.jit(spmm_segsum_scan)
    )
    # error forensics computed ON DEVICE (fused, no materialized |err|
    # array, scalar fetches only): a products-scale (V, 256) f32 result
    # is 2.5 GB, and host-side copies would double peak memory.
    # The kernel output comes FIRST: its transients (~8 GB at products
    # scale) must not co-reside with the oracle's reference buffer.
    # Everything is jitted — eagerly dispatched ops would pin every
    # intermediate as a live buffer instead of letting XLA reuse them.
    y = jax.jit(
        lambda g_, c: maxk_spgemm(
            g_, c, dim=dim, mode=mode, compute_dtype=compute_dtype
        )
    )(graph, cbsr)
    # no host sync needed: device executions run in order, so y's
    # (large) temp buffers are freed before the oracle executes.
    # Above ~2 GB of (V, dim) f32, the oracle's densified input and
    # output drop to compute_dtype (its cross-edge ACCUMULATION stays
    # f32 inside segment_sum/scan) — an f32 reference at products scale
    # pushes peak memory over the chip.
    v, d = y.shape
    oracle_dtype = (
        compute_dtype
        if compute_dtype is not None and v * d * 4 > (2 << 30)
        else None
    )

    def _ref(g_, c):
        vals = c.values if oracle_dtype is None else c.values.astype(
            oracle_dtype
        )
        return oracle(g_, cbsr_densify(CBSR(vals, c.selector), dim))

    ref = jax.jit(_ref)(graph.csr, cbsr)

    @jax.jit
    def stats(y, ref):
        err = jnp.abs(y.astype(jnp.float32) - ref.astype(jnp.float32))
        return (
            err.max(),
            err.mean(),
            jnp.argmax(err),
            (err > 0.1).sum(),
            (err > 0.5).sum(),
        )

    mx, mn, am, n01, n05 = stats(y, ref)
    shape = y.shape
    max_err, mean_err = float(mx), float(mn)
    for a in (y, ref):
        if hasattr(a, "delete"):
            a.delete()
    ok = mean_err < tol
    detail = {
        "max_err": max_err,
        "mean_err": mean_err,
        "argmax": [int(i) for i in np.unravel_index(int(am), shape)],
        "n_gt_0.1": int(n01),
        "n_gt_0.5": int(n05),
    }
    return ok, detail


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--graphs", nargs="+", default=DEFAULT_GRAPHS)
    p.add_argument("--dir", default="", help="directory of .indptr binaries")
    p.add_argument("--k", nargs="+", type=int, default=[16, 32, 64])
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--scale", type=float, default=0.02)
    p.add_argument("--mode", default="auto")
    p.add_argument("--validate", action="store_true")
    p.add_argument(
        "--dispatch_check", action="store_true",
        help="also time the NON-picked arm (hybrid vs tiles_scan) once "
        "per graph, recording whether the dispatch rule picked the "
        "faster one (the degree-axis sweep uses this)",
    )
    p.add_argument("--json_out", default="")
    p.add_argument(
        "--io_itemsize", type=int, default=4,
        help="(V,dim) output/cotangent itemsize assumed by the strip HBM "
        "budget: 2 widens the strip on HBM-limited graphs (products) by "
        "keeping every IO tensor bf16 — see auto_strip_cols",
    )
    p.add_argument(
        "--strip_dtype", default="auto",
        choices=["auto", "bfloat16", "int8"],
        help="hybrid strip storage dtype. auto = the production rule "
        "(int8 where exact, else bf16 — sparse.hybrid.auto_strip_dtype)."
        " int8 is EXACT on integer-valued graphs (the strip holds raw "
        "symmetric values; build_hybrid_device raises otherwise), "
        "halves the strip's bytes/column, and its measured default "
        "width (24576 at reddit) cuts the gather-wall tail ~4x",
    )
    p.add_argument(
        "--tail_band_cols", type=int, default=-1,
        help="hybrid tail column-band width; 0 disables banding, -1 = "
        "production default (sparse.hybrid.auto_tail_band_cols)",
    )
    p.add_argument(
        "--platform", default="",
        help="force a jax platform (e.g. 'cpu'); empty = environment "
        "default. Applied before any device op.",
    )
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from maxk_gnn.runtime import enable_compile_cache

    enable_compile_cache()
    from maxk_gnn.bench.micro import timeit
    from maxk_gnn.ops.dispatch import choose_mode
    from maxk_gnn.ops.mask import maxk_activation
    from maxk_gnn.ops.spgemm import maxk_spgemm, spmm
    from maxk_gnn.sparse.cbsr import CBSR, cbsr_densify
    from maxk_gnn.sparse.csr import with_norm
    from maxk_gnn.sparse.graph import Graph
    from maxk_gnn.sparse.meta import build_edge_tiles_device

    # mode selection is the production dispatch rule, so default suite
    # invocations benchmark what training actually runs; "auto" resolves
    # PER GRAPH and per device (ops/dispatch.choose_mode)
    results = []
    n = 0
    for name, g in load_suite(args):
        e_live = int(np.asarray(g.indptr[-1]))
        strip_choice = args.strip_dtype
        if strip_choice == "auto":
            from maxk_gnn.sparse.hybrid import strip_int8_exact

            strip_choice = (
                "int8" if strip_int8_exact(g) else "bfloat16"
            )
        mode = choose_mode(args.mode, g, args.dim, jnp.bfloat16).value
        if mode == "hybrid":
            from maxk_gnn.sparse.hybrid import (
                degree_perm_device,
                permute_csr_device,
            )

            # permute now, but build the strip only AFTER the baseline
            # arm is timed — at ogbn-products scale the strip (5.6 GB)
            # plus the tile tables + scan accumulator don't co-reside
            g = permute_csr_device(g, degree_perm_device(g))
        g_raw = g  # pre-norm CSR: the strip builder folds norm itself
        g = with_norm(g, "right")
        e_real = int(np.asarray(jnp.sum(g.values != 0)))
        # the baseline arm is the LIBRARY path — plain XLA gather +
        # segment-sum. This is the cuSPARSE role of `kernels/main.cu`: the
        # reference times its hand-built kernel against the vendor
        # library, not against itself. The maxk arm runs the resolved
        # production kernel.
        base_mode = "segsum"
        tiles = (
            build_edge_tiles_device(g)
            if mode in ("tiles_xla", "tiles_scan") else None
        )
        graph = Graph(csr=g, csc=g, tiles=tiles, tiles_t=tiles)
        v = g.num_nodes
        key = jax.random.PRNGKey(123)
        x_dense_f = jax.jit(
            lambda: jax.random.normal(key, (v, args.dim), jnp.float32)
        )
        x_dense = x_dense_f()
        # graph passed as jit argument, never closed over (closures are
        # embedded as constants)
        t_base = timeit(
            jax.jit(lambda g_, x: spmm(g_, x, mode=base_mode)),
            graph, x_dense, iters=4,
        )
        print(f"{n} {name} {args.dim} - cusparse_role {t_base*1e3:.4f}")
        # bf16 baseline arm: like-for-like dtype with the maxk path
        t_base16 = timeit(
            jax.jit(
                lambda g_, x: spmm(g_, x.astype(jnp.bfloat16), mode=base_mode)
            ),
            graph,
            x_dense,
            iters=4,
        )
        print(f"{n} {name} {args.dim} - cusparse_role_bf16 {t_base16*1e3:.4f}")
        if mode == "hybrid":
            # baseline arms done: free the tile tables and the dense
            # feature matrix before materializing the strip (products:
            # strip 5.6 GB, tiles 2.4 GB, x 2.5 GB — not co-resident)
            from maxk_gnn.sparse.hybrid import (
                auto_strip_cols,
                build_hybrid_device,
            )

            if tiles is not None:
                jax.tree.map(
                    lambda a: a.delete() if hasattr(a, "delete") else None,
                    (tiles, x_dense),
                )
            tiles = None
            from maxk_gnn.sparse.hybrid import auto_tail_band_cols

            strip_dtype = (
                jnp.int8 if strip_choice == "int8" else jnp.bfloat16
            )
            s_cols = auto_strip_cols(
                g.num_nodes, e_live=e_real, dim=args.dim,
                io_itemsize=args.io_itemsize,
                strip_itemsize=jnp.dtype(strip_dtype).itemsize,
            )
            band = (
                auto_tail_band_cols(g.num_nodes, s_cols)
                if args.tail_band_cols < 0 else args.tail_band_cols
            )
            hybrid = build_hybrid_device(
                g_raw, s_cols=s_cols, norm="right", tail_band_cols=band,
                strip_dtype=strip_dtype,
            )
            graph = Graph(csr=g, csc=g, hybrid=hybrid)
            # pre-norm CSR no longer needed: free its values (indices are
            # shared with the normalized copy)
            if hasattr(g_raw.values, "delete"):
                g_raw.values.delete()
            g_raw = None
        for k in args.k:
            # --- production maxk arm (what training actually runs) ---
            # Single-chip, densify(topk(x)) ≡ x ⊙ mask, so the model
            # never materializes a CBSR (`models._nonlinear`): the per-
            # layer kernel is the plain SpMM over the MASKED bf16
            # features. The masked input is prepared OUTSIDE the timed
            # region, exactly as main.cu prepares the CBSR outside its
            # timed kernels (`kernels/main.cu:120-146`); the mask kernel
            # itself is timed separately below (the maxk_kernel.cu role).
            # When the CBSR path has no advantage for (graph, k), the
            # production kernel IS the library kernel over masked inputs —
            # it can never lose to its own fallback.
            # masked-arm dtype: bf16 once the (V, dim) f32 in/out pair
            # (5 GB at products scale) is large. bf16 is also
            # what production runs (the SpMM consumes bf16), so nothing
            # about the timed kernel changes except its IO width.
            mask_dtype = (
                jnp.bfloat16
                if args.io_itemsize == 2 or v * args.dim * 4 > (2 << 30)
                else jnp.float32
            )
            xk_f = jax.jit(
                lambda: jax.random.normal(
                    jax.random.fold_in(key, 300 + k), (v, args.dim)
                ).astype(mask_dtype)
            )
            x_k = xk_f()
            t_mask = timeit(
                jax.jit(lambda x: maxk_activation(x, k)), x_k, iters=4
            )
            print(f"{n} {name} {args.dim} {k} maxk_mask {t_mask*1e3:.4f}")
            xm = jax.jit(
                lambda x: maxk_activation(x, k).astype(jnp.bfloat16)
            )(x_k)
            if hasattr(x_k, "delete"):
                x_k.delete()  # (V, dim): products-scale headroom
            prod_fwd = jax.jit(lambda g_, x: spmm(g_, x, mode=mode))
            t_fwd = timeit(prod_fwd, graph, xm, iters=4)
            print(f"{n} {name} {args.dim} {k} maxk_fwd {t_fwd*1e3:.4f}")
            ct16 = jax.jit(
                lambda: jax.random.normal(
                    jax.random.fold_in(key, 200 + k), (v, args.dim)
                ).astype(jnp.bfloat16)
            )()
            # value_and_grad, NOT grad: under plain grad() the primal
            # output feeds nothing and XLA dead-code-eliminates the
            # forward. Returning the loss keeps the forward live in the
            # timed executable.
            prod_vg = jax.jit(
                jax.value_and_grad(
                    lambda x, g_, c_: jnp.vdot(
                        spmm(g_, x, mode=mode).astype(jnp.float32),
                        c_.astype(jnp.float32),
                    )
                )
            )
            t_fb = timeit(prod_vg, xm, graph, ct16, iters=4)
            print(f"{n} {name} {args.dim} {k} maxk_fwd_bwd {t_fb*1e3:.4f}")
            for a in (xm, ct16):
                if hasattr(a, "delete"):
                    a.delete()

            # --- CBSR arm (the sharded-collective input path; k-shaped
            # backward producing the compact (V, k) gradient) ---
            # io_itemsize=2 runs the whole arm with bf16-valued CBSR
            # (output dtype follows the values dtype) — the widened
            # strip budget assumes no (V, dim) f32 IO buffer exists.
            # Same auto-bf16 pressure rule as the masked arm: at products
            # scale the (V, dim) f32 cotangent alone is 2.5 GB; production
            # (compute_dtype=bfloat16) runs bf16 values regardless, so
            # only the IO width of the timed kernel changes
            val_dtype = (
                jnp.bfloat16
                if args.io_itemsize == 2 or v * args.dim * 4 > (2 << 30)
                else jnp.float32
            )
            vals = jax.jit(
                lambda: jax.random.normal(
                    jax.random.fold_in(key, k), (v, k)
                ).astype(val_dtype)
            )()
            sel = jax.jit(
                lambda: jax.random.randint(
                    jax.random.fold_in(key, 100 + k), (v, k), 0, args.dim, jnp.int32
                )
            )()
            cbsr = CBSR(values=vals, selector=sel)
            fwd = jax.jit(
                lambda g_, c: maxk_spgemm(
                    g_, c, dim=args.dim, mode=mode, compute_dtype=jnp.bfloat16
                )
            )
            t_fwd_cbsr = timeit(fwd, graph, cbsr, iters=4)
            print(f"{n} {name} {args.dim} {k} maxk_fwd_cbsr {t_fwd_cbsr*1e3:.4f}")
            ct = jax.jit(
                lambda: jax.random.normal(
                    jax.random.fold_in(key, 200 + k), (v, args.dim)
                ).astype(val_dtype)
            )()
            vg_fn = jax.jit(
                jax.value_and_grad(
                    lambda va, g_, s_, c_: jnp.vdot(
                        maxk_spgemm(
                            g_, CBSR(va, s_), dim=args.dim, mode=mode,
                            compute_dtype=jnp.bfloat16,
                        ),
                        c_,
                    )
                )
            )
            t_fb_cbsr = timeit(vg_fn, vals, graph, sel, ct, iters=4)
            print(
                f"{n} {name} {args.dim} {k} maxk_fwd_bwd_cbsr "
                f"{t_fb_cbsr*1e3:.4f}"
            )
            # free the (V, dim) f32 cotangent before validation — at
            # products scale it is 2.5 GB of the validation headroom
            if hasattr(ct, "delete"):
                ct.delete()
            rec = {
                "graph": name,
                "V": v,
                "E": e_real,
                "k": k,
                "mode": mode,
                "base_mode": base_mode,
                "maxk_input": "masked_dense",
                "t_mask_ms": t_mask * 1e3,
                "t_fwd_ms": t_fwd * 1e3,
                "t_fwd_bwd_ms": t_fb * 1e3,
                "t_fwd_cbsr_ms": t_fwd_cbsr * 1e3,
                "t_fwd_bwd_cbsr_ms": t_fb_cbsr * 1e3,
                "t_baseline_ms": t_base * 1e3,
                "t_baseline_bf16_ms": t_base16 * 1e3,
                "fwd_gnnz_s": e_real / t_fwd / 1e9,
                "speedup_vs_baseline": t_base / t_fwd,
                # single-chip k benefit (DESIGN.md thesis): the CBSR
                # backward emits the compact (V, k) gradient vs the
                # masked path's (V, dim) cotangent-sized one — sized at
                # each arm's ACTUAL value dtype
                "bwd_grad_bytes_cbsr": v * k * jnp.dtype(val_dtype).itemsize,
                "bwd_grad_bytes_masked": v * args.dim * 2,  # xm is bf16
                "cbsr_val_dtype": jnp.dtype(val_dtype).name,
                "mask_dtype": jnp.dtype(mask_dtype).name,
            }
            if mode == "hybrid":
                rec["strip_dtype"] = strip_choice
                # the width actually BUILT (build clamps to min(s, v) and
                # 128-aligns), not the requested auto_strip_cols value
                rec["strip_cols"] = hybrid.s_cols
                rec["tail_band_cols"] = band
            # persist the timing record BEFORE validation, and again with
            # the validation fields: a late OOM (products k=64) must not
            # lose the completed measurements
            results.append(rec)

            def dump():
                if args.json_out:
                    with open(args.json_out, "w") as f:
                        json.dump(results, f, indent=1)

            dump()
            if args.validate:
                ok, detail = validate_graph(
                    graph, cbsr, args.dim, mode, compute_dtype=jnp.bfloat16
                )
                rec["valid"] = ok
                rec["validation"] = detail
                log(f"  validate k={k}: ok={ok} {detail}")
                dump()
            # free this k's CBSR before the next iteration allocates its
            # (V, dim) feature pair — every 100 MB counts at products scale
            for a in (vals, sel):
                if hasattr(a, "delete"):
                    a.delete()
        if args.dispatch_check and mode in ("hybrid", "segsum"):
            # time the arm the dispatch rule did NOT pick, once per
            # graph (the production forward is k-independent), so the
            # sweep artifact can show whether the rule chose the faster
            # schedule at every point of the degree axis
            alt = "segsum" if mode == "hybrid" else "hybrid"
            alt_graph = None
            if alt == "segsum":
                alt_graph = Graph(csr=g, csc=g)
            elif g_raw is not None:
                from maxk_gnn.sparse.hybrid import (
                    auto_strip_cols,
                    build_hybrid_device,
                    degree_perm_device,
                    permute_csr_device,
                )

                s_alt = auto_strip_cols(v, e_live=e_real, dim=args.dim)
                if s_alt >= 256:
                    # (timing-only relabeling: the alt arm runs on the
                    # degree-permuted twin; the operator cost is what's
                    # compared, not the row order)
                    gp = permute_csr_device(g_raw, degree_perm_device(g_raw))
                    hyb = build_hybrid_device(gp, s_cols=s_alt, norm="right")
                    alt_graph = Graph(csr=g, csc=g, hybrid=hyb)
            if alt_graph is not None:
                kf = min(args.k)
                xm2 = jax.jit(
                    lambda: maxk_activation(
                        jax.random.normal(
                            jax.random.fold_in(key, 999), (v, args.dim)
                        ),
                        kf,
                    ).astype(jnp.bfloat16)
                )()
                t_alt = timeit(
                    jax.jit(lambda g_, x: spmm(g_, x, mode=alt)),
                    alt_graph, xm2, iters=4,
                )
                t_pick = next(
                    r["t_fwd_ms"] for r in results
                    if r.get("graph") == name and r.get("k") == kf
                )
                results.append({
                    "kind": "dispatch_check",
                    "graph": name, "V": v, "E": e_real,
                    "picked": mode, "alt": alt,
                    "t_fwd_picked_ms": t_pick,
                    "t_fwd_alt_ms": t_alt * 1e3,
                    "picked_faster": bool(t_pick <= t_alt * 1e3),
                })
                log(f"  dispatch_check: picked={mode} {t_pick:.2f} ms vs "
                    f"{alt} {t_alt*1e3:.2f} ms")
                dump()
                jax.tree.map(
                    lambda a: a.delete() if hasattr(a, "delete") else None,
                    (alt_graph.tiles, alt_graph.hybrid, xm2),
                )
        n += 1
    if args.json_out:
        log(f"wrote {args.json_out} ({len(results)} records)")
    return results


if __name__ == "__main__":
    main()
