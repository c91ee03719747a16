"""Multi-chip scaling-efficiency artifact (virtual mesh).

The reference is single-GPU by design (SURVEY §2.3: no distributed
machinery of any kind); multi-chip row-partitioned training is this
framework's new capability. This driver measures STRONG scaling of the
sharded train step over an n-device mesh for n ∈ {1,2,4,8}:

  - the maxk arm all_gathers COMPRESSED (V,k) CBSR values+selectors over
    the mesh axis (`ops/spgemm.py:_maxk_spgemm`), the relu arm gathers
    dense (V,D) rows — the artifact records both measured step times and
    the analytic per-layer collective bytes, so the compressed-collective
    advantage is visible independently of the mesh fabric.

On GPUs the gathers ride NVLink; on the virtual CPU mesh
(`xla_force_host_platform_device_count`, `--platform cpu`) collectives are
memcpys, so CPU numbers show *relative* scaling of the compiled SPMD
program, not hardware throughput. Mesh sizes beyond the devices JAX finds
are skipped.

Usage:
  python -m maxk_gnn.bench.scaling [--dataset flickr --scale 0.2]
Emits ONE JSON line: per (arm, n) mean step ms + analytic bytes.
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
    p.add_argument("--dataset", default="flickr")
    p.add_argument("--scale", type=float, default=0.2)
    p.add_argument("--model", default="sage")
    p.add_argument("--maxk", type=int, default=32)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--hidden_layers", type=int, default=3)
    p.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4, 8])
    # steady-state protocol: ≥50 timed iters after warmup, best of
    # `repeats` timing windows — the r2 artifact (10 iters, 1 window)
    # was noise-dominated on the shared-core virtual mesh (n=4 read
    # slower than n=2)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--kernel_mode", default="tiles_scan")
    p.add_argument(
        "--platform", default="",
        help="force a jax platform (e.g. 'cpu' for the virtual mesh)",
    )
    p.add_argument(
        "--json_out", default="",
        help="persist per-config records incrementally (timeout-safe)",
    )
    args = p.parse_args(argv)

    import os

    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
    )

    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from maxk_gnn.runtime import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()

    from maxk_gnn.data.datasets import load_dataset
    from maxk_gnn.parallel.mesh import make_mesh
    from maxk_gnn.parallel.train import make_sharded_train_step, sharded_setup
    from maxk_gnn.train.config import TrainConfig

    data = load_dataset(args.dataset, scale=args.scale, seed=123)
    v, e = data.csr.num_nodes, int(np.asarray(data.csr.indptr[-1]))
    d, k, nl = args.hidden_dim, args.maxk, args.hidden_layers
    log(f"{args.dataset} x{args.scale}: V={v} E={e} "
        f"{args.model} {nl}x{d} k={k} on {devices[0].platform}")

    # arm = (label, nonlinearity, kernel_mode). maxk_hybrid runs the
    # row-partitioned strip schedule (spmm_hybrid_sharded): its only
    # cross-device aggregation term is a psum of (S,D) hub partials.
    arms = [
        ("maxk", "maxk", args.kernel_mode),
        ("maxk_hybrid", "maxk", "hybrid"),
        ("relu", "relu", args.kernel_mode),
    ]
    # re-entrant: resume from an existing json_out (the r5 run lost its
    # relu arm to a timeout kill with no way to continue) — per-config
    # done-state lives in the artifact
    results = []
    if args.json_out and os.path.exists(args.json_out):
        with open(args.json_out) as f:
            prev = json.load(f)
        results = prev["results"] if isinstance(prev, dict) else prev
        log(f"resuming: {len(results)} completed configs in {args.json_out}")
    done = {(r["arm"], r["n"]) for r in results}
    for arm, nonlinear, kmode in arms:
        for n in args.devices:
            if (arm, n) in done:
                continue
            if n > len(devices):
                log(f"skip n={n}: only {len(devices)} devices")
                continue
            mesh = make_mesh(devices=devices[:n])
            cfg = TrainConfig(
                dataset=args.dataset, model=args.model, epochs=1,
                hidden_dim=d, hidden_layers=nl, nonlinear=nonlinear,
                maxk=k, dropout=0.0, kernel_mode=kmode,
                data_scale=args.scale, seed=97,
            )
            model, variables, opt_state, sgraph, arrays, tx = sharded_setup(
                cfg, data, mesh
            )
            step = make_sharded_train_step(model, tx, data.multilabel, mesh)
            rng = jax.random.PRNGKey(0)
            sa = (arrays["feats"], arrays["labels"], arrays["train"])
            # warmup (compile + reach steady state)
            for _ in range(args.warmup):
                variables, opt_state, loss, _ = step(
                    variables, opt_state, rng, sgraph, *sa
                )
            jax.block_until_ready(loss)
            # best of `repeats` windows of `iters` steps: the min is the
            # noise-robust statistic on a shared-core virtual mesh
            ms = float("inf")
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    variables, opt_state, loss, _ = step(
                        variables, opt_state, rng, sgraph, *sa
                    )
                jax.block_until_ready(loss)
                ms = min(
                    ms, (time.perf_counter() - t0) / args.iters * 1e3
                )
            assert np.isfinite(float(loss)), float(loss)
            # analytic per-layer forward collective volume (bytes moved
            # per device): compressed CBSR vs dense row gather, plus the
            # hybrid's (S,D) hub-partial psum
            fwd_bytes = v * (k * 8) if nonlinear == "maxk" else v * (d * 4)
            # analytic halo-exchange alternative (hub psum + per-shard
            # halo all_to_all, parallel/shard.halo_stats) — recorded so the
            # artifact shows the design comparison per graph
            if nonlinear == "maxk" and n > 1:
                from maxk_gnn.parallel.shard import halo_stats

                hs = halo_stats(data.csr, n, k=k, s_cols=0)
                halo_alt = hs["halo_recv_bytes_per_device_max"]
            else:
                halo_alt = None
            rec = {
                "arm": arm, "n": n, "step_ms": round(ms, 2),
                "fwd_allgather_bytes_per_layer": fwd_bytes,
            }
            s_cols = sgraph.hybrid.s_cols if sgraph.hybrid is not None else 0
            if sgraph.hybrid is not None:
                rec["fwd_hub_psum_bytes_per_layer"] = s_cols * d * 4
            # tail size: edges outside the hub strip after degree sort
            # (rows≥S ∧ cols≥S)
            if arm == "maxk_hybrid" and s_cols:
                indptr = np.asarray(data.csr.indptr, dtype=np.int64)
                deg = np.diff(indptr)
                rank = np.empty(v, dtype=np.int64)
                rank[np.argsort(-deg, kind="stable")] = np.arange(v)
                rows = rank[np.repeat(np.arange(v), deg)]
                cols = rank[np.asarray(data.csr.indices)[: indptr[-1]]]
                rec["tail_edges"] = int(((rows >= s_cols) & (cols >= s_cols)).sum())
            if halo_alt is not None:
                rec["halo_alt_recv_bytes_per_device"] = halo_alt
            results.append(rec)
            log(f"  {arm} n={n}: {ms:.2f} ms/step "
                f"loss={float(loss):.4f}")
            if args.json_out:
                # persist after EVERY config: a timeout kill must not
                # lose completed measurements
                with open(args.json_out, "w") as f:
                    json.dump(results, f, indent=1)

    # strong-scaling vs n=1 of the same arm. Two readings:
    #   efficiency_chips  = base/(n·ms) — the real-hardware formula, valid
    #                       when each device is its own card
    #   efficiency_shared = base/ms — virtual CPU devices share one core
    #     pool, so total work is fixed and the ideal is a FLAT step time;
    #     a flat curve means partitioning+collectives add no overhead
    for r in results:
        base = next(
            (b for b in results if b["arm"] == r["arm"] and b["n"] == 1), None
        )
        if base:
            r["efficiency_chips"] = round(
                base["step_ms"] / (r["step_ms"] * r["n"]), 3
            )
            r["efficiency_shared"] = round(base["step_ms"] / r["step_ms"], 3)
    doc = {
        "protocol": {
            "dataset": args.dataset, "scale": args.scale, "V": v, "E": e,
            "model": args.model, "hidden_dim": d, "layers": nl, "k": k,
            "platform": devices[0].platform,
            "device_kind": devices[0].device_kind, "iters": args.iters,
        },
        "results": results,
        "compressed_collective_ratio": round((k * 8) / (d * 4), 4),
    }
    print(json.dumps(doc))
    if args.json_out:
        # final artifact = full doc (protocol + efficiency fields); a
        # partial run's json_out stays a resumable bare list
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
    return results


if __name__ == "__main__":
    main()
