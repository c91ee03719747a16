"""k-vs-accuracy-vs-epoch-time sweep — the `plotgnn.py:26-39` artifact.

The reference's headline training tables report, per dataset × model, the
speed improvement and accuracy delta of MaxK (k swept over {2..128})
against the ReLU baseline (`README.md:160-174`, BASELINE.md). This driver
reproduces that protocol on DC-SBM synthetic datasets (homophilous
communities + power-law hubs — see `synthetic.dcsbm_graph` for why R-MAT
cannot serve the accuracy axis) with per-dataset calibrated feature SNR
and learning rate (`train.golden.ACC_PROTOCOL`) chosen so the relu
CONTROL arm sits in a discriminative 0.3–0.95 band — a saturated task
(r1: snr 0.5 → 1.000 everywhere) or a collapsed control (r4 probes:
reddit relu 0.15 at the published lr) discriminates nothing.

Three arms per (dataset, model): relu on the production kernel, relu on
the library schedule (the reference's DGL-baseline role), and maxk_k*.

Usage:
  python -m maxk_gnn.bench.ksweep --datasets flickr reddit yelp \
      --models sage gcn --scale 0.1 --epochs 300 --json_out KSWEEP.json

Emits per (dataset, model, arm) best val/test accuracy and mean epoch
time, plus acc-delta and speedups vs both relu arms.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datasets", nargs="+", default=["flickr", "reddit"])
    p.add_argument("--models", nargs="+", default=["sage"])
    p.add_argument("--k", nargs="+", type=int,
                   default=[2, 4, 8, 16, 32, 64, 96, 128])
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--hidden_layers", type=int, default=3)
    p.add_argument("--feat_snr", type=float, default=0.0,
                   help="0 = per-dataset calibrated value "
                   "(train.golden.ACC_PROTOCOL)")
    p.add_argument("--lr", type=float, default=0.0,
                   help="0 = per-dataset calibrated value "
                   "(train.golden.ACC_PROTOCOL)")
    p.add_argument("--graph_kind", default="sbm",
                   help="synthetic generator: sbm (accuracy protocol "
                   "default — homophilous DC-SBM) or rmat")
    p.add_argument("--kernel_mode", default="auto")
    p.add_argument("--lib_mode", default="tiles_scan",
                   help="kernel mode of the relu_lib baseline arm (the "
                   "reference's DGL-gspmm role)")
    p.add_argument("--compute_dtype", default="")
    p.add_argument("--seed", type=int, default=97)
    p.add_argument("--json_out", default="",
                   help="persist results incrementally (timeout-safe)")
    p.add_argument("--platform", default="",
                   help="force a jax platform (e.g. 'cpu')")
    args = p.parse_args(argv)

    import jax
    import numpy as np

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from maxk_gnn.runtime import enable_compile_cache

    enable_compile_cache()

    from maxk_gnn.data.datasets import load_dataset
    from maxk_gnn.train.config import TrainConfig
    from maxk_gnn.train.loop import train

    # protocol fields that make two runs' records comparable: a resume
    # against a file measured under a different one of THESE silently
    # mixes incomparable arms into one artifact (ADVICE r4 #5). The
    # dataset/model lists are deliberately excluded — adding a dataset
    # to a sweep does not invalidate the arms already measured.
    core_protocol = {
        "scale": args.scale, "epochs": args.epochs,
        "hidden_dim": args.hidden_dim, "hidden_layers": args.hidden_layers,
        "seed": args.seed, "graph_kind": args.graph_kind,
        "kernel_mode": args.kernel_mode, "lib_mode": args.lib_mode,
        "compute_dtype": args.compute_dtype,
    }

    # re-entrant: resume from an existing json_out (the r3 campaign died
    # mid-run with nothing to resume from — per-arm done-state lives in
    # the artifact itself, so a wedge costs the current arm, not the sweep)
    results = []
    if args.json_out and os.path.exists(args.json_out):
        with open(args.json_out) as f:
            prev = json.load(f)
        # partial runs persist {"core_protocol", "results"}; a finished
        # run persists the full doc; legacy partials were a bare list —
        # resume from any, but refuse a core-protocol mismatch
        if isinstance(prev, dict):
            results = prev["results"]
            prev_core = prev.get("core_protocol")
            if prev_core is not None and prev_core != core_protocol:
                diff = {
                    k2: (prev_core.get(k2), core_protocol.get(k2))
                    for k2 in set(prev_core) | set(core_protocol)
                    if prev_core.get(k2) != core_protocol.get(k2)
                }
                log(f"REFUSING resume: {args.json_out} was measured "
                    f"under a different core protocol: {diff}. "
                    f"Move it aside or rerun with matching args.")
                sys.exit(2)
        else:
            results = prev
            log("legacy bare-list resume: core protocol unverifiable "
                "(pre-r5 partial) — records assumed in-protocol")
        log(f"resuming: {len(results)} completed arms in {args.json_out}")

    from maxk_gnn.train.golden import ACC_PROTOCOL

    for ds in args.datasets:
        proto = ACC_PROTOCOL.get(ds, {})
        snr = args.feat_snr or proto.get("feat_snr", 0.15)
        lr = args.lr or proto.get("lr", 0.001)
        p_intra = proto.get("p_intra", 0.8)
        # skip an arm only if its record matches the CURRENT resolved
        # per-dataset (snr, lr, p_intra): recalibrating ACC_PROTOCOL
        # re-runs exactly the recalibrated dataset's arms on resume.
        # Legacy records (no protocol fields) are assumed in-protocol.
        stale = [
            r for r in results if r["dataset"] == ds
            and not (
                abs(r.get("feat_snr", snr) - snr) < 1e-12
                and abs(r.get("lr", lr) - lr) < 1e-12
                and abs(r.get("p_intra", p_intra) - p_intra) < 1e-12
            )
        ]
        if stale:
            log(f"{ds}: {len(stale)} records measured at a superseded "
                f"(feat_snr, lr, p_intra) — dropped for re-run at "
                f"({snr}, {lr}, {p_intra})")
            results = [r for r in results if r not in stale]
        done = {(r["dataset"], r["model"], r["arm"]) for r in results}
        data = None
        for model in args.models:
            # three arm kinds (reference protocol + one of this repo's):
            #   relu      — relu on the production kernel (accuracy ref;
            #               the dense-feature aggregation cost is
            #               k-independent, so this is ALSO the speed-parity
            #               arm)
            #   relu_lib  — relu on the library schedule: the analog of
            #               the reference's DGL-gspmm baseline, which is
            #               what its published 54%-on-reddit speedups are
            #               measured against (`plotgnn.py:26-31`)
            #   maxk_k*   — MaxK on the production kernel
            arms = [
                ("relu", args.hidden_dim, "relu", args.kernel_mode),
                ("relu", args.hidden_dim, "relu_lib", args.lib_mode),
            ] + [
                ("maxk", k, f"maxk_k{k}", args.kernel_mode)
                for k in args.k if k <= args.hidden_dim
            ]
            for nonlinear, k, arm, kmode in arms:
                if (ds, model, arm) in done:
                    continue
                if data is None:
                    data = load_dataset(ds, scale=args.scale, seed=123,
                                        feat_snr=snr,
                                        graph_kind=args.graph_kind,
                                        sbm_p_intra=p_intra)
                    log(f"{ds} x{args.scale} ({args.graph_kind}): "
                        f"V={data.csr.num_nodes} E={data.csr.nnz} "
                        f"snr={snr} lr={lr} p_intra={p_intra}")
                cfg = TrainConfig(
                    dataset=ds, model=model, epochs=args.epochs,
                    lr=lr, hidden_dim=args.hidden_dim,
                    hidden_layers=args.hidden_layers, nonlinear=nonlinear,
                    maxk=k, seed=args.seed, data_scale=args.scale,
                    kernel_mode=kmode,
                    compute_dtype=args.compute_dtype,
                    feat_snr=snr,
                )
                state = train(cfg, data, logger=None, writer=None)
                ms = (
                    float(np.mean(state.epoch_times) * 1e3)
                    if state.epoch_times else 0.0
                )
                rec = {
                    "dataset": ds, "model": model, "arm": arm,
                    "best_val": round(state.best_val, 4),
                    "best_test": round(state.best_test, 4),
                    "epoch_ms": round(ms, 2),
                    # resolved per-dataset protocol, recorded per arm so
                    # resume can tell an in-protocol record from a
                    # superseded one (ADVICE r4 #5)
                    "feat_snr": snr, "lr": lr, "p_intra": p_intra,
                    # epoch_ms is only comparable within one platform;
                    # acc columns are platform-independent
                    "platform": jax.default_backend(),
                }
                results.append(rec)
                done.add((ds, model, arm))
                log(f"  {model}/{arm}: val {rec['best_val']} "
                    f"test {rec['best_test']} {ms:.1f} ms/ep")
                if args.json_out:
                    # persist after EVERY arm: a timeout kill must not
                    # lose completed measurements
                    with open(args.json_out, "w") as f:
                        json.dump({"core_protocol": core_protocol,
                                   "results": results}, f, indent=1)

    # per (dataset, model): accuracy delta + speedup vs the relu arm,
    # the two columns of the reference's plotgnn tables
    summary = []
    for ds in args.datasets:
        for model in args.models:
            rows = [r for r in results
                    if r["dataset"] == ds and r["model"] == model]
            relu = next((r for r in rows if r["arm"] == "relu"), None)
            lib = next((r for r in rows if r["arm"] == "relu_lib"), None)
            if relu is None:
                continue  # partial resume: no reference arm yet
            for r in rows:
                if r["arm"] in ("relu", "relu_lib"):
                    continue
                row = {
                    "dataset": ds, "model": model, "arm": r["arm"],
                    "acc_delta": round(r["best_test"] - relu["best_test"], 4),
                    # vs relu on the SAME production kernel (the dense
                    # aggregation is k-independent, so expect ~0)
                    "speedup_pct": round(
                        100.0 * (relu["epoch_ms"] - r["epoch_ms"])
                        / max(relu["epoch_ms"], 1e-9), 1),
                }
                if lib is not None:
                    # vs the library-schedule baseline — the comparison
                    # the reference's published % improvements make
                    # (`plotgnn.py:26-31` vs DGL)
                    row["speedup_vs_lib_pct"] = round(
                        100.0 * (lib["epoch_ms"] - r["epoch_ms"])
                        / max(lib["epoch_ms"], 1e-9), 1)
                summary.append(row)
    doc = {
        "core_protocol": core_protocol,
        "protocol": {
            "feat_snr": args.feat_snr or "per-dataset (ACC_PROTOCOL)",
            "lr": args.lr or "per-dataset (ACC_PROTOCOL)",
            "graph_kind": args.graph_kind, "scale": args.scale,
            "epochs": args.epochs, "hidden_dim": args.hidden_dim,
            "hidden_layers": args.hidden_layers, "seed": args.seed,
            "datasets": args.datasets, "models": args.models,
        },
        "results": results,
        "vs_relu": summary,
    }
    print(json.dumps(doc))
    if args.json_out:
        # final artifact = full doc (protocol + vs_relu table), written
        # LAST so a partial run's json_out stays a resumable bare list
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
    return results


if __name__ == "__main__":
    main()
