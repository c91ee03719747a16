"""Analysis figures from benchmark JSON — role of the reference's plot
scripts (`plotgnn.py`, `plot_gnn2.py`, `gnnaia_plot*.py`), which embed
hard-coded measured tables; here figures render from the JSON reports the
harnesses emit.

  python -m maxk_gnn.bench.plots --kernel kernel_bench.json --out figs/
"""

from __future__ import annotations

import argparse
import json
import os


def plot_kernel_bench(records, out_dir):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    records = [r for r in records if "k" in r]
    graphs = sorted({r["graph"] for r in records})
    ks = sorted({r["k"] for r in records})
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    width = 0.8 / max(len(ks), 1)
    for i, k in enumerate(ks):
        xs, speed, nnzs = [], [], []
        for gi, g in enumerate(graphs):
            rec = next((r for r in records if r["graph"] == g and r["k"] == k), None)
            if rec:
                xs.append(gi + i * width)
                speed.append(rec["speedup_vs_baseline"])
                nnzs.append(rec["fwd_gnnz_s"])
        axes[0].bar(xs, speed, width=width, label=f"k={k}")
        axes[1].bar(xs, nnzs, width=width, label=f"k={k}")
    for ax, title in zip(axes, ["speedup vs dense baseline", "fwd Gnnz/s"]):
        ax.set_xticks(range(len(graphs)))
        ax.set_xticklabels(graphs, rotation=20)
        ax.set_title(title)
        ax.legend()
        ax.axhline(1.0 if "speedup" in title else 0, color="k", lw=0.5)
    fig.tight_layout()
    path = os.path.join(out_dir, "kernel_bench.png")
    fig.savefig(path, dpi=120)
    return path


def plot_degree_sweep(data, out_dir):
    """Speedup vs average degree (the 24-graph-suite axis), colored by
    the dispatched arm, with the reference's avg-deg-50 claim boundary."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    records = data["results"] if isinstance(data, dict) else data
    records = [r for r in records if "k" in r]
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for mode, marker in (("hybrid", "o"), ("tiles_scan", "s"),
                         ("segsum", "^")):
        rows = [r for r in records if r["mode"] == mode]
        if not rows:
            continue
        ax.scatter(
            [r["E"] / max(r["V"], 1) for r in rows],
            [r["speedup_vs_baseline"] for r in rows],
            marker=marker, label=f"dispatched: {mode}", alpha=0.8,
        )
    ax.axvline(50, color="k", lw=0.8, ls="--", label="avg deg = 50")
    ax.axhline(1.0, color="k", lw=0.5)
    ax.set_xscale("log")
    ax.set_xlabel("average degree (E/V)")
    ax.set_ylabel("speedup vs f32 library baseline")
    ax.set_title("degree-axis sweep (24-graph-suite analog)")
    ax.legend(fontsize=8)
    fig.tight_layout()
    path = os.path.join(out_dir, "degree_sweep.png")
    fig.savefig(path, dpi=120)
    return path


def plot_ksweep(data, out_dir):
    """k vs accuracy and k vs epoch time, relu arm as reference line —
    the figure `plotgnn.py:26-39` hard-codes, rendered from KSWEEP json."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = data["results"]
    pairs = sorted({(r["dataset"], r["model"]) for r in rows})
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for ds, model in pairs:
        sub = [r for r in rows if r["dataset"] == ds and r["model"] == model]
        relu = next((r for r in sub if r["arm"] == "relu"), None)
        ks = sorted(
            int(r["arm"].split("maxk_k")[1])
            for r in sub if r["arm"].startswith("maxk_k")
        )
        acc = [next(r["best_test"] for r in sub if r["arm"] == f"maxk_k{k}")
               for k in ks]
        ms = [next(r["epoch_ms"] for r in sub if r["arm"] == f"maxk_k{k}")
              for k in ks]
        relu_lib = next((r for r in sub if r["arm"] == "relu_lib"), None)
        (ln,) = axes[0].plot(ks, acc, "o-", label=f"{ds}/{model}")
        axes[1].plot(ks, ms, "o-", color=ln.get_color(),
                     label=f"{ds}/{model}")
        if relu:
            axes[0].axhline(relu["best_test"], color=ln.get_color(),
                            ls="--", lw=0.8)
            axes[1].axhline(relu["epoch_ms"], color=ln.get_color(),
                            ls="--", lw=0.8)
        if relu_lib:
            # the library-schedule relu arm — the reference's DGL
            # baseline role, what its published speedups compare against
            axes[1].axhline(relu_lib["epoch_ms"], color=ln.get_color(),
                            ls=":", lw=1.2)
    for ax, yl in zip(axes, ["best test accuracy", "epoch ms"]):
        ax.set_xscale("log", base=2)
        ax.set_xlabel("k")
        ax.set_ylabel(yl + " (dashed = relu, dotted = relu_lib)")
        ax.legend(fontsize=8)
    fig.tight_layout()
    path = os.path.join(out_dir, "ksweep.png")
    fig.savefig(path, dpi=120)
    return path


def plot_scaling(data, out_dir):
    """Sharded step time vs mesh size per arm (SCALING json)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = data["results"]
    fig, ax = plt.subplots(figsize=(6, 4))
    for arm in sorted({r["arm"] for r in rows}):
        sub = sorted((r["n"], r["step_ms"]) for r in rows if r["arm"] == arm)
        ax.plot([n for n, _ in sub], [m for _, m in sub], "o-", label=arm)
    ax.set_xlabel("mesh devices")
    ax.set_ylabel("step ms")
    ax.set_xscale("log", base=2)
    note = data.get("protocol", {}).get("platform", "")
    ax.set_title(f"sharded step scaling ({note})")
    ax.legend()
    fig.tight_layout()
    path = os.path.join(out_dir, "scaling.png")
    fig.savefig(path, dpi=120)
    return path


def plot_spgemm_study(data, out_dir):
    """Phase-stacked strategy comparison per sparsity — the role of the
    reference's AIA study figures (`gnnaia_plot2.py`, `plot_gnn2.py`),
    rendered from SPGEMM_STUDY json (single-graph dict or list)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    studies = data if isinstance(data, list) else [data]
    fig, axes = plt.subplots(
        1, len(studies), figsize=(5.5 * len(studies), 4), squeeze=False
    )
    phases = ["densify_ms", "numeric_ms", "symbolic_ms"]
    for ax, study in zip(axes[0], studies):
        recs = study["results"]
        arms = sorted(
            a for a in recs[0] if isinstance(recs[0][a], dict)
        )
        if not arms:
            # legacy flat format (SPGEMM_STUDY_r1): arm times as
            # top-level `<arm>_ms` floats with no phase split
            arms = sorted(
                a[:-3] for a in recs[0]
                if a.endswith("_ms") and isinstance(recs[0][a], float)
            )
            recs = [
                {**r, **{a: {"numeric_ms": r[f"{a}_ms"]} for a in arms}}
                for r in recs
            ]
        width = 0.8 / len(arms)
        for i, arm in enumerate(arms):
            xs = [j + i * width for j in range(len(recs))]
            bottom = [0.0] * len(recs)
            for ph in phases:
                hs = [r[arm].get(ph, 0.0) for r in recs]
                if not any(hs):
                    continue
                ax.bar(xs, hs, width=width, bottom=bottom,
                       label=f"{arm}:{ph[:-3]}" if ph != "numeric_ms"
                       else arm)
                bottom = [b + h for b, h in zip(bottom, hs)]
        ax.set_xticks(range(len(recs)))
        ax.set_xticklabels([f"s={r['sparsity']}" for r in recs])
        ax.set_ylabel("ms (stacked phases)")
        ax.set_title(f"{study['graph']} V={study['V']} E={study['E']}")
        ax.legend(fontsize=6)
    fig.tight_layout()
    path = os.path.join(out_dir, "spgemm_study.png")
    fig.savefig(path, dpi=120)
    return path


def plot_three_arms(data, out_dir):
    """Forward time of the three independent schedules per graph
    (hybrid / tiles_scan / bricks) — the GNNAdvisor-comparison figure,
    rendered from THREE_ARMS json."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    records = data["results"] if isinstance(data, dict) else data
    arms = ["hybrid", "tiles_scan", "bricks"]
    graphs = [r["graph"] for r in records]
    fig, ax = plt.subplots(figsize=(6.5, 4))
    width = 0.8 / len(arms)
    for i, arm in enumerate(arms):
        xs, ms = [], []
        for gi, r in enumerate(records):
            if f"{arm}_ms" in r:
                xs.append(gi + i * width)
                ms.append(r[f"{arm}_ms"])
        if xs:
            ax.bar(xs, ms, width=width, label=arm)
    ax.set_xticks(range(len(graphs)))
    ax.set_xticklabels(graphs, rotation=20)
    ax.set_ylabel("fwd ms (same bf16 input, each validated)")
    ax.set_title("three independent SpMM schedules")
    ax.legend()
    fig.tight_layout()
    path = os.path.join(out_dir, "three_arms.png")
    fig.savefig(path, dpi=120)
    return path


def plot_training_curves(scalars_jsonl, out_dir, tag="val_acc"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps, vals = [], []
    with open(scalars_jsonl) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag:
                steps.append(rec["step"])
                vals.append(rec["value"])
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(steps, vals)
    ax.set_xlabel("epoch")
    ax.set_ylabel(tag)
    fig.tight_layout()
    path = os.path.join(out_dir, f"train_{tag}.png")
    fig.savefig(path, dpi=120)
    return path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--kernel", default="")
    p.add_argument("--degree", default="")
    p.add_argument("--ksweep", default="")
    p.add_argument("--scaling", default="")
    p.add_argument("--study", default="")
    p.add_argument("--three_arms", default="")
    p.add_argument("--scalars", default="")
    p.add_argument("--out", default="figs")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.kernel:
        with open(args.kernel) as f:
            data = json.load(f)
        # assembled suite artifacts wrap the record list in {results: ...}
        records = data["results"] if isinstance(data, dict) else data
        print(plot_kernel_bench(records, args.out))
    if args.degree:
        with open(args.degree) as f:
            print(plot_degree_sweep(json.load(f), args.out))
    if args.ksweep:
        with open(args.ksweep) as f:
            print(plot_ksweep(json.load(f), args.out))
    if args.scaling:
        with open(args.scaling) as f:
            print(plot_scaling(json.load(f), args.out))
    if args.study:
        with open(args.study) as f:
            print(plot_spgemm_study(json.load(f), args.out))
    if args.three_arms:
        with open(args.three_arms) as f:
            print(plot_three_arms(json.load(f), args.out))
    if args.scalars:
        print(plot_training_curves(args.scalars, args.out))


if __name__ == "__main__":
    main()
