"""Degree-axis kernel sweep — the 24-graph-suite analog.

The reference benchmarks 24 graphs spanning the degree spectrum
(`kernels/main.cu:196-218`, `README.md:72-78`) and conditions its
headline speedups on avg degree > 50 (`README.md:136`). This driver
sweeps the same axis with the R-MAT family (`rmat_v<V>_d<deg>`,
`kernel_bench.load_suite`): V × avg-degree points spanning both sides of
the claim boundary, with `--dispatch_check` so every record shows
whether the dispatch rule picked the faster arm, and `--validate` so
every timing is oracle-checked.

Each graph runs in its OWN subprocess under a timeout, one at a time (one
process per card): a graph that hangs or runs out of memory costs its
timeout, not the sweep. Per-graph JSONs accumulate in
--dir; the final artifact is assembled with the avg-degree-50 split.

Usage:
  python -m maxk_gnn.bench.degree_sweep --out DEGREE_SWEEP.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# V × avg-degree grid: crosses the avg-deg-50 dispatch boundary at two
# node scales (reddit-scale 256K and 1M); degrees 5..400
DEFAULT_GRAPHS = [
    "rmat_v262144_d5",
    "rmat_v262144_d15",
    "rmat_v262144_d50",
    "rmat_v262144_d150",
    "rmat_v262144_d400",
    "rmat_v1048576_d15",
    "rmat_v1048576_d50",
    "rmat_v1048576_d120",
]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--graphs", nargs="+", default=DEFAULT_GRAPHS)
    p.add_argument("--k", nargs="+", default=["8", "64"])
    p.add_argument("--dir", default="build/degree_sweep")
    p.add_argument("--out", default="DEGREE_SWEEP.json")
    p.add_argument("--timeout", type=int, default=2400, help="per graph")
    p.add_argument("--mode", default="auto")
    p.add_argument("--no_validate", action="store_true")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--platform", default="", help="forwarded to kernel_bench")
    args = p.parse_args(argv)

    os.makedirs(args.dir, exist_ok=True)
    failed = []
    for g in args.graphs:
        out = os.path.join(args.dir, f"{g}.json")
        if os.path.exists(out):
            log(f"skip {g}: {out} exists")
            continue
        cmd = [
            sys.executable, "-m", "maxk_gnn.bench.kernel_bench",
            "--graphs", g, "--k", *args.k,
            "--scale", str(args.scale), "--mode", args.mode,
            "--dispatch_check", "--json_out", out,
        ]
        if not args.no_validate:
            cmd.append("--validate")
        if args.platform:
            cmd.extend(["--platform", args.platform])
        log(f"=== {g} (timeout {args.timeout}s)")
        try:
            r = subprocess.run(cmd, timeout=args.timeout)
            rc = r.returncode
        except subprocess.TimeoutExpired:
            rc = -1
        if rc != 0:
            failed.append({"graph": g, "rc": rc})
            log(f"FAILED {g} rc={rc}")
            # keep whatever records the incremental dump persisted

    from maxk_gnn.bench.assemble_suite import main as assemble

    assemble(["--dir", args.dir, "--out", args.out,
              "--note", "degree-axis R-MAT sweep (24-graph-suite analog)"])
    if failed:
        with open(args.out) as f:
            doc = json.load(f)
        doc["failed"] = failed
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    log(f"wrote {args.out} ({len(failed)} failures)")


if __name__ == "__main__":
    main()
