"""Merge per-graph kernel_bench JSON outputs into one suite artifact.

The suite runs one graph per process (`kernel_bench --graphs G --json_out
DIR/G.json`) so a crash, timeout or OOM only loses one graph; this stitches
the survivors into the committed artifact with a summary block comparable
to BASELINE.md (`README.md:136` reports per-k geomean speedups restricted
to avg degree > 50).

Usage: python -m maxk_gnn.bench.assemble_suite --dir DIR \
           --out BENCH_SUITE.json --note "..."
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--note", default="")
    args = p.parse_args(argv)

    records = []
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            records.extend(json.load(f))
    # auxiliary per-graph records (dispatch_check) summarize separately
    checks = [r for r in records if r.get("kind") == "dispatch_check"]
    records = [r for r in records if "k" in r]

    # consistency audit — recompute every derived field and check timing
    # invariants. This is the automated answer to the r2 record defects
    # (a 1000× unit bug in hand-patched records; "fwd+bwd" < fwd because
    # the forward was dead-code-eliminated): any record that fails is
    # flagged in the artifact itself, loudly.
    inconsistencies = []
    for r in records:
        derived = r["E"] / (r["t_fwd_ms"] * 1e-3) / 1e9
        if abs(derived - r["fwd_gnnz_s"]) > 1e-6 * max(derived, 1e-12):
            inconsistencies.append(
                {"graph": r["graph"], "k": r["k"],
                 "field": "fwd_gnnz_s",
                 "recorded": r["fwd_gnnz_s"], "recomputed": derived}
            )
        sp = r["t_baseline_ms"] / r["t_fwd_ms"]
        if abs(sp - r["speedup_vs_baseline"]) > 1e-6 * sp:
            inconsistencies.append(
                {"graph": r["graph"], "k": r["k"],
                 "field": "speedup_vs_baseline",
                 "recorded": r["speedup_vs_baseline"], "recomputed": sp}
            )
        for fb, fw in (("t_fwd_bwd_ms", "t_fwd_ms"),
                       ("t_fwd_bwd_cbsr_ms", "t_fwd_cbsr_ms")):
            if fb in r and fw in r and r[fb] < r[fw]:
                inconsistencies.append(
                    {"graph": r["graph"], "k": r["k"], "field": fb,
                     "issue": f"{fb} < {fw} (forward cannot be free)",
                     "fwd_bwd_ms": r[fb], "fwd_ms": r[fw]}
                )

    # geomean speedup per k, split on the reference's avg-degree-50 claim
    # boundary; f32 and bf16 baseline arms
    summary = {}
    for k in sorted({r["k"] for r in records}):
        for hi in (True, False):
            rows = [
                r for r in records
                if r["k"] == k and (r["E"] / max(r["V"], 1) > 50) == hi
            ]
            if not rows:
                continue
            gm = math.exp(
                sum(math.log(r["speedup_vs_baseline"]) for r in rows) / len(rows)
            )
            gm16 = math.exp(
                sum(
                    math.log(r["t_baseline_bf16_ms"] / r["t_fwd_ms"])
                    for r in rows
                ) / len(rows)
            )
            key = f"k={k} avg_deg{'>' if hi else '<='}50"
            summary[key] = {
                "n_graphs": len(rows),
                "geomean_speedup_f32_baseline": round(gm, 3),
                "geomean_speedup_bf16_baseline": round(gm16, 3),
            }

    out = {
        "protocol": {
            "dim_origin": 256,
            "timing": "4 warmup + 4 timed (kernels/spmm_base.h:34-63 analog)",
            "baseline": "library tiles_scan/segsum arm (cuSPARSE role)",
            "validated": all(r.get("valid", False) for r in records),
            "dispatch_checks": len(checks),
            "dispatch_picked_faster_everywhere": all(
                c["picked_faster"] for c in checks
            ) if checks else None,
            "note": args.note,
        },
        "consistency": {
            "ok": not inconsistencies,
            "checks": ["fwd_gnnz_s == E/t_fwd", "speedup == t_base/t_fwd",
                       "t_fwd_bwd >= t_fwd (both arms)"],
            "violations": inconsistencies,
        },
        "summary": summary,
        "results": records,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}: {len(records)} records, "
          f"validated={out['protocol']['validated']}, "
          f"consistent={not inconsistencies}")


if __name__ == "__main__":
    main()
