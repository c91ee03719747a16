"""Golden-accuracy regression thresholds (VERDICT r3 #6).

The reference's ultimate test is end-to-end accuracy per dataset at the
published configs (`maxk_gnn_integrated.py:156-175`, `scripts_train/*.sh`
hyperparameters). Real dataset binaries are unobtainable in this
environment (zero egress; they drop in via `$MAXK_DATA`,
round-trip-tested in tests/test_data.py), so the regression floor is
pinned on the calibrated synthetic protocol instead: a DC-SBM graph at
the dataset's shape (homophilous communities + power-law hubs —
aggregation genuinely helps, like the real datasets; see
`synthetic.dcsbm_graph` for why R-MAT cannot serve the accuracy axis)
+ planted features at a per-dataset calibrated feat_snr, trained with
each dataset's PUBLISHED architecture (hidden/layers/dropout from
scripts_train/*.sh) at a CPU-feasible scale. Learning rates are the
published ones except where a config is unstable at synthetic scale
(reddit: relu diverges at the published 0.01, maxk stalls at 0.001 —
each golden row pins ITS OWN stable operating point; see the GOLDEN
table comments). Cross-arm comparisons are KSWEEP's job, where arms
share one calibrated lr; golden rows are per-config regression floors.

Each entry's `min_val` was measured by `python -m maxk_gnn.train.golden
--measure` (deterministic seeds) minus a 0.04 safety margin; the test
(tests/test_golden.py) retrains every config and asserts best-val ≥
min_val, so an accuracy regression in any layer of the stack — kernels,
autograd, models, optimizer, data pipeline — fails CI loudly. When the
real binaries are dropped in, the same harness reruns at scale=1.0 with
the reference's published accuracies as the thresholds.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass


@dataclass(frozen=True)
class GoldenConfig:
    dataset: str
    model: str
    nonlinear: str  # maxk | relu
    maxk: int
    hidden_dim: int
    hidden_layers: int
    lr: float
    dropout: float
    epochs: int
    scale: float
    min_val: float  # measured - 0.04 margin; 0.0 = not yet calibrated
    # task overrides (default: ACC_PROTOCOL). A regression FLOOR needs a
    # learnable task with a stable measured value at its (small) CPU
    # scale; a sweep CONTROL needs discrimination at the sweep scale —
    # where those conflict (reddit: the r5-calibrated discriminative
    # task p_intra=0.3/snr=0.05 collapses to ~chance at golden's
    # scale=0.004, measured 0.06-0.09), the golden row pins ITS OWN
    # task and the sweep keeps ACC_PROTOCOL.
    feat_snr: float = 0.0  # 0 = ACC_PROTOCOL value
    p_intra: float = -1.0  # <0 = ACC_PROTOCOL value (default 0.8)


# the accuracy-axis protocol, shared with bench/ksweep: per-dataset
# (feat_snr, lr, and optionally the DC-SBM homophily p_intra) calibrated
# so the relu CONTROL lands in a discriminative band (0.3–0.95) on the
# DC-SBM graph at protocol scale. Both golden and ksweep read this so
# the two artifacts measure the same task.
#
# reddit needs the p_intra knob: at its density (avg degree ~494 at
# protocol scale) aggregation over an 0.8-homophilous neighborhood
# denoises ANY feature snr (CPU probes: relu 0.9994 at snr=0.05, 0.9985
# at 0.02) — a saturated reddit control cannot be fixed by snr alone;
# the structure itself must weaken. Reddit calibrated by a CPU grid:
# p_intra=0.3, snr=0.05 puts the relu control at val 0.564 — mid-band,
# vs 0.9998 at p_intra 0.8, snr 0.15.
ACC_PROTOCOL = {
    "flickr": {"feat_snr": 0.15, "lr": 0.001},
    "reddit": {"feat_snr": 0.05, "lr": 0.001, "p_intra": 0.3},
    "yelp": {"feat_snr": 0.5, "lr": 0.001},
    "ogbn-products": {"feat_snr": 0.5, "lr": 0.003},
    "ogbn-proteins": {"feat_snr": 0.15, "lr": 0.01},
}
GRAPH_KIND = "sbm"

# published per-dataset architecture (reference scripts_train/*.sh via
# SURVEY §3.2: reddit 4x256 do .5 | flickr 3x256 .2 | yelp 4x384 .1 |
# products 3x256 .5 | proteins 3x256 .5) at CPU-feasible scales; lr from
# ACC_PROTOCOL. min_val measured 2026-08-19 on the cpu backend (seed 97,
# data seed 123, --measure: reddit maxk 0.597/relu 0.683, flickr
# 0.963/0.969, yelp 0.262/0.399, products 1.0/1.0, proteins 0.626/0.526)
# minus a ~0.04 margin.
GOLDEN = [
    # reddit maxk runs at lr 0.01: each golden row is a regression floor
    # for ITS OWN stable operating point (maxk at lr 0.001 sits at 0.09
    # after 120 epochs — a noise-region floor detects nothing; measured
    # 0.60 at lr 0.01). Cross-arm comparisons live in KSWEEP, where the
    # arms share one calibrated lr. Task pinned at the r4 point
    # (snr 0.15, p_intra 0.8): see GoldenConfig field docs.
    GoldenConfig("reddit", "sage", "maxk", 32, 256, 4, 0.01, 0.5, 120, 0.004, 0.56,
                 feat_snr=0.15, p_intra=0.8),
    GoldenConfig("reddit", "sage", "relu", 32, 256, 4, 0.001, 0.5, 120, 0.004, 0.64,
                 feat_snr=0.15, p_intra=0.8),
    GoldenConfig("flickr", "sage", "maxk", 32, 256, 3, 0.001, 0.2, 150, 0.05, 0.92),
    GoldenConfig("flickr", "sage", "relu", 32, 256, 3, 0.001, 0.2, 150, 0.05, 0.92),
    GoldenConfig("yelp", "sage", "maxk", 32, 384, 4, 0.001, 0.1, 120, 0.004, 0.22),
    GoldenConfig("yelp", "sage", "relu", 32, 384, 4, 0.001, 0.1, 120, 0.004, 0.35),
    GoldenConfig("ogbn-products", "sage", "maxk", 32, 256, 3, 0.003, 0.5, 120, 0.0004, 0.96),
    GoldenConfig("ogbn-products", "sage", "relu", 32, 256, 3, 0.003, 0.5, 120, 0.0004, 0.96),
    GoldenConfig("ogbn-proteins", "sage", "maxk", 32, 256, 3, 0.01, 0.5, 100, 0.002, 0.58),
    GoldenConfig("ogbn-proteins", "sage", "relu", 32, 256, 3, 0.01, 0.5, 100, 0.002, 0.48),
]

SEED = 97
DATA_SEED = 123


def run_golden(gc: GoldenConfig):
    """Train one golden config; returns (best_val, best_test)."""
    from maxk_gnn.data.datasets import load_dataset
    from maxk_gnn.train.config import TrainConfig
    from maxk_gnn.train.loop import train

    proto = ACC_PROTOCOL[gc.dataset]
    snr = gc.feat_snr or proto["feat_snr"]
    p_intra = gc.p_intra if gc.p_intra >= 0 else proto.get("p_intra", 0.8)
    data = load_dataset(
        gc.dataset, scale=gc.scale, seed=DATA_SEED, feat_snr=snr,
        graph_kind=GRAPH_KIND, sbm_p_intra=p_intra,
    )
    cfg = TrainConfig(
        dataset=gc.dataset, model=gc.model, epochs=gc.epochs, lr=gc.lr,
        hidden_dim=gc.hidden_dim, hidden_layers=gc.hidden_layers,
        nonlinear=gc.nonlinear, maxk=gc.maxk, dropout=gc.dropout,
        seed=SEED, data_scale=gc.scale, feat_snr=snr,
    )
    state = train(cfg, data, logger=None, writer=None)
    return state.best_val, state.best_test


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--measure", action="store_true",
                   help="train every golden config and print measured "
                   "best-val (threshold calibration)")
    p.add_argument("--platform", default="cpu")
    args = p.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    rows = []
    for gc in GOLDEN:
        bv, bt = run_golden(gc)
        rows.append({
            "dataset": gc.dataset, "model": gc.model,
            "nonlinear": gc.nonlinear, "best_val": round(bv, 4),
            "best_test": round(bt, 4), "min_val": gc.min_val,
            "ok": bv >= gc.min_val,
        })
        print(f"{gc.dataset:14s} {gc.model} {gc.nonlinear:4s} "
              f"val {bv:.4f} test {bt:.4f} (floor {gc.min_val})",
              file=sys.stderr, flush=True)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
