"""Graph structure checker — re-design of `graph_conn_check.py:18-…`.

The reference script analyzes Reddit's symmetry/self-loop structure to
decide whether the backward pass needs a transpose. Here that decision is
made structurally (`build_graph` autodetects A ≈ Aᵀ after normalization),
and this CLI reports the same diagnostics for any dataset or binary:

  python -m maxk_gnn.data.check --dataset flickr --scale 0.01
  python -m maxk_gnn.data.check --binary graphs/reddit
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def check_graph(csr) -> dict:
    from maxk_gnn.sparse.csr import csr_to_scipy, with_norm

    m = csr_to_scipy(csr)
    v = m.shape[0]
    deg = np.diff(m.indptr)
    asym = abs(m - m.T)
    diag = m.diagonal()
    report = {
        "num_nodes": int(v),
        "num_edges": int(m.nnz),
        "avg_degree": float(deg.mean()),
        "max_degree": int(deg.max()),
        "min_degree": int(deg.min()),
        "isolated_nodes": int((deg == 0).sum()),
        "symmetric_structure": bool((abs(m != 0).astype(int) - (m.T != 0).astype(int)).nnz == 0),
        "symmetric_values": bool(asym.nnz == 0 or float(asym.max()) < 1e-6),
        "self_loops": int((diag != 0).sum()),
        "self_loop_complete": bool(np.all(diag != 0)),
    }
    # the question that matters is per NORM MODE: right-norm breaks value
    # symmetry on symmetric structure, so report what `build_graph`'s
    # symmetric=None autodetect decides for each mode (same criterion)
    needs_t = {}
    for mode in ("none", "right", "left", "both"):
        mn = csr_to_scipy(with_norm(csr, mode))
        d = abs(mn - mn.T)
        needs_t[mode] = not (d.nnz == 0 or float(d.max()) < 1e-6)
    report["backward_needs_transpose"] = needs_t
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="")
    p.add_argument("--binary", default="", help="graph binary prefix")
    p.add_argument("--scale", type=float, default=1.0)
    args = p.parse_args(argv)
    if args.binary:
        from maxk_gnn.data.io import load_graph_binary

        csr = load_graph_binary(args.binary)
        name = args.binary
    else:
        from maxk_gnn.data.datasets import load_dataset

        data = load_dataset(args.dataset, scale=args.scale)
        csr = data.csr
        name = args.dataset
    report = {"graph": name, **check_graph(csr)}
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
