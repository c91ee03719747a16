"""Dataset → kernel-binary exporter CLI.

Re-design of `dataset_gen.py:15-233`: load a dataset, normalize the graph
(undirected + dedup + optional self-loops), and write the reference's
binary format (`.indptr/.indices` int32 + sidecars) plus a verification
pass (`dataset_gen.py:185-225`).

  python -m maxk_gnn.data.export --dataset flickr --out graphs/
  python -m maxk_gnn.data.export --all --out graphs/ --scale 0.01
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def export_dataset(name: str, out_dir: str, scale: float = 1.0, seed: int = 123):
    from maxk_gnn.data.datasets import load_dataset
    from maxk_gnn.data.io import load_graph_binary, save_graph_binary

    data = load_dataset(name, scale=scale, seed=seed)
    prefix = os.path.join(out_dir, name if scale == 1.0 else f"{name}_x{scale}")
    save_graph_binary(
        prefix,
        np.asarray(data.csr.indptr),
        np.asarray(data.csr.indices),
        np.asarray(data.csr.values),
    )
    data.features.astype(np.float32).tofile(prefix + ".feat")
    if data.multilabel:
        data.labels.astype(np.float32).tofile(prefix + ".labels")
    else:
        data.labels.astype(np.int32).tofile(prefix + ".labels")
    masks = np.stack([data.train_mask, data.val_mask, data.test_mask]).astype(
        np.int8
    )
    masks.tofile(prefix + ".masks")

    # verification pass (dataset_gen.py:185-225 role)
    g2 = load_graph_binary(prefix)
    assert g2.num_nodes == data.csr.num_nodes
    assert g2.nnz == data.csr.nnz
    np.testing.assert_array_equal(
        np.asarray(g2.indices), np.asarray(data.csr.indices)
    )
    print(
        f"exported {name}: V={g2.num_nodes} E={g2.nnz} -> {prefix}.*",
        file=sys.stderr,
    )
    return prefix


def main(argv=None):
    from maxk_gnn.data.datasets import DATASETS

    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", required=True)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=123)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    names = list(DATASETS) if args.all else [args.dataset]
    for name in names:
        export_dataset(name, args.out, args.scale, args.seed)


if __name__ == "__main__":
    main()
