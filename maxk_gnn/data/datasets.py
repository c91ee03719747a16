"""Dataset registry — the 5 training datasets + synthetic fallback.

The reference loads flickr/reddit/yelp via DGL, ogbn-products/proteins via
OGB (`maxk_gnn_integrated.py:212-269`, `utils/proteins_loader.py`). Neither
library nor network access exists here, so each dataset resolves in order:

  1. real binaries under `$MAXK_DATA/<name>.indptr/.indices`
     (+ optional `.feat`/`.labels`/`.masks` float32/int32 sidecars),
  2. a seeded synthetic graph with the dataset's published (V, E, F, C)
     and label regime (multilabel for yelp/proteins).

`scale` shrinks V and E proportionally for tests (scale=1 is full size).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from maxk_gnn.data.io import load_graph_binary
from maxk_gnn.data.synthetic import planted_partition_data, rmat_graph
from maxk_gnn.sparse.csr import CSRGraph, add_self_loops


@dataclass
class DatasetSpec:
    num_nodes: int
    num_edges: int
    feat_dim: int
    num_classes: int
    multilabel: bool = False
    self_loop: bool = False  # per scripts_train/*.sh (flickr: yes)


# published stats of the reference's training datasets (README.md:160-174,
# scripts_train/*.sh hyperparameters table in SURVEY.md §3.2)
DATASETS = {
    "flickr": DatasetSpec(89_250, 899_756, 500, 7, self_loop=True),
    "reddit": DatasetSpec(232_965, 114_615_892, 602, 41),
    "yelp": DatasetSpec(716_847, 13_954_819, 300, 100, multilabel=True),
    "ogbn-products": DatasetSpec(2_449_029, 123_718_280, 100, 47),
    "ogbn-proteins": DatasetSpec(132_534, 79_122_504, 8, 112, multilabel=True),
}


@dataclass
class GraphData:
    name: str
    csr: CSRGraph  # raw adjacency (undirected, dedup, ±self-loops)
    features: np.ndarray
    labels: np.ndarray
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    multilabel: bool

    @property
    def feat_dim(self) -> int:
        return self.features.shape[1]


def _data_dir() -> Optional[str]:
    d = os.environ.get("MAXK_DATA")
    return d if d and os.path.isdir(d) else None


@functools.lru_cache(maxsize=1)
def load_dataset(
    name: str,
    scale: float = 1.0,
    seed: int = 123,
    feat_snr: float = 0.5,
    graph_kind: str = "rmat",
    sbm_p_intra: float = 0.8,
) -> GraphData:
    """`graph_kind` selects the synthetic generator (ignored for real
    binaries): "rmat" (kernel benchmarks — degree profile is what
    matters) or "sbm" (accuracy protocols — DC-SBM homophily makes
    aggregation genuinely useful; see `synthetic.dcsbm_graph`).

    `sbm_p_intra` is the DC-SBM homophily (intra-community edge
    fraction). It is the difficulty knob the accuracy protocol
    calibrates on DENSE datasets: at reddit's avg degree (~494)
    aggregation over an 0.8-homophilous neighborhood denoises any
    feat_snr (measured: relu best_val 0.9985 even at snr=0.02), so the
    relu control can only be brought into the discriminative band by
    weakening the structure itself (train.golden.ACC_PROTOCOL).

    The last result is kept in-process: two runs on one graph (the arms
    of a comparison) load it once. Treat the returned arrays as
    read-only."""
    spec = DATASETS[name]
    d = _data_dir()
    prefix = os.path.join(d, name) if d else None
    if scale == 1.0 and prefix and os.path.exists(prefix + ".indptr"):
        csr = load_graph_binary(prefix)
        if spec.self_loop:
            csr = add_self_loops(csr)
        feats, labels, masks = _load_sidecars(prefix, csr, spec, seed)
    else:
        v = max(int(spec.num_nodes * scale), 64)
        e = max(int(spec.num_edges * scale), 256)
        labels_init = None
        if graph_kind == "sbm":
            from maxk_gnn.data.synthetic import dcsbm_graph

            csr, labels_init = dcsbm_graph(
                v, e, spec.num_classes, p_intra=sbm_p_intra, seed=seed
            )
        elif graph_kind == "rmat":
            csr = rmat_graph(v, e, seed=seed)
        else:
            raise ValueError(f"unknown graph_kind {graph_kind!r}")
        feats, labels, masks = planted_partition_data(
            csr, spec.feat_dim, spec.num_classes, seed=seed,
            multilabel=spec.multilabel, feat_snr=feat_snr,
            labels_init=labels_init,
        )
        if name == "ogbn-proteins":
            # the proteins regime has EDGE features only; node features
            # are the incident-edge sum (`utils/proteins_loader.py:42-44`).
            # Color synthetic edge features by their endpoints' community
            # features so the task stays learnable through the pathway.
            import numpy as _np

            from maxk_gnn.data.proteins import node_features_from_edges

            rows = _np.asarray(csr.row_ids())
            cols = _np.asarray(csr.indices)
            rng = _np.random.default_rng(seed + 1)
            edge_feats = 0.5 * (feats[rows] + feats[cols]) + 0.25 * rng.standard_normal(
                (csr.nnz, spec.feat_dim)
            ).astype(np.float32)
            deg = _np.maximum(_np.diff(_np.asarray(csr.indptr)), 1)
            feats = _np.asarray(
                node_features_from_edges(csr, edge_feats.astype(np.float32))
            ) / deg[:, None]
    return GraphData(
        name=name,
        csr=csr,
        features=feats,
        labels=labels,
        train_mask=masks[0],
        val_mask=masks[1],
        test_mask=masks[2],
        num_classes=spec.num_classes,
        multilabel=spec.multilabel,
    )


def _load_sidecars(prefix: str, csr: CSRGraph, spec: DatasetSpec, seed: int):
    v = csr.num_nodes
    fpath, lpath, mpath = prefix + ".feat", prefix + ".labels", prefix + ".masks"
    if os.path.exists(fpath) and os.path.exists(lpath):
        feats = np.fromfile(fpath, dtype=np.float32).reshape(v, spec.feat_dim)
        if spec.multilabel:
            labels = np.fromfile(lpath, dtype=np.float32).reshape(
                v, spec.num_classes
            )
        else:
            labels = np.fromfile(lpath, dtype=np.int32)
        if os.path.exists(mpath):
            m = np.fromfile(mpath, dtype=np.int8).reshape(3, v).astype(bool)
            masks = (m[0], m[1], m[2])
        else:
            masks = _random_split(v, seed)
        return feats, labels, masks
    # graph is real but features aren't — synthesize the rest
    feats, labels, masks = planted_partition_data(
        csr, spec.feat_dim, spec.num_classes, seed=seed,
        multilabel=spec.multilabel,
    )
    return feats, labels, masks


def _random_split(v: int, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    order = rng.permutation(v)
    tm = np.zeros(v, dtype=bool)
    vm = np.zeros(v, dtype=bool)
    sm = np.zeros(v, dtype=bool)
    tm[order[: int(0.6 * v)]] = True
    vm[order[int(0.6 * v) : int(0.8 * v)]] = True
    sm[order[int(0.8 * v) :]] = True
    return tm, vm, sm
