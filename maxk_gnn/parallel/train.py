"""Sharded (multi-chip) training step over a `jax.sharding.Mesh`.

The whole model runs inside `jax.shard_map`: parameters replicated, node
features/labels/masks row-partitioned, the graph as stacked per-shard CSR
blocks. Aggregation collectives (compressed all_gather / psum_scatter)
live inside the ops (`maxk_gnn.ops.spgemm`); this module adds the loss
psum and the gradient psum that make the step SPMD-correct.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from maxk_gnn.data.datasets import GraphData
from maxk_gnn.models.models import build_model
from maxk_gnn.ops.dispatch import KernelMode, choose_mode
from maxk_gnn.parallel.mesh import GRAPH_AXIS
from maxk_gnn.parallel.shard import ShardedGraph, build_sharded_graph, shard_rows
from maxk_gnn.train.config import TrainConfig
from maxk_gnn.train.optim import build_optimizer


def _local_masked_loss(logits, labels, mask, multilabel: bool, axis: str):
    """LOCAL loss contribution with the GLOBAL mask count as denominator.

    Deliberately no psum on the numerator: inside shard_map (check_vma
    off) the transpose of psum is psum, which would inflate cotangents by
    the axis size. Per-device grads of this local partial are summed with
    one explicit psum(grads) after autodiff — the collectives inside the
    aggregation ops already route cross-device cotangents correctly.
    """
    w = mask.astype(jnp.float32)
    if multilabel:
        per = optax.sigmoid_binary_cross_entropy(logits, labels).mean(-1)
    else:
        per = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    c = jax.lax.stop_gradient(jax.lax.psum(w.sum(), axis))
    return (per * w).sum() / jnp.maximum(c, 1.0)


def make_sharded_train_step(model, tx, multilabel: bool, mesh: Mesh):
    axis = GRAPH_AXIS

    def local_step(variables, opt_state, rng, sgraph, feats, labels, mask):
        rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
        params = variables["params"]

        def loss_of(p):
            logits = model.apply(
                {"params": p}, sgraph, feats, train=True, rngs={"dropout": rng}
            )
            return _local_masked_loss(logits, labels, mask, multilabel, axis), logits

        (loss, logits), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        grads = jax.lax.psum(grads, axis)
        loss = jax.lax.psum(loss, axis)  # report the global loss
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return {"params": params}, opt_state, loss, logits

    graph_spec = P(axis)  # leading stacked-shard axis of every graph array
    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P(), P(), graph_spec, P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P(), P(axis)),
        check_vma=False,
    )
    return jax.jit(step)


def make_sharded_eval_step(model, multilabel: bool, mesh: Mesh, metric: str = "f1"):
    axis = GRAPH_AXIS

    def local_eval(variables, sgraph, feats, labels, masks):
        logits = model.apply(variables, sgraph, feats, train=False)
        if metric == "rocauc":
            # rank-based ROC-AUC needs global ranks: gather the (small)
            # logits/labels/mask rows and reuse the single-device metric
            # (ogbn-proteins: V×112 ≈ 50 MB gathered — fine per eval)
            from maxk_gnn.train.metrics import rocauc

            lg = jax.lax.all_gather(logits, axis, tiled=True)
            lb = jax.lax.all_gather(labels, axis, tiled=True)
            return tuple(
                rocauc(lg, lb, jax.lax.all_gather(m, axis, tiled=True))
                for m in masks
            )
        out = []
        for m in masks:
            w = m.astype(jnp.float32)
            if multilabel:
                pred = (logits > 0).astype(jnp.float32) * w[:, None]
                lab = (labels > 0.5).astype(jnp.float32) * w[:, None]
                tp = jax.lax.psum((pred * lab).sum(), axis)
                fp = jax.lax.psum((pred * (1 - lab)).sum(), axis)
                fn = jax.lax.psum(((1 - pred) * lab * w[:, None]).sum(), axis)
                out.append(2 * tp / jnp.maximum(2 * tp + fp + fn, 1.0))
            else:
                pred = jnp.argmax(logits, -1)
                corr = jax.lax.psum(((pred == labels) * w).sum(), axis)
                cnt = jax.lax.psum(w.sum(), axis)
                out.append(corr / jnp.maximum(cnt, 1.0))
        return tuple(out)

    step = jax.shard_map(
        local_eval,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(),) * 3,
        check_vma=False,
    )
    return jax.jit(step)


def sharded_setup(
    cfg: TrainConfig, data: GraphData, mesh: Mesh
) -> Tuple[Any, Dict[str, Any], Any, ShardedGraph, Dict[str, jax.Array], Any]:
    """Build (model, variables, opt_state, sharded graph, device arrays).

    Arrays are placed with NamedShardings so the jitted shard_map step
    runs without resharding transfers.
    """
    n = mesh.devices.size
    compute_dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    model, gnorm = build_model(
        cfg.model,
        out_dim=data.num_classes,
        hidden_dim=cfg.hidden_dim,
        num_layers=cfg.hidden_layers,
        maxk=cfg.maxk,
        nonlinear=cfg.nonlinear,
        dropout=cfg.dropout,
        norm=cfg.norm,
        kernel_mode=cfg.kernel_mode,
        compute_dtype=compute_dtype,
    )
    # the one dispatch rule (ops/dispatch.choose_mode), per device's rows.
    # The sharded builder needs the degree-permuted CSR up front, so the
    # permutation (and matching node-data permutation) happens here.
    mode = choose_mode(
        cfg.kernel_mode, data.csr, cfg.hidden_dim, compute_dtype,
        num_shards=n, device=mesh.devices.flat[0],
    )
    want_hybrid = mode == KernelMode.HYBRID
    csr = data.csr
    if want_hybrid:
        from maxk_gnn.sparse.hybrid import check_hybrid_ok, degree_perm, permute_csr

        if not check_hybrid_ok(csr) and cfg.kernel_mode == "hybrid":
            # same contract as the single-device path (_spmm_impl raises
            # for an explicit hybrid request without a strip schedule):
            # never silently downgrade an explicit kernel_mode
            raise ValueError(
                "kernel_mode='hybrid' requires a value-symmetric "
                "(undirected) graph; use kernel_mode='auto' for "
                "automatic fallback"
            )
        if check_hybrid_ok(csr):
            from dataclasses import replace

            perm = degree_perm(csr)
            csr = permute_csr(csr, perm)
            data = replace(
                data,
                features=np.asarray(data.features)[perm],
                labels=np.asarray(data.labels)[perm],
                train_mask=np.asarray(data.train_mask)[perm],
                val_mask=np.asarray(data.val_mask)[perm],
                test_mask=np.asarray(data.test_mask)[perm],
            )
        else:
            want_hybrid = False  # directed graph: strip symmetry unavailable
    build_tiles = mode in (KernelMode.TILES_XLA, KernelMode.TILES_SCAN)
    sgraph = build_sharded_graph(
        csr,
        n,
        norm=gnorm,
        build_tiles=build_tiles and not want_hybrid,
        row_block=cfg.row_block,
        edge_tile=cfg.edge_tile,
        hybrid=want_hybrid,
        dim=cfg.hidden_dim,
    )

    row = NamedSharding(mesh, P(GRAPH_AXIS))
    rep = NamedSharding(mesh, P())
    feats = jax.device_put(shard_rows(data.features, n), row)
    if data.multilabel:
        labels = jax.device_put(
            shard_rows(data.labels.astype(np.float32), n), row
        )
    else:
        labels = jax.device_put(shard_rows(data.labels.astype(np.int32), n), row)
    masks = {
        name: jax.device_put(shard_rows(m, n, fill=False), row)
        for name, m in (
            ("train", data.train_mask),
            ("val", data.val_mask),
            ("test", data.test_mask),
        )
    }
    sgraph = jax.tree.map(
        lambda x: jax.device_put(x, row) if hasattr(x, "shape") else x, sgraph
    )

    # init on a tiny single-device identity graph: parameter shapes depend
    # only on feature widths, and ops with a ShardedGraph need bound axis
    # names (shard_map), which model.init doesn't have
    from maxk_gnn.sparse.csr import CSRGraph
    from maxk_gnn.sparse.graph import build_graph as _build_graph

    nv = 16
    # tiles (and, when requested, a strip schedule) built too so any
    # explicit kernel_mode can init
    eye = _build_graph(
        CSRGraph(
            indptr=jnp.arange(nv + 1, dtype=jnp.int32),
            indices=jnp.arange(nv, dtype=jnp.int32),
            values=jnp.ones((nv,), jnp.float32),
        ),
        norm="none",
        build_tiles=True,
        symmetric=True,
        hybrid=cfg.kernel_mode == "hybrid",
    )
    rng = jax.random.PRNGKey(cfg.seed)
    with jax.default_device(jax.devices()[0]):
        variables = model.init(
            {"params": rng, "dropout": rng},
            eye,
            jnp.asarray(data.features[:nv]),
            train=False,
        )
    variables = jax.device_put(variables, rep)
    tx = build_optimizer(
        cfg.lr, cfg.weight_decay, cfg.enable_lookahead, lookahead_k=cfg.w_lookahead
    )
    opt_state = jax.device_put(tx.init(variables["params"]), rep)
    arrays = {"feats": feats, "labels": labels, **masks}
    return model, dict(variables), opt_state, sgraph, arrays, tx
