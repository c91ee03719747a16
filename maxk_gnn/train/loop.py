"""Full-graph training loop — re-design of `maxk_gnn_integrated.py:96-183`.

Same protocol as the reference driver: full-graph forward, masked loss
(CE single-label / BCE multilabel), Adam(+Lookahead), per-epoch full
evaluate on train/val/test masks, best-val model tracking, fwd/bwd timing
after a warmup epoch threshold. torch.autograd/cuda-event machinery is
replaced by one jitted train step + `jax.block_until_ready` timing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from maxk_gnn.data.datasets import GraphData
from maxk_gnn.models.models import build_model
from maxk_gnn.ops.dispatch import KernelMode, choose_mode, resolve_mode
from maxk_gnn.sparse.graph import Graph, build_graph
from maxk_gnn.train.config import TrainConfig
from maxk_gnn.train.metrics import compute_micro_f1, rocauc
from maxk_gnn.train.optim import build_optimizer


@dataclass
class TrainState:
    variables: Dict[str, Any]
    opt_state: Any
    model: Any
    tx: Any
    graph: Graph
    rng: jax.Array
    kernel_mode: str = ""  # the aggregation kernel the graph was built for
    best_val: float = 0.0
    best_test: float = 0.0
    epoch_times: list = field(default_factory=list)  # every step, seconds
    losses: list = field(default_factory=list)


def _loss_fn(logits, labels, mask, multilabel: bool):
    w = mask.astype(jnp.float32)
    if multilabel:
        per = optax.sigmoid_binary_cross_entropy(logits, labels).mean(-1)
    else:
        per = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    return (per * w).sum() / jnp.maximum(w.sum(), 1.0)


def permuted_data(data: GraphData, graph: Graph) -> GraphData:
    """Hybrid graphs live in degree-permuted node space: permute every
    per-node array to match (metrics/masks are permutation-invariant).
    Identity when the graph carries no permutation."""
    if graph.perm is None:
        return data
    from dataclasses import replace

    perm = np.asarray(graph.perm)
    return replace(
        data,
        features=np.asarray(data.features)[perm],
        labels=np.asarray(data.labels)[perm],
        train_mask=np.asarray(data.train_mask)[perm],
        val_mask=np.asarray(data.val_mask)[perm],
        test_mask=np.asarray(data.test_mask)[perm],
    )


def setup(cfg: TrainConfig, data: GraphData) -> TrainState:
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
    mode = choose_mode(cfg.kernel_mode, data.csr, cfg.hidden_dim, compute_dtype)
    graph = build_graph(
        data.csr,
        norm=gnorm,
        build_tiles=mode in (KernelMode.TILES_XLA, KernelMode.TILES_SCAN),
        row_block=cfg.row_block,
        edge_tile=cfg.edge_tile,
        hybrid=mode in (KernelMode.HYBRID, KernelMode.HYBRID_INT8),
        dim=cfg.hidden_dim,
    )
    data = permuted_data(data, graph)
    rng = jax.random.PRNGKey(cfg.seed)
    feats = jnp.asarray(data.features)
    variables = model.init(
        {"params": rng, "dropout": rng}, graph, feats, train=False
    )
    tx = build_optimizer(
        cfg.lr,
        cfg.weight_decay,
        cfg.enable_lookahead,
        lookahead_k=cfg.w_lookahead,
    )
    opt_state = tx.init(variables["params"])
    return TrainState(
        variables=dict(variables),
        opt_state=opt_state,
        model=model,
        tx=tx,
        graph=graph,
        rng=rng,
        kernel_mode=resolve_mode(
            mode, graph.tiles is not None, graph.hybrid is not None
        ).value,
    )


def make_train_step(model, tx, multilabel: bool):
    @jax.jit
    def train_step(variables, opt_state, rng, graph, feats, labels, mask):
        params = variables["params"]
        extra = {k: v for k, v in variables.items() if k != "params"}
        has_bs = "batch_stats" in extra

        def loss_of(p):
            vs = {"params": p, **extra}
            if has_bs:
                logits, upd = model.apply(
                    vs,
                    graph,
                    feats,
                    train=True,
                    rngs={"dropout": rng},
                    mutable=["batch_stats"],
                )
            else:
                logits = model.apply(
                    vs, graph, feats, train=True, rngs={"dropout": rng}
                )
                upd = {}
            return _loss_fn(logits, labels, mask, multilabel), (logits, upd)

        (loss, (logits, upd)), grads = jax.value_and_grad(
            loss_of, has_aux=True
        )(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        new_vars = {"params": params, **extra, **upd}
        return new_vars, opt_state, loss, logits

    return train_step


def make_eval_step(model, multilabel: bool, metric: str = "f1"):
    @jax.jit
    def eval_step(variables, graph, feats, labels, masks):
        logits = model.apply(variables, graph, feats, train=False)
        fn = rocauc if metric == "rocauc" else compute_micro_f1
        return tuple(fn(logits, labels, m) for m in masks)

    return eval_step


def evaluate(state: TrainState, data: GraphData, metric: Optional[str] = None):
    metric = metric or ("rocauc" if data.name == "ogbn-proteins" else "f1")
    eval_step = make_eval_step(state.model, data.multilabel, metric)
    data = permuted_data(data, state.graph)
    feats = jnp.asarray(data.features)
    labels = jnp.asarray(data.labels)
    masks = (
        jnp.asarray(data.train_mask),
        jnp.asarray(data.val_mask),
        jnp.asarray(data.test_mask),
    )
    return tuple(float(x) for x in eval_step(state.variables, state.graph, feats, labels, masks))


def _ckpt_payload(state: TrainState, epoch: int) -> Dict[str, Any]:
    return {
        "variables": state.variables,
        "opt_state": state.opt_state,
        "epoch": epoch,
        "best_val": state.best_val,
        "best_test": state.best_test,
    }


def train(
    cfg: TrainConfig,
    data: GraphData,
    logger=None,
    writer=None,
    warmup_epochs: int = 10,
    checkpoint_dir: str = "",
) -> TrainState:
    """Run the full training loop; returns the final state with best-val
    tracking (`maxk_gnn_integrated.py:156-175`).

    With `cfg.checkpoint_every > 0` and a `checkpoint_dir`, saves
    (params, opt_state, epoch, best metrics) periodically and RESUMES
    from the latest checkpoint on restart — the capability the reference
    declared but never wired (`utils/config.py:55-56` unused
    `--evaluate`, no mid-training resume)."""
    state = setup(cfg, data)
    if logger:
        logger.info(f"kernel mode: {cfg.kernel_mode} -> {state.kernel_mode}")
    start_epoch = 0
    if checkpoint_dir and cfg.checkpoint_every > 0:
        from maxk_gnn.train.checkpoint import latest_checkpoint, restore_checkpoint

        path = latest_checkpoint(checkpoint_dir)
        if path:
            # full variables (incl. batch_stats for gnn_res) round-trip;
            # the RNG needs no payload entry because per-epoch keys are
            # fold_in(base, epoch) — resuming at epoch N replays the
            # exact dropout stream of an uninterrupted run
            payload = {
                "variables": state.variables,
                "opt_state": state.opt_state,
                "epoch": 0,
                "best_val": 0.0,
                "best_test": 0.0,
            }
            restored = restore_checkpoint(path, payload)
            state.variables = restored["variables"]
            state.opt_state = restored["opt_state"]
            start_epoch = int(restored["epoch"]) + 1
            state.best_val = float(restored["best_val"])
            state.best_test = float(restored["best_test"])
            if logger:
                logger.info(f"resumed from {path} at epoch {start_epoch}")
    metric = "rocauc" if data.name == "ogbn-proteins" else "f1"
    train_step = make_train_step(state.model, state.tx, data.multilabel)
    eval_step = make_eval_step(state.model, data.multilabel, metric)

    if cfg.validate_kernels and cfg.nonlinear == "maxk":
        # --validate_kernels (utils/config.py:68-69): selected kernel vs
        # the segment-sum oracle before training starts
        from maxk_gnn.bench.kernel_bench import validate_graph
        from maxk_gnn.sparse.cbsr import maxk_cbsr

        xs = jnp.asarray(data.features[:, : cfg.hidden_dim])
        if xs.shape[1] < cfg.hidden_dim:
            xs = jnp.pad(xs, ((0, 0), (0, cfg.hidden_dim - xs.shape[1])))
        ok, detail = validate_graph(
            state.graph, maxk_cbsr(xs, cfg.maxk), cfg.hidden_dim, cfg.kernel_mode
        )
        if logger:
            logger.info(f"kernel validation: ok={ok} {detail}")
        if not ok:
            raise RuntimeError(f"kernel validation failed: {detail}")

    data = permuted_data(data, state.graph)
    feats = jnp.asarray(data.features)
    labels = jnp.asarray(data.labels)
    tmask = jnp.asarray(data.train_mask)
    masks = (tmask, jnp.asarray(data.val_mask), jnp.asarray(data.test_mask))

    log = logger.info if logger else (lambda *_: None)

    fwd_only = None
    if cfg.profile_kernels:
        # --profile_kernels (utils/config.py:70-71): separate fwd timing,
        # the role of the reference's cuda-event fwd/bwd split
        # (maxk_gnn_integrated.py:119-151)
        fwd_only = jax.jit(
            lambda v: state.model.apply(v, state.graph, feats, train=False)
        )

    for epoch in range(start_epoch, cfg.epochs):
        step_rng = jax.random.fold_in(state.rng, epoch)
        t0 = time.perf_counter()
        state.variables, state.opt_state, loss, _ = train_step(
            state.variables, state.opt_state, step_rng, state.graph,
            feats, labels, tmask,
        )
        jax.block_until_ready(loss)
        dt = time.perf_counter() - t0
        state.epoch_times.append(dt)
        if epoch >= warmup_epochs:
            if fwd_only is not None and epoch % 10 == 0:
                t1 = time.perf_counter()
                jax.block_until_ready(fwd_only(state.variables))
                log(
                    f"  profile: fwd {1e3*(time.perf_counter()-t1):.2f} ms "
                    f"of {dt*1e3:.2f} ms step"
                )
        # one host fetch for loss + the three metrics
        loss, tr, va, te = (
            float(q) for q in jax.device_get(
                (loss,)
                + tuple(
                    eval_step(state.variables, state.graph, feats, labels, masks)
                )
            )
        )
        state.losses.append(loss)
        improved = va > state.best_val
        if improved:
            state.best_val, state.best_test = va, te
            # best/ is written whenever a checkpoint_dir exists —
            # checkpoint_every=0 means "only final/best" (config.py), so
            # it must not gate the best snapshot, only the periodic ones
            if checkpoint_dir:
                from maxk_gnn.train.checkpoint import save_best

                save_best(checkpoint_dir, _ckpt_payload(state, epoch))
        if writer is not None:
            writer.add_scalar("loss", float(loss), epoch)
            writer.add_scalar("train_acc", tr, epoch)
            writer.add_scalar("val_acc", va, epoch)
            writer.add_scalar("test_acc", te, epoch)
        log(
            f"epoch {epoch:05d} | loss {float(loss):.4f} | train {tr:.4f} "
            f"| val {va:.4f} | test {te:.4f} | {dt*1e3:.1f} ms"
        )
        if (
            checkpoint_dir
            and cfg.checkpoint_every > 0
            and (epoch + 1) % cfg.checkpoint_every == 0
        ):
            from maxk_gnn.train.checkpoint import save_checkpoint

            save_checkpoint(
                checkpoint_dir, _ckpt_payload(state, epoch), step=epoch
            )
    if len(state.epoch_times) > warmup_epochs:
        log(
            f"avg epoch time (post-warmup): "
            f"{1e3*np.mean(state.epoch_times[warmup_epochs:]):.2f} ms"
        )
    log(f"best val {state.best_val:.4f} | best test {state.best_test:.4f}")
    return state
