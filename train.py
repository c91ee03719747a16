#!/usr/bin/env python
"""Training CLI — the `maxk_gnn_integrated.py` driver analog.

  python train.py --dataset reddit --model sage --maxk 32 --epochs 3000
  python train.py --dataset flickr --model gcn --nonlinear relu ...
  python train.py --dataset reddit --mesh_shape 8 ...   (sharded)

Experiment artifacts land in `{path}/{dataset}_seed{seed}/{model}_{nonlinear}`
(reference layout, `scripts_train/*.sh`).
"""

import os

import jax
import numpy as np


def main(argv=None):
    """Run one training job; returns the final `TrainState` (single
    device) or the sharded run's summary dict (`--mesh_shape N`)."""
    from maxk_gnn.data.datasets import load_dataset
    from maxk_gnn.runtime import enable_compile_cache
    from maxk_gnn.train.config import parse_args
    from maxk_gnn.train.logging import ScalarWriter, experiment_dir, get_logger

    cfg = parse_args(argv)
    enable_compile_cache()
    exp = experiment_dir(cfg)
    logger = get_logger(os.path.join(exp, "train.log"))
    writer = ScalarWriter(exp)
    logger.info(f"config: {cfg}")
    logger.info(f"devices: {jax.devices()}")

    np.random.seed(cfg.seed)
    data = load_dataset(
        cfg.dataset, scale=cfg.data_scale, seed=123, feat_snr=cfg.feat_snr
    )
    logger.info(
        f"dataset {cfg.dataset}: V={data.csr.num_nodes} E={data.csr.nnz} "
        f"F={data.feat_dim} C={data.num_classes} multilabel={data.multilabel}"
    )

    if cfg.mesh_shape > 1:
        out = run_sharded(cfg, data, logger, writer)
    else:
        out = run_single(cfg, data, logger, writer, exp)
    writer.close()
    return out


def run_single(cfg, data, logger, writer, exp):
    from maxk_gnn.train.checkpoint import restore_checkpoint, save_checkpoint
    from maxk_gnn.train.loop import evaluate, setup, train

    if cfg.evaluate:
        from maxk_gnn.train.loop import _ckpt_payload

        state = setup(cfg, data)
        # restore FULL variables (incl. batch_stats for gnn_res), not
        # just params — eval with empty batch_stats would be garbage
        restored = restore_checkpoint(cfg.evaluate, _ckpt_payload(state, 0))
        state.variables = restored["variables"]
        tr, va, te = evaluate(state, data)
        logger.info(f"eval-only: train {tr:.4f} val {va:.4f} test {te:.4f}")
        return state
    state = train(cfg, data, logger, writer, checkpoint_dir=exp)
    if cfg.save_model:
        from maxk_gnn.train.loop import _ckpt_payload

        save_checkpoint(
            exp, _ckpt_payload(state, cfg.epochs - 1), step=cfg.epochs, is_best=True
        )
        logger.info(f"saved model to {exp}")
    return state


def run_sharded(cfg, data, logger, writer):
    import time

    from maxk_gnn.parallel.mesh import make_mesh
    from maxk_gnn.parallel.train import (
        make_sharded_eval_step,
        make_sharded_train_step,
        sharded_setup,
    )
    mesh = make_mesh(cfg.mesh_shape)
    logger.info(f"mesh: {mesh}")
    model, variables, opt_state, sgraph, arrays, tx = sharded_setup(
        cfg, data, mesh
    )
    kernel_mode = (
        "hybrid" if sgraph.hybrid is not None
        else "tiles_scan" if sgraph.fwd_tiles is not None else "segsum"
    )
    logger.info(f"kernel mode: {cfg.kernel_mode} -> {kernel_mode}")
    metric = "rocauc" if data.name == "ogbn-proteins" else "f1"
    train_step = make_sharded_train_step(model, tx, data.multilabel, mesh)
    eval_step = make_sharded_eval_step(model, data.multilabel, mesh, metric)
    rng = jax.random.PRNGKey(cfg.seed)
    best_val = best_test = 0.0
    times, losses = [], []
    for epoch in range(cfg.epochs):
        # per-epoch key by fold-in (not split-chain) so a resumed run
        # replays the identical stream from any epoch
        srng = jax.random.fold_in(rng, epoch)
        t0 = time.perf_counter()
        variables, opt_state, loss, _ = train_step(
            variables, opt_state, srng, sgraph,
            arrays["feats"], arrays["labels"], arrays["train"],
        )
        jax.block_until_ready(loss)
        dt = time.perf_counter() - t0
        times.append(dt)
        # one host fetch for loss + metrics
        loss, tr, va, te = (
            float(q) for q in jax.device_get(
                (loss,) + tuple(eval_step(
                    variables, sgraph, arrays["feats"], arrays["labels"],
                    (arrays["train"], arrays["val"], arrays["test"]),
                ))
            )
        )
        losses.append(loss)
        if va > best_val:
            best_val, best_test = va, te
        writer.add_scalar("loss", float(loss), epoch)
        writer.add_scalar("val_acc", va, epoch)
        logger.info(
            f"epoch {epoch:05d} | loss {float(loss):.4f} | train {tr:.4f} "
            f"| val {va:.4f} | test {te:.4f} | {dt*1e3:.1f} ms"
        )
    if len(times) > 10:
        logger.info(f"avg epoch time (post-warmup): {1e3*np.mean(times[10:]):.2f} ms")
    logger.info(f"best val {best_val:.4f} | best test {best_test:.4f}")
    return {"mesh": mesh, "sgraph": sgraph, "kernel_mode": kernel_mode,
            "losses": losses,
            "step_times": times, "best_val": best_val, "best_test": best_test}


if __name__ == "__main__":
    main()
