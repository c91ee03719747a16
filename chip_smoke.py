#!/usr/bin/env python
"""Quickest proof that the system runs on a GPU: one process, several
phases, any failure exits non-zero.

    python chip_smoke.py             # one card
    python chip_smoke.py --chips 4   # row-partitioned training, 4 cards vs 1

One card:
  device  the platform is `gpu`; the card's name and power limit.
  parity  each translated op on the card at real widths against a plain
          reference computed at "highest" matmul precision: the MaxK mask
          (Triton kernel) and CBSR at V=232,965, D=256, k in {8, 32}, exact;
          densify and sample, exact; the SpMM that `auto` picks on reddit
          at published V and E, forward and A^T, against `spmm_segsum_scan`
          in f32 — relative error <= 2e-2 of max|y| under bf16 compute
          (bf16 features) and <= 1e-4 under f32 (summation order).
  train   `train.py`'s main: MaxK-SAGE 256 x 4 layers, k=32, on reddit at
          published V and E (seeded synthetic R-MAT), 3 steps per arm
          (maxk, relu); kernel mode, step times, finite losses, peak memory.

`--chips 4` runs only the sharded job (`--mesh_shape 4`) and the same job
on one card, with dropout 0, and compares the losses after 3 steps
(relative difference <= 2e-2); it also checks that each card holds its
quarter of the rows.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# reddit at published size; MaxK-SAGE as in scripts_train/reddit_maxk.sh
JOB = ["--dataset", "reddit", "--model", "sage", "--hidden_dim", "256",
       "--hidden_layers", "4", "--maxk", "32", "--lr", "0.01",
       "--compute_dtype", "bfloat16", "--epochs", "3"]
STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    check(bool(out), "nvidia-smi printed nothing")
    return out


def peak_gb(dev) -> float:
    return (dev.memory_stats() or {}).get("peak_bytes_in_use", 0) / 1e9


def phase_parity(jax, jnp, v: int, e: int):
    import numpy as np

    from maxk_gnn.data.device_gen import rmat_graph_device
    from maxk_gnn.ops.dispatch import choose_mode
    from maxk_gnn.ops.mask import maxk_activation, mask_plain
    from maxk_gnn.ops.spgemm import spmm
    from maxk_gnn.ops.spmm_xla import spmm_segsum_scan
    from maxk_gnn.sparse.cbsr import cbsr_densify, cbsr_sample, maxk_cbsr
    from maxk_gnn.sparse.csr import csr_transpose_device, with_norm
    from maxk_gnn.sparse.graph import Graph
    from maxk_gnn.sparse.hybrid import (
        auto_strip_cols,
        auto_strip_dtype,
        build_hybrid_device,
        degree_perm_device,
        permute_csr_device,
    )
    from maxk_gnn.sparse.meta import build_edge_tiles_device

    d = 256
    x = jax.jit(lambda: jax.random.normal(jax.random.PRNGKey(0), (v, d)))()
    ct = jax.jit(lambda: jax.random.normal(jax.random.PRNGKey(1), (v, d)))()

    def maxerr(a, b):
        return float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))

    for k in (8, 32):
        with jax.default_matmul_precision("highest"):
            y_ref, t_ref = jax.jit(mask_plain, static_argnums=1)(x, k)
            c = jax.jit(maxk_cbsr, static_argnums=1)(x, k)
            dense_ref = jax.jit(lambda vals, sel: jnp.sum(jnp.where(
                sel[..., None] == jnp.arange(d), vals[..., None], 0.0), axis=1))(
                    c.values, c.selector)
        y = jax.jit(maxk_activation, static_argnums=1)(x, k)
        g = jax.jit(jax.grad(lambda a: jnp.vdot(maxk_activation(a, k), ct)))(x)
        e_mask = maxerr(y, y_ref)
        e_grad = maxerr(g, ct * t_ref)
        counts = np.unique(np.asarray(jnp.sum(t_ref.astype(jnp.int32), axis=1)))
        dense = jax.jit(cbsr_densify, static_argnums=1)(c, d)
        e_cbsr = maxerr(dense, y_ref)
        e_dens = maxerr(dense, dense_ref)
        z = jax.jit(cbsr_sample)(ct, c.selector)
        z_ref = jax.jit(lambda zz, sel: jnp.sum(jnp.where(
            sel[..., None] == jnp.arange(d), zz[:, None, :], 0.0), axis=-1))(
                ct, c.selector)
        e_samp = maxerr(z, z_ref)
        log(f"parity mask   V={v} D={d} k={k}: max err {e_mask} (tol 0), "
            f"grad {e_grad} (tol 0), survivors/row {counts.tolist()}")
        log(f"parity cbsr   k={k}: densify(top_k) vs mask {e_cbsr} (tol 0)")
        log(f"parity densify k={k}: {e_dens} (tol 0); sample: {e_samp} (tol 0)")
        check(e_mask == 0 and e_grad == 0 and counts.tolist() == [k], "mask")
        check(e_cbsr == 0 and e_dens == 0 and e_samp == 0, "cbsr/densify/sample")
        del y_ref, t_ref, c, dense_ref, y, g, dense, z, z_ref
    del x, ct

    g = rmat_graph_device(v, e, seed=123)
    for cdt, tol in ((jnp.bfloat16, 2e-2), (None, 1e-4)):
        mode = choose_mode("auto", g, d, cdt)
        if mode.value == "hybrid":
            gp = permute_csr_device(g, degree_perm_device(g))
            sdt = auto_strip_dtype(gp)
            e_live = int(np.asarray(gp.indptr[-1]))
            s = auto_strip_cols(v, e_live=e_live, dim=d, io_itemsize=2,
                                strip_itemsize=jnp.dtype(sdt).itemsize)
            gn = with_norm(gp, "right")
            graph = Graph(csr=gn, csc=gn, hybrid=build_hybrid_device(
                gp, s_cols=s, norm="right", strip_dtype=sdt))
        else:
            gn = with_norm(g, "right")
            gt = csr_transpose_device(gn)
            tiles = (build_edge_tiles_device(gn), build_edge_tiles_device(gt)) \
                if mode.value == "tiles_scan" else (None, None)
            graph = Graph(csr=gn, csc=gt, tiles=tiles[0], tiles_t=tiles[1])
        xk = jax.jit(lambda: maxk_activation(
            jax.random.normal(jax.random.PRNGKey(2), (v, d)), 32))()
        xin = xk if cdt is None else xk.astype(cdt)
        # A^T a is the VJP of a -> A a at cotangent a
        ops = {
            "A": (graph.csr, jax.jit(lambda gr, a: spmm(gr, a, mode=mode.value))),
            "A^T": (graph.csc if graph.hybrid is None
                    else csr_transpose_device(graph.csr),
                    jax.jit(lambda gr, a: jax.vjp(
                        lambda b: spmm(gr, b, mode=mode.value), a)[1](a)[0])),
        }
        for name, (ref_csr, fn) in ops.items():
            with jax.default_matmul_precision("highest"):
                ref = jax.jit(spmm_segsum_scan)(ref_csr, xk)
            y = fn(graph, xin)
            rel = maxerr(y, ref) / float(jnp.max(jnp.abs(ref)))
            log(f"parity spmm {name} auto->{mode.value} "
                f"compute={'f32' if cdt is None else 'bf16'} V={v} "
                f"E={int(np.asarray(g.indptr[-1]))}: rel err {rel:.3e} "
                f"(tol {tol:g})")
            check(rel <= tol, f"spmm {name} {mode.value}")
            del y, ref
        del graph, xk, xin
    del g


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = p.parse_args(argv)
    try:
        import jax
        import jax.numpy as jnp
    except ImportError as ex:
        fail(f"JAX is not installed ({ex})")
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    try:
        import maxk_gnn
        import train as train_cli
    except ImportError as ex:
        fail(f"run from a checkout of the repository ({ex})")
    check(os.path.dirname(os.path.dirname(os.path.abspath(maxk_gnn.__file__)))
          == HERE, "run from a checkout of the repository")

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX found {devs[0].platform} ({devs[0].device_kind})")
    check(len(devs) >= args.chips, f"{args.chips} cards asked, {len(devs)} found")
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    from maxk_gnn.runtime import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    out_root = os.path.join(HERE, "build", "chip_smoke")  # train.py --path

    if args.chips == 1:
        t0 = time.perf_counter()
        from maxk_gnn.data.datasets import DATASETS

        spec = DATASETS["reddit"]
        phase_parity(jax, jnp, spec.num_nodes, spec.num_edges)
        log(f"phase parity done in {time.perf_counter() - t0:.1f} s")
        for arm in ("maxk", "relu"):
            t0 = time.perf_counter()
            state = train_cli.main(JOB + ["--nonlinear", arm, "--path", out_root])
            losses = [float(l) for l in state.losses]
            log(f"train {arm}: kernel mode {state.kernel_mode}; step times "
                f"{[round(1e3 * t, 1) for t in state.epoch_times]} ms; losses "
                f"{losses}; peak memory {peak_gb(devs[0]):.2f} GB; "
                f"{time.perf_counter() - t0:.1f} s")
            check(len(losses) == STEPS and all(math.isfinite(l) for l in losses),
                  f"train {arm}: losses {losses}")
            del state
    else:
        job = JOB + ["--dropout", "0", "--nonlinear", "maxk", "--path", out_root]
        t0 = time.perf_counter()
        res = train_cli.main(job + ["--mesh_shape", "4"])
        sg = res["sgraph"]
        sharded_losses = [float(l) for l in res["losses"]]
        rows = sg.fwd_indptr.shape[1] - 1
        for leaf in (sg.fwd_indptr, sg.fwd_indices):
            shards = leaf.addressable_shards
            check(len(shards) == 4 and {s.device.id for s in shards}
                  == {d.id for d in devs[:4]}, "graph not on 4 cards")
            check(all(s.data.shape[0] == 1 for s in shards), "shard shape")
        log(f"sharded: kernel mode {res['kernel_mode']}; {rows} rows per card "
            f"of {sg.padded_nodes}; losses {sharded_losses}; step times "
            f"{[round(1e3 * t, 1) for t in res['step_times']]} ms; "
            f"{time.perf_counter() - t0:.1f} s")
        del res, sg
        t0 = time.perf_counter()
        single = train_cli.main(job)
        ls = [float(l) for l in single.losses]
        log(f"single card: kernel mode {single.kernel_mode}; losses {ls}; "
            f"{time.perf_counter() - t0:.1f} s")
        rel = abs(ls[-1] - sharded_losses[-1]) / abs(ls[-1])
        log(f"loss after {STEPS} steps: 4 cards {sharded_losses[-1]} vs 1 card "
            f"{ls[-1]}: rel diff {rel:.3e} (tol 2e-2)")
        check(rel <= 2e-2, "sharded loss differs from single card")

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
