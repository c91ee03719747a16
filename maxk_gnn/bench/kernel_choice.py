"""The measurements behind the kernel decisions and the dispatch constants
(`ops/dispatch.DEVICE_CONSTANTS`), taken on the card:

    python -m maxk_gnn.bench.kernel_choice [--only mask spmm step] [--out F]

mask: the Triton MaxK mask (`ops/mask.py`) against the plain `lax` form at
      reddit and ogbn-products V, D=256, k in {8, 32, 64}; forward and
      forward+backward; the kernel checked against the plain form (exact).
spmm: segsum, tiles_scan and the strip hybrid at several widths on reddit
      at published V and E, k=32, bf16 and f32 compute; forward and
      forward+backward; each checked against `spmm_segsum_scan` in f32.
      Then the raw gather and bf16 matmul rates.
step: one MaxK-SAGE training step (256 x 4, k=32, bf16 compute) with
      each mask and the ReLU arm, under the hybrid and segsum kernels.

Each record is one JSON line on stdout (and in --out).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from maxk_gnn.bench.micro import device_info, timeit
from maxk_gnn.ops.mask import mask_plain, mask_triton
from maxk_gnn.sparse.cbsr import CBSR, cbsr_densify, cbsr_sample


def _emit(rec, out):
    print(json.dumps(rec), flush=True)
    out.append(rec)


def _max_err(a, b):
    return float(jnp.max(jnp.abs(jnp.asarray(a, jnp.float32) - jnp.asarray(b, jnp.float32))))


def _mask_op(impl, interpret=False):
    """Differentiable mask over one implementation (the production op,
    `ops.mask.maxk_activation`, picks the Triton one on CUDA)."""
    raw = (functools.partial(mask_triton, interpret=interpret)
           if impl == "triton" else mask_plain)

    @functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
    def op(x, k):
        return raw(x, k)[0]

    op.defvjp(lambda x, k: raw(x, k), lambda k, t, g: (g * t.astype(g.dtype),))
    return op


def bench_mask(sizes, ks, d=256, interpret=False, iters=5):
    out = []
    ops = {impl: _mask_op(impl, interpret) for impl in ("plain", "triton")}
    for gname, v in sizes:
        key = jax.random.PRNGKey(v)
        x = jax.jit(lambda: jax.random.normal(key, (v, d), jnp.float32))()
        ct = jax.jit(lambda: jax.random.normal(jax.random.fold_in(key, 1), (v, d)))()
        for k in ks:
            fwd = {i: jax.jit(functools.partial(op, k=k)) for i, op in ops.items()}
            fb = {i: jax.jit(jax.value_and_grad(
                lambda a, c, op=op: jnp.vdot(op(a, k), c))) for i, op in ops.items()}
            ref, gref = fwd["plain"](x), fb["plain"](x, ct)[1]
            for impl in ops:
                rec = {"op": "mask", "graph": gname, "V": v, "D": d, "k": k,
                       "impl": impl,
                       "err_fwd": _max_err(fwd[impl](x), ref),
                       "err_grad": _max_err(fb[impl](x, ct)[1], gref),
                       "fwd_ms": 1e3 * timeit(fwd[impl], x, iters=iters),
                       "fwd_bwd_ms": 1e3 * timeit(fb[impl], x, ct, iters=iters)}
                _emit(rec, out)
            del ref, gref
        del x, ct
    return out


def _reddit_device_graph(scale):
    from maxk_gnn.data.datasets import DATASETS
    from maxk_gnn.data.device_gen import rmat_graph_device

    spec = DATASETS["reddit"]
    v = max(int(spec.num_nodes * scale), 64)
    return rmat_graph_device(v, max(int(spec.num_edges * scale), 256), seed=123)


def bench_spmm(scale=1.0, k=32, d=256, iters=5,
               widths=(16384, 24576, 32768, 49152),
               arms=("segsum", "tiles_scan", "hybrid")):
    from maxk_gnn.ops.spgemm import maxk_spgemm
    from maxk_gnn.ops.spmm_xla import spmm_segsum_scan
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

    out = []
    g = _reddit_device_graph(scale)
    v = g.num_nodes
    g = permute_csr_device(g, degree_perm_device(g))
    e_live = int(jnp.sum(g.values != 0))
    key = jax.random.PRNGKey(5)
    vals = jax.jit(lambda: jax.random.normal(key, (v, k), jnp.float32))()
    sel = jax.jit(lambda: jax.lax.top_k(
        jax.random.normal(jax.random.fold_in(key, 1), (v, d)), k)[1])()
    cbsr = CBSR(vals, sel)
    ct = jax.jit(lambda: jax.random.normal(jax.random.fold_in(key, 2), (v, d)))()
    gn = with_norm(g, "right")
    gt = csr_transpose_device(gn)
    with jax.default_matmul_precision("highest"):
        y_ref = jax.jit(spmm_segsum_scan)(gn, jax.jit(cbsr_densify, static_argnums=1)(cbsr, d))
        dx_ref = jax.jit(cbsr_sample)(jax.jit(spmm_segsum_scan)(gt, ct), sel)
    base = {"graph": "reddit", "V": v, "E_live": e_live, "k": k, "D": d}

    def run(arm, graph, cdt, extra=None):
        rec = {**base, "arm": arm,
               "compute": "bf16" if cdt is not None else "f32", **(extra or {})}
        try:
            fwd = jax.jit(lambda g_, c: maxk_spgemm(
                g_, c, dim=d, mode=arm, compute_dtype=cdt))
            fb = jax.jit(jax.value_and_grad(
                lambda va, g_, s_, c_: jnp.vdot(maxk_spgemm(
                    g_, CBSR(va, s_), dim=d, mode=arm,
                    compute_dtype=cdt).astype(jnp.float32), c_)))
            y = fwd(graph, cbsr)
            rec["rel_err_fwd"] = _max_err(y, y_ref) / float(jnp.max(jnp.abs(y_ref)))
            del y
            dv = fb(vals, graph, sel, ct)[1]
            rec["rel_err_bwd"] = _max_err(dv, dx_ref) / float(jnp.max(jnp.abs(dx_ref)))
            del dv
            rec["fwd_ms"] = 1e3 * timeit(fwd, graph, cbsr, iters=iters)
            rec["fwd_bwd_ms"] = 1e3 * timeit(fb, vals, graph, sel, ct, iters=iters)
        except Exception as ex:  # an arm that cannot run is a result
            rec["error"] = f"{type(ex).__name__}: {str(ex)[:400]}"
        _emit(rec, out)

    _emit({**base, "note": "graph built",
           "memory_gb": (jax.devices()[0].memory_stats() or {}).get(
               "bytes_limit", 0) / 1e9}, out)
    if "segsum" in arms:
        for cdt in (jnp.bfloat16, None):
            run("segsum", Graph(csr=gn, csc=gt), cdt)
    if "tiles_scan" in arms:
        tiles = Graph(csr=gn, csc=gt, tiles=build_edge_tiles_device(gn),
                      tiles_t=build_edge_tiles_device(gt))
        for cdt in (jnp.bfloat16, None):
            run("tiles_scan", tiles, cdt)
        del tiles
    sdt = auto_strip_dtype(g)
    for s_cols in widths if "hybrid" in arms else ():
        s = auto_strip_cols(v, s_cols=s_cols, e_live=e_live, dim=d,
                            io_itemsize=2, strip_itemsize=jnp.dtype(sdt).itemsize)
        if s < s_cols:
            continue
        h = build_hybrid_device(g, s_cols=s, norm="right", strip_dtype=sdt)
        run("hybrid", Graph(csr=gn, csc=gn, hybrid=h), jnp.bfloat16,
            {"s_cols": s, "strip_dtype": jnp.dtype(sdt).name,
             "tail_tiles": h.tail_tiles.num_tiles,
             "tail_edge_tile": h.tail_tiles.edge_tile})
        del h
    return out


def bench_rates(interpret=False):
    from maxk_gnn.bench.micro import bench_matmul, bench_xla_gather
    from maxk_gnn.data.datasets import DATASETS

    n = 1 << 20 if interpret else 1 << 24
    v = DATASETS["reddit"].num_nodes
    m = 256 if interpret else 16384
    return [{
        "rates": True,
        "gather_bf16_rows_per_s": bench_xla_gather(v=v, e=n, dtype=jnp.bfloat16),
        "gather_f32_rows_per_s": bench_xla_gather(v=v, e=n),
        "matmul_bf16_flops": bench_matmul(m, m, m),
    }]


def bench_step(scale=1.0, iters=5, interpret=False):
    """One training step per mask implementation, through `train.loop`."""
    import maxk_gnn.models.models as models
    from maxk_gnn.data.datasets import DATASETS, GraphData
    from maxk_gnn.train.config import TrainConfig
    from maxk_gnn.train.loop import make_train_step, permuted_data, setup

    spec = DATASETS["reddit"]
    g = _reddit_device_graph(scale)
    v = g.num_nodes
    rng = np.random.default_rng(0)
    split = rng.random(v)
    data = GraphData(
        name="reddit", csr=g,
        features=rng.standard_normal((v, spec.feat_dim), np.float32),
        labels=rng.integers(0, spec.num_classes, v).astype(np.int32),
        train_mask=split < 0.6, val_mask=(split >= 0.6) & (split < 0.8),
        test_mask=split >= 0.8, num_classes=spec.num_classes, multilabel=False,
    )
    out = []
    production = models.maxk_activation
    arms = [(n, m, km) for km in ("hybrid", "segsum")
            for n, m in (("maxk", "triton"), ("maxk", "plain"), ("relu", "-"))]
    try:
        for nonlinear, impl, kernel_mode in arms:
            models.maxk_activation = (
                _mask_op(impl, interpret) if impl != "-" else production)
            cfg = TrainConfig(
                dataset="reddit", model="sage", hidden_dim=256, hidden_layers=4,
                maxk=32, nonlinear=nonlinear, compute_dtype="bfloat16",
                kernel_mode=kernel_mode,
            )
            state = setup(cfg, data)
            d = permuted_data(data, state.graph)
            step = make_train_step(state.model, state.tx, False)
            args = (state.variables, state.opt_state, jax.random.PRNGKey(1),
                    state.graph, jnp.asarray(d.features), jnp.asarray(d.labels),
                    jnp.asarray(d.train_mask))
            _emit({"step": True, "nonlinear": nonlinear, "mask": impl,
                   "kernel_mode": state.kernel_mode, "V": v,
                   "step_ms": 1e3 * timeit(step, *args, iters=iters)}, out)
            del state, args, step
    finally:
        models.maxk_activation = production
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--only", nargs="+", choices=("mask", "spmm", "step"),
                   default=("mask", "spmm", "step"))
    p.add_argument("--interpret", action="store_true",
                   help="run the Triton kernel in interpret mode (CPU rehearsal)")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--ks", type=int, nargs="+", default=[8, 32, 64])
    p.add_argument("--widths", type=int, nargs="+",
                   default=[16384, 24576, 32768, 49152],
                   help="int8 strip widths of the hybrid arm")
    p.add_argument("--spmm_arms", nargs="+",
                   default=["segsum", "tiles_scan", "hybrid"])
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    info = device_info()
    print(json.dumps({"device": info}), flush=True)
    if not args.interpret and info["platform"] != "gpu":
        sys.exit("kernel_choice measures the card; no GPU found")
    from maxk_gnn.data.datasets import DATASETS

    res = [{"device": info}]
    if "mask" in args.only:
        sizes = [(n, max(int(DATASETS[n].num_nodes * args.scale), 64))
                 for n in ("reddit", "ogbn-products")]
        res += bench_mask(sizes, args.ks, interpret=args.interpret)
    if "spmm" in args.only:
        res += bench_spmm(scale=args.scale, widths=args.widths,
                          arms=args.spmm_arms)
        res += bench_rates(args.interpret)
    if "step" in args.only:
        res += bench_step(scale=args.scale, interpret=args.interpret)
    if args.out:
        with open(args.out, "w") as f:
            for r in res:
                f.write(json.dumps(r) + "\n")
    return res


if __name__ == "__main__":
    main()
