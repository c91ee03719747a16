"""Compiled-memory evidence for the single-device k benefit.

DESIGN.md's thesis: here the MaxK/CBSR advantage is NOT gather traffic
(the dense-feature SpMM is k-independent) — it is collective bytes,
backward compactness, and activation memory. This probe substantiates the memory
part with the COMPILER's own numbers: XLA's buffer assignment
(`compiled.memory_analysis()`) for

  A. the op-level fwd+bwd (`value_and_grad` of `maxk_spgemm` at
     published reddit shapes, lowered abstractly — no device buffers
     needed): temp + output bytes as a function of k. The custom-VJP
     residuals are (graph, selector) only, so temp memory is k-shaped
     where a (V,D) residual design would be flat.
  B. the model train step (flickr-scale, real arrays): maxk vs relu.

Caveats (honest reading): temp_bytes under the CPU backend reflects
CPU fusion/buffer-reuse decisions, not the GPU's — use it for SHAPE
comparisons (k-scaling, arm-vs-arm at the same backend), not absolute
device-memory predictions. The unambiguous k-shaped numbers are the output/grad
bytes (the compact (V,k) gradient: 16× smaller than the masked (V,D)
design at k=8/D=256).

Usage: python -m maxk_gnn.bench.memcheck [--v 232965] [--json_out F]
"""

from __future__ import annotations

import argparse
import json
import sys


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _stats(compiled) -> dict:
    m = compiled.memory_analysis()
    return {
        "argument_bytes": int(m.argument_size_in_bytes),
        "output_bytes": int(m.output_size_in_bytes),
        "temp_bytes": int(m.temp_size_in_bytes),
        "peak_bytes": int(m.peak_memory_in_bytes),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--v", type=int, default=232965)  # published reddit V
    p.add_argument("--e", type=int, default=114_615_892)  # reddit E
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--k", nargs="+", type=int, default=[8, 16, 32, 64])
    p.add_argument("--train_scale", type=float, default=0.02)
    p.add_argument("--platform", default="cpu",
                   help="buffer assignment sizes are shape-determined; "
                   "cpu lowering needs no device")
    p.add_argument("--json_out", default="")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from maxk_gnn.ops.spgemm import maxk_spgemm, spmm
    from maxk_gnn.sparse.cbsr import CBSR
    from maxk_gnn.sparse.csr import CSRGraph
    from maxk_gnn.sparse.graph import Graph

    v, e, d = args.v, args.e, args.dim
    sds = jax.ShapeDtypeStruct
    csr = CSRGraph(
        indptr=sds((v + 1,), jnp.int32),
        indices=sds((e,), jnp.int32),
        values=sds((e,), jnp.float32),
    )
    graph = Graph(csr=csr, csc=csr, tiles=None, tiles_t=None)
    ct = sds((v, d), jnp.float32)

    out = {"shapes": {"V": v, "E": e, "D": d}, "op_level": [], "train_step": []}

    # --- A. op-level fwd+bwd buffer assignment across k ---
    for k in args.k:
        vals = sds((v, k), jnp.float32)
        sel = sds((v, k), jnp.int32)
        f = jax.jit(
            jax.value_and_grad(
                lambda va, g_, s_, c_: jnp.vdot(
                    maxk_spgemm(g_, CBSR(va, s_), dim=d, mode="segsum",
                                compute_dtype=jnp.bfloat16),
                    c_,
                )
            )
        )
        st = _stats(f.lower(vals, graph, sel, ct).compile())
        st.update({"arm": f"maxk_cbsr_k{k}", "k": k})
        out["op_level"].append(st)
        log(f"op maxk_cbsr k={k}: temp {st['temp_bytes']/1e9:.3f} GB "
            f"out {st['output_bytes']/1e9:.3f} GB")

    # masked-dense reference point: the (V,D)-residual design
    x = sds((v, d), jnp.bfloat16)
    fm = jax.jit(
        jax.value_and_grad(
            lambda x_, g_, c_: jnp.vdot(
                spmm(g_, x_, mode="segsum").astype(jnp.float32),
                c_.astype(jnp.float32),
            )
        )
    )
    st = _stats(fm.lower(x, graph, ct).compile())
    st.update({"arm": "masked_dense", "k": None})
    out["op_level"].append(st)
    log(f"op masked_dense: temp {st['temp_bytes']/1e9:.3f} GB "
        f"out {st['output_bytes']/1e9:.3f} GB")

    # --- A2. PRODUCTION path (strip hybrid) lowered abstractly at the
    # same reddit shapes: the segsum arm above materializes the oracle's
    # (E, D) scratch, swamping temp; the hybrid arm shows the real
    # working set the device must hold. Tail size = a reddit-like
    # fraction (6.6% of E live, ×1.37 tile padding at T=64).
    from maxk_gnn.sparse.hybrid import HybridSchedule
    from maxk_gnn.sparse.meta import EdgeTiles

    vp = -(-v // 128) * 128
    s_cols = min(16384, vp)
    nt = max(int(e * 0.066 * 1.37 / 64), 1)
    tiles = EdgeTiles(
        block=sds((nt,), jnp.int32),
        cols=sds((nt, 64), jnp.int32),
        vals=sds((nt, 64), jnp.float32),
        localrow=sds((nt, 64), jnp.int32),
        row_block=8,
        num_row_blocks=-(-v // 8),
        num_nodes=v,
    )
    hyb = HybridSchedule(
        strip=sds((vp, s_cols), jnp.bfloat16),
        pre=sds((v,), jnp.float32),
        post=sds((v,), jnp.float32),
        tail_tiles=tiles,
        num_nodes=v,
        s_cols=s_cols,
        tail_window=256,
    )
    ghyb = Graph(csr=csr, csc=csr, tiles=None, tiles_t=None, hybrid=hyb)
    for k in args.k:
        vals = sds((v, k), jnp.float32)
        sel = sds((v, k), jnp.int32)
        fh = jax.jit(
            jax.value_and_grad(
                lambda va, g_, s_, c_: jnp.vdot(
                    maxk_spgemm(g_, CBSR(va, s_), dim=d, mode="hybrid",
                                compute_dtype=jnp.bfloat16),
                    c_,
                )
            )
        )
        st = _stats(fh.lower(vals, ghyb, sel, ct).compile())
        st.update({"arm": f"hybrid_cbsr_k{k}", "k": k})
        out["op_level"].append(st)
        log(f"op hybrid_cbsr k={k}: temp {st['temp_bytes']/1e9:.3f} GB "
            f"out {st['output_bytes']/1e9:.3f} GB")

    # --- B. whole train step, maxk vs relu (real tiny arrays) ---
    from maxk_gnn.data.datasets import load_dataset
    from maxk_gnn.train.config import TrainConfig
    from maxk_gnn.train.loop import make_train_step, setup

    data = load_dataset("flickr", scale=args.train_scale, seed=123)
    for nonlinear, k in [("relu", 32)] + [("maxk", kk) for kk in args.k]:
        cfg = TrainConfig(
            dataset="flickr", model="sage", epochs=1, nonlinear=nonlinear,
            maxk=k, dropout=0.5, kernel_mode="segsum",
            data_scale=args.train_scale,
        )
        state = setup(cfg, data)
        step = make_train_step(state.model, state.tx, data.multilabel)
        import numpy as np

        feats = jnp.asarray(data.features)
        labels = jnp.asarray(
            data.labels.astype(np.int32)
        )
        mask = jnp.asarray(data.train_mask)
        lowered = step.lower(
            state.variables, state.opt_state, jax.random.PRNGKey(0),
            state.graph, feats, labels, mask,
        )
        st = _stats(lowered.compile())
        arm = "relu" if nonlinear == "relu" else f"maxk_k{k}"
        st["arm"] = arm
        out["train_step"].append(st)
        log(f"train {arm}: temp {st['temp_bytes']/1e6:.2f} MB "
            f"peak {st['peak_bytes']/1e6:.2f} MB")

    s = json.dumps(out, indent=1)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(s)
        log(f"wrote {args.json_out}")
    print(s)
    return out


if __name__ == "__main__":
    main()
