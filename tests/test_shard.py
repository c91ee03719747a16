"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

The correctness bar: sharded execution must produce the SAME math as the
single-device path (forward values, gradients, training trajectory)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maxk_gnn.parallel.mesh import GRAPH_AXIS, make_mesh
from maxk_gnn.parallel.shard import build_sharded_graph, shard_rows
from maxk_gnn.parallel.train import (
    make_sharded_eval_step,
    make_sharded_train_step,
    sharded_setup,
)
from maxk_gnn.ops.spgemm import maxk_spgemm, spmm
from maxk_gnn.ops.spmm_xla import spmm_segsum
from maxk_gnn.sparse.cbsr import cbsr_densify, maxk_cbsr
from maxk_gnn.sparse.csr import with_norm
from maxk_gnn.sparse.graph import build_graph
from maxk_gnn.train.config import TrainConfig

from jax.sharding import NamedSharding, PartitionSpec as P

D = 32
N_DEV = 8

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < N_DEV, reason="needs 8 (virtual) devices"
)


def _sharded_apply(mesh, sgraph, fn, *arrays):
    """Run fn(sgraph, *local arrays) under shard_map with row-sharded IO."""
    shard = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(GRAPH_AXIS),) + (P(GRAPH_AXIS),) * len(arrays),
        out_specs=P(GRAPH_AXIS),
        check_vma=False,
    )
    return shard(sgraph, *arrays)


def test_sharded_spmm_matches_single(small_graph):
    mesh = make_mesh(N_DEV)
    sgraph = build_sharded_graph(small_graph, N_DEV, norm="right")
    g1 = build_graph(small_graph, norm="right", build_tiles=False)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((small_graph.num_nodes, D)).astype(np.float32)
    xp = jnp.asarray(shard_rows(x, N_DEV))

    y_sharded = _sharded_apply(
        mesh, sgraph, lambda g, xx: spmm(g, xx, mode="segsum"), xp
    )
    y_single = spmm(g1, jnp.asarray(x), mode="segsum")
    np.testing.assert_allclose(
        np.asarray(y_sharded)[: small_graph.num_nodes],
        np.asarray(y_single),
        rtol=1e-4,
        atol=1e-4,
    )


def test_sharded_maxk_spgemm_fwd_bwd(small_graph):
    mesh = make_mesh(N_DEV)
    sgraph = build_sharded_graph(small_graph, N_DEV, norm="right")
    g1 = build_graph(small_graph, norm="right", build_tiles=False)
    rng = np.random.default_rng(1)
    v = small_graph.num_nodes
    x = rng.standard_normal((v, D)).astype(np.float32)
    ct = rng.standard_normal((v, D)).astype(np.float32)
    xp = jnp.asarray(shard_rows(x, N_DEV))
    ctp = jnp.asarray(shard_rows(ct, N_DEV))
    k = 8

    def local_val_and_grad(g, xx, cc):
        def f(xx):
            cbsr = maxk_cbsr(xx, k)
            y = maxk_spgemm(g, cbsr, dim=D, mode="segsum")
            # LOCAL partial of the global dot (no psum inside the grad
            # path — see _local_masked_loss): cross-device cotangents
            # arrive via the op's internal psum_scatter
            return jnp.vdot(y, cc)

        return jax.grad(f)(xx)

    gx_sharded = _sharded_apply(mesh, sgraph, local_val_and_grad, xp, ctp)

    def f_single(xx):
        cbsr = maxk_cbsr(xx, k)
        return jnp.vdot(maxk_spgemm(g1, cbsr, dim=D, mode="segsum"), jnp.asarray(ct))

    gx_single = jax.grad(f_single)(jnp.asarray(x))
    np.testing.assert_allclose(
        np.asarray(gx_sharded)[:v], np.asarray(gx_single), rtol=1e-4, atol=1e-4
    )


def test_sharded_training_learns(tiny_data):
    mesh = make_mesh(N_DEV)
    cfg = TrainConfig(
        dataset="tiny",
        model="sage",
        epochs=25,
        lr=0.01,
        hidden_dim=32,
        hidden_layers=2,
        maxk=8,
        dropout=0.0,
        kernel_mode="segsum",
    )
    model, variables, opt_state, sgraph, arrays, tx = sharded_setup(
        cfg, tiny_data, mesh
    )
    train_step = make_sharded_train_step(model, tx, False, mesh)
    eval_step = make_sharded_eval_step(model, False, mesh)
    rng = jax.random.PRNGKey(0)
    losses = []
    for epoch in range(cfg.epochs):
        rng, srng = jax.random.split(rng)
        variables, opt_state, loss, _ = train_step(
            variables, opt_state, srng, sgraph,
            arrays["feats"], arrays["labels"], arrays["train"],
        )
        losses.append(float(loss))
    tr, va, te = eval_step(
        variables, sgraph, arrays["feats"], arrays["labels"],
        (arrays["train"], arrays["val"], arrays["test"]),
    )
    assert losses[-1] < losses[0] * 0.7, losses[:3] + losses[-3:]
    assert float(va) > 0.5, float(va)


def test_sharded_tiles_matches_single(small_graph):
    """Sharded path with tile schedules == single-device result."""
    mesh = make_mesh(N_DEV)
    sgraph = build_sharded_graph(small_graph, N_DEV, norm="right", build_tiles=True)
    g1 = build_graph(small_graph, norm="right", build_tiles=False)
    rng = np.random.default_rng(2)
    v = small_graph.num_nodes
    x = rng.standard_normal((v, D)).astype(np.float32)
    ct = rng.standard_normal((v, D)).astype(np.float32)
    xp = jnp.asarray(shard_rows(x, N_DEV))
    ctp = jnp.asarray(shard_rows(ct, N_DEV))
    k = 8

    y_sh = _sharded_apply(mesh, sgraph, lambda g, xx: spmm(g, xx), xp)
    y1 = spmm(g1, jnp.asarray(x), mode="segsum")
    np.testing.assert_allclose(
        np.asarray(y_sh)[:v], np.asarray(y1), rtol=1e-4, atol=1e-4
    )

    def lgrad(g, xx, cc):
        def f(xx):
            return jnp.vdot(maxk_spgemm(g, maxk_cbsr(xx, k), dim=D), cc)

        return jax.grad(f)(xx)

    gx_sh = _sharded_apply(mesh, sgraph, lgrad, xp, ctp)

    def f1(xx):
        return jnp.vdot(maxk_spgemm(g1, maxk_cbsr(xx, k), dim=D, mode="segsum"), jnp.asarray(ct))

    gx1 = jax.grad(f1)(jnp.asarray(x))
    np.testing.assert_allclose(
        np.asarray(gx_sh)[:v], np.asarray(gx1), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("model_name", ["gcn", "gin"])
def test_sharded_training_other_models(tiny_data, model_name):
    mesh = make_mesh(N_DEV)
    cfg = TrainConfig(
        dataset="tiny",
        model=model_name,
        epochs=15,
        lr=0.02,
        hidden_dim=32,
        hidden_layers=2,
        maxk=8,
        dropout=0.0,
        kernel_mode="segsum",
    )
    model, variables, opt_state, sgraph, arrays, tx = sharded_setup(
        cfg, tiny_data, mesh
    )
    train_step = make_sharded_train_step(model, tx, False, mesh)
    rng = jax.random.PRNGKey(0)
    losses = []
    for _ in range(cfg.epochs):
        rng, srng = jax.random.split(rng)
        variables, opt_state, loss, _ = train_step(
            variables, opt_state, srng, sgraph,
            arrays["feats"], arrays["labels"], arrays["train"],
        )
        losses.append(float(loss))
    assert losses[-1] < losses[0], (model_name, losses[:2], losses[-2:])


def test_sharded_agg_uses_post_densify_transform(small_graph):
    """The compact sharded path must aggregate the POST-dropout features:
    layers resample CBSR values from x before maxk_spgemm, so transforms
    applied after densify (the model's dropout) reach the aggregation —
    matching single-device semantics."""
    from maxk_gnn.models.layers import Agg
    from maxk_gnn.sparse.cbsr import CBSR

    mesh = make_mesh(N_DEV)
    sgraph = build_sharded_graph(small_graph, N_DEV, norm="right")
    g1 = build_graph(small_graph, norm="right", build_tiles=False)
    v = small_graph.num_nodes
    rng = np.random.default_rng(3)
    x0 = jnp.asarray(rng.standard_normal((v, D)).astype(np.float32))
    cbsr = maxk_cbsr(x0, 8)
    xd = cbsr_densify(cbsr, D)
    # a post-densify transform standing in for dropout (deterministic)
    keep = jnp.asarray((rng.random((v, D)) > 0.5).astype(np.float32))
    xdrop = xd * keep * 2.0

    ref = spmm(g1, xdrop, mode="segsum")

    agg = Agg(kernel_mode="segsum")
    out = _sharded_apply(
        mesh,
        sgraph,
        lambda g, xx, vv, ss: agg(g, xx, CBSR(values=vv, selector=ss)),
        jnp.asarray(shard_rows(np.asarray(xdrop), N_DEV)),
        jnp.asarray(shard_rows(np.asarray(cbsr.values), N_DEV)),
        jnp.asarray(shard_rows(np.asarray(cbsr.selector), N_DEV)),
    )
    np.testing.assert_allclose(
        np.asarray(out)[:v], np.asarray(ref), atol=1e-4
    )


def test_sharded_hybrid_matches_single(small_graph):
    """Row-partitioned strip hybrid == single-device result (fwd, A^T,
    and the maxk_spgemm gradient) on a degree-permuted symmetric graph."""
    from maxk_gnn.sparse.hybrid import check_hybrid_ok, degree_perm, permute_csr

    assert check_hybrid_ok(small_graph)
    pcsr = permute_csr(small_graph, degree_perm(small_graph))
    v = pcsr.num_nodes
    mesh = make_mesh(N_DEV)
    sgraph = build_sharded_graph(
        pcsr, N_DEV, norm="right", hybrid=True,
        strip_cols=128, strip_dtype=jnp.float32,
    )
    assert sgraph.hybrid is not None
    g1 = build_graph(pcsr, norm="right", build_tiles=False)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((v, D)).astype(np.float32)
    ct = rng.standard_normal((v, D)).astype(np.float32)
    xp = jnp.asarray(shard_rows(x, N_DEV))
    ctp = jnp.asarray(shard_rows(ct, N_DEV))

    y_sh = _sharded_apply(mesh, sgraph, lambda g, xx: spmm(g, xx), xp)
    y1 = spmm(g1, jnp.asarray(x), mode="segsum")
    np.testing.assert_allclose(
        np.asarray(y_sh)[:v], np.asarray(y1), rtol=1e-4, atol=1e-4
    )

    # dense-spmm VJP exercises the transpose direction
    def dgrad(g, xx, cc):
        return jax.grad(lambda x_: jnp.vdot(spmm(g, x_), cc))(xx)

    gx_sh = _sharded_apply(mesh, sgraph, dgrad, xp, ctp)
    gx1 = jax.grad(
        lambda x_: jnp.vdot(spmm(g1, x_, mode="segsum"), jnp.asarray(ct))
    )(jnp.asarray(x))
    np.testing.assert_allclose(
        np.asarray(gx_sh)[:v], np.asarray(gx1), rtol=1e-4, atol=1e-4
    )

    # compact maxk path: compressed gather + hybrid aggregation + sampled grad
    k = 8

    def lgrad(g, xx, cc):
        return jax.grad(
            lambda x_: jnp.vdot(maxk_spgemm(g, maxk_cbsr(x_, k), dim=D), cc)
        )(xx)

    gm_sh = _sharded_apply(mesh, sgraph, lgrad, xp, ctp)
    gm1 = jax.grad(
        lambda x_: jnp.vdot(
            maxk_spgemm(g1, maxk_cbsr(x_, k), dim=D, mode="segsum"),
            jnp.asarray(ct),
        )
    )(jnp.asarray(x))
    np.testing.assert_allclose(
        np.asarray(gm_sh)[:v], np.asarray(gm1), rtol=1e-4, atol=1e-4
    )


def test_sharded_setup_hybrid_training_learns(tiny_data):
    """kernel_mode='hybrid' end-to-end: sharded_setup permutes the node
    data to the hybrid's degree order and the step trains."""
    mesh = make_mesh(N_DEV)
    cfg = TrainConfig(
        dataset="tiny",
        model="sage",
        epochs=25,
        lr=0.01,
        hidden_dim=32,
        hidden_layers=2,
        maxk=8,
        dropout=0.0,
        kernel_mode="hybrid",
    )
    model, variables, opt_state, sgraph, arrays, tx = sharded_setup(
        cfg, tiny_data, mesh
    )
    assert sgraph.hybrid is not None
    train_step = make_sharded_train_step(model, tx, False, mesh)
    eval_step = make_sharded_eval_step(model, False, mesh)
    rng = jax.random.PRNGKey(0)
    losses = []
    for _ in range(cfg.epochs):
        rng, srng = jax.random.split(rng)
        variables, opt_state, loss, _ = train_step(
            variables, opt_state, srng, sgraph,
            arrays["feats"], arrays["labels"], arrays["train"],
        )
        losses.append(float(loss))
    tr, va, te = eval_step(
        variables, sgraph, arrays["feats"], arrays["labels"],
        (arrays["train"], arrays["val"], arrays["test"]),
    )
    assert losses[-1] < losses[0] * 0.7, losses[:3] + losses[-3:]
    assert float(va) > 0.5, float(va)


def test_halo_stats():
    """Halo analysis: sane fields, and the documented negative result —
    at reddit-like density the halo exchange does NOT beat the full
    compressed all_gather (each shard's tail references most rows), which
    is why the production collective design is hub-psum-free."""
    from maxk_gnn.data.synthetic import rmat_graph
    from maxk_gnn.parallel.shard import halo_stats
    from maxk_gnn.sparse.hybrid import degree_perm, permute_csr

    g = rmat_graph(2048, 200_000, seed=3)
    pg = permute_csr(g, degree_perm(g))
    st = halo_stats(pg, 4, k=32, s_cols=256)
    assert len(st["halo_rows_per_shard"]) == 4
    assert all(0 <= h <= 2048 for h in st["halo_rows_per_shard"])
    assert st["allgather_recv_bytes_per_device"] > 0
    # dense-regime R-MAT: halo ≈ all rows -> no reduction
    assert st["reduction_vs_allgather"] < 1.5


def test_sharded_explicit_hybrid_on_directed_graph_raises(tiny_data):
    """An explicit kernel_mode='hybrid' on a value-asymmetric graph must
    raise (matching the single-device contract) instead of silently
    downgrading to the segsum fallback."""
    from dataclasses import replace

    import scipy.sparse as sp

    from maxk_gnn.sparse.csr import CSRGraph, csr_to_scipy

    m = csr_to_scipy(tiny_data.csr).tolil()
    # break symmetry: zero one directed edge that has a reverse twin
    r = int(np.asarray(tiny_data.csr.row_ids())[5])
    c = int(np.asarray(tiny_data.csr.indices)[5])
    if r != c:
        m[r, c] = 0
    m = m.tocsr()
    m.eliminate_zeros()
    directed = CSRGraph(
        indptr=jnp.asarray(m.indptr.astype(np.int32)),
        indices=jnp.asarray(m.indices.astype(np.int32)),
        values=jnp.asarray(m.data.astype(np.float32)),
    )
    data = replace(tiny_data, csr=directed)
    mesh = make_mesh(2)
    cfg = TrainConfig(
        dataset="tiny", model="sage", epochs=1, hidden_dim=16,
        hidden_layers=2, maxk=4, kernel_mode="hybrid",
    )
    with pytest.raises(ValueError, match="value-symmetric"):
        sharded_setup(cfg, data, mesh)


# ---------------------------------------------------------------------------
# compiled-HLO collective audit (VERDICT r3 #5): the analytic collective
# model the scaling roofline charges must equal what XLA actually emits
# ---------------------------------------------------------------------------


def _compiled_text(fn, mesh, sgraph, *arrays, out_len=2):
    sharded = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(GRAPH_AXIS),) + (P(GRAPH_AXIS),) * len(arrays),
        out_specs=(P(GRAPH_AXIS),) * out_len,
        check_vma=False,
    )
    return jax.jit(sharded).lower(sgraph, *arrays).compile().as_text()


def test_collective_bytes_match_analytic(small_graph):
    """maxk/relu fwd+bwd on the tile-free sharded path: XLA must emit
    exactly the modeled collectives (CBSR all_gather + cotangent
    reduce-scatter for maxk; dense all_gather + reduce-scatter for relu),
    byte for byte."""
    from maxk_gnn.parallel.audit import (
        hlo_collectives,
        model_recv_bytes_fwd_bwd,
        recv_bytes_per_device,
    )
    from maxk_gnn.sparse.cbsr import CBSR

    mesh = make_mesh(N_DEV)
    sgraph = build_sharded_graph(small_graph, N_DEV, norm="right")
    vp = sgraph.padded_nodes
    k = 4
    vals = jnp.ones((vp, k), jnp.float32)
    sel = jnp.zeros((vp, k), jnp.int32)
    ct = jnp.ones((vp, D), jnp.float32)

    def f_maxk(g, va, se, c):
        y, vjp = jax.vjp(
            lambda vv: maxk_spgemm(g, CBSR(vv, se), dim=D, mode="segsum"), va
        )
        (dv,) = vjp(c)
        return y, dv

    txt = _compiled_text(f_maxk, mesh, sgraph, vals, sel, ct)
    colls = hlo_collectives(txt)
    ops = sorted(c[0] for c in colls)
    assert ops == ["all-gather", "all-gather", "reduce-scatter"], colls
    got = recv_bytes_per_device(colls, N_DEV)
    want = model_recv_bytes_fwd_bwd("maxk", N_DEV, vp, D, k=k)
    assert got == pytest.approx(want, rel=1e-12), (got, want, colls)

    def f_relu(g, x, c):
        y, vjp = jax.vjp(lambda xx: spmm(g, xx, mode="segsum"), x)
        (dx,) = vjp(c)
        return y, dx

    x = jnp.ones((vp, D), jnp.float32)
    txt = _compiled_text(f_relu, mesh, sgraph, x, ct)
    colls = hlo_collectives(txt)
    ops = sorted(c[0] for c in colls)
    assert ops == ["all-gather", "reduce-scatter"], colls
    got = recv_bytes_per_device(colls, N_DEV)
    want = model_recv_bytes_fwd_bwd("relu", N_DEV, vp, D)
    assert got == pytest.approx(want, rel=1e-12), (got, want, colls)


def test_collective_bytes_match_analytic_hybrid(small_graph):
    """Sharded strip-hybrid fwd+bwd: compressed CBSR gather + cotangent
    gather + two (S, D) hub psums — and nothing else."""
    from maxk_gnn.parallel.audit import (
        hlo_collectives,
        model_recv_bytes_fwd_bwd,
        recv_bytes_per_device,
    )
    from maxk_gnn.sparse.cbsr import CBSR
    from maxk_gnn.sparse.hybrid import degree_perm, permute_csr

    pcsr = permute_csr(small_graph, degree_perm(small_graph))
    mesh = make_mesh(N_DEV)
    s_cols = 128
    sgraph = build_sharded_graph(
        pcsr, N_DEV, norm="right", hybrid=True,
        strip_cols=s_cols, strip_dtype=jnp.float32,
    )
    assert sgraph.hybrid is not None
    vp = sgraph.padded_nodes
    k = 4
    vals = jnp.ones((vp, k), jnp.float32)
    sel = jnp.zeros((vp, k), jnp.int32)
    ct = jnp.ones((vp, D), jnp.float32)

    def f(g, va, se, c):
        y, vjp = jax.vjp(
            lambda vv: maxk_spgemm(g, CBSR(vv, se), dim=D, mode="auto"), va
        )
        (dv,) = vjp(c)
        return y, dv

    txt = _compiled_text(f, mesh, sgraph, vals, sel, ct)
    colls = hlo_collectives(txt)
    ops = sorted(c[0] for c in colls)
    assert ops == [
        "all-gather", "all-gather", "all-gather", "all-reduce", "all-reduce",
    ], colls
    got = recv_bytes_per_device(colls, N_DEV)
    want = model_recv_bytes_fwd_bwd(
        "maxk_hybrid", N_DEV, vp, D, k=k,
        s_cols=sgraph.hybrid.s_cols,
    )
    assert got == pytest.approx(want, rel=1e-12), (got, want, colls)
