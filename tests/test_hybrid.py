"""Symmetric-strip hybrid SpMM: exact parity with the oracle paths.

The hybrid decomposition (sparse/hybrid.py, ops/spmm_hybrid.py) must
reproduce the normalized SpMM for every norm mode, forward and
transpose, through autodiff, on host- and device-built schedules, and
end-to-end through training — the validation bar the reference sets for
its kernels (`direct_kernel_interface.py:221-372`) plus gradient checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maxk_gnn.data.synthetic import rmat_graph
from maxk_gnn.ops.spgemm import maxk_spgemm, spmm
from maxk_gnn.ops.spmm_hybrid import spmm_hybrid
from maxk_gnn.ops.spmm_xla import spmm_segsum
from maxk_gnn.sparse.cbsr import maxk_cbsr
from maxk_gnn.sparse.csr import CSRGraph, csr_transpose, with_norm
from maxk_gnn.sparse.graph import build_graph
from maxk_gnn.sparse.hybrid import (
    build_hybrid,
    build_hybrid_device,
    check_hybrid_ok,
    degree_perm,
    degree_perm_device,
    permute_csr,
    permute_csr_device,
)

D = 64
S = 128  # strip narrower than V so the tail arm is exercised


def _graph(v=400, e=3000, seed=11):
    return rmat_graph(v, e, seed=seed)


def _x(v, d=D, seed=3):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((v, d)), jnp.float32)


@pytest.mark.parametrize("norm", ["none", "right", "left", "both"])
def test_hybrid_matches_segsum(norm):
    csr = _graph()
    perm = degree_perm(csr)
    pcsr = permute_csr(csr, perm)
    h = build_hybrid(pcsr, s_cols=S, norm=norm, strip_dtype=jnp.float32)
    x = _x(csr.num_nodes)
    y = spmm_hybrid(h, x)
    ref = spmm_segsum(with_norm(pcsr, norm), x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("norm", ["right", "both"])
def test_hybrid_transpose_matches_segsum_transpose(norm):
    csr = _graph(seed=12)
    pcsr = permute_csr(csr, degree_perm(csr))
    h = build_hybrid(pcsr, s_cols=S, norm=norm, strip_dtype=jnp.float32)
    x = _x(csr.num_nodes, seed=5)
    y = spmm_hybrid(h, x, transpose=True)
    gt = csr_transpose(with_norm(pcsr, norm))
    ref = spmm_segsum(gt, x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref), atol=2e-4)


def test_hybrid_autodiff_matches_oracle_grad():
    csr = _graph(seed=13)
    pcsr = permute_csr(csr, degree_perm(csr))
    h = build_hybrid(pcsr, s_cols=S, norm="right", strip_dtype=jnp.float32)
    gn = with_norm(pcsr, "right")
    x = _x(csr.num_nodes, seed=6)
    ct = _x(csr.num_nodes, seed=7)

    g1 = jax.grad(lambda x_: jnp.vdot(spmm_hybrid(h, x_), ct))(x)
    g2 = jax.grad(lambda x_: jnp.vdot(spmm_segsum(gn, x_), ct))(x)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=2e-4)


def test_device_build_matches_host_build():
    csr = _graph(seed=14)
    pd = degree_perm_device(csr)
    ph = degree_perm(csr)
    # degrees tie often; permutations may differ but degree sequences match
    deg = np.diff(np.asarray(csr.indptr))
    np.testing.assert_array_equal(deg[np.asarray(pd)], deg[ph])

    pcsr_h = permute_csr(csr, ph)
    pcsr_d = permute_csr_device(csr, jnp.asarray(ph))
    hh = build_hybrid(pcsr_h, s_cols=S, norm="both", strip_dtype=jnp.float32)
    hd = build_hybrid_device(pcsr_d, s_cols=S, norm="both", strip_dtype=jnp.float32)
    x = _x(csr.num_nodes, seed=8)
    np.testing.assert_allclose(
        np.asarray(spmm_hybrid(hh, x)),
        np.asarray(spmm_hybrid(hd, x)),
        atol=2e-4,
    )


def test_build_graph_hybrid_spmm_and_maxk_modes():
    csr = _graph(seed=15)
    g = build_graph(csr, norm="right", hybrid=True, strip_cols=S)
    assert g.hybrid is not None and g.perm is not None
    x = _x(csr.num_nodes, seed=9)
    y = spmm(g, x, mode="hybrid")
    ref = spmm_segsum(g.csr, x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref), atol=1e-2)

    # resolve_mode: auto prefers hybrid when the schedule exists
    y2 = spmm(g, x, mode="auto")
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y), atol=1e-6)

    cbsr = maxk_cbsr(x, 8)
    ym = maxk_spgemm(g, cbsr, dim=D, mode="hybrid")
    from maxk_gnn.sparse.cbsr import cbsr_densify

    refm = spmm_segsum(g.csr, cbsr_densify(cbsr, D))
    np.testing.assert_allclose(np.asarray(ym), np.asarray(refm), atol=1e-2)

    # compact-gradient path through the custom VJP
    ct = _x(csr.num_nodes, seed=10)
    gv = jax.grad(
        lambda v: jnp.vdot(
            maxk_spgemm(g, dataclasses.replace(cbsr, values=v), dim=D, mode="hybrid"), ct
        )
    )(cbsr.values)
    gv_ref = jax.grad(
        lambda v: jnp.vdot(
            spmm_segsum(g.csr, cbsr_densify(dataclasses.replace(cbsr, values=v), D)), ct
        )
    )(cbsr.values)
    # 2e-2: the tail arm gathers (and backpropagates) in the bf16 strip
    # dtype, so single-element rounding can reach ~1.3e-2 absolute here
    np.testing.assert_allclose(np.asarray(gv), np.asarray(gv_ref), atol=2e-2)


def test_hybrid_rejects_directed_graph():
    from maxk_gnn.sparse.csr import CSRGraph

    # a 3-node directed chain: 0→1→2 (no reverse edges)
    csr = CSRGraph(
        indptr=jnp.asarray([0, 1, 2, 2], jnp.int32),
        indices=jnp.asarray([1, 2], jnp.int32),
        values=jnp.ones((2,), jnp.float32),
    )
    assert not check_hybrid_ok(csr)
    g = build_graph(csr, norm="none", hybrid=True)
    assert g.hybrid is None  # silent fallback, op dispatch stays valid


def test_training_with_hybrid_mode(tiny_data):
    from maxk_gnn.train.config import TrainConfig
    from maxk_gnn.train.loop import train

    cfg = TrainConfig(
        dataset="tiny", model="sage", epochs=30, hidden_dim=32,
        hidden_layers=2, maxk=8, dropout=0.0, kernel_mode="hybrid",
        lr=0.01, seed=0,
    )
    state = train(cfg, tiny_data)
    assert state.best_val > 0.5, state.best_val


def test_auto_strip_cols_working_set():
    """The strip budget must subtract the SpMM working set at scale
    (ogbn-products does not fit otherwise) and keep the default width
    where memory allows. Budgets are given explicitly: the one H100
    (`bytes_limit` at the default 0.75 fraction) and a 16 GB device."""
    from maxk_gnn.ops.dispatch import DEVICE_CONSTANTS
    from maxk_gnn.sparse.hybrid import auto_strip_cols, hybrid_profitable

    h100 = DEVICE_CONSTANTS["NVIDIA H100 80GB HBM3"]
    card, small = 63_763_120_128, 16_000_000_000
    # reddit published scale: working set is small -> full default width
    assert auto_strip_cols(232965, e_live=79_000_000, memory=card) == 16384
    # products published scale: (V,256) f32 buffers eat ~12 GB -> on a
    # 16 GB device the strip shrinks to a positive, lane-aligned width
    s = auto_strip_cols(2_449_029, e_live=123_700_000, memory=small)
    assert 0 < s < 1024 and s % 128 == 0
    s_card = auto_strip_cols(2_449_029, e_live=123_700_000, memory=card)
    assert s < s_card <= 16384 and s_card % 128 == 0
    # with the H100's measured rates the planning rule rejects the hybrid
    # on reddit, as the measured training step did (PERF.md), and takes
    # it on products only while the strip is narrow (its cost grows with
    # the width)
    for mem in (card, small):
        assert not hybrid_profitable(232965, 79_000_000, constants=h100,
                                     memory=mem)
    assert hybrid_profitable(2_449_029, 123_700_000, constants=h100,
                             memory=small)
    assert not hybrid_profitable(2_449_029, 123_700_000, constants=h100,
                                 memory=card)
    # flickr-density graphs stay on the gather path
    assert not hybrid_profitable(89250, 1_900_000, constants=h100, memory=card)
    # a graph too large for any strip row block falls out cleanly
    assert auto_strip_cols(40_000_000, e_live=500_000_000, memory=card) == 0


@pytest.mark.parametrize("rb,t", [(32, 32), (64, 32), (8, 32)])
def test_hybrid_tail_shapes(rb, t):
    """The tail arm must be correct for any (row_block, edge_tile) —
    these are probe-tunable knobs (round-2 tail padding work)."""
    import numpy as np

    from maxk_gnn.data.synthetic import rmat_graph
    from maxk_gnn.ops.spmm_hybrid import spmm_hybrid
    from maxk_gnn.ops.spmm_xla import spmm_segsum
    from maxk_gnn.sparse.csr import with_norm
    from maxk_gnn.sparse.hybrid import build_hybrid, degree_perm, permute_csr

    g = rmat_graph(3000, 40000, seed=7)
    pg = permute_csr(g, degree_perm(g))
    x = jax.random.normal(jax.random.PRNGKey(0), (3000, 64))
    ref = np.asarray(spmm_segsum(with_norm(pg, "right"), x))
    h = build_hybrid(pg, s_cols=512, norm="right", row_block=rb, edge_tile=t)
    y = np.asarray(spmm_hybrid(h, x))
    assert np.abs(y - ref).max() < 2e-2  # bf16 strip rounding


@pytest.mark.parametrize("band", [64, 96])
def test_hybrid_banded_tail_matches(band):
    """Column-banded tail (rebased cols, elided empty blocks, per-band
    windows) is numerically identical to the single-band tail, on both
    the host and device builders, fwd + transpose + grad."""
    csr = _graph(v=500, e=4000, seed=21)
    pcsr = permute_csr(csr, degree_perm(csr))
    h0 = build_hybrid(pcsr, s_cols=S, norm="right", strip_dtype=jnp.float32)
    hb = build_hybrid(
        pcsr, s_cols=S, norm="right", strip_dtype=jnp.float32,
        tail_band_cols=band,
    )
    assert hb.tail_band_meta, "banding should engage (v - s > band)"
    hd = build_hybrid_device(
        pcsr, s_cols=S, norm="right", strip_dtype=jnp.float32,
        tail_band_cols=band,
    )
    assert hd.tail_band_meta
    x = _x(csr.num_nodes, seed=9)
    ref = np.asarray(spmm_hybrid(h0, x))
    np.testing.assert_allclose(np.asarray(spmm_hybrid(hb, x)), ref, atol=1e-4)
    np.testing.assert_allclose(np.asarray(spmm_hybrid(hd, x)), ref, atol=1e-4)
    # transpose (A^T = swapped scales) and gradient through the bands
    rt = np.asarray(spmm_hybrid(h0, x, transpose=True))
    np.testing.assert_allclose(
        np.asarray(spmm_hybrid(hb, x, transpose=True)), rt, atol=1e-4
    )
    ct = _x(csr.num_nodes, seed=10)
    g0 = jax.grad(lambda x_: jnp.vdot(spmm_hybrid(h0, x_), ct))(x)
    gb = jax.grad(lambda x_: jnp.vdot(spmm_hybrid(hb, x_), ct))(x)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(g0), atol=1e-4)


def test_effective_band_cap():
    from maxk_gnn.sparse.hybrid import _effective_band

    # under the cap: width unchanged
    assert _effective_band(100_000, 32_768) == 32_768
    # over the cap: widened to ≤12 bands, 128-aligned
    w = _effective_band(2_400_000, 32_768)
    assert w % 128 == 0 and -(-2_400_000 // w) <= 12


def test_build_graph_hybrid_keeps_tail_tile_shape():
    """build_graph's dense-path edge_tile (256) must NOT leak into the
    hybrid tail schedule (tuned per strip dtype: TAIL_EDGE_TILE_INT8 for
    the auto-picked int8 strip on this integer-valued graph,
    TAIL_EDGE_TILE for float strips)."""
    from maxk_gnn.sparse.hybrid import TAIL_EDGE_TILE, TAIL_EDGE_TILE_INT8

    csr = _graph(seed=31)
    g = build_graph(csr, norm="right", hybrid=True, strip_cols=S,
                    edge_tile=256)
    assert g.hybrid is not None
    assert g.hybrid.strip.dtype == jnp.int8  # auto-picked (integer graph)
    assert g.hybrid.tail_tiles.edge_tile == TAIL_EDGE_TILE_INT8
    gf = build_graph(csr, norm="right", hybrid=True, strip_cols=S,
                     edge_tile=256, strip_dtype=jnp.bfloat16)
    assert gf.hybrid.tail_tiles.edge_tile == TAIL_EDGE_TILE


def test_tail_slot_stats_match_built_schedule():
    """The host planning helper predicts exactly the slot counts the
    real builders produce (same ceil/elision rules), banded and not."""
    from maxk_gnn.sparse.hybrid import tail_slot_stats

    csr = _graph(v=500, e=4000, seed=21)
    pcsr = permute_csr(csr, degree_perm(csr))
    h0 = build_hybrid(pcsr, s_cols=S, norm="right", strip_dtype=jnp.float32)
    st0 = tail_slot_stats(pcsr, S, presorted=True)
    assert st0["tiles"] == int(h0.tail_tiles.block.shape[0])
    assert st0["slots"] == st0["tiles"] * h0.tail_tiles.edge_tile
    assert st0["tail_live"] == int(
        np.asarray(jnp.sum(h0.tail_tiles.vals != 0))
    )

    band = 96
    hb = build_hybrid(
        pcsr, s_cols=S, norm="right", strip_dtype=jnp.float32,
        tail_band_cols=band,
    )
    stb = tail_slot_stats(pcsr, S, band_cols=band, presorted=True)
    assert stb["tiles"] == sum(
        int(t.block.shape[0]) for t in hb.tail_bands
    )
    assert stb["n_bands"] == len(hb.tail_bands)
    # banding never reduces slots; inflation is what the rule audits
    assert stb["slots"] >= st0["slots"]
    # unsorted input: helper computes ranks itself, same answer
    st_raw = tail_slot_stats(csr, S)
    assert st_raw["tail_live"] == st0["tail_live"]


def test_int8_strip_exact_on_integer_graph():
    """int8 strip (exact on integer-valued graphs, half the HBM of bf16
    → 2× wider strip at the same budget): fwd, transpose and grad match
    the f32 schedule to bf16-feature precision, on both builders."""
    from maxk_gnn.sparse.hybrid import auto_strip_cols

    csr = _graph(v=500, e=4000, seed=21)
    pcsr = permute_csr(csr, degree_perm(csr))
    h32 = build_hybrid(pcsr, s_cols=S, norm="right", strip_dtype=jnp.float32)
    h8 = build_hybrid(pcsr, s_cols=S, norm="right", strip_dtype=jnp.int8)
    assert h8.strip.dtype == jnp.int8
    np.testing.assert_array_equal(
        np.asarray(h8.strip, np.float32), np.asarray(h32.strip)
    )
    h8d = build_hybrid_device(
        pcsr, s_cols=S, norm="right", strip_dtype=jnp.int8
    )
    np.testing.assert_array_equal(
        np.asarray(h8d.strip, np.float32), np.asarray(h32.strip)
    )
    x = _x(csr.num_nodes, seed=9)
    ref = np.asarray(spmm_hybrid(h32, x))
    # features ride bf16 with the int8 strip: bf16 tolerance
    sc = np.abs(ref).max()
    assert np.abs(np.asarray(spmm_hybrid(h8, x)) - ref).max() < 2e-2 * sc
    assert np.abs(np.asarray(spmm_hybrid(h8d, x)) - ref).max() < 2e-2 * sc
    rt = np.asarray(spmm_hybrid(h32, x, transpose=True))
    assert np.abs(
        np.asarray(spmm_hybrid(h8, x, transpose=True)) - rt
    ).max() < 2e-2 * max(np.abs(rt).max(), 1e-6)
    ct = _x(csr.num_nodes, seed=10)
    g32 = jax.grad(lambda x_: jnp.vdot(spmm_hybrid(h32, x_), ct))(x)
    g8 = jax.grad(lambda x_: jnp.vdot(spmm_hybrid(h8, x_), ct))(x)
    gsc = np.abs(np.asarray(g32)).max()
    assert np.abs(np.asarray(g8) - np.asarray(g32)).max() < 2e-2 * gsc
    # non-integer strip values must be rejected, not silently truncated
    bad = CSRGraph(
        indptr=pcsr.indptr, indices=pcsr.indices,
        values=pcsr.values * 0.5,
    )
    with pytest.raises(ValueError, match="integer strip values"):
        build_hybrid(bad, s_cols=S, strip_dtype=jnp.int8)
    # the width rule: int8 halves the per-column cost
    s2 = auto_strip_cols(300_000, e_live=80_000_000, strip_itemsize=1,
                         s_cols=1 << 30)
    s4 = auto_strip_cols(300_000, e_live=80_000_000, strip_itemsize=2,
                         s_cols=1 << 30)
    assert s2 >= 2 * s4 - 256


def test_feat_int8_lossy_path_within_quant_bound():
    """feat_int8 (LOSSY opt-in, VERDICT r4 #7c): per-column int8 feature
    quantization on the strip matmuls. The strip itself is exact int8,
    so the only error is feature rounding: |Δx| ≤ scale/2 per element →
    |Δy[r]| ≤ deg_norm(r)·scale/2 per output. Checked against the exact
    f32 hybrid, fwd + transpose; tail rows consume UNQUANTIZED features
    and must match exactly to bf16 precision."""
    csr = _graph(v=500, e=4000, seed=21)
    pcsr = permute_csr(csr, degree_perm(csr))
    h8 = build_hybrid(pcsr, s_cols=S, norm="right", strip_dtype=jnp.int8)
    h32 = build_hybrid(pcsr, s_cols=S, norm="right", strip_dtype=jnp.float32)
    x = _x(csr.num_nodes, seed=9)
    ref = np.asarray(spmm_hybrid(h32, x))
    yq = np.asarray(spmm_hybrid(h8, x, feat_int8=True))
    sc = np.abs(ref).max()
    # quant step is ~|x|max/127 ≈ 0.8%/element pre-aggregation; bf16
    # rounding of the quantize input adds a little on top
    err = np.abs(yq - ref)
    assert err.max() < 4e-2 * sc, err.max() / sc
    assert err.mean() < 4e-3 * sc
    # transpose rides the same quantized matmuls (swapped scales)
    rt = np.asarray(spmm_hybrid(h32, x, transpose=True))
    yqt = np.asarray(spmm_hybrid(h8, x, transpose=True, feat_int8=True))
    assert np.abs(yqt - rt).max() < 4e-2 * max(np.abs(rt).max(), 1e-6)
    # a float strip must be rejected: int32 accumulation would be lossy
    # on both operands
    with pytest.raises(ValueError, match="integer strip"):
        spmm_hybrid(h32, x, feat_int8=True)


def test_auto_strip_dtype_rule():
    """Production dtype rule: int8 where exact (integer values within
    int8 range), bf16 otherwise; equal-HBM default width doubles."""
    import jax.numpy as jnp

    from maxk_gnn.data.synthetic import rmat_graph
    from maxk_gnn.sparse.hybrid import (
        STRIP_COLS,
        auto_strip_cols,
        auto_strip_dtype,
        strip_int8_exact,
    )

    g = rmat_graph(512, 4096, seed=3)  # integer-valued (1.0 + dedup)
    assert strip_int8_exact(g)
    assert auto_strip_dtype(g) == jnp.int8

    frac = CSRGraph(
        indptr=g.indptr, indices=g.indices, values=g.values * 0.5
    )
    assert not strip_int8_exact(frac)
    assert auto_strip_dtype(frac) == jnp.bfloat16

    big = CSRGraph(
        indptr=g.indptr, indices=g.indices, values=g.values * 1000.0
    )
    assert not strip_int8_exact(big)

    # measured per-dtype default widths (budget not binding at this V)
    from maxk_gnn.sparse.hybrid import STRIP_COLS_INT8

    s_int8 = auto_strip_cols(200_000, e_live=1_000_000, strip_itemsize=1)
    s_bf16 = auto_strip_cols(200_000, e_live=1_000_000, strip_itemsize=2)
    assert s_bf16 == STRIP_COLS
    assert s_int8 == STRIP_COLS_INT8


def test_build_graph_auto_int8_strip(small_graph):
    """build_graph(hybrid=True) picks the int8 strip automatically on an
    integer-valued graph and stays exact vs the bf16-strip build."""
    import jax.numpy as jnp

    from maxk_gnn.ops.spgemm import spmm
    from maxk_gnn.sparse.graph import build_graph

    g8 = build_graph(small_graph, norm="right", hybrid=True,
                     strip_cols=128, build_tiles=False)
    assert g8.hybrid is not None
    assert g8.hybrid.strip.dtype == jnp.int8
    gb = build_graph(small_graph, norm="right", hybrid=True,
                     strip_cols=128, build_tiles=False,
                     strip_dtype=jnp.float32)
    assert gb.hybrid.strip.dtype == jnp.float32
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal(
            (small_graph.num_nodes, 64)
        ).astype(np.float32)
    )
    y8 = spmm(g8, x, mode="hybrid")
    yf = spmm(gb, x, mode="hybrid")
    # int8 strip holds the same exact integers; only the f32 vs int8
    # read path differs -> results match to f32 rounding
    np.testing.assert_allclose(
        np.asarray(y8), np.asarray(yf), rtol=2e-2, atol=2e-2
    )
