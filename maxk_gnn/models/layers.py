"""Graph convolution layers over the maxk_gnn aggregation ops, as plain
init/apply functions on nested-dict parameters.

Re-design of the reference layer zoo:
  sage_conv  ← MaxKSAGEConv `maxk_models_integrated.py:45-376`
  gcn_conv   ← MaxKGraphConv `all_model.py:45-281` (DGL GraphConv)
  gin_conv   ← MaxKGINConv `all_model.py:283-421` (DGL GINConv)

Differences by design:
  - Degree normalization is folded into the graph's edge values at build
    time (`build_graph(norm=...)`), not applied as pre/post feature
    scaling per forward (`all_model.py:167-176`) — the VJP is then exactly
    A^T and the in/out-degree bookkeeping of the reference autograd
    functions disappears.
  - Each layer takes an optional CBSR; when given on a sharded graph,
    aggregation runs the compact maxk_spgemm path (precomputed-topk design
    of `spgemmfunction.py`), otherwise the dense spmm path.

Parameter names and shapes follow the usual Dense/LayerNorm/BatchNorm
convention: `{"kernel": (in, out), "bias": (out,)}`, `{"scale", "bias"}`,
and BatchNorm running statistics `{"mean", "var"}` kept apart from the
trained parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from maxk_gnn.ops.spgemm import maxk_spgemm, spmm
from maxk_gnn.sparse.cbsr import CBSR

_kernel_init = jax.nn.initializers.lecun_normal()


# ---------------------------------------------------------------------------
# dense building blocks
# ---------------------------------------------------------------------------


def dense_init(key, in_dim: int, out_dim: int, use_bias: bool = True) -> dict:
    p = {"kernel": _kernel_init(key, (in_dim, out_dim), jnp.float32)}
    if use_bias:
        p["bias"] = jnp.zeros((out_dim,), jnp.float32)
    return p


def dense(p: dict, x):
    y = x @ p["kernel"].astype(x.dtype)
    return y + p["bias"].astype(x.dtype) if "bias" in p else y


def layer_norm_init(dim: int) -> dict:
    return {"scale": jnp.ones((dim,), jnp.float32),
            "bias": jnp.zeros((dim,), jnp.float32)}


def layer_norm(p: dict, x, eps: float = 1e-6):
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * p["scale"] + p["bias"]


def batch_norm_init(dim: int) -> tuple[dict, dict]:
    """(params, running statistics)."""
    return (
        {"scale": jnp.ones((dim,), jnp.float32),
         "bias": jnp.zeros((dim,), jnp.float32)},
        {"mean": jnp.zeros((dim,), jnp.float32),
         "var": jnp.ones((dim,), jnp.float32)},
    )


def batch_norm(p: dict, stats: dict, x, train: bool,
               momentum: float = 0.99, eps: float = 1e-5):
    """Returns (y, new running statistics). Training normalizes by the
    batch (all nodes) and updates the running averages; evaluation uses
    the running averages and returns them unchanged."""
    if train:
        mean = jnp.mean(x, axis=0)
        var = jnp.mean(jnp.square(x - mean), axis=0)
        stats = {
            "mean": momentum * stats["mean"] + (1 - momentum) * mean,
            "var": momentum * stats["var"] + (1 - momentum) * var,
        }
    else:
        mean, var = stats["mean"], stats["var"]
    y = (x - mean) * jax.lax.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y, stats


def dropout(x, rate: float, key: Optional[jax.Array]):
    """Inverted dropout; identity when `key` is None or rate is 0."""
    if key is None or rate == 0.0:
        return x
    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))


# ---------------------------------------------------------------------------
# graph convolutions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Agg:
    """How a conv aggregates: the SpMM kernel mode and compute dtype."""

    kernel_mode: str = "auto"
    compute_dtype: Optional[jnp.dtype] = None

    def __call__(self, graph, x, cbsr: Optional[CBSR] = None):
        if cbsr is not None:
            from maxk_gnn.parallel.shard import ShardedGraph

            if isinstance(graph, ShardedGraph):
                # sharded: the compressed-CBSR all_gather path (V·k over
                # the interconnect instead of V·D) needs the explicit
                # custom-VJP op. Resample values from x so post-densify
                # transforms (the model's dropout) reach the aggregation,
                # matching the single-device path; with no dropout this is
                # exactly cbsr.values again (x == densify(cbsr)).
                from maxk_gnn.sparse.cbsr import cbsr_sample

                cbsr = dataclasses.replace(
                    cbsr, values=cbsr_sample(x, cbsr.selector)
                )
                return maxk_spgemm(
                    graph,
                    cbsr,
                    dim=x.shape[-1],
                    mode=self.kernel_mode,
                    compute_dtype=self.compute_dtype,
                )
            # single-device: x IS densify(cbsr) (computed once by the
            # model); spmm's VJP is Aᵀ and the mask's VJP keeps the
            # selected coordinates, so plain autodiff already gives the
            # SSpMM-backward
        if self.compute_dtype is not None:
            y = spmm(graph, x.astype(self.compute_dtype), mode=self.kernel_mode)
            return y.astype(x.dtype)
        return spmm(graph, x, mode=self.kernel_mode)

    def dense_spmm(self, graph, x):
        return spmm(graph, x, mode=self.kernel_mode)


def sage_conv_init(key, in_dim: int, out_dim: int) -> dict:
    """GraphSAGE conv, mean aggregator (graph built with norm="right")."""
    k1, k2 = jax.random.split(key)
    return {"fc_self": dense_init(k1, in_dim, out_dim),
            "fc_neigh": dense_init(k2, in_dim, out_dim, use_bias=False)}


def sage_conv(p: dict, agg: Agg, graph, x, cbsr=None):
    """`fc_self(x) + fc_neigh(mean_agg(x))`. When fc_neigh shrinks the
    width, it runs before aggregation (`maxk_models_integrated.py:247`);
    that breaks CBSR sparsity, so the compact path applies only when
    aggregation comes first."""
    in_dim, out_dim = p["fc_neigh"]["kernel"].shape
    if in_dim > out_dim:
        h_neigh = agg.dense_spmm(graph, dense(p["fc_neigh"], x))
    else:
        h_neigh = dense(p["fc_neigh"], agg(graph, x, cbsr))
    return dense(p["fc_self"], x) + h_neigh


def gcn_conv_init(key, in_dim: int, out_dim: int) -> dict:
    """GCN conv (graph built with norm="both", `all_model.py:167-176`)."""
    return {"weight": dense_init(key, in_dim, out_dim)}


def gcn_conv(p: dict, agg: Agg, graph, x, cbsr=None):
    in_dim, out_dim = p["weight"]["kernel"].shape
    if in_dim > out_dim:
        return agg.dense_spmm(graph, dense(p["weight"], x))
    return dense(p["weight"], agg(graph, x, cbsr))


def gin_conv_init(key, in_dim: int, out_dim: int,
                  mlp_hidden: Optional[int] = None, init_eps: float = 0.0) -> dict:
    """GIN conv (graph built with norm="none"). `apply_func` is the
    2-layer MLP (Dense → ReLU → Dense) of the reference's fixed GIN
    (`GIN:17-21` — the bare-Dense variant was the bug its "CRITICAL FIX"
    comment repairs); eps is learned."""
    k1, k2 = jax.random.split(key)
    hid = mlp_hidden or out_dim
    return {"eps": jnp.asarray(init_eps, jnp.float32),
            "apply_func_0": dense_init(k1, in_dim, hid),
            "apply_func_1": dense_init(k2, hid, out_dim)}


def gin_conv(p: dict, agg: Agg, graph, x, cbsr=None):
    """`apply_func((1+eps)·x + sum_agg(x))` (`all_model.py:410-411`)."""
    h = (1.0 + p["eps"]) * x + agg(graph, x, cbsr)
    h = jax.nn.relu(dense(p["apply_func_0"], h))
    return dense(p["apply_func_1"], h)


CONVS = {
    "sage": (sage_conv_init, sage_conv),
    "gcn": (gcn_conv_init, gcn_conv),
    "gin": (gin_conv_init, gin_conv),
}
