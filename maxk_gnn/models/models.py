"""GNN models: MaxK-accelerated and ReLU baselines, as plain JAX.

Re-design of the reference model stacks (`maxk_models_integrated.py:378-454`
MaxKSAGE/MaxKGCN/MaxKGIN; `utils/models.py:27-220` SAGE/GCN/GIN/GNN_res
baselines). Shared shape: `lin_in → L×[nonlinear → dropout → conv] → lin_out`
with per-family extras (LayerNorm on hidden layers when `norm`, BatchNorm +
residual for GNN_res).

A model is a frozen dataclass of hyperparameters with two methods that
keep the familiar call shapes:

    variables = model.init({"params": key, "dropout": key}, graph, x)
    logits = model.apply(variables, graph, x, train=True,
                         rngs={"dropout": key})
    logits, upd = model.apply(..., mutable=["batch_stats"])

`variables` is `{"params": {...}}`, plus `{"batch_stats": {...}}` for
GNNRes. The nonlinearity is a constructor argument ("maxk" | "relu"),
replicating the reference's control arm (`utils/config.py: --nonlinear`).

Graph norm expectations: SAGE → "right", GCN/GNNRes → "both", GIN → "none"
(see `build_graph`). `build_model()` returns (model, norm_mode).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from maxk_gnn.models.layers import (
    CONVS,
    Agg,
    batch_norm,
    batch_norm_init,
    dense,
    dense_init,
    dropout,
    gcn_conv,
    gcn_conv_init,
    layer_norm,
    layer_norm_init,
)
from maxk_gnn.ops.mask import maxk_activation
from maxk_gnn.sparse.cbsr import cbsr_densify, maxk_cbsr


def _keys(rngs):
    """(params key, dropout key) from a key or an rngs dict."""
    if rngs is None:
        return None, None
    if isinstance(rngs, dict):
        return rngs.get("params"), rngs.get("dropout")
    return rngs, None


@dataclasses.dataclass(frozen=True)
class _GNNBase:
    hidden_dim: int = 256
    num_layers: int = 3
    out_dim: int = 41
    maxk: int = 32
    nonlinear: str = "maxk"  # "maxk" | "relu"
    dropout: float = 0.5
    norm: bool = False  # LayerNorm on hidden layers (config.norm)
    kernel_mode: str = "auto"
    compute_dtype: Optional[jnp.dtype] = None
    conv: str = "sage"

    @property
    def _agg(self) -> Agg:
        return Agg(self.kernel_mode, self.compute_dtype)

    def _nonlinear(self, x, graph):
        """Returns (activated_dense, cbsr_or_None).

        Sharded graphs need the compact CBSR (the compressed all_gather
        moves V·k between devices, and only the explicit custom-VJP op
        carries that collective); there the densify is the only expansion
        per layer and its VJP samples compactly at the selectors. On one
        device `densify(topk(x)) ≡ x ⊙ mask`, so the layers aggregate the
        masked dense features directly."""
        if self.nonlinear == "maxk":
            from maxk_gnn.parallel.shard import ShardedGraph

            if isinstance(graph, ShardedGraph):
                cbsr = maxk_cbsr(x, self.maxk)
                return cbsr_densify(cbsr, x.shape[-1]), cbsr
            return maxk_activation(x, self.maxk), None
        return jax.nn.relu(x), None

    def init(self, rngs, graph, x, train: bool = False) -> dict:
        """Parameters for inputs of width x.shape[-1]. `graph` and `train`
        are accepted for call-shape compatibility; shapes depend on widths
        only."""
        key, _ = _keys(rngs)
        keys = jax.random.split(key, self.num_layers + 2)
        h = self.hidden_dim
        conv_init = CONVS[self.conv][0]
        params = {"lin_in": dense_init(keys[0], x.shape[-1], h)}
        for i in range(self.num_layers):
            params[f"conv{i}"] = conv_init(keys[i + 1], h, h)
            if self.norm:
                params[f"ln{i}"] = layer_norm_init(h)
        params["lin_out"] = dense_init(keys[-1], h, self.out_dim)
        return {"params": params}

    def apply(self, variables, graph, x, train: bool = False, rngs=None,
              mutable=False):
        p = variables["params"]
        _, drop_key = _keys(rngs)
        conv_apply = CONVS[self.conv][1]
        x = dense(p["lin_in"], x)
        for i in range(self.num_layers):
            x, cbsr = self._nonlinear(x, graph)
            x = dropout(x, self.dropout, _layer_key(drop_key, i, train))
            x = conv_apply(p[f"conv{i}"], self._agg, graph, x, cbsr)
            if self.norm:
                x = layer_norm(p[f"ln{i}"], x)
        out = dense(p["lin_out"], x)
        return (out, {}) if mutable else out


def _layer_key(key, i: int, train: bool):
    return jax.random.fold_in(key, i) if train and key is not None else None


@dataclasses.dataclass(frozen=True)
class MaxKSAGE(_GNNBase):
    """`lin_in → L×[MaxK → SAGEConv(mean)] → lin_out`
    (`maxk_models_integrated.py:378-454`)."""

    conv: str = "sage"


@dataclasses.dataclass(frozen=True)
class MaxKGCN(_GNNBase):
    """`lin_in → L×[MaxK → dropout → GraphConv (+LayerNorm)] → lin_out`
    (`all_model.py:423-611`)."""

    conv: str = "gcn"


@dataclasses.dataclass(frozen=True)
class MaxKGIN(_GNNBase):
    """GIN stack with `(1+eps)x + sum_agg` convs (`all_model.py:283-421`)."""

    conv: str = "gin"


# ReLU-defaulting aliases for the baseline arm (`utils/models.py:27-220`).
# Same architecture; nonlinear="relu" switches off the CBSR path entirely.
@dataclasses.dataclass(frozen=True)
class SAGE(MaxKSAGE):
    nonlinear: str = "relu"


@dataclasses.dataclass(frozen=True)
class GCN(MaxKGCN):
    nonlinear: str = "relu"


@dataclasses.dataclass(frozen=True)
class GIN(MaxKGIN):
    nonlinear: str = "relu"


@dataclasses.dataclass(frozen=True)
class GNNRes(_GNNBase):
    """Residual GCN with BatchNorm (`utils/models.py` GNN_res): each layer
    `h = conv(x); h = BN(h); x = relu(h) + x`, mean-pool-free node head."""

    conv: str = "gcn"

    def init(self, rngs, graph, x, train: bool = False) -> dict:
        key, _ = _keys(rngs)
        keys = jax.random.split(key, self.num_layers + 2)
        h = self.hidden_dim
        params = {"lin_in": dense_init(keys[0], x.shape[-1], h)}
        stats = {}
        for i in range(self.num_layers):
            params[f"conv{i}"] = gcn_conv_init(keys[i + 1], h, h)
            params[f"bn{i}"], stats[f"bn{i}"] = batch_norm_init(h)
        params["lin_out"] = dense_init(keys[-1], h, self.out_dim)
        return {"params": params, "batch_stats": stats}

    def apply(self, variables, graph, x, train: bool = False, rngs=None,
              mutable=False):
        p = variables["params"]
        stats = variables["batch_stats"]
        _, drop_key = _keys(rngs)
        new_stats = {}
        x = dense(p["lin_in"], x)
        for i in range(self.num_layers):
            h = gcn_conv(p[f"conv{i}"], self._agg, graph, x, None)
            h, new_stats[f"bn{i}"] = batch_norm(
                p[f"bn{i}"], stats[f"bn{i}"], h, train
            )
            h = dropout(h, self.dropout, _layer_key(drop_key, i, train))
            x = jax.nn.relu(h) + x
        out = dense(p["lin_out"], x)
        if mutable and "batch_stats" in mutable:
            return out, {"batch_stats": new_stats}
        return (out, {}) if mutable else out


_MODEL_NORMS = {
    "sage": (MaxKSAGE, "right"),
    "gcn": (MaxKGCN, "both"),
    "gin": (MaxKGIN, "none"),
    "gnn_res": (GNNRes, "both"),
}


def build_model(
    model: str,
    out_dim: int,
    hidden_dim: int = 256,
    num_layers: int = 3,
    maxk: int = 32,
    nonlinear: str = "maxk",
    dropout: float = 0.5,
    norm: bool = False,
    kernel_mode: str = "auto",
    compute_dtype=None,
):
    """Model factory mirroring the driver's selection
    (`maxk_gnn_integrated.py:271-296`). Returns (model, graph_norm_mode)."""
    cls, gnorm = _MODEL_NORMS[model]
    return (
        cls(
            hidden_dim=hidden_dim,
            num_layers=num_layers,
            out_dim=out_dim,
            maxk=maxk,
            nonlinear=nonlinear,
            dropout=dropout,
            norm=norm,
            kernel_mode=kernel_mode,
            compute_dtype=compute_dtype,
        ),
        gnorm,
    )
