"""End-to-end training tests: loss decreases, accuracy learns, metrics,
optimizer, checkpointing."""

import jax.numpy as jnp
import numpy as np
import pytest

from maxk_gnn.train.config import TrainConfig, parse_args
from maxk_gnn.train.loop import evaluate, setup, train
from maxk_gnn.train.metrics import compute_micro_f1, rocauc
from maxk_gnn.train.optim import build_optimizer, lookahead


def _cfg(**kw):
    base = dict(
        dataset="flickr",
        model="sage",
        epochs=30,
        lr=0.01,
        hidden_dim=32,
        hidden_layers=2,
        maxk=8,
        dropout=0.0,
        kernel_mode="segsum",
        seed=97,
    )
    base.update(kw)
    return TrainConfig(**base)


def test_training_learns(tiny_data):
    cfg = _cfg()
    state = train(cfg, tiny_data)
    # planted-partition labels are learnable: well above 1/5 chance
    assert state.best_val > 0.5, state.best_val
    assert state.best_test > 0.5


def test_relu_baseline_trains(tiny_data):
    state = train(_cfg(nonlinear="relu", epochs=20), tiny_data)
    assert state.best_val > 0.5


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_other_models_train(tiny_data, model):
    state = train(_cfg(model=model, epochs=40, lr=0.02, norm=True), tiny_data)
    assert state.best_val > 0.4, (model, state.best_val)


def test_hybrid_int8_mode_trains(tiny_data):
    """kernel_mode='hybrid_int8' (LOSSY opt-in: int8×int8 strip matmuls,
    per-column feature quantization) trains end-to-end through the
    custom VJP — the quant error (~0.5%/aggregation) must not break
    learning on the planted-partition task."""
    state = train(_cfg(kernel_mode="hybrid_int8", epochs=30), tiny_data)
    assert np.isfinite(state.best_val)
    assert state.best_val > 0.5, state.best_val


def test_lookahead_optimizer_trains(tiny_data):
    state = train(_cfg(enable_lookahead=True, epochs=20), tiny_data)
    assert state.best_val > 0.4


def test_micro_f1_single_and_multilabel():
    logits = jnp.asarray([[2.0, -1.0], [-1.0, 2.0], [2.0, -1.0]])
    labels = jnp.asarray([0, 1, 1])
    acc = compute_micro_f1(logits, labels)
    np.testing.assert_allclose(float(acc), 2 / 3, rtol=1e-5)
    ml_labels = jnp.asarray([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    f1 = compute_micro_f1(logits, ml_labels)
    # preds: [1,0],[0,1],[1,0]: tp=3, fp=0, fn=1 → f1 = 6/7
    np.testing.assert_allclose(float(f1), 6 / 7, rtol=1e-5)


def test_rocauc_perfect_and_random():
    labels = jnp.asarray([[1.0], [1.0], [0.0], [0.0]])
    perfect = jnp.asarray([[4.0], [3.0], [2.0], [1.0]])
    np.testing.assert_allclose(float(rocauc(perfect, labels)), 1.0, atol=1e-6)
    inverted = -perfect
    np.testing.assert_allclose(float(rocauc(inverted, labels)), 0.0, atol=1e-6)


def test_rocauc_masked():
    labels = jnp.asarray([[1.0], [0.0], [1.0], [0.0]])
    # mask hides the last two (which would make AUC 0); first two are perfect
    scores = jnp.asarray([[2.0], [1.0], [-5.0], [5.0]])
    mask = jnp.asarray([True, True, False, False])
    np.testing.assert_allclose(float(rocauc(scores, labels, mask)), 1.0, atol=1e-6)


def test_lookahead_transform_math():
    import optax

    tx = lookahead(k=2, alpha=0.5)
    params = {"w": jnp.asarray(1.0)}
    state = tx.init(params)
    # step 1: no sync
    updates, state = tx.update({"w": jnp.asarray(0.1)}, state, params)
    params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(float(params["w"]), 1.1, rtol=1e-6)
    # step 2: sync → slow = 1.0 + 0.5*(1.2-1.0) = 1.1; fast = slow
    updates, state = tx.update({"w": jnp.asarray(0.1)}, state, params)
    params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(float(params["w"]), 1.1, rtol=1e-6)
    np.testing.assert_allclose(float(state.slow["w"]), 1.1, rtol=1e-6)


def test_checkpoint_roundtrip(tmp_path, tiny_data):
    import jax

    from maxk_gnn.train.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )

    cfg = _cfg(epochs=2)
    state = setup(cfg, tiny_data)
    payload = {"params": state.variables["params"], "epoch": 2}
    save_checkpoint(str(tmp_path), payload, step=2, is_best=True)
    path = latest_checkpoint(str(tmp_path))
    assert path and path.endswith("ckpt_2")
    template = jax.tree.map(np.zeros_like, payload)
    restored = restore_checkpoint(path, template)
    np.testing.assert_allclose(
        np.asarray(restored["params"]["lin_in"]["kernel"]),
        np.asarray(payload["params"]["lin_in"]["kernel"]),
    )


def test_parse_args_roundtrip():
    cfg = parse_args(
        ["--dataset", "yelp", "--model", "gcn", "--maxk", "16", "--norm"]
    )
    assert cfg.dataset == "yelp"
    assert cfg.model == "gcn"
    assert cfg.maxk == 16
    assert cfg.norm is True


def test_evaluate_entrypoint(tiny_data):
    cfg = _cfg(epochs=1)
    state = setup(cfg, tiny_data)
    tr, va, te = evaluate(state, tiny_data)
    for m in (tr, va, te):
        assert 0.0 <= m <= 1.0


def test_checkpoint_resume_midtraining(tmp_path, tiny_data):
    """Train 10 epochs with checkpointing, kill, resume — final params
    must continue from the checkpoint (new capability vs reference)."""
    from maxk_gnn.train.loop import train

    cfg = _cfg(epochs=6, checkpoint_every=2)
    s1 = train(cfg, tiny_data, checkpoint_dir=str(tmp_path))
    # second run with more epochs resumes from epoch 6's checkpoint
    cfg2 = _cfg(epochs=8, checkpoint_every=2)
    s2 = train(cfg2, tiny_data, checkpoint_dir=str(tmp_path))
    # resumed run retains (or improves) the best metrics
    assert s2.best_val >= s1.best_val - 1e-6
    import os

    names = sorted(os.listdir(tmp_path))
    assert any(n.startswith("ckpt_") for n in names)
    assert "best" in names


class _Recorder:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, {})[step] = float(value)

    def add_text(self, *a):
        pass


def test_resume_matches_uninterrupted_run(tmp_path, tiny_data):
    """A resumed run must replay the exact loss trajectory of an
    uninterrupted one (per-epoch fold_in RNG + full-variables +
    opt_state round-trip) — with dropout active."""
    from maxk_gnn.train.loop import train

    def cfg(epochs, ck=0):
        return _cfg(epochs=epochs, checkpoint_every=ck, dropout=0.3)

    wa = _Recorder()
    train(cfg(8), tiny_data, writer=wa)

    wb1 = _Recorder()
    train(cfg(4, ck=2), tiny_data, writer=wb1, checkpoint_dir=str(tmp_path))
    wb2 = _Recorder()
    train(cfg(8, ck=2), tiny_data, writer=wb2, checkpoint_dir=str(tmp_path))

    # resumed epochs 4..7 must match the uninterrupted run's losses
    for e in range(4, 8):
        assert e in wb2.scalars["loss"], "run B did not resume at epoch 4"
        np.testing.assert_allclose(
            wb2.scalars["loss"][e], wa.scalars["loss"][e], rtol=1e-6
        )


def test_multilabel_training(tiny_data):
    """yelp/proteins regime: multilabel BCE + micro-F1 path end-to-end."""
    import numpy as np

    from maxk_gnn.data.datasets import GraphData
    from maxk_gnn.data.synthetic import planted_partition_data

    feats, labels, masks = planted_partition_data(
        tiny_data.csr, 32, 6, seed=11, multilabel=True
    )
    data = GraphData(
        name="tiny_ml",
        csr=tiny_data.csr,
        features=feats,
        labels=labels,
        train_mask=masks[0],
        val_mask=masks[1],
        test_mask=masks[2],
        num_classes=6,
        multilabel=True,
    )
    assert labels.shape == (tiny_data.csr.num_nodes, 6)
    state = train(_cfg(epochs=25, lr=0.02), data)
    # multilabel micro-F1 should beat the all-negative baseline
    assert state.best_val > 0.3, state.best_val


def test_proteins_edge_feature_init(tiny_data):
    from maxk_gnn.data.proteins import (
        node_features_from_edges,
        synthetic_edge_features,
    )

    ef = synthetic_edge_features(tiny_data.csr, 8)
    nf = node_features_from_edges(tiny_data.csr, ef)
    assert nf.shape == (tiny_data.csr.num_nodes, 8)
    # row 0's features = sum of its incident edge features
    import numpy as np

    indptr = np.asarray(tiny_data.csr.indptr)
    np.testing.assert_allclose(
        np.asarray(nf)[0], ef[indptr[0] : indptr[1]].sum(0), rtol=1e-5
    )
