"""Test configuration: an 8-device virtual CPU mesh.

Sharding/multi-device tests run against `xla_force_host_platform_device_count`.
Tests that need the card are marked `gpu` and take the `gpu_device`
fixture, which skips them unless `MAXK_TEST_GPU=1` is set and JAX finds a
GPU. On the card:

    MAXK_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

ON_GPU = os.environ.get("MAXK_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")

from maxk_gnn.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test unless MAXK_TEST_GPU=1 and JAX has one."""
    if not ON_GPU:
        pytest.skip("needs the card: run with MAXK_TEST_GPU=1 on a GPU host")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"MAXK_TEST_GPU=1 but JAX found {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def small_graph():
    """Deterministic random ~200-node graph (undirected + self loops)."""
    from maxk_gnn.data.synthetic import rmat_graph

    return rmat_graph(200, 1500, seed=123)


@pytest.fixture(scope="session")
def tiny_data():
    from maxk_gnn.data.datasets import GraphData
    from maxk_gnn.data.synthetic import planted_partition_data, rmat_graph

    csr = rmat_graph(200, 1500, seed=7)
    feats, labels, masks = planted_partition_data(csr, 32, 5, seed=7)
    return GraphData(
        name="tiny",
        csr=csr,
        features=feats,
        labels=labels,
        train_mask=masks[0],
        val_mask=masks[1],
        test_mask=masks[2],
        num_classes=5,
        multilabel=False,
    )

