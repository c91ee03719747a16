"""On the card: the compiled Triton mask and the `auto` SpMM against their
plain references. Skipped unless MAXK_TEST_GPU=1 (tests/conftest.py):

    MAXK_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("k", [8, 32, 64])
def test_triton_mask_compiles_and_matches_plain(gpu_device, k):
    from maxk_gnn.ops.mask import mask_plain, mask_triton, maxk_activation

    x = jax.random.normal(jax.random.PRNGKey(k), (4099, 256), jnp.float32)
    y, take = mask_triton(x, k)
    y_ref, take_ref = mask_plain(x, k)
    np.testing.assert_array_equal(np.asarray(take), np.asarray(take_ref))
    np.testing.assert_array_equal(np.asarray(y), np.asarray(y_ref))
    # the production op lowers the Triton branch on the card
    hlo = jax.jit(maxk_activation, static_argnums=1).lower(x, k).as_text()
    assert "maxk_mask" in hlo


def test_auto_spmm_matches_reference(gpu_device):
    from maxk_gnn.data.synthetic import rmat_graph
    from maxk_gnn.ops.dispatch import KernelMode, choose_mode
    from maxk_gnn.ops.spgemm import spmm
    from maxk_gnn.ops.spmm_xla import spmm_segsum_scan
    from maxk_gnn.sparse.graph import build_graph

    csr = rmat_graph(4096, 200_000, seed=3)
    mode = choose_mode("auto", csr, 256)  # the device's f32 choice
    g = build_graph(csr, norm="right", build_tiles=mode in (
        KernelMode.TILES_XLA, KernelMode.TILES_SCAN))
    x = jax.random.normal(jax.random.PRNGKey(0), (4096, 256))
    y = jax.jit(lambda gr, a: spmm(gr, a, mode=mode.value))(g, x)
    with jax.default_matmul_precision("highest"):
        ref = spmm_segsum_scan(g.csr, x)
    rel = float(jnp.max(jnp.abs(y - ref)) / jnp.max(jnp.abs(ref)))
    assert rel <= 1e-4, rel
