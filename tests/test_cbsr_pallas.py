"""CBSR densify (row scatter) and sample (`take_along_axis`) against the
compare-select-sum formulation, and their VJPs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maxk_gnn.sparse.cbsr import CBSR, cbsr_densify, cbsr_sample, maxk_cbsr


def _onehot_densify(vals, sel, d):
    hit = sel[..., None] == jnp.arange(d)
    return jnp.sum(jnp.where(hit, vals[..., None], 0.0), axis=1)


def _onehot_sample(z, sel):
    hit = sel[..., None] == jnp.arange(z.shape[-1])
    return jnp.sum(jnp.where(hit, z[:, None, :], 0.0), axis=-1)


@pytest.mark.parametrize("v,k,d", [(64, 8, 128), (700, 32, 256), (64, 1, 128)])
def test_densify_matches_xla(v, k, d):
    rng = np.random.default_rng(v + k)
    x = jnp.asarray(rng.standard_normal((v, d)), jnp.float32)
    cbsr = maxk_cbsr(x, k)
    ref = np.asarray(_onehot_densify(cbsr.values, cbsr.selector, d))
    got = np.asarray(jax.jit(cbsr_densify, static_argnums=1)(cbsr, d))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32


@pytest.mark.parametrize("v,k,d", [(64, 8, 128), (700, 32, 256)])
def test_sample_matches_take_along(v, k, d):
    rng = np.random.default_rng(v)
    z = jnp.asarray(rng.standard_normal((v, d)), jnp.float32)
    sel = jnp.asarray(
        np.stack([rng.choice(d, k, replace=False) for _ in range(v)]), jnp.int32
    )
    ref = np.asarray(_onehot_sample(z, sel))
    got = np.asarray(jax.jit(cbsr_sample)(z, sel))
    np.testing.assert_array_equal(got, ref)


def test_densify_sample_vjp_pair():
    """densify's VJP is sample (and sample's is densify)."""
    rng = np.random.default_rng(3)
    v, k, d = 64, 8, 128
    x = jnp.asarray(rng.standard_normal((v, d)), jnp.float32)
    cbsr = maxk_cbsr(x, k)
    ct = jnp.asarray(rng.standard_normal((v, d)), jnp.float32)

    _, vjp = jax.vjp(lambda vals: cbsr_densify(CBSR(vals, cbsr.selector), d),
                     cbsr.values)
    np.testing.assert_array_equal(
        np.asarray(vjp(ct)[0]), np.asarray(cbsr_sample(ct, cbsr.selector))
    )
    _, vjp_s = jax.vjp(lambda z: cbsr_sample(z, cbsr.selector), ct)
    np.testing.assert_array_equal(
        np.asarray(vjp_s(cbsr.values)[0]), np.asarray(cbsr_densify(cbsr, d))
    )


def test_densify_keeps_bf16_values():
    """bf16 values come back as a bf16 array with the values unchanged
    (the scatter itself runs in f32)."""
    rng = np.random.default_rng(5)
    v, k, d = 300, 16, 256
    x = jnp.asarray(rng.standard_normal((v, d)), jnp.bfloat16)
    cbsr = maxk_cbsr(x, k)
    got = jax.jit(cbsr_densify, static_argnums=1)(cbsr, d)
    assert got.dtype == jnp.bfloat16
    ref = _onehot_densify(cbsr.values.astype(jnp.float32), cbsr.selector, d)
    np.testing.assert_array_equal(np.asarray(got, np.float32), np.asarray(ref))
