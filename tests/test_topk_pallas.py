"""MaxK mask and top-k → CBSR: the Triton kernel (interpret mode on the
CPU) and the plain `lax` forms against each other and `lax.top_k`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maxk_gnn.ops.mask import mask_plain, mask_triton, maxk_activation
from maxk_gnn.sparse.cbsr import CBSR, cbsr_densify, maxk_cbsr, maxk_mask


def _densify_pair(vals, sel, d):
    return np.asarray(cbsr_densify(CBSR(values=vals, selector=sel), d))


def _triton(x, k):
    return mask_triton(x, k, True)


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("v,d", [(64, 256), (200, 256), (64, 128)])
def test_topk_matches_lax(k, v, d):
    rng = np.random.default_rng(k + v)
    x = jnp.asarray(rng.standard_normal((v, d)), jnp.float32)
    ref = maxk_cbsr(x, k)
    # the CBSR densifies to the mask, and selects k distinct columns
    np.testing.assert_array_equal(
        _densify_pair(ref.values, ref.selector, d), np.asarray(maxk_mask(x, k))
    )
    s = np.sort(np.asarray(ref.selector), axis=1)
    assert np.all(np.diff(s, axis=1) > 0)
    assert ref.selector.dtype == jnp.int32


def test_topk_with_ties():
    x = jnp.asarray(
        np.array([[1.0] * 8 + [0.0] * 8, [2.0, 2.0, 2.0, 2.0] + [-1.0] * 12]),
        jnp.float32,
    )
    c = maxk_cbsr(x, 3)
    np.testing.assert_allclose(np.asarray(c.values), [[1, 1, 1], [2, 2, 2]])
    # ties go to the first columns, as in the mask
    np.testing.assert_array_equal(np.sort(np.asarray(c.selector), 1),
                                  [[0, 1, 2], [0, 1, 2]])
    np.testing.assert_array_equal(
        _densify_pair(c.values, c.selector, 16) != 0,
        np.asarray(mask_plain(x, 3)[1]) == 1,
    )


def test_topk_negative_values():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((64, 256)) - 5.0, jnp.float32)  # all < 0
    y, take = _triton(x, 4)
    ref = maxk_cbsr(x, 4)
    np.testing.assert_array_equal(
        np.asarray(y), _densify_pair(ref.values, ref.selector, 256)
    )
    np.testing.assert_array_equal(np.asarray(take).sum(1), 4)


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("v,d", [(64, 256), (200, 256), (64, 128)])
def test_mask_matches_cbsr_densify(k, v, d):
    rng = np.random.default_rng(k + v + 7)
    x = jnp.asarray(rng.standard_normal((v, d)), jnp.float32)
    y, take = _triton(x, k)
    ref = maxk_cbsr(x, k)
    np.testing.assert_array_equal(
        np.asarray(y), _densify_pair(ref.values, ref.selector, d)
    )
    # mask is 0/1 with exactly k survivors per row (tie-aware), and the
    # kernel agrees with the plain form bit for bit
    t = np.asarray(take, np.float32)
    assert set(np.unique(t)) <= {0.0, 1.0}
    np.testing.assert_array_equal(t.sum(axis=1), k)
    y_p, take_p = mask_plain(x, k)
    np.testing.assert_array_equal(np.asarray(take), np.asarray(take_p))
    np.testing.assert_array_equal(np.asarray(y), np.asarray(y_p))


@pytest.mark.parametrize("impl", [mask_plain, _triton], ids=["plain", "triton"])
def test_mask_ties_exactly_k(impl):
    x = jnp.asarray(
        np.array([[1.0] * 8 + [0.0] * 8, [2.0] * 4 + [-1.0] * 12]),
        jnp.float32,
    )
    y, take = impl(x, 3)
    np.testing.assert_array_equal(np.asarray(take).sum(axis=1), 3)
    np.testing.assert_allclose(np.asarray(y).sum(axis=1), [3.0, 6.0])
    # the first tied columns in column order
    np.testing.assert_array_equal(np.asarray(take)[:, :4], [[1, 1, 1, 0]] * 2)


def test_mask_grad_routes_to_selected():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((64, 256)), jnp.float32)
    k = 8

    def f_ref(x):
        return jnp.sum(cbsr_densify(maxk_cbsr(x, k), 256) ** 2)

    gref = jax.grad(f_ref)(x)
    gx = jax.grad(lambda a: jnp.sum(maxk_activation(a, k) ** 2))(x)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(gref), atol=1e-5)

    # the kernel's mask drives the same VJP rule
    @functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
    def act(a, k):
        return _triton(a, k)[0]

    act.defvjp(lambda a, k: _triton(a, k), lambda k, t, g: (g * t.astype(g.dtype),))
    gt = jax.grad(lambda a: jnp.sum(act(a, k) ** 2))(x)
    np.testing.assert_array_equal(np.asarray(gt), np.asarray(gx))


def test_topk_grad_matches_lax():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((64, 256)), jnp.float32)
    k = 8

    def f_cbsr(x):
        return jnp.sum(maxk_cbsr(x, k).values ** 2)

    def f_mask(x):
        return jnp.sum(maxk_activation(x, k) ** 2)

    np.testing.assert_allclose(
        np.asarray(jax.grad(f_cbsr)(x)), np.asarray(jax.grad(f_mask)(x)), atol=1e-6
    )


def test_triton_kernel_lowered_for_cuda_only():
    x = jnp.ones((64, 256), jnp.float32)
    traced = jax.jit(maxk_activation, static_argnums=1).trace(x, 8)
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "maxk_mask" in cuda
    assert "maxk_mask" not in cpu
    # a width that is not a power of two stays on the plain form
    odd = jax.jit(maxk_activation, static_argnums=1).trace(
        jnp.ones((64, 96)), 8).lower(lowering_platforms=("cuda",)).as_text()
    assert "maxk_mask" not in odd
