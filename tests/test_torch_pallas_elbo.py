"""The port's one-pass 2PL and 3PL training loglik (plain versions, on the
CPU) against the JAX package's Pallas kernels in interpret mode, in both
layouts: `masked_loglik_{2pl,3pl}_packed_train_t` (thetaT (K, B) -> scalar)
and `masked_loglik_{2pl,3pl}_packed_train` ((B, K) -> (B,)). Value and the
gradients of theta, a, b (and g_hat) through each framework's autograd,
within 1e-5 relative to each array's largest magnitude (f32 sums in
different orders). The 3PL op also at the extreme point of
`tests/test_pallas.py` (theta = +-30, g_hat = -25, every cell observed and
right): finite, and equal to JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu.ops import pallas_elbo as jelbo
from vibo_tpu_torch.ops import pallas_elbo


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


def _inputs(b, m, k, seed=0):
    rng = np.random.default_rng(seed)
    resp = (rng.random((b, m)) < 0.5).astype(np.float32)
    mask = (rng.random((b, m)) < 0.8).astype(np.float32)
    packed = jelbo.pack_responses(resp, mask)
    theta = rng.standard_normal((b, k)).astype(np.float32)
    a = rng.standard_normal((m, k)).astype(np.float32)
    bb = rng.standard_normal(m).astype(np.float32)
    gh = (rng.standard_normal(m) - 1.5).astype(np.float32)
    return packed, theta, a, bb, gh


def _ops(link, layout):
    """(JAX op, port op, number of item arrays) of one link and layout."""
    suffix = "_packed_train_t" if layout == "kb" else "_packed_train"
    name = f"masked_loglik_{link}{suffix}"
    return getattr(jelbo, name), getattr(pallas_elbo, name)


def _value_and_grads(link, layout, th_in, items, packed):
    """Value and gradients (theta and every item array) of the op summed
    over persons, in JAX and in the port."""
    jop, top = _ops(link, layout)
    pk = jnp.asarray(packed)
    jfn = lambda t, *xs: jop(t, *xs, pk).sum()
    n = 1 + len(items)
    jval, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(n)))(
        jnp.asarray(th_in), *(jnp.asarray(x) for x in items))
    ts = [torch.tensor(x, requires_grad=True) for x in (th_in, *items)]
    val = top(*ts, torch.from_numpy(packed)).sum()
    val.backward()
    return (val.detach(), [t.grad for t in ts]), (jval, jgrads)


# the (B, K) layout is summed: the uniform cotangent its contract allows
@pytest.mark.parametrize("link", ["2pl", "3pl"])
@pytest.mark.parametrize("layout", ["kb", "bk"])
@pytest.mark.parametrize("shape", [(45, 130, 4), (9, 20, 1),
                                   (23, 70, 12)])   # K > 8: the wide kernels
def test_fused_loglik_value_and_grads(link, layout, shape):
    b, m, k = shape
    packed, theta, a, bb, gh = _inputs(b, m, k)
    th_in = theta.T.copy() if layout == "kb" else theta
    items = (a, bb) if link == "2pl" else (a, bb, gh)
    (val, grads), (jval, jgrads) = _value_and_grads(link, layout, th_in,
                                                    items, packed)
    _close(val, jval)
    for got, want in zip(grads, jgrads):
        _close(got, want)


@pytest.mark.parametrize("link", ["2pl", "3pl"])
def test_per_person_loglik_and_dtheta_any_cotangent(link):
    """(B, K) layout: per-person values, and dtheta exact for a non-uniform
    cotangent (the item gradients assume a uniform one, the documented
    contract)."""
    packed, theta, a, bb, gh = _inputs(33, 70, 3, seed=1)
    items = (a, bb) if link == "2pl" else (a, bb, gh)
    jop, top = _ops(link, "bk")
    g = np.random.default_rng(2).random(33).astype(np.float32)
    pk = jnp.asarray(packed)
    jll, jvjp = jax.vjp(lambda t: jop(t, *map(jnp.asarray, items), pk),
                        jnp.asarray(theta))
    tt = torch.tensor(theta, requires_grad=True)
    ll = top(tt, *map(torch.from_numpy, items), torch.from_numpy(packed))
    (ll * torch.from_numpy(g)).sum().backward()
    _close(ll.detach(), jll)
    _close(tt.grad, jvjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("layout", ["kb", "bk"])
def test_3pl_extreme_point_finite_and_equal_to_jax(layout):
    """theta = +-30 and 0, a = 1, b = 0, g_hat = -25, every cell observed and
    right: the branch ratios stay finite in both frameworks and agree."""
    theta = np.array([[30.0], [-30.0], [0.0]], np.float32)
    a = np.ones((128, 1), np.float32)
    bb = np.zeros(128, np.float32)
    gh = np.full(128, -25.0, np.float32)
    packed = np.full((3, 128), 2, np.int8)
    th_in = theta.T.copy() if layout == "kb" else theta
    (val, grads), (jval, jgrads) = _value_and_grads("3pl", layout, th_in,
                                                    (a, bb, gh), packed)
    assert np.isfinite(float(val))
    _close(val, jval)
    for got, want in zip(grads, jgrads):
        assert torch.isfinite(got).all()
        _close(got, want)
