"""The port's general masked 2PL loglik (plain versions, on the CPU) against
the JAX package's Pallas op in interpret mode: `masked_loglik_2pl` on dense
(resp, mask) and `masked_loglik_2pl_packed` on the int8 code. Values, and
the VJP of theta, a and b under a NON-uniform random cotangent (the contract
that sets this op apart from the one-pass training kernel), within 1e-5
relative to each array's largest magnitude: the two frameworks sum f32 in
different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu.ops import pallas_elbo as jelbo
from vibo_tpu_torch.ops import pallas_elbo


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


def _inputs(b, m, k, s=None, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if s is None else (s,)
    resp = (rng.random((b, m)) < 0.5).astype(np.float32)
    mask = (rng.random((b, m)) < 0.8).astype(np.float32)
    mask[b // 2] = 0.0                      # an all-missing row is inert
    theta = rng.standard_normal(lead + (b, k)).astype(np.float32)
    a = rng.standard_normal(lead + (m, k)).astype(np.float32)
    bb = rng.standard_normal(lead + (m,)).astype(np.float32)
    g = rng.random(lead + (b,)).astype(np.float32) * 2.0 - 0.5
    return resp, mask, theta, a, bb, g


def _jax_vjp(fn, g, *args):
    val, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in args))
    return val, vjp(jnp.asarray(g))


def _port_vjp(fn, g, *args):
    ts = [torch.tensor(x, requires_grad=True) for x in args]
    val = fn(*ts)
    (val * torch.from_numpy(g)).sum().backward()
    return val.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("reader", ["dense", "int8"])
@pytest.mark.parametrize("shape", [(45, 130, 4), (9, 20, 1)])
def test_value_and_vjp_any_cotangent(reader, shape):
    resp, mask, theta, a, bb, g = _inputs(*shape)
    if reader == "dense":
        r_j, m_j = jnp.asarray(resp), jnp.asarray(mask)
        jfn = lambda t, a, b: jelbo.masked_loglik_2pl(t, a, b, r_j, m_j)
        r_t, m_t = torch.from_numpy(resp), torch.from_numpy(mask)
        tfn = lambda t, a, b: pallas_elbo.masked_loglik_2pl(t, a, b, r_t, m_t)
    else:
        packed = jelbo.pack_responses(resp, mask)
        pk_j, pk_t = jnp.asarray(packed), torch.from_numpy(packed)
        jfn = lambda t, a, b: jelbo.masked_loglik_2pl_packed(t, a, b, pk_j)
        tfn = lambda t, a, b: pallas_elbo.masked_loglik_2pl_packed(t, a, b,
                                                                   pk_t)
    jval, jgrads = _jax_vjp(jfn, g, theta, a, bb)
    val, grads = _port_vjp(tfn, g, theta, a, bb)
    _close(val, jval)
    assert float(val[shape[0] // 2]) == 0.0
    for got, want in zip(grads, jgrads):
        _close(got, want)


def test_sample_axis_per_sample_items():
    """theta (2, B, K) with per-sample a (2, M, K) and b (2, M), shared
    data: one launch in the port, vmap in JAX."""
    resp, mask, theta, a, bb, g = _inputs(11, 24, 3, s=2, seed=1)
    r_j, m_j = jnp.asarray(resp), jnp.asarray(mask)
    r_t, m_t = torch.from_numpy(resp), torch.from_numpy(mask)
    jval, jgrads = _jax_vjp(
        lambda t, a, b: jelbo.masked_loglik_2pl(t, a, b, r_j, m_j),
        g, theta, a, bb)
    val, grads = _port_vjp(
        lambda t, a, b: pallas_elbo.masked_loglik_2pl(t, a, b, r_t, m_t),
        g, theta, a, bb)
    _close(val, jval)
    for got, want in zip(grads, jgrads):
        _close(got, want)


def test_sample_axis_shared_items_sum_their_gradient():
    """A shared a (the 1PL path's unit a) or b over S samples gets the sum
    of the per-sample gradients: equal to running each sample alone."""
    resp, mask, theta, a, bb, g = _inputs(10, 17, 2, s=3, seed=2)
    r_t, m_t = torch.from_numpy(resp), torch.from_numpy(mask)
    fn = lambda t, a, b: pallas_elbo.masked_loglik_2pl(t, a, b, r_t, m_t)
    val, (dth, da, db) = _port_vjp(fn, g, theta, a[0], bb[0])
    assert da.shape == a[0].shape and db.shape == bb[0].shape
    singles = [_port_vjp(fn, g[s], theta[s], a[0], bb[0]) for s in range(3)]
    _close(val, np.stack([v for v, _ in singles]))
    _close(dth, np.stack([gr[0] for _, gr in singles]))
    _close(da, sum(gr[1] for _, gr in singles))
    _close(db, sum(gr[2] for _, gr in singles))


def test_packed_equals_dense_on_the_code():
    resp, mask, theta, a, bb, g = _inputs(33, 70, 4, seed=3)
    packed = jelbo.pack_responses(resp, mask)
    dense = _port_vjp(lambda t, a, b: pallas_elbo.masked_loglik_2pl(
        t, a, b, torch.from_numpy(resp), torch.from_numpy(mask)),
        g, theta, a, bb)
    code = _port_vjp(lambda t, a, b: pallas_elbo.masked_loglik_2pl_packed(
        t, a, b, torch.from_numpy(packed)), g, theta, a, bb)
    _close(code[0], dense[0])
    for got, want in zip(code[1], dense[1]):
        _close(got, want)


def test_rejects_mismatched_shapes():
    theta = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="do not match"):
        pallas_elbo.masked_loglik_2pl(theta, torch.zeros((5, 2)),
                                      torch.zeros(5), torch.zeros((4, 6)),
                                      torch.zeros((4, 6)))
    with pytest.raises(ValueError, match="int8"):
        pallas_elbo.masked_loglik_2pl_packed(theta, torch.zeros((5, 2)),
                                             torch.zeros(5),
                                             torch.zeros((4, 5)))
