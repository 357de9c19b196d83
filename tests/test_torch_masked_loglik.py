"""The port's general masked 2PL and 3PL loglik (plain versions, on the CPU)
against the JAX package's Pallas ops in interpret mode:
`masked_loglik_{2pl,3pl}` on dense (resp, mask) and
`masked_loglik_{2pl,3pl}_packed` on the int8 code. Values, and the VJP of
theta, a, b (and g_hat) under a NON-uniform random cotangent (the contract
that sets this op apart from the one-pass training kernel), within 1e-5
relative to each array's largest magnitude: the two frameworks sum f32 in
different orders. With a leading sample axis the items are per-sample or
shared (a shared g_hat, like a and b, sums its gradient over the
samples). The 3PL op also at the extreme point of `tests/test_pallas.py`:
finite, and equal to JAX."""

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


def _inputs(b, m, k, s=None, seed=0, link="2pl"):
    """(resp, mask, g, theta, *items): items (a, b) for 2PL, (a, b, g_hat)
    for 3PL, each with the sample axis s when given."""
    rng = np.random.default_rng(seed)
    lead = () if s is None else (s,)
    resp = (rng.random((b, m)) < 0.5).astype(np.float32)
    mask = (rng.random((b, m)) < 0.8).astype(np.float32)
    mask[b // 2] = 0.0                      # an all-missing row is inert
    theta = rng.standard_normal(lead + (b, k)).astype(np.float32)
    a = rng.standard_normal(lead + (m, k)).astype(np.float32)
    bb = rng.standard_normal(lead + (m,)).astype(np.float32)
    g = rng.random(lead + (b,)).astype(np.float32) * 2.0 - 0.5
    gh = (rng.standard_normal(lead + (m,)) - 1.5).astype(np.float32)
    items = (a, bb) if link == "2pl" else (a, bb, gh)
    return resp, mask, g, theta, items


def _fns(link, reader, resp, mask):
    """(JAX fn, port fn) of (theta, *items) for one link and reader."""
    if reader == "dense":
        data_j = (jnp.asarray(resp), jnp.asarray(mask))
        data_t = (torch.from_numpy(resp), torch.from_numpy(mask))
        name = f"masked_loglik_{link}"
    else:
        packed = jelbo.pack_responses(resp, mask)
        data_j, data_t = (jnp.asarray(packed),), (torch.from_numpy(packed),)
        name = f"masked_loglik_{link}_packed"
    jop, top = getattr(jelbo, name), getattr(pallas_elbo, name)
    return (lambda *xs: jop(*xs, *data_j)), (lambda *xs: top(*xs, *data_t))


def _jax_vjp(fn, g, *args):
    val, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in args))
    return val, vjp(jnp.asarray(g))


def _port_vjp(fn, g, *args):
    ts = [torch.tensor(x, requires_grad=True) for x in args]
    val = fn(*ts)
    (val * torch.from_numpy(g)).sum().backward()
    return val.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("link", ["2pl", "3pl"])
@pytest.mark.parametrize("reader", ["dense", "int8"])
@pytest.mark.parametrize("shape", [(45, 130, 4), (9, 20, 1),
                                   (23, 70, 12)])   # K > 8: the wide kernels
def test_value_and_vjp_any_cotangent(link, reader, shape):
    resp, mask, g, theta, items = _inputs(*shape, link=link)
    jfn, tfn = _fns(link, reader, resp, mask)
    jval, jgrads = _jax_vjp(jfn, g, theta, *items)
    val, grads = _port_vjp(tfn, g, theta, *items)
    _close(val, jval)
    assert float(val[shape[0] // 2]) == 0.0
    assert not grads[0][shape[0] // 2].any()
    for got, want in zip(grads, jgrads):
        _close(got, want)


@pytest.mark.parametrize("link", ["2pl", "3pl"])
def test_sample_axis_per_sample_items(link):
    """theta (2, B, K) with per-sample items (a (2, M, K), b and g_hat
    (2, M)), shared data: one launch in the port, vmap in JAX."""
    resp, mask, g, theta, items = _inputs(11, 24, 3, s=2, seed=1, link=link)
    jfn, tfn = _fns(link, "dense", resp, mask)
    jval, jgrads = _jax_vjp(jfn, g, theta, *items)
    val, grads = _port_vjp(tfn, g, theta, *items)
    _close(val, jval)
    for got, want in zip(grads, jgrads):
        _close(got, want)


@pytest.mark.parametrize("link", ["2pl", "3pl"])
def test_sample_axis_shared_items_sum_their_gradient(link):
    """Shared items (the 1PL path's unit a; a, b and g_hat drawn once) over
    S samples get the sum of the per-sample gradients: equal to running
    each sample alone."""
    resp, mask, g, theta, items = _inputs(10, 17, 2, s=3, seed=2, link=link)
    items = [x[0] for x in items]
    _, fn = _fns(link, "dense", resp, mask)
    val, (dth, *ditems) = _port_vjp(fn, g, theta, *items)
    assert all(d.shape == x.shape for d, x in zip(ditems, items))
    singles = [_port_vjp(fn, g[s], theta[s], *items) for s in range(3)]
    _close(val, np.stack([v for v, _ in singles]))
    _close(dth, np.stack([gr[0] for _, gr in singles]))
    for i, d in enumerate(ditems):
        _close(d, sum(gr[1 + i] for _, gr in singles))


@pytest.mark.parametrize("link", ["2pl", "3pl"])
def test_packed_equals_dense_on_the_code(link):
    resp, mask, g, theta, items = _inputs(33, 70, 4, seed=3, link=link)
    _, dense_fn = _fns(link, "dense", resp, mask)
    _, code_fn = _fns(link, "int8", resp, mask)
    dense = _port_vjp(dense_fn, g, theta, *items)
    code = _port_vjp(code_fn, g, theta, *items)
    _close(code[0], dense[0])
    for got, want in zip(code[1], dense[1]):
        _close(got, want)


@pytest.mark.parametrize("reader", ["dense", "int8"])
def test_3pl_extreme_point_finite_and_equal_to_jax(reader):
    """theta = +-30 and 0, a = 1, b = 0, g_hat = -25, every cell observed and
    right, a non-uniform cotangent: finite, and equal to JAX."""
    theta = np.array([[30.0], [-30.0], [0.0]], np.float32)
    items = (np.ones((128, 1), np.float32), np.zeros(128, np.float32),
             np.full(128, -25.0, np.float32))
    ones = np.ones((3, 128), np.float32)
    g = np.array([1.0, 0.5, 2.0], np.float32)
    jfn, tfn = _fns("3pl", reader, ones, ones)
    jval, jgrads = _jax_vjp(jfn, g, theta, *items)
    val, grads = _port_vjp(tfn, g, theta, *items)
    assert torch.isfinite(val).all()
    _close(val, jval)
    for got, want in zip(grads, jgrads):
        assert torch.isfinite(got).all()
        _close(got, want)


def test_rejects_mismatched_shapes():
    theta = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="do not match"):
        pallas_elbo.masked_loglik_2pl(theta, torch.zeros((5, 2)),
                                      torch.zeros(5), torch.zeros((4, 6)),
                                      torch.zeros((4, 6)))
    with pytest.raises(ValueError, match="do not match"):
        pallas_elbo.masked_loglik_3pl(theta, torch.zeros((5, 2)),
                                      torch.zeros(5), torch.zeros(4),
                                      torch.zeros((4, 5)),
                                      torch.zeros((4, 5)))
    with pytest.raises(ValueError, match="int8"):
        pallas_elbo.masked_loglik_2pl_packed(theta, torch.zeros((5, 2)),
                                             torch.zeros(5),
                                             torch.zeros((4, 5)))
