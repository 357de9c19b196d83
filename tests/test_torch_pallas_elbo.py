"""The port's one-pass 2PL training loglik (plain version, on the CPU)
against the JAX package's Pallas kernels in interpret mode, in both layouts:
`masked_loglik_2pl_packed_train_t` (thetaT (K, B) -> scalar) and
`masked_loglik_2pl_packed_train` ((B, K) -> (B,)). Value and the gradients
of theta, a and b through each framework's autograd, within 1e-5 relative
to each array's largest magnitude (f32 sums in different orders)."""

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
    return packed, theta, a, bb


@pytest.mark.parametrize("layout", ["kb", "bk"])
@pytest.mark.parametrize("shape", [(45, 130, 4), (9, 20, 1)])
def test_fused_loglik_value_and_grads(layout, shape):
    b, m, k = shape
    packed, theta, a, bb = _inputs(b, m, k)
    pk = jnp.asarray(packed)
    # the (B, K) layout is summed: the uniform cotangent its contract allows
    if layout == "kb":
        th_in = theta.T.copy()
        jfn = lambda t, a, b: jelbo.masked_loglik_2pl_packed_train_t(
            t, a, b, pk)
        tfn = pallas_elbo.masked_loglik_2pl_packed_train_t
    else:
        th_in = theta
        jfn = lambda t, a, b: jelbo.masked_loglik_2pl_packed_train(
            t, a, b, pk).sum()
        tfn = lambda *xs: pallas_elbo.masked_loglik_2pl_packed_train(
            *xs).sum()
    jval, jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        jnp.asarray(th_in), jnp.asarray(a), jnp.asarray(bb))
    ts = [torch.tensor(x, requires_grad=True) for x in (th_in, a, bb)]
    val = tfn(*ts, torch.from_numpy(packed))
    val.backward()
    _close(val.detach(), jval)
    for t, g in zip(ts, jgrads):
        _close(t.grad, g)


def test_per_person_loglik_and_dtheta_any_cotangent():
    """(B, K) layout: per-person values, and dtheta exact for a non-uniform
    cotangent (da/db assume a uniform one, the documented contract)."""
    packed, theta, a, bb = _inputs(33, 70, 3, seed=1)
    g = np.random.default_rng(2).random(33).astype(np.float32)
    pk = jnp.asarray(packed)
    jll, jvjp = jax.vjp(lambda t: jelbo.masked_loglik_2pl_packed_train(
        t, jnp.asarray(a), jnp.asarray(bb), pk), jnp.asarray(theta))
    tt = torch.tensor(theta, requires_grad=True)
    ll = pallas_elbo.masked_loglik_2pl_packed_train(
        tt, torch.from_numpy(a), torch.from_numpy(bb),
        torch.from_numpy(packed))
    (ll * torch.from_numpy(g)).sum().backward()
    _close(ll.detach(), jll)
    _close(tt.grad, jvjp(jnp.asarray(g))[0])
