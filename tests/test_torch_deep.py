"""The deep nonlinear link of the port against the JAX package's, at the
Pallas tests' shapes (B = 48, M = 200, K = 4, D = 16, H = 128):

- `networks.apply_deep_link` (values and every gradient through
  torch.utils.checkpoint) at f32 and bf16, unchunked and in item blocks of
  64 on a ragged M, and with a leading sample axis;
- the one-pass op `pallas_deep.masked_loglik_deep_packed_train` (on a CPU
  tensor: its plain version `fused_deep_plain`) against the Pallas op in
  interpret mode, bf16 and f32 products: ll, every gradient under a
  non-uniform cotangent (dtheta, dW_theta and db1 exact for it; dd,
  dW_item, dW2, db2, dwo and dbo scaled by its first entry, the Pallas op's
  contract), a sample axis, a padded ragged shape and an all-missing row;
- the plain version's item blocking, and the op's routing and shape checks.

Tolerances, relative to each array's largest magnitude: 1e-5 where both
sides compute in f32 and only sum in different orders (the link at f32, the
op with f32 products); 1e-3 for the op with bf16 products and 5e-3 for the
link at bf16: both sides round the same operands to bf16, but an operand
whose f32 value differs in its last bit between the two (t1 = theta W + b1
is summed in another order) and lands on a rounding boundary rounds the
other way, moving one term of a sum by 2^-8 of itself (measured: 3.6e-5 for
the op, 6.2e-4 for the link).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu.models import networks as jnet
from vibo_tpu.ops import pallas_deep as jpd
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.models import networks
from vibo_tpu_torch.ops import _build, pallas_deep

B, M, K, D, H = 48, 200, 4, 16, 128


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


def _link(seed=0, h=H):
    """JAX's init_deep_link, nudged so no weight is exactly zero."""
    rng = np.random.default_rng(seed + 100)
    link = jnet.init_deep_link(jax.random.key(seed), K, D, h)
    return jax.tree.map(lambda x: x + jnp.asarray(
        0.05 * rng.standard_normal(x.shape).astype(np.float32)), link)


def _data(rng, b=B, m=M, lead=()):
    theta = rng.standard_normal(lead + (b, K)).astype(np.float32)
    d = rng.standard_normal(lead + (m, D)).astype(np.float32)
    resp = (rng.random((b, m)) < 0.5).astype(np.float32)
    mask = (rng.random((b, m)) < 0.8).astype(np.float32)
    return theta, d, resp, mask


@pytest.mark.parametrize("dtype,chunk,lead,tol", [
    ("float32", 0, (), 1e-5),
    ("float32", 64, (), 1e-5),
    ("bfloat16", 0, (), 5e-3),
    ("bfloat16", 64, (), 5e-3),
    ("float32", 64, (2,), 1e-5),
])
def test_apply_deep_link_matches_jax(dtype, chunk, lead, tol):
    rng = np.random.default_rng(1)
    link = _link()
    theta, d, _, _ = _data(rng, lead=lead)
    w = rng.standard_normal(lead + (B, M)).astype(np.float32)

    def jloss(th, dd, lk):
        out = jnet.apply_deep_link(lk, th, dd, chunk, jnp.dtype(dtype))
        return (out * w).sum(), out
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(theta), jnp.asarray(d), link)

    params = params_from_jax(jax.tree.map(np.asarray, link), "cpu")
    th = torch.tensor(theta, requires_grad=True)
    dd = torch.tensor(d, requires_grad=True)
    out = networks.apply_deep_link(params, th, dd, chunk, dtype)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach(), jout, tol)
    _close(th.grad, jgrads[0], tol)
    _close(dd.grad, jgrads[1], tol)
    leaves = tree_leaves(params)
    assert len(leaves) == len(jax.tree.leaves(jgrads[2])) == 7
    for p, g in zip(leaves, jax.tree.leaves(jgrads[2])):
        _close(p.grad, g, tol)


def _op_case(f32_dots, b=B, m=M, lead=(), shared_d=False, seed=2, h=H):
    """The op and its gradients under one cotangent, JAX (interpret mode)
    and the port, on the same numpy inputs. Returns [(got, want)]."""
    rng = np.random.default_rng(seed)
    link = _link(seed, h)
    theta, d, resp, mask = _data(rng, b, m, lead)
    if shared_d:
        d = d[0]
    mask[3] = 0.0                          # an all-missing row
    packed = jpack(resp, mask)
    g = (2.0 * rng.random(lead + (b,)) - 0.5).astype(np.float32)

    def jcall(th, dd, lk):
        if shared_d:
            dd = jnp.broadcast_to(dd, lead + dd.shape)
        return jpd.masked_loglik_deep_packed_train(
            th, dd, lk, jnp.asarray(packed), interpret=True,
            f32_dots=f32_dots)

    jll = jcall(jnp.asarray(theta), jnp.asarray(d), link)
    _, vjp = jax.vjp(jcall, jnp.asarray(theta), jnp.asarray(d), link)
    jgrads = vjp(jnp.asarray(g))

    params = params_from_jax(jax.tree.map(np.asarray, link), "cpu")
    th = torch.tensor(theta, requires_grad=True)
    dd = torch.tensor(d, requires_grad=True)
    ll = pallas_deep.masked_loglik_deep_packed_train(
        th, dd, params, torch.from_numpy(packed), f32_dots=f32_dots)
    (ll * torch.from_numpy(g)).sum().backward()
    assert torch.equal(ll[..., 3].detach(), torch.zeros(lead))
    assert torch.equal(th.grad[..., 3, :], torch.zeros(lead + (K,)))
    pairs = [(ll.detach(), jll), (th.grad, jgrads[0]), (dd.grad, jgrads[1])]
    pairs += list(zip([p.grad for p in tree_leaves(params)],
                      jax.tree.leaves(jgrads[2])))
    assert len(pairs) == 10
    return pairs


@pytest.mark.parametrize("f32_dots,tol", [(False, 1e-3), (True, 1e-5)])
def test_op_matches_pallas_under_a_cotangent(f32_dots, tol):
    for got, want in _op_case(f32_dots):
        _close(got, want, tol)


@pytest.mark.parametrize("lead,shared_d,b,m", [
    ((3,), False, 40, 70),
    ((2,), True, 40, 70),
    ((), False, 37, 150),                 # padded ragged shape in JAX
])
def test_op_sample_axis_and_ragged_shape(lead, shared_d, b, m):
    for got, want in _op_case(False, b, m, lead, shared_d, seed=3):
        _close(got, want, 1e-3)


@pytest.mark.parametrize("h", [256, 384, 512])
@pytest.mark.parametrize("f32_dots,tol", [(False, 1e-3), (True, 1e-5)])
def test_op_matches_pallas_at_width_384(h, f32_dots, tol):
    """384 and the other widths the CUDA kernel takes on a thread-block
    cluster (256, 512: W2 and dW2 outgrow one SM): the op's contract does
    not depend on H."""
    for got, want in _op_case(f32_dots, 24, 70, seed=5, h=h):
        _close(got, want, tol)


def test_pooled_gradients_follow_the_first_cotangent():
    """dtheta, dW_theta and db1 carry each person's own cotangent; the
    pooled gradients (dd, dW_item, layer2, out) are the uniform
    cotangent's, scaled by g[0]."""
    rng = np.random.default_rng(4)
    link = params_from_jax(jax.tree.map(np.asarray, _link(4)), "cpu")
    theta, d, resp, mask = _data(rng, 24, 40)
    packed = torch.from_numpy(jpack(resp, mask))
    g = torch.from_numpy((rng.random(24) + 0.5).astype(np.float32))
    grads = []
    for cot in (g, torch.full_like(g, float(g[0]))):
        for p in tree_leaves(link):
            p.grad = None
        th = torch.tensor(theta, requires_grad=True)
        dd = torch.tensor(d, requires_grad=True)
        ll = pallas_deep.masked_loglik_deep_packed_train(th, dd, link, packed)
        (ll * cot).sum().backward()
        grads.append({"theta": th.grad, "d": dd.grad,
                      **{n: p.grad.clone() for n, p in
                         zip(["b1", "b2", "w2", "bo", "wo", "w_item",
                              "w_theta"], tree_leaves(link))}})
    per_person, uniform = grads
    for name in ("d", "w_item", "b2", "w2", "bo", "wo"):
        assert torch.equal(per_person[name], uniform[name]), name
    for name in ("theta", "w_theta", "b1"):
        assert not torch.allclose(per_person[name], uniform[name]), name


def test_plain_item_blocks_and_routing():
    """fused_deep_plain gives the same sums in item blocks of any size, the
    op on a CPU tensor launches nothing, and bad shapes or devices raise."""
    rng = np.random.default_rng(5)
    link = params_from_jax(jax.tree.map(np.asarray, _link(5)), "cpu")
    theta, d, resp, mask = _data(rng, 33, 90)
    packed = torch.from_numpy(jpack(resp, mask))
    t1 = torch.from_numpy(theta) @ link["w_theta"].detach() + link["b1"].detach()
    t2 = torch.from_numpy(d) @ link["w_item"].detach()
    args = (t1, t2, link["layer2"]["w"].detach(), link["layer2"]["b"].detach(),
            link["out"]["w"].detach().reshape(-1), link["out"]["b"].detach(),
            packed)
    whole = pallas_deep.fused_deep_plain(*args)
    for block in (1, 7, 64):
        for x, y in zip(pallas_deep.fused_deep_plain(*args, item_block=block),
                        whole):
            _close(x, y, 1e-5)
    _build.reset_launches()
    ll = pallas_deep.masked_loglik_deep_packed_train(
        torch.from_numpy(theta), torch.from_numpy(d), link, packed)
    _close(ll.detach(), whole[0], 0.0)
    assert pallas_deep.TRAIN.launches == 0 and pallas_deep.TRAIN._fn is None
    assert pallas_deep.supports(link)
    assert not pallas_deep.supports({"w_theta": torch.zeros((K, 96))})
    with pytest.raises(ValueError, match="int8"):
        pallas_deep.masked_loglik_deep_packed_train(
            torch.from_numpy(theta), torch.from_numpy(d), link,
            packed.float())
    with pytest.raises(ValueError, match="shapes"):
        pallas_deep.masked_loglik_deep_packed_train(
            torch.from_numpy(theta), torch.from_numpy(d[:50]), link, packed)
    with pytest.raises(ValueError, match="devices"):
        pallas_deep.masked_loglik_deep_packed_train(
            torch.from_numpy(theta).to("meta"), torch.from_numpy(d), link,
            packed)
