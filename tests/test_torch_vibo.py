"""The port's packed ELBO against the JAX package: the three terms of
`elbo_packed_sums` and the gradient of the bound with respect to EVERY
parameter, on params from the JAX `init_params` and the same numpy noise.

Tolerances: 1e-4 relative to each array's largest magnitude at f32 (the two
frameworks sum in different orders); 2e-2 at bf16, where the two round the
encoder's operands at the same places but accumulate in different orders,
so a rounding flip of one bf16 operand moves a value by up to 2^-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu.ops import objectives as jobj
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.models import VIBO, VIBOConfig
from vibo_tpu_torch.ops import objectives

N, M, K, H, S = 29, 37, 3, 24, 2


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


@pytest.mark.parametrize("transposed,dtype,cond,tol", [
    (True, "float32", "sample", 1e-4),
    (False, "float32", "sample", 1e-4),
    (True, "float32", "mean", 1e-4),
    (True, "bfloat16", "sample", 2e-2),
])
def test_elbo_packed_sums_terms_and_grads(transposed, dtype, cond, tol):
    rng = np.random.default_rng(0)
    resp = (rng.random((N, M)) < 0.55).astype(np.float32)
    mask = (rng.random((N, M)) < 0.8).astype(np.float32)
    mask[3] = 0.0                          # an all-missing row: KL excluded
    packed = jpack(resp, mask)
    kw = dict(num_items=M, irt_model="2pl", ability_dim=K, hidden_dim=H,
              condition_on=cond, use_pallas=True, compute_dtype=dtype)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(1))
    item_eps = {"a": rng.standard_normal((S, M, K)).astype(np.float32),
                "b": rng.standard_normal((S, M, 1)).astype(np.float32)}
    shape = (S, K, N) if transposed else (S, N, K)
    theta_eps = rng.standard_normal(shape).astype(np.float32)

    def jbound(p):
        ll, klt, kli = jmodel.elbo_packed_sums(
            p, jnp.asarray(packed), jax.tree.map(jnp.asarray, item_eps),
            jnp.asarray(theta_eps), transposed=transposed)
        return jobj.elbo(ll, klt, kli), (ll, klt, kli)

    (_, jterms), jgrads = jax.value_and_grad(jbound, has_aux=True)(jparams)

    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    terms = model.elbo_packed_sums(
        params, torch.from_numpy(packed),
        {k: torch.from_numpy(v) for k, v in item_eps.items()},
        torch.from_numpy(theta_eps), transposed=transposed)
    objectives.elbo(*terms).backward()

    for got, want in zip(terms, jterms):
        _close(got.detach(), want, tol)
    jleaves = jax.tree.leaves(jgrads)       # dict keys sorted, as tree_leaves
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves) == 10
    for p, g in zip(leaves, jleaves):
        assert p.grad.shape == g.shape
        _close(p.grad, g, tol)
