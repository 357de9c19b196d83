"""The packed objectives run their S samples as the JAX package's vmap over
them runs (`VIBO._packed_samples`, `_tile_samples`): the encoder once, on
the item draws' leading sample axis, its first layer's fused op once on
the code.

At bf16 where the samples meet is part of the numbers. JAX rounds each
dense weight's gradient to bf16 once, after the sum over the samples and
the persons, and hands the first layer's backward the cotangent summed
over the samples, rounded once. An encoder run once a sample rounds each
sample's share apart: at S = 5 that put the port's first and second
dense-weight gradients 6.5e-4 to 2.2e-3 (relative L2) from JAX's in the
cases below; with the samples meeting where they meet in JAX every leaf
is within 4.5e-5 (most within 1e-6). So the bf16 ELBO gradient is held
leaf by leaf at 2e-4 here, and the encoder's calls are counted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu.ops import objectives as jobj
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.models import VIBO, VIBOConfig, networks
from vibo_tpu_torch.ops import objectives

S, C = 5, 5


def _case(irt: str, n: int, m: int, k: int, h: int, transposed: bool,
          **cfg):
    """(JAX model, its params, port model, packed code, item eps, theta
    eps) at S samples, bf16, use_pallas."""
    rng = np.random.default_rng(0)
    cats = C if irt == "grm" else 2
    resp = (rng.integers(0, C, (n, m)) if irt == "grm"
            else rng.random((n, m)) < 0.55).astype(np.float32)
    mask = (rng.random((n, m)) < 0.8).astype(np.float32)
    kw = dict(num_items=m, irt_model=irt, ability_dim=k, hidden_dim=h,
              use_pallas=True, compute_dtype="bfloat16",
              num_categories=cats, **cfg)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(1))
    widths = {"a": k, "b": cats - 1}
    item_eps = {name: rng.standard_normal((S, m, d)).astype(np.float32)
                for name, d in widths.items()}
    theta_eps = rng.standard_normal(
        (S, k, n) if transposed else (S, n, k)).astype(np.float32)
    return (jmodel, jparams, VIBO(VIBOConfig(**kw), device="cpu"),
            jpack(resp, mask), item_eps, theta_eps)


@pytest.mark.parametrize("irt,n,m,k,h,transposed", [
    ("2pl", 200, 64, 1, 32, True),        # the at-scale model's layout
    ("2pl", 300, 100, 1, 64, True),
    ("grm", 120, 40, 2, 32, False),       # theta (B, K)
])
def test_bf16_elbo_gradients_meet_where_jax_sums_the_samples(irt, n, m, k,
                                                             h, transposed):
    jmodel, jparams, model, packed, item_eps, theta_eps = _case(
        irt, n, m, k, h, transposed)

    def jbound(p):
        return jobj.elbo(*jmodel.elbo_packed_sums(
            p, jnp.asarray(packed), jax.tree.map(jnp.asarray, item_eps),
            jnp.asarray(theta_eps), transposed=transposed))

    jgrads = jax.tree.leaves(jax.grad(jbound)(jparams))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    objectives.elbo(*model.elbo_packed_sums(
        params, torch.from_numpy(packed),
        {name: torch.from_numpy(v) for name, v in item_eps.items()},
        torch.from_numpy(theta_eps), transposed=transposed)).backward()
    leaves = tree_leaves(params)
    assert len(leaves) == len(jgrads) == 10
    for p, g in zip(leaves, jgrads):
        got, want = p.grad.double().numpy(), np.asarray(g, np.float64)
        assert np.linalg.norm(got - want) <= 2e-4 * np.linalg.norm(want)


@pytest.mark.parametrize("objective", ["elbo", "iwae"])
@pytest.mark.parametrize("condition_on", ["sample", "mean"])
def test_packed_objectives_run_the_encoder_once(monkeypatch, objective,
                                                condition_on):
    """The fused first layer and the head once an objective, whether the
    encoder reads the draw ("sample": on its sample axis) or not ("mean":
    shared by every sample); every sample's theta and loglik still come
    out, the head's (mu, logvar) (S, K, B) sliced a sample each."""
    _, _, model, packed, item_eps, theta_eps = _case(
        "2pl", 40, 24, 1, 16, True, condition_on=condition_on)
    seen = []
    first_layer = networks.pallas_encoder.packed_first_layer
    monkeypatch.setattr(networks.pallas_encoder, "packed_first_layer",
                        lambda *a, **kw: seen.append(1) or first_layer(
                            *a, **kw))
    params = model.init_params(0)
    args = (params, torch.from_numpy(packed),
            {name: torch.from_numpy(v) for name, v in item_eps.items()},
            torch.from_numpy(theta_eps))
    if objective == "elbo":
        terms = model.elbo_packed_sums(*args, transposed=True)
    else:
        terms = model.iwae_packed_terms(*args, transposed=True)
        assert terms[0].shape == (S,)
    assert len(seen) == 1
    assert all(torch.isfinite(t).all() for t in terms)


def test_2d_tile_runs_its_encoder_once(monkeypatch):
    """The 2D tile's item-sharded encoder once an objective, on the draws'
    sample axis, and the same ELBO terms as the unsharded packed objective
    on a tile of the whole matrix (no mesh: item_index 0, one shard)."""
    _, _, model, packed, item_eps, theta_eps = _case(
        "2pl", 40, 24, 1, 16, False)
    seen = []
    sharded = networks.apply_ability_encoder_item_sharded
    monkeypatch.setattr(networks, "apply_ability_encoder_item_sharded",
                        lambda *a, **kw: seen.append(1) or sharded(*a, **kw))
    params = model.init_params(0)
    code = torch.from_numpy(packed)
    eps = {name: torch.from_numpy(v) for name, v in item_eps.items()}
    theta = torch.from_numpy(theta_eps)
    valid = (code > 0).any(-1).float()
    tile = model.elbo_packed_sums_2d(params, code, eps, theta, valid, 0)
    assert len(seen) == 1
    whole = model.elbo_packed_sums(params, code, eps, theta, valid)
    for got, want in zip(tile, whole):
        np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
