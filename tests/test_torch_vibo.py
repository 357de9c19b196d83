"""The port's packed ELBO against the JAX package: the three terms of
`elbo_packed_sums` and the gradient of the bound with respect to EVERY
parameter, on params from the JAX `init_params` and the same numpy noise,
for the 2PL and the 3PL link (both theta layouts), the GRM and GPCM
families (C = 5, theta (B, K), their one-pass ops) and the deep link
(theta (B, K); the one-pass op with deep_fused_kernel, else the decoded
plain link in item blocks, JAX's default).

Tolerances: 1e-4 relative to each array's largest magnitude at f32 (the two
frameworks sum in different orders); 2e-2 at bf16, where the two round the
encoder's operands at the same places but accumulate in different orders,
so a rounding flip of one bf16 operand moves a value by up to 2^-8.

The deep link's one-pass op rounds its products' operands to bf16 at any
compute dtype, on both sides; 1e-3 there, as an operand may round the other
way in one framework (tests/test_torch_deep.py).

The decoded-data `elbo` and `iwae` are held the same way, on JAX's own
noise replayed from its key, for use_pallas on and off, 1PL, 2PL, 3PL, GRM,
GPCM and deep, S = 1 to 3, item_scale < 1 and an all-missing row.
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

from jax_noise_replay import replay_noise

N, M, K, H, S = 29, 37, 3, 24, 2
C = 5                                      # grm/gpcm categories
DL = 4                                     # deep: item latent dim
# deep: the op's width (a multiple of 128), item blocks of 16 (ragged M)
DEEP = dict(item_latent_dim=DL, deep_hidden_dim=128, deep_item_chunk=16)


def _deep_kw(irt_model: str) -> dict:
    return DEEP if irt_model == "deep" else {}


def _categories(irt_model: str) -> int:
    return C if irt_model in ("grm", "gpcm") else 2


def _item_shapes(irt_model: str, m: int, k: int) -> dict:
    """{name: (M, D)} of the link's item parameters (the head spec)."""
    spec = {"1pl": {"b": 1}, "2pl": {"a": k, "b": 1},
            "3pl": {"a": k, "b": 1, "g_hat": 1},
            "grm": {"a": k, "b": C - 1},
            "gpcm": {"a": k, "b": C - 1},
            "deep": {"d": DL}}[irt_model]
    return {n: (m, d) for n, d in spec.items()}


def _responses(rng, irt_model: str, shape):
    """Binary responses, or categories 0..C-1 for grm/gpcm."""
    if irt_model in ("grm", "gpcm"):
        return rng.integers(0, C, shape).astype(np.float32)
    return (rng.random(shape) < 0.55).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


@pytest.mark.parametrize("transposed,dtype,cond,tol,irt", [
    (True, "float32", "sample", 1e-4, "2pl"),
    (False, "float32", "sample", 1e-4, "2pl"),
    (True, "float32", "mean", 1e-4, "2pl"),
    (True, "bfloat16", "sample", 2e-2, "2pl"),
    (True, "float32", "sample", 1e-4, "3pl"),
    (False, "float32", "sample", 1e-4, "3pl"),
    (True, "bfloat16", "sample", 2e-2, "3pl"),
    (False, "float32", "sample", 1e-4, "grm"),
    (False, "float32", "mean", 1e-4, "grm"),
    (False, "bfloat16", "sample", 2e-2, "grm"),
    (False, "float32", "sample", 1e-4, "gpcm"),
    (False, "bfloat16", "sample", 2e-2, "gpcm"),
])
def test_elbo_packed_sums_terms_and_grads(transposed, dtype, cond, tol, irt):
    _packed_case(dict(irt_model=irt, condition_on=cond, compute_dtype=dtype,
                      num_categories=_categories(irt)), transposed, tol)


@pytest.mark.parametrize("fused,dtype,cond,tol", [
    (True, "float32", "sample", 1e-3),
    (True, "bfloat16", "mean", 2e-2),
    (False, "float32", "sample", 1e-4),
    (False, "bfloat16", "sample", 2e-2),
])
def test_deep_elbo_packed_sums_terms_and_grads(fused, dtype, cond, tol):
    """deep under use_pallas: the fused first layer always; the loglik the
    one-pass op (deep_fused_kernel) or the decoded plain link."""
    _packed_case(dict(irt_model="deep", condition_on=cond,
                      compute_dtype=dtype, deep_fused_kernel=fused, **DEEP),
                 False, tol)


def _packed_case(cfg: dict, transposed: bool, tol: float):
    """elbo_packed_sums' terms and every gradient, JAX and the port, on
    the same params and numpy noise under the config cfg."""
    irt = cfg["irt_model"]
    rng = np.random.default_rng(0)
    resp = _responses(rng, irt, (N, M))
    mask = (rng.random((N, M)) < 0.8).astype(np.float32)
    mask[3] = 0.0                          # an all-missing row: KL excluded
    packed = jpack(resp, mask)
    kw = dict(num_items=M, ability_dim=K, hidden_dim=H, use_pallas=True,
              **cfg)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(1))
    item_eps = {n: rng.standard_normal((S,) + shp).astype(np.float32)
                for n, shp in _item_shapes(irt, M, K).items()}
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
    # 3 encoder layers (w, b), each item parameter's (mu, logvar), and the
    # deep link's 7 leaves
    assert len(leaves) == len(jleaves) == (
        6 + 2 * len(item_eps) + (7 if irt == "deep" else 0))
    for p, g in zip(leaves, jleaves):
        assert p.grad.shape == g.shape
        _close(p.grad, g, tol)


# ------------------------------------------------ decoded-data objectives
#
# JAX draws its noise from a key inside elbo/iwae; the port's cores take it
# from outside, replayed from the same key (jax_noise_replay).

DN, DM, DK, DH = 13, 21, 2, 16


def _decoded_setup(irt_model, use_pallas, dtype, cond, seed=0):
    rng = np.random.default_rng(seed)
    resp = _responses(rng, irt_model, (DN, DM))
    mask = (rng.random((DN, DM)) < 0.8).astype(np.float32)
    mask[3] = 0.0                          # an all-missing row: inert
    kw = dict(num_items=DM, irt_model=irt_model, ability_dim=DK,
              hidden_dim=DH, conditional_posterior=cond,
              use_pallas=use_pallas, compute_dtype=dtype,
              num_categories=_categories(irt_model), **_deep_kw(irt_model))
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(seed + 1))
    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    names = _item_shapes(irt_model, DM, DK)
    return resp, mask, jmodel, jparams, model, params, names


def _check_grads(params, jgrads, tol):
    jleaves = jax.tree.leaves(jgrads)       # dict keys sorted, as tree_leaves
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves)
    for p, g in zip(leaves, jleaves):
        assert p.grad.shape == g.shape
        _close(p.grad, g, tol)


DECODED_CASES = [  # use_pallas, irt_model, S, item_scale, dtype, cond, tol
    (True, "2pl", 1, 0.25, "float32", True, 1e-4),
    (True, "2pl", 2, 0.5, "float32", True, 1e-4),
    (False, "2pl", 2, 1.0, "float32", True, 1e-4),
    (True, "1pl", 2, 0.5, "float32", False, 1e-4),
    (False, "1pl", 1, 0.3, "float32", True, 1e-4),
    (True, "2pl", 2, 0.5, "bfloat16", True, 2e-2),
    (True, "3pl", 2, 0.5, "float32", True, 1e-4),
    (False, "3pl", 1, 0.3, "float32", True, 1e-4),
    (True, "3pl", 2, 0.5, "bfloat16", True, 2e-2),
    (True, "grm", 2, 0.5, "float32", True, 1e-4),
    (False, "grm", 1, 0.3, "float32", False, 1e-4),
    (True, "grm", 2, 0.5, "bfloat16", True, 2e-2),
    (True, "gpcm", 2, 0.5, "float32", True, 1e-4),
    (True, "gpcm", 2, 0.5, "bfloat16", True, 2e-2),
    (True, "deep", 2, 0.5, "float32", True, 1e-4),
    (False, "deep", 1, 0.3, "float32", False, 1e-4),
    (True, "deep", 2, 0.5, "bfloat16", True, 2e-2),
]


@pytest.mark.parametrize("use_pallas,irt,s,scale,dtype,cond,tol",
                         DECODED_CASES)
def test_elbo_decoded_terms_and_grads(use_pallas, irt, s, scale, dtype, cond,
                                      tol):
    resp, mask, jmodel, jparams, model, params, names = _decoded_setup(
        irt, use_pallas, dtype, cond)
    key = jax.random.key(7)
    (_, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.elbo(p, key, jnp.asarray(resp), jnp.asarray(mask),
                              scale, s), has_aux=True)(jparams)
    item_eps, theta_eps = replay_noise(key, s, names, DN, DK)
    bound, aux = model.elbo_eps(params, torch.from_numpy(resp),
                                torch.from_numpy(mask), item_eps, theta_eps,
                                scale)
    bound.backward()
    for name in ("elbo", "loglik", "kl_theta", "kl_items"):
        _close(aux[name].detach(), jaux[name], tol)
    _check_grads(params, jgrads, tol)


@pytest.mark.parametrize("use_pallas,irt,s,scale,dtype,cond,tol", [
    (True, "2pl", 3, 0.5, "float32", True, 1e-4),
    (False, "2pl", 1, 1.0, "float32", True, 1e-4),
    (True, "1pl", 2, 0.25, "float32", False, 1e-4),
    (False, "1pl", 2, 0.7, "float32", True, 1e-4),
    (True, "2pl", 2, 0.5, "bfloat16", True, 2e-2),
    (True, "3pl", 3, 0.5, "float32", True, 1e-4),
    (False, "3pl", 2, 0.7, "float32", False, 1e-4),
    (True, "3pl", 2, 0.5, "bfloat16", True, 2e-2),
    (True, "grm", 3, 0.5, "float32", True, 1e-4),
    (True, "gpcm", 2, 0.7, "float32", False, 1e-4),
    (True, "gpcm", 2, 0.5, "bfloat16", True, 2e-2),
    (True, "deep", 3, 0.5, "float32", True, 1e-4),
    (True, "deep", 2, 0.5, "bfloat16", False, 2e-2),
])
def test_iwae_decoded_bound_and_grads(use_pallas, irt, s, scale, dtype, cond,
                                      tol):
    resp, mask, jmodel, jparams, model, params, names = _decoded_setup(
        irt, use_pallas, dtype, cond, seed=1)
    key = jax.random.key(8)
    jbound, jgrads = jax.value_and_grad(
        lambda p: jmodel.iwae(p, key, jnp.asarray(resp), jnp.asarray(mask),
                              s, scale))(jparams)
    item_eps, theta_eps = replay_noise(key, s, names, DN, DK)
    bound = model.iwae_eps(params, torch.from_numpy(resp),
                           torch.from_numpy(mask), item_eps, theta_eps, scale)
    bound.backward()
    _close(bound.detach(), jbound, tol)
    _check_grads(params, jgrads, tol)


def test_elbo_packed_sums_without_fused_kernels():
    """use_pallas=False decodes the code and runs the decoded-data path."""
    rng = np.random.default_rng(2)
    resp = (rng.random((N, M)) < 0.55).astype(np.float32)
    mask = (rng.random((N, M)) < 0.8).astype(np.float32)
    mask[5] = 0.0
    packed = jpack(resp, mask)
    kw = dict(num_items=M, irt_model="2pl", ability_dim=K, hidden_dim=H,
              use_pallas=False)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(3))
    item_eps = {"a": rng.standard_normal((S, M, K)).astype(np.float32),
                "b": rng.standard_normal((S, M, 1)).astype(np.float32)}
    theta_eps = rng.standard_normal((S, N, K)).astype(np.float32)

    def jbound(p):
        terms = jmodel.elbo_packed_sums(
            p, jnp.asarray(packed), jax.tree.map(jnp.asarray, item_eps),
            jnp.asarray(theta_eps))
        return jobj.elbo(*terms), terms

    (_, jterms), jgrads = jax.value_and_grad(jbound, has_aux=True)(jparams)
    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    terms = model.elbo_packed_sums(
        params, torch.from_numpy(packed),
        {k: torch.from_numpy(v) for k, v in item_eps.items()},
        torch.from_numpy(theta_eps))
    objectives.elbo(*terms).backward()
    for got, want in zip(terms, jterms):
        _close(got.detach(), want, 1e-4)
    _check_grads(params, jgrads, 1e-4)
    with pytest.raises(ValueError, match="use_pallas"):
        model.elbo_packed_sums(params, torch.from_numpy(packed),
                               {k: torch.from_numpy(v)
                                for k, v in item_eps.items()},
                               torch.from_numpy(theta_eps), transposed=True)


@pytest.mark.parametrize("objective", ["elbo", "iwae"])
def test_generator_wrappers_draw_sample_noise(objective):
    """VIBO.elbo / VIBO.iwae are their eps-taking cores on
    sample_noise(batch, S) drawn from the same generator."""
    resp, mask, _, _, model, params, _ = _decoded_setup("2pl", True,
                                                        "float32", True)
    resp, mask = torch.from_numpy(resp), torch.from_numpy(mask)
    gens = [torch.Generator(), torch.Generator()]
    for g in gens:
        g.manual_seed(5)
    item_eps, theta_eps = model.sample_noise(DN, 2, generator=gens[1])
    if objective == "elbo":
        got, _ = model.elbo(params, resp, mask, 0.5, 2, gens[0])
        want, _ = model.elbo_eps(params, resp, mask, item_eps, theta_eps, 0.5)
    else:
        got = model.iwae(params, resp, mask, 2, 0.5, gens[0])
        want = model.iwae_eps(params, resp, mask, item_eps, theta_eps, 0.5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("irt", ["grm", "gpcm"])
def test_polytomous_config_layout_and_scoring_paths(irt):
    """grm/gpcm: C in [3, 32], theta (B, K) on the packed path (the JAX
    wants_transposed_theta), no transposed ELBO, no binary response_prob;
    category_logprobs and the argmax imputation against JAX's."""
    with pytest.raises(ValueError, match="num_categories"):
        VIBOConfig(num_items=4, irt_model=irt, num_categories=2)
    with pytest.raises(ValueError, match="num_categories"):
        VIBOConfig(num_items=4, irt_model=irt, num_categories=33)
    with pytest.raises(ValueError, match="polytomous"):
        VIBOConfig(num_items=4, irt_model="2pl", num_categories=5)
    resp, mask, jmodel, jparams, model, params, names = _decoded_setup(
        irt, True, "float32", True)
    assert not model.wants_transposed_theta()
    assert not jmodel.wants_transposed_theta()
    means = model.item_posterior_mean(params)
    jmeans = {k: jnp.asarray(v.detach().numpy()) for k, v in means.items()}
    theta = np.random.default_rng(4).standard_normal((DN, DK)).astype(
        np.float32)
    got = model.category_logprobs(params, torch.from_numpy(theta), means)
    want = jmodel.category_logprobs(jparams, jnp.asarray(theta), jmeans)
    _close(got.detach(), want, 1e-5)
    pred = model.impute_category_with_items(
        params, torch.from_numpy(resp), torch.from_numpy(mask), means)
    jpred = jmodel.impute_category_with_items(
        jparams, jnp.asarray(resp), jnp.asarray(mask), jmeans)
    assert pred.shape == (DN, DM)
    # a near-tie between two categories could flip one cell
    assert (pred.numpy() == np.asarray(jpred)).mean() > 0.99
    with pytest.raises(ValueError, match="polytomous"):
        model.response_prob(params, torch.from_numpy(theta), means)
    packed = torch.from_numpy(jpack(resp, mask))
    eps = model.sample_noise(DN, 1)
    with pytest.raises(ValueError, match="transposed"):
        model.elbo_packed_sums(params, packed, *eps, transposed=True)
