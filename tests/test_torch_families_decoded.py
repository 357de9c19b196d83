"""The posterior and conditioning families on decoded (response, mask)
data, the port against the JAX package: the minibatch ELBO (`elbo_sums`
through `elbo_eps`) and IWAE bound (`iwae_terms` through `iwae_eps`) of
1PL/2PL/3PL/GRM/GPCM under theta_posterior chol, laplace and laplace-w,
each with condition_on sample, mean and stats, on JAX's own noise replayed
from its key (tests/jax_noise_replay.py), and the evaluation of a
full-covariance posterior: infer_posterior_means with the scale tril,
iwae_per_person, iwae_loglik and the refinement of the Cholesky family.

Tolerances: 1e-4 of each array's largest magnitude for the objectives and
their gradients at f32 (2e-2 at bf16), 1e-5 for the evaluation outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu import evaluation as jeval
from vibo_tpu.data.masking import holdout_split as jholdout
from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu_torch import evaluation
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.data.masking import holdout_split
from vibo_tpu_torch.models import VIBO, VIBOConfig

from jax_noise_replay import replay_noise

N, M, K, H = 13, 17, 2, 16
C = 5


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


def _setup(cfg: dict, seed=0, n=N, m=M):
    irt = cfg["irt_model"]
    rng = np.random.default_rng(seed)
    if irt in ("grm", "gpcm"):
        resp = rng.integers(0, C, (n, m)).astype(np.float32)
    else:
        resp = (rng.random((n, m)) < 0.55).astype(np.float32)
    mask = (rng.random((n, m)) < 0.8).astype(np.float32)
    mask[3] = 0.0                          # an all-missing row: inert
    kw = dict(num_items=m, ability_dim=K, hidden_dim=H,
              num_categories=C if irt in ("grm", "gpcm") else 2, **cfg)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(seed + 1))
    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    shapes = {name: (m, d) for name, d in model._head_spec.items()}
    return resp, mask, jmodel, jparams, model, params, shapes


def _grads_agree(params, jgrads, tol):
    jleaves = jax.tree.leaves(jgrads)
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves)
    for p, g in zip(leaves, jleaves):
        _close(p.grad, g, tol)


def decoded_objectives_agree(cfg: dict, tol: float, s: int = 2):
    """elbo (its four aux terms) and iwae, and the gradients of both with
    respect to every parameter, on JAX's noise; item_scale 0.5."""
    resp, mask, jmodel, jparams, model, params, shapes = _setup(cfg)
    jr, jm = jnp.asarray(resp), jnp.asarray(mask)
    tr, tm = torch.from_numpy(resp), torch.from_numpy(mask)
    key = jax.random.key(7)
    (_, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.elbo(p, key, jr, jm, 0.5, s), has_aux=True)(jparams)
    bound, aux = model.elbo_eps(params, tr, tm,
                                *replay_noise(key, s, shapes, N, K), 0.5)
    bound.backward()
    for name in ("elbo", "loglik", "kl_theta", "kl_items"):
        _close(aux[name].detach(), jaux[name], tol)
    _grads_agree(params, jgrads, tol)
    for leaf in tree_leaves(params):
        leaf.grad = None
    key = jax.random.key(8)
    jbound, jgrads = jax.value_and_grad(
        lambda p: jmodel.iwae(p, key, jr, jm, s + 1, 0.5))(jparams)
    bound = model.iwae_eps(params, tr, tm,
                           *replay_noise(key, s + 1, shapes, N, K), 0.5)
    bound.backward()
    _close(bound.detach(), jbound, tol)
    _grads_agree(params, jgrads, tol)


@pytest.mark.parametrize("cond", ["sample", "mean", "stats"])
@pytest.mark.parametrize("family", ["chol", "laplace", "laplace-w"])
@pytest.mark.parametrize("irt", ["1pl", "2pl", "3pl", "grm", "gpcm"])
def test_decoded_objectives_match_jax(irt, family, cond):
    decoded_objectives_agree(dict(irt_model=irt, theta_posterior=family,
                                  condition_on=cond), 1e-4)


@pytest.mark.parametrize("cfg,tol", [
    (dict(irt_model="2pl", theta_posterior="laplace-w", condition_on="stats",
          compute_dtype="bfloat16"), 2e-2),
    (dict(irt_model="3pl", theta_posterior="chol", condition_on="sample",
          use_pallas=True), 1e-4),
    (dict(irt_model="deep", theta_posterior="chol", condition_on="stats",
          item_latent_dim=4, deep_hidden_dim=32, deep_item_chunk=8), 1e-4),
    (dict(irt_model="2pl", theta_posterior="chol",
          conditional_posterior=False), 1e-4),
])
def test_decoded_objectives_more_configs_match_jax(cfg, tol):
    """bf16, the general masked op (use_pallas), the deep link under chol
    with stats, and the mean-field encoder with the chol head."""
    decoded_objectives_agree(cfg, tol)


@pytest.mark.parametrize("family", ["chol", "laplace-w"])
def test_iwae_per_person_matches_jax(family):
    resp, mask, jmodel, jparams, model, params, shapes = _setup(
        dict(irt_model="2pl", theta_posterior=family, condition_on="stats"))
    key = jax.random.key(3)
    want = jmodel.iwae_per_person(jparams, key, jnp.asarray(resp),
                                  jnp.asarray(mask), 4, 40)
    got = model.iwae_per_person(params, torch.from_numpy(resp),
                                torch.from_numpy(mask), 4, 40,
                                noise=replay_noise(key, 4, shapes, N, K))
    _close(got.detach(), want, 1e-5)


@pytest.fixture(scope="module", params=["chol", "laplace-w"])
def evaluated(request):
    """A trained-shape model of the family on a held-out split: JAX's
    params, both packages' datasets."""
    resp, mask, jmodel, jparams, model, params, shapes = _setup(
        dict(irt_model="2pl", theta_posterior=request.param,
             condition_on="stats"), n=40)
    jds = jholdout(resp, mask, 0.2, seed=0)
    ds = holdout_split(resp, mask, 0.2, seed=0)
    return jmodel, jparams, model, params, jds, ds, shapes


def test_posterior_means_scale_tril_matches_jax(evaluated):
    jmodel, jparams, model, params, jds, ds, _ = evaluated
    want = jeval.infer_posterior_means(jmodel, jparams, jds, block_size=16,
                                       return_scale_tril=True)
    got = evaluation.infer_posterior_means(model, params, ds, block_size=16,
                                           return_scale_tril=True)
    for g, w in ((got[0], want[0]), (got[2], want[2]), (got[3], want[3])):
        _close(g, w, 1e-5)
    # the marginal sds are the tril's row norms, and the tril is lower
    np.testing.assert_allclose(got[2], np.sqrt((got[3] ** 2).sum(-1)),
                               rtol=1e-5)
    assert np.all(np.triu(got[3], 1) == 0.0)


def test_iwae_loglik_matches_jax(evaluated):
    jmodel, jparams, model, params, jds, ds, shapes = evaluated
    key = jax.random.key(11)
    want = jeval.iwae_loglik(jmodel, jparams, key, jds, num_samples=5)
    state = {"key": key}

    def noise(_bi, rows):
        state["key"], sub = jax.random.split(state["key"])
        return replay_noise(sub, 5, shapes, rows, K)
    got = evaluation.iwae_loglik(model, params, ds, num_samples=5,
                                 noise=noise)
    assert got["num_cells"] == want["num_cells"]
    _close(got["loglik"], want["loglik"], 1e-5)


@pytest.mark.parametrize("cond", ["mean", "stats"])
def test_iwae_loglik_conditions_on_the_draw_as_jax(cond):
    """JAX's iwae_loglik conditions the encoder on each sample's item draw
    whatever condition_on says: under "mean" too (the port scores it as
    "sample", the same params)."""
    resp, mask, jmodel, jparams, model, params, shapes = _setup(
        dict(irt_model="2pl", condition_on=cond), n=40)
    jds = jholdout(resp, mask, 0.2, seed=0)
    ds = holdout_split(resp, mask, 0.2, seed=0)
    key = jax.random.key(11)
    want = jeval.iwae_loglik(jmodel, jparams, key, jds, num_samples=5)
    state = {"key": key}

    def noise(_bi, rows):
        state["key"], sub = jax.random.split(state["key"])
        return replay_noise(sub, 5, shapes, rows, K)
    got = evaluation.iwae_loglik(model, params, ds, num_samples=5,
                                 noise=noise)
    _close(got["loglik"], want["loglik"], 1e-5)


def test_refine_full_covariance_matches_jax(evaluated):
    """refine_theta_posterior of the Cholesky token (mu, logvar, off all
    refined) on JAX's draws (key(0), fold_in per block)."""
    jmodel, jparams, model, params, jds, ds, _ = evaluated
    steps, n = 4, ds.response.shape[0]
    want = jeval.refine_theta_posterior(jmodel, jparams, jds, steps=steps,
                                        block_size=64)

    def noise(bi, rows):
        key = jax.random.fold_in(jax.random.key(0), bi)
        shape = (8, rows, K)
        eps = np.stack([np.asarray(jax.random.normal(kk, shape))
                        for kk in jax.random.split(key, steps)])
        last = np.asarray(jax.random.normal(
            jax.random.fold_in(key, steps + 1), shape))
        return torch.from_numpy(eps), torch.from_numpy(last)
    got = evaluation.refine_theta_posterior(model, params, ds, steps=steps,
                                            block_size=64, noise=noise)
    assert got[0].shape == (n, K) and got[2].shape == (n, K, K)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 1e-5)
    assert got[3]["persons_worse"] == want[3]["persons_worse"]
    _close(got[3]["elbo_gain_per_person"], want[3]["elbo_gain_per_person"],
           1e-4)
    # the off-diagonal entries moved: the family is refined as a whole
    assert np.abs(np.tril(got[2], -1)).max() > 0.0


def test_config_guards_match_jax():
    """laplace needs a loading vector (not deep) and the free-form item
    posterior; both packages refuse the same configs."""
    for kw in (dict(irt_model="deep", theta_posterior="laplace"),
               dict(theta_posterior="laplace-w", item_encoder=True),
               dict(theta_posterior="full"), dict(condition_on="draw")):
        with pytest.raises(ValueError):
            JConfig(num_items=4, **kw)
        with pytest.raises(ValueError):
            VIBOConfig(num_items=4, **kw)
    jf = {f.name for f in dataclasses.fields(JConfig)}
    assert {f.name for f in dataclasses.fields(VIBOConfig)} == jf
