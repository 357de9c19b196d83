"""The port's scoring and imputation against the JAX package's on the same
(converted) params: `AbilityScorer.score` (theta_mu, theta_sigma, prob) and
`evaluation.imputation_accuracy` (acc, base_rate, num_heldout). f32 encoder;
scores within 1e-5 relative to each array's largest magnitude (f32 sums in
different orders); the accuracy counts exactly."""

import jax
import numpy as np
import pytest

from vibo_tpu import evaluation as jeval
from vibo_tpu.data import holdout_split as jholdout, simulate_irt as jsim
from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu.serve import AbilityScorer as JScorer
from vibo_tpu_torch import evaluation
from vibo_tpu_torch.convert import params_from_jax
from vibo_tpu_torch.models import VIBO, VIBOConfig
from vibo_tpu_torch.serve import AbilityScorer


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


@pytest.mark.parametrize("irt_model,cond", [("2pl", True), ("1pl", False),
                                            ("3pl", True), ("grm", True),
                                            ("gpcm", False), ("deep", True)])
def test_score_and_imputation_match_jax(irt_model, cond):
    """grm/gpcm (C = 5): prob is (B, M, C), accuracy the exact category
    match, the base rate over the C categories; deep: prob through the link
    MLP (item blocks of 8), on the nonlinear family's data."""
    c = 5 if irt_model in ("grm", "gpcm") else 2
    sim = jsim("nonlinear" if irt_model == "deep" else irt_model, 90, 30,
               ability_dim=2, seed=4, missing_rate=0.1, num_categories=c)
    jds = jholdout(sim.response, sim.mask, 0.2, seed=0, num_categories=c)
    kw = dict(num_items=30, irt_model=irt_model, ability_dim=2,
              hidden_dim=16, conditional_posterior=cond, num_categories=c)
    if irt_model == "deep":
        kw.update(item_latent_dim=3, deep_hidden_dim=32, deep_item_chunk=8)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(5))
    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")

    resp = jds.response * jds.train_mask
    want = JScorer(jmodel, jparams, pad_multiple=16).score(
        resp[:37], jds.train_mask[:37])
    got = AbilityScorer(model, params, pad_multiple=16, device="cpu").score(
        resp[:37], jds.train_mask[:37])
    for key in ("theta_mu", "theta_sigma", "prob"):
        assert got[key].shape == want[key].shape
        _close(got[key], want[key])
    assert got["prob"].shape == (37, 30) + ((c,) if c > 2 else ())

    jacc = jeval.imputation_accuracy(jmodel, jparams, jds)
    acc = evaluation.imputation_accuracy(model, params, jds, block_size=32)
    assert acc["num_heldout"] == jacc["num_heldout"] > 0
    assert acc["base_rate"] == pytest.approx(jacc["base_rate"], abs=1e-12)
    # a probability within rounding of 0.5 could flip one cell
    assert abs(acc["acc"] - jacc["acc"]) <= 1.0 / acc["num_heldout"]


def test_score_rejects_mismatched_shapes():
    model = VIBO(VIBOConfig(num_items=5, hidden_dim=8), device="cpu")
    scorer = AbilityScorer(model, model.init_params(0), device="cpu")
    with pytest.raises(ValueError, match="matching"):
        scorer.score(np.zeros((3, 5)), np.zeros((3, 4)))


@pytest.mark.parametrize("irt_model", ["2pl", "3pl", "grm", "deep"])
def test_laplace_sigma_and_refine_match_jax(irt_model):
    """AbilityScorer.laplace_sigma (closed form; deep: the Gauss-Newton
    widths) at 1e-5 and refine on JAX's replayed draws (the scorer's key,
    split over the steps, fold_in(steps + 1) for the paired bound) at 1e-4,
    on a batch padded to the scorer's multiple."""
    import torch

    c = 5 if irt_model == "grm" else 2
    sim = jsim("nonlinear" if irt_model == "deep" else irt_model, 40, 18,
               ability_dim=2, seed=6, missing_rate=0.2, num_categories=c)
    kw = dict(num_items=18, irt_model=irt_model, ability_dim=2,
              hidden_dim=16, num_categories=c)
    if irt_model == "deep":
        kw.update(item_latent_dim=3, deep_hidden_dim=32, deep_item_chunk=8)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(2))
    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jscorer = JScorer(jmodel, jparams, pad_multiple=16)
    scorer = AbilityScorer(model, params, pad_multiple=16, device="cpu")
    resp, mask = sim.response[:21], sim.mask[:21]
    _close(scorer.laplace_sigma(resp, mask),
           jscorer.laplace_sigma(resp, mask))
    steps, s, seed = 5, 3, 7
    want = jscorer.refine(resp, mask, steps=steps, num_samples=s, seed=seed)
    key = jax.random.key(seed)
    shape = (s, 32, 2)
    step_eps = np.stack([np.asarray(jax.random.normal(k, shape))
                         for k in jax.random.split(key, steps)])
    last = np.asarray(jax.random.normal(jax.random.fold_in(key, steps + 1),
                                        shape))
    got = scorer.refine(resp, mask, steps=steps, num_samples=s,
                        noise=(torch.from_numpy(step_eps),
                               torch.from_numpy(last)))
    for k in ("theta_mu", "theta_sigma", "theta_tril"):
        assert got[k].shape == want[k].shape
        _close(got[k], want[k], 1e-4)
    assert got["elbo_gain_per_person"] == pytest.approx(
        want["elbo_gain_per_person"], rel=1e-4, abs=1e-5)
    drawn = scorer.refine(resp, mask, steps=steps, num_samples=s, seed=seed)
    assert np.isfinite(drawn["theta_mu"]).all()
