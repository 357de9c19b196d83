"""The port's plain ops against the JAX package's on the same numpy inputs:
links (1PL/2PL/3PL logits, probabilities, response_prob), the diagonal
Gaussian pieces, the masked Bernoulli loglik and the objectives. Within
1e-6 relative to each array's largest magnitude (f32, same formulas; the
sums may run in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu.ops import distributions as jdist
from vibo_tpu.ops import likelihood as jlik
from vibo_tpu.ops import links as jlinks
from vibo_tpu.ops import objectives as jobj
from vibo_tpu_torch.ops import distributions as dist
from vibo_tpu_torch.ops import likelihood as lik
from vibo_tpu_torch.ops import links, objectives


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale


def _both(*arrays):
    return ([jnp.asarray(x) for x in arrays],
            [torch.from_numpy(x) for x in arrays])


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"theta": f(2, 7, 3), "a": f(11, 3), "b": f(11), "g": f(11),
            "mu": 3 * f(7, 3), "logvar": f(7, 3), "eps": f(7, 3),
            "resp": (rng.random((7, 11)) < 0.5).astype(np.float32),
            "mask": (rng.random((7, 11)) < 0.7).astype(np.float32),
            "logw": 50 * f(6, 4)}


@pytest.mark.parametrize("model", ["1pl", "2pl", "3pl"])
def test_links_match_jax(data, model):
    (jt, ja, jb, jg), (tt, ta, tb, tg) = _both(
        data["theta"], data["a"], data["b"], data["g"])
    jp = {"a": ja, "b": jb, "g_hat": jg}
    tp = {"a": ta, "b": tb, "g_hat": tg}
    _close(links.response_prob(model, tt, tp),
           jlinks.response_prob(model, jt, jp))
    _close(links.logits_1pl(tt, tb), jlinks.logits_1pl(jt, jb))
    _close(links.logits_3pl(tt, ta, tb), jlinks.logits_3pl(jt, ja, jb))


def test_distributions_likelihood_objectives_match_jax(data):
    (jmu, jlv, jeps), (tmu, tlv, teps) = _both(
        data["mu"], data["logvar"], data["eps"])
    z = dist.reparameterize_eps(teps, tmu, tlv)
    jz = jdist.reparameterize_eps(jeps, jmu, jlv)
    _close(z, jz)
    _close(dist.kl_standard_normal(tmu, tlv),
           jdist.kl_standard_normal(jmu, jlv))
    _close(dist.gaussian_log_prob(z, tmu, tlv),
           jdist.gaussian_log_prob(jz, jmu, jlv))
    _close(dist.standard_normal_log_prob(z),
           jdist.standard_normal_log_prob(jz))
    _close(dist.tril_marginal_sigma(tlv), jdist.tril_marginal_sigma(jlv))

    (jt, ja, jb, jr, jm), (tt, ta, tb, tr, tm) = _both(
        data["theta"][0], data["a"], data["b"], data["resp"], data["mask"])
    _close(lik.masked_loglik_per_person(links.logits_2pl(tt, ta, tb), tr, tm),
           jlik.masked_loglik_per_person(jlinks.logits_2pl(jt, ja, jb),
                                         jr, jm))

    (jw,), (tw,) = _both(data["logw"])
    _close(objectives.iwae_bound(tw), jobj.iwae_bound(jw))
    _close(objectives.importance_log_weights(tw[0], tw[1], tw[2], tw[3],
                                             tw[4], 0.5),
           jobj.importance_log_weights(jw[0], jw[1], jw[2], jw[3], jw[4],
                                       0.5))
    _close(objectives.elbo(tw[0], tw[1], tw[2], 0.25),
           jobj.elbo(jw[0], jw[1], jw[2], 0.25))


@pytest.mark.parametrize("per_sample", [False, True])
def test_3pl_likelihood_matches_jax(data, per_sample):
    """masked_loglik_per_person with g_hat: shared (M,), or per sample
    (S, M) beside a leading sample axis of the logits, which JAX vmaps."""
    (jt, ja, jb, jg, jr, jm), (tt, ta, tb, tg, tr, tm) = _both(
        data["theta"], data["a"], data["b"], data["g"], data["resp"],
        data["mask"])
    tg2 = torch.stack([tg, tg - 2.0]) if per_sample else tg
    got = lik.masked_loglik_per_person(links.logits_3pl(tt, ta, tb), tr, tm,
                                       g_hat=tg2)
    for s, jg_s in enumerate([jg, jg - 2.0] if per_sample else [jg, jg]):
        _close(got[s], jlik.masked_loglik_per_person(
            jlinks.logits_3pl(jt[s], ja, jb), jr, jm, g_hat=jg_s))


def test_logits_2pl_takes_per_sample_items(data):
    (jt, ja, jb), (tt, ta, tb) = _both(data["theta"], data["a"], data["b"])
    a2, b2 = torch.stack([ta, 2 * ta]), torch.stack([tb, -tb])
    got = links.logits_2pl(tt, a2, b2)
    for s, (ja_s, jb_s) in enumerate([(ja, jb), (2 * ja, -jb)]):
        _close(got[s], jlinks.logits_2pl(jt[s], ja_s, jb_s))
