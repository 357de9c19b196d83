"""The port's evaluation against the JAX package's. The IWAE test
log-likelihood:
`evaluation.iwae_loglik` on the same (converted) params and on JAX's own
noise, replayed from the keys it splits per person block (GRM and GPCM at
C = 5 too, and the deep link, its samples in chunks of 2). One case fits in
one block (N <= block_size); the others cut N into zero-padded blocks, so
the padded rows and the per-block item_scale are exercised. f32 encoder;
the bound within 1e-5 relative (f32 sums in different orders), the cell
count exactly. Then, on the same (converted) params: calibration (ECE, MCE
and Brier at 1e-6, the bin counts equal), the numpy helpers at 1e-12, the
closed-form Laplace widths of every linear and polytomous link at K = 1 and
2 at 1e-10 (f64 numpy on both sides), the deep link's Gauss-Newton widths at
1e-5, per-person refinement on JAX's replayed draws at 1e-4, the amortized
new-person accuracy exactly, and iwae_per_person and impute_prob at
1e-5."""

import jax
import numpy as np
import pytest
import torch

from vibo_tpu import evaluation as jeval
from vibo_tpu.data import holdout_split as jholdout, simulate_irt as jsim
from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu_torch import evaluation
from vibo_tpu_torch.convert import params_from_jax
from vibo_tpu_torch.models import VIBO, VIBOConfig

from jax_noise_replay import replay_noise

N, M, K, H = 30, 14, 2, 12
DL = 3                                     # deep: item latent dim


@pytest.mark.parametrize("irt_model,block,s,on", [
    ("2pl", 64, 4, "heldout"),
    ("2pl", 16, 12, "heldout"),
    ("1pl", 16, 5, "train"),
    ("3pl", 16, 4, "heldout"),
    ("grm", 16, 4, "heldout"),
    ("gpcm", 64, 5, "train"),
    ("deep", 16, 4, "heldout"),
])
def test_iwae_loglik_matches_jax(irt_model, block, s, on, monkeypatch):
    c = 5 if irt_model in ("grm", "gpcm") else 2
    sim = jsim("nonlinear" if irt_model == "deep" else irt_model, N, M,
               ability_dim=K, seed=2, missing_rate=0.2, num_categories=c)
    ds = jholdout(sim.response, sim.mask, 0.25, seed=1, num_categories=c)
    ds.train_mask[4] = 0.0        # a person with nothing to condition on
    kw = dict(num_items=M, irt_model=irt_model, ability_dim=K,
              hidden_dim=H, use_pallas=True, num_categories=c)
    if irt_model == "deep":
        kw.update(item_latent_dim=DL, deep_hidden_dim=32, deep_item_chunk=8)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(3))
    key = jax.random.key(11)
    want = jeval.iwae_loglik(jmodel, jparams, key, ds, num_samples=s,
                             block_size=block, on=on)

    shapes = {"1pl": {"b": (M, 1)}, "2pl": {"a": (M, K), "b": (M, 1)},
              "3pl": {"a": (M, K), "b": (M, 1), "g_hat": (M, 1)},
              "grm": {"a": (M, K), "b": (M, c - 1)},
              "gpcm": {"a": (M, K), "b": (M, c - 1)},
              "deep": {"d": (M, DL)}}[irt_model]
    state = {"key": key, "blocks": []}

    def noise(block_index, rows):
        state["key"], sub = jax.random.split(state["key"])
        state["blocks"].append((block_index, rows))
        return replay_noise(sub, s, shapes, rows, K)

    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    if irt_model == "deep":
        # a chunk of 2 samples: the deep link's activation budget at work
        monkeypatch.setattr(evaluation, "_DEEP_CHUNK_BYTES",
                            2 * 4 * block * 8 * 32)
    got = evaluation.iwae_loglik(model, params, ds, num_samples=s,
                                 block_size=block, on=on, noise=noise)
    n_blocks = -(-N // block)
    assert state["blocks"] == [(i, min(N, block)) for i in range(n_blocks)]
    assert got["num_cells"] == want["num_cells"] > 0
    assert got["num_samples"] == s
    assert got["loglik"] < 0
    assert got["loglik"] == pytest.approx(want["loglik"], rel=1e-5)
    assert got["loglik_per_cell"] == pytest.approx(want["loglik_per_cell"],
                                                   rel=1e-5)


def test_iwae_loglik_draws_from_a_generator():
    sim = jsim("2pl", 20, 10, ability_dim=1, seed=0, missing_rate=0.1)
    ds = jholdout(sim.response, sim.mask, 0.3, seed=0)
    model = VIBO(VIBOConfig(num_items=10, hidden_dim=8), device="cpu")
    params = model.init_params(0)
    runs = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(4)
        runs.append(evaluation.iwae_loglik(model, params, ds,
                                           num_samples=6, block_size=8,
                                           generator=gen))
    assert runs[0] == runs[1]
    assert np.isfinite(runs[0]["loglik"]) and runs[0]["loglik"] < 0
    with pytest.raises(ValueError, match="heldout"):
        evaluation.iwae_loglik(model, params, ds, on="test")


# ---------------------------------------------------------------------------
# calibration, the Laplace widths, refinement, new persons, per-person IWAE

def _pair(irt_model, n=N, m=M, k=K, seed=2, cond=True):
    """A JAX model and Dataset with the port's twin on the same params."""
    c = 5 if irt_model in ("grm", "gpcm") else 2
    sim = jsim("nonlinear" if irt_model == "deep" else irt_model, n, m,
               ability_dim=k, seed=seed, missing_rate=0.2, num_categories=c)
    ds = jholdout(sim.response, sim.mask, 0.25, seed=1, num_categories=c)
    kw = dict(num_items=m, irt_model=irt_model, ability_dim=k,
              hidden_dim=H, num_categories=c, conditional_posterior=cond)
    if irt_model == "deep":
        kw.update(item_latent_dim=DL, deep_hidden_dim=32, deep_item_chunk=8)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(3))
    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params, ds


def _rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


@pytest.mark.parametrize("irt_model", ["2pl", "grm"])
def test_calibration_matches_jax(irt_model):
    jmodel, jparams, model, params, ds = _pair(irt_model)
    want = jeval.calibration(jmodel, jparams, ds, bins=7)
    got = evaluation.calibration(model, params, ds, bins=7, block_size=13)
    assert got["bin_count"] == want["bin_count"]
    assert got["num_heldout"] == want["num_heldout"] > 0
    for key in ("ece", "brier", "mce"):
        assert got[key] == pytest.approx(want[key], abs=1e-6)


def test_numpy_helpers_match_jax():
    rng = np.random.default_rng(0)
    n, m, c = 40, 9, 4
    prob = rng.random((n, m))
    resp = (rng.random((n, m)) < 0.5).astype(np.float32)
    hmask = (rng.random((n, m)) < 0.4).astype(np.float32)
    cprob = rng.dirichlet(np.ones(c), (n, m))
    cresp = rng.integers(0, c, (n, m)).astype(np.float32)
    for got, want in (
            (evaluation.calibration_from_probs(prob, resp, hmask, 8),
             jeval.calibration_from_probs(prob, resp, hmask, 8)),
            (evaluation.calibration_from_category_probs(cprob, cresp, hmask),
             jeval.calibration_from_category_probs(cprob, cresp, hmask))):
        assert got["bin_count"] == want["bin_count"]
        for key in ("ece", "mce", "brier"):
            assert got[key] == pytest.approx(want[key], abs=1e-12)
        np.testing.assert_array_equal(got["bin_accuracy"],
                                      want["bin_accuracy"])
    tril = np.tril(rng.standard_normal((n, 3, 3)))
    w = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    _rel(evaluation.rotate_tril_sigma(tril, w),
         jeval.rotate_tril_sigma(tril, w), 1e-12)
    x = rng.standard_normal((n, 3))
    y = x @ [0.5, -1.0, 0.2] + rng.standard_normal(n)
    for args in ((y, x), (y, x[:, 0]), (np.ones(n), x)):
        assert evaluation.multiple_correlation(*args) == pytest.approx(
            jeval.multiple_correlation(*args), abs=1e-12)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("irt_model", ["1pl", "2pl", "3pl", "grm", "gpcm"])
def test_laplace_sigma_from_items_matches_jax(irt_model, k):
    rng = np.random.default_rng(k)
    m, n = 11, 23
    c1 = 4
    items = {"b": rng.standard_normal((m, c1 if irt_model in ("grm", "gpcm")
                                       else 1)),
             "a": rng.standard_normal((m, k)),
             "g_hat": rng.standard_normal((m, 1)) - 1.5}
    mask = (rng.random((n, m)) < 0.7).astype(np.float32)
    theta = rng.standard_normal((n, k))
    want = jeval.laplace_sigma_from_items(items, irt_model, mask, theta,
                                          block_size=8, return_factor=True)
    got = evaluation.laplace_sigma_from_items(items, irt_model, mask, theta,
                                              block_size=8,
                                              return_factor=True)
    for g, w in zip(got, want):
        _rel(g, w, 1e-10)


def test_laplace_theta_sigma_and_deep_match_jax():
    """The model entry point on the 3PL link, and the deep link's
    Gauss-Newton widths (JVPs through the plain link, item chunks of 8)."""
    jmodel, jparams, model, params, ds = _pair("3pl")
    want = jeval.laplace_theta_sigma(jmodel, jparams, ds, block_size=16,
                                     return_factor=True)
    got = evaluation.laplace_theta_sigma(model, params, ds, block_size=16,
                                         return_factor=True)
    for g, w in zip(got, want):
        _rel(g, w, 1e-5)
    jmodel, jparams, model, params, ds = _pair("deep")
    theta = np.random.default_rng(1).standard_normal((N, K)).astype(
        np.float32)
    d = np.asarray(jparams["item_post"]["d"]["mu"])
    dp = jax.tree.map(np.asarray, jparams["deep_link"])
    want = jeval.laplace_sigma_deep(dp, d, ds.train_mask, theta,
                                    block_size=16, return_factor=True,
                                    item_chunk=8)
    got = evaluation.laplace_sigma_deep(dp, d, ds.train_mask, theta,
                                        block_size=16, return_factor=True,
                                        item_chunk=8, device="cpu")
    for g, w in zip(got, want):
        _rel(g, w, 1e-5)
    got2 = evaluation.laplace_theta_sigma(model, params, ds, theta=theta,
                                          block_size=16)
    _rel(got2, jeval.laplace_theta_sigma(jmodel, jparams, ds, theta=theta,
                                         block_size=16), 1e-5)


def refine_noise(seed, steps, s, k):
    """JAX's refinement draws: block i's key fold_in(key(seed), i), its
    steps' split(., steps), the paired bound's fold_in(., steps + 1)."""
    def noise(block_index, rows):
        bkey = jax.random.fold_in(jax.random.key(seed), block_index)
        return scorer_noise(bkey, steps, s, rows, k)
    return noise


def scorer_noise(key, steps, s, rows, k):
    shape = (s, rows, k)
    step = np.stack([np.asarray(jax.random.normal(kk, shape))
                     for kk in jax.random.split(key, steps)])
    last = np.asarray(jax.random.normal(jax.random.fold_in(key, steps + 1),
                                        shape))
    return torch.from_numpy(step), torch.from_numpy(last)


@pytest.mark.parametrize("irt_model,block", [("2pl", 64), ("1pl", 16),
                                             ("3pl", 16), ("gpcm", 64),
                                             ("deep", 16)])
def test_refine_theta_posterior_matches_jax(irt_model, block):
    jmodel, jparams, model, params, ds = _pair(irt_model)
    steps, s = 6, 3
    want = jeval.refine_theta_posterior(jmodel, jparams, ds, steps=steps,
                                        num_samples=s, seed=4,
                                        block_size=block)
    got = evaluation.refine_theta_posterior(
        model, params, ds, steps=steps, num_samples=s, seed=4,
        block_size=block, noise=refine_noise(4, steps, s, K))
    for g, w in zip(got[:3], want[:3]):
        _rel(g, w, 1e-4)
    assert got[3].keys() == want[3].keys()
    assert got[3]["elbo_gain_per_person"] == pytest.approx(
        want[3]["elbo_gain_per_person"], rel=1e-4, abs=1e-5)
    assert got[3]["persons_worse"] == want[3]["persons_worse"]
    # the seeded route runs
    gen = evaluation.refine_theta_posterior(model, params, ds, steps=steps,
                                            num_samples=s, seed=4,
                                            block_size=block)
    assert np.isfinite(gen[0]).all() and gen[3]["steps"] == steps


def test_amortized_new_person_eval_matches_jax():
    from vibo_tpu.data.masking import split_persons as jsplit
    jmodel, jparams, model, params, ds = _pair("2pl", n=60)
    train, test = jsplit(ds, 0.3, seed=2)
    want = jeval.amortized_new_person_eval(jmodel, jparams, test)
    got = evaluation.amortized_new_person_eval(model, params, test,
                                               block_size=7)
    assert got["num_heldout"] == want["num_heldout"] > 0
    assert got["acc"] == want["acc"]
    assert got["base_rate"] == want["base_rate"]
    assert got["persons_per_sec"] > 0 and got["warm_persons_per_sec"] > 0


@pytest.mark.parametrize("irt_model", ["2pl", "3pl", "grm", "deep"])
def test_iwae_per_person_and_impute_prob_match_jax(irt_model):
    jmodel, jparams, model, params, ds = _pair(irt_model)
    resp, mask = ds.response, ds.train_mask
    key = jax.random.key(9)
    s = 4
    want = np.asarray(jmodel.iwae_per_person(jparams, key, resp, mask,
                                             num_samples=s,
                                             num_persons_total=3 * N))
    shapes = {name: tuple(p["mu"].shape)
              for name, p in jparams["item_post"].items()}
    noise = replay_noise(key, s, shapes, N, K)
    t = [torch.from_numpy(x) for x in (resp, mask)]
    got = model.iwae_per_person(params, *t, num_persons_total=3 * N,
                                noise=noise)
    _rel(got.detach().numpy(), want, 1e-5)
    gen = torch.Generator()
    gen.manual_seed(0)
    assert model.iwae_per_person(params, *t, num_samples=3,
                                 generator=gen).shape == (N,)
    if irt_model != "grm":
        _rel(model.impute_prob(params, *t).detach().numpy(),
             np.asarray(jmodel.impute_prob(jparams, resp, mask)), 1e-5)
