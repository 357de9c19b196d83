"""The posterior and conditioning families of the port against the JAX
package: the full-covariance (Cholesky) Gaussian of `ops.distributions`,
the Laplace anchor, the expected Fisher weights of `ops.likelihood`, the
sufficient-statistic conditioning of `models.networks` and the packed
objectives (`elbo_packed_sums`, `iwae_packed_terms`) of every link under
theta_posterior chol, laplace and laplace-w, each with condition_on
sample, mean and stats (the deep link under chol with stats).

Values and gradients: 1e-5 of each array's largest magnitude for the
building blocks (at K = 1 to 5; the two frameworks order their sums
differently), 1e-4 for the objectives at f32 and 2e-2 at bf16 (a bf16
operand may round the other way in one framework, tests/test_torch_vibo.py).
The family with off=None is the diagonal one bitwise. Params cross from
the JAX `init_params` (`convert.params_from_jax`); noise is drawn with
numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu.models import networks as jnet
from vibo_tpu.ops import distributions as jdist
from vibo_tpu.ops import likelihood as jlik
from vibo_tpu.ops import links as jlinks
from vibo_tpu.ops import objectives as jobj
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.models import VIBO, VIBOConfig, networks
from vibo_tpu_torch.ops import distributions as dist
from vibo_tpu_torch.ops import likelihood as lik
from vibo_tpu_torch.ops import links, objectives

B, MI = 11, 7


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


def _vjp_agree(jfn, tfn, inputs, seed=0, tol=1e-5):
    """jfn and tfn on the same numpy inputs: every output, and the
    gradient of every input under a random cotangent of every output."""
    rng = np.random.default_rng(seed)
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(x) for x in inputs])
    jouts = jout if isinstance(jout, tuple) else (jout,)
    cot = tuple(None if o is None else
                rng.standard_normal(np.shape(o)).astype(np.float32)
                for o in jouts)
    jgrads = vjp(tuple(None if c is None else jnp.asarray(c) for c in cot)
                 if isinstance(jout, tuple) else jnp.asarray(cot[0]))
    tin = [torch.tensor(x, requires_grad=True) for x in inputs]
    tout = tfn(*tin)
    touts = tout if isinstance(tout, tuple) else (tout,)
    assert len(touts) == len(jouts)
    loss = 0.0
    for t, j, c in zip(touts, jouts, cot):
        assert (t is None) == (j is None)
        if t is None:
            continue
        _close(t.detach(), j, tol)
        loss = loss + (t * torch.from_numpy(c)).sum()
    loss.backward()
    for t, g in zip(tin, jgrads):
        _close(t.grad, g, tol)


def _gauss(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _s_flat(rng, k, weights=False):
    """Pair statistics sum_j m_ij [w_ij] a_j a_j^T (B, K(K+1)/2)."""
    a = _gauss(rng, MI, k)
    m = (rng.random((B, MI)) < 0.8).astype(np.float32)
    if weights:
        m = m * rng.random((B, MI)).astype(np.float32) * 0.25
    pairs = dist.triu_flat_index(k)
    a2 = np.stack([a[:, i] * a[:, j] for i, j in pairs], -1)
    return (m @ a2).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_tril_family_matches_jax(k):
    rng = np.random.default_rng(k)
    eps, mu = _gauss(rng, B, k), _gauss(rng, B, k)
    logvar = _gauss(rng, B, k, scale=0.5)
    p = dist.tril_dim(k)
    assert p == jdist.tril_dim(k) == k * (k - 1) // 2
    assert dist.triu_flat_index(k) == jdist.triu_flat_index(k)
    if p == 0:
        _vjp_agree(lambda e, m, lv: jdist.tril_reparameterize_eps(e, m, lv),
                   lambda e, m, lv: dist.tril_reparameterize_eps(e, m, lv),
                   [eps, mu, logvar])
        return
    off = _gauss(rng, B, p, scale=0.3)
    _vjp_agree(jdist.tril_reparameterize_eps, dist.tril_reparameterize_eps,
               [eps, mu, logvar, off])
    _vjp_agree(jdist.kl_standard_normal_tril, dist.kl_standard_normal_tril,
               [mu, logvar, off])
    _vjp_agree(jdist.tril_log_prob_from_eps, dist.tril_log_prob_from_eps,
               [eps, logvar])
    _vjp_agree(jdist.tril_marginal_sigma, dist.tril_marginal_sigma,
               [logvar, off])
    _vjp_agree(jdist.tril_matrix, dist.tril_matrix, [logvar, off])


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_off_none_is_the_diagonal_family_bitwise(k):
    rng = np.random.default_rng(10 + k)
    eps, mu = (torch.from_numpy(_gauss(rng, B, k)) for _ in range(2))
    logvar = torch.from_numpy(_gauss(rng, B, k, scale=0.5))
    empty = torch.zeros((B, 0))
    for off in (None, empty):
        assert torch.equal(dist.tril_reparameterize_eps(eps, mu, logvar, off),
                           dist.reparameterize_eps(eps, mu, logvar))
        assert torch.equal(dist.kl_standard_normal_tril(mu, logvar, off),
                           dist.kl_standard_normal(mu, logvar).sum(-1))
        assert torch.equal(dist.tril_marginal_sigma(logvar, off),
                           torch.sqrt(torch.exp(logvar)))
    assert torch.equal(dist.tril_matrix(logvar),
                       torch.diag_embed(torch.exp(0.5 * logvar)))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_laplace_anchor_parts_matches_jax(k, weighted):
    rng = np.random.default_rng(20 + k)
    c = _gauss(rng, B, k, scale=0.5)
    s_flat = _s_flat(rng, k, weighted)
    _vjp_agree(jdist.laplace_anchor_parts, dist.laplace_anchor_parts,
               [c, s_flat])
    # the factor is the Cholesky factor of (I + D S D)^-1
    logvar, off = dist.laplace_anchor_parts(torch.from_numpy(c),
                                            torch.from_numpy(s_flat))
    el = dist.tril_matrix(logvar, off).double()
    d = torch.exp(0.5 * torch.from_numpy(c)).double()
    info = torch.zeros((B, k, k), dtype=torch.float64)
    for n, (i, j) in enumerate(dist.triu_flat_index(k)):
        info[:, i, j] = info[:, j, i] = torch.from_numpy(s_flat[:, n]).double()
    info = d[:, :, None] * info * d[:, None, :] + torch.eye(k)
    cov = el @ el.transpose(-1, -2)
    assert torch.allclose(cov @ info, torch.eye(k, dtype=torch.float64)
                          .expand(B, k, k), atol=1e-4)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_fisher_weights_match_jax(k):
    rng = np.random.default_rng(30 + k)
    theta, a = _gauss(rng, B, k), _gauss(rng, MI, k, scale=0.7)
    b, g_hat = _gauss(rng, MI), _gauss(rng, MI)
    kappa = np.sort(_gauss(rng, MI, 4), -1)

    def jlogits(t, a_, b_):
        return jlinks.logits_2pl(t, a_, b_)

    def tlogits(t, a_, b_):
        return links.logits_2pl(t, a_, b_)
    _vjp_agree(lambda t, a_, b_: jlik.bernoulli_fisher_weight(
                   jlogits(t, a_, b_)),
               lambda t, a_, b_: lik.bernoulli_fisher_weight(
                   tlogits(t, a_, b_)), [theta, a, b])
    _vjp_agree(lambda t, a_, b_, g: jlik.fisher_weight_3pl(
                   jlogits(t, a_, b_), g),
               lambda t, a_, b_, g: lik.fisher_weight_3pl(
                   tlogits(t, a_, b_), g), [theta, a, b, g_hat])
    for fam in ("grm", "gpcm"):
        _vjp_agree(lambda t, a_, kp, fam=fam: jlik.categorical_fisher_weight(
                       fam, jlinks.grm_base(t, a_), kp),
                   lambda t, a_, kp, fam=fam: lik.categorical_fisher_weight(
                       fam, links.grm_base(t, a_), kp), [theta, a, kappa])


def _item_draw(rng, irt, k, m, d=4):
    spec = networks.item_head_spec(irt, k, d, 5)
    return {name: _gauss(rng, m, w) for name, w in sorted(spec.items())}


@pytest.mark.parametrize("irt", ["1pl", "2pl", "3pl", "grm", "gpcm", "deep"])
def test_condition_stat_mats_and_modulated_layer_match_jax(irt):
    k, m, h = 3, MI, 9
    rng = np.random.default_rng(40)
    draw = _item_draw(rng, irt, k, m)
    names = sorted(draw)
    fr, fm = networks.condition_stat_dim(irt, k, 4)
    assert (fr, fm) == jnet.condition_stat_dim(irt, k, 4)
    w = _gauss(rng, 2 * m + fr + fm, h)

    def jfn(w_, *vals):
        mats = jnet.condition_stat_mats(dict(zip(names, vals)), m, irt)
        return (*mats, *jnet.modulated_first_layer({"w": w_}, mats, m))

    def tfn(w_, *vals):
        mats = networks.condition_stat_mats(dict(zip(names, vals)), m, irt)
        return (*mats, *networks.modulated_first_layer({"w": w_}, mats, m))
    _vjp_agree(jfn, tfn, [w, *(draw[n] for n in names)])
    raw = networks.modulated_first_layer({"w": torch.from_numpy(w)}, None, m)
    assert torch.equal(raw[0], torch.from_numpy(w[:m]))
    assert torch.equal(raw[1], torch.from_numpy(w[m:2 * m]))


# ------------------------------------------------------ packed objectives

N, M, K, H, S = 23, 19, 3, 16, 2
C = 5
FAMILIES = ("chol", "laplace", "laplace-w")
CONDS = ("sample", "mean", "stats")


def _responses(rng, irt, shape):
    if irt in ("grm", "gpcm"):
        return rng.integers(0, C, shape).astype(np.float32)
    return (rng.random(shape) < 0.55).astype(np.float32)


def _setup(cfg: dict, seed=0):
    irt = cfg["irt_model"]
    rng = np.random.default_rng(seed)
    resp = _responses(rng, irt, (N, M))
    mask = (rng.random((N, M)) < 0.8).astype(np.float32)
    mask[3] = 0.0                          # an all-missing row: inert
    kw = dict(num_items=M, ability_dim=K, hidden_dim=H,
              num_categories=C if irt in ("grm", "gpcm") else 2, **cfg)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(seed + 1))
    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return rng, resp, mask, jmodel, jparams, model, params


def _noise(rng, model, n, s):
    item = {name: rng.standard_normal((s, M, d)).astype(np.float32)
            for name, d in sorted(model._head_spec.items())}
    return item, rng.standard_normal((s, n, K)).astype(np.float32)


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _grads_agree(params, jgrads, tol):
    jleaves = jax.tree.leaves(jgrads)       # dict keys sorted, as tree_leaves
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves)
    for p, g in zip(leaves, jleaves):
        assert p.grad.shape == g.shape
        _close(p.grad, g, tol)


def packed_objectives_agree(cfg: dict, tol: float, seed: int = 0):
    """elbo_packed_sums' terms and iwae_packed_terms' (local, ratio), and
    the gradients of both bounds with respect to every parameter, JAX
    against the port on the same params, code and numpy noise."""
    rng, resp, mask, jmodel, jparams, model, params = _setup(
        {"use_pallas": True, **cfg}, seed)
    packed = jpack(resp, mask)
    item_eps, theta_eps = _noise(rng, model, N, S)
    jargs = (jnp.asarray(packed), jax.tree.map(jnp.asarray, item_eps),
             jnp.asarray(theta_eps))
    targs = (torch.from_numpy(packed), _torch(item_eps),
             torch.from_numpy(theta_eps))
    assert not model.wants_transposed_theta() or model.cfg.theta_posterior \
        == "diag"

    def jelbo(p):
        terms = jmodel.elbo_packed_sums(p, *jargs)
        return jobj.elbo(*terms, 0.5), terms

    def jiwae(p):
        local, ratio = jmodel.iwae_packed_terms(p, *jargs)
        return jobj.iwae_bound(local + 0.5 * ratio), (local, ratio)

    for jfn, tfn, bound in (
            (jelbo, model.elbo_packed_sums,
             lambda t: objectives.elbo(*t, 0.5)),
            (jiwae, model.iwae_packed_terms,
             lambda t: objectives.iwae_bound(t[0] + 0.5 * t[1]))):
        (_, jterms), jgrads = jax.value_and_grad(jfn, has_aux=True)(jparams)
        for leaf in tree_leaves(params):
            leaf.grad = None
        terms = tfn(params, *targs)
        bound(terms).backward()
        for got, want in zip(terms, jterms):
            _close(got.detach(), want, tol)
        _grads_agree(params, jgrads, tol)


@pytest.mark.parametrize("cond", CONDS)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("irt", ["1pl", "2pl", "3pl", "grm", "gpcm"])
def test_packed_objectives_match_jax(irt, family, cond):
    packed_objectives_agree(dict(irt_model=irt, theta_posterior=family,
                                 condition_on=cond), 1e-4)


@pytest.mark.parametrize("irt,family,cond", [
    ("2pl", "chol", "stats"), ("2pl", "laplace-w", "stats"),
    ("3pl", "laplace", "mean"), ("grm", "laplace-w", "stats"),
    ("gpcm", "chol", "sample")])
def test_packed_objectives_match_jax_bf16(irt, family, cond):
    packed_objectives_agree(dict(irt_model=irt, theta_posterior=family,
                                 condition_on=cond,
                                 compute_dtype="bfloat16"), 2e-2)


@pytest.mark.parametrize("fused", [False, True])
def test_deep_chol_stats_packed_objectives_match_jax(fused):
    """The deep link under chol with stats conditioning: the plain link on
    the decoded code (JAX's default) or the one-pass op (deep_fused_kernel;
    bf16 products on both sides, 1e-3 as tests/test_torch_vibo.py)."""
    packed_objectives_agree(dict(
        irt_model="deep", theta_posterior="chol", condition_on="stats",
        item_latent_dim=4, deep_hidden_dim=128, deep_item_chunk=8,
        deep_fused_kernel=fused), 1e-3 if fused else 1e-4)


def test_families_run_theta_bk_and_decode_what_they_read():
    """chol and laplace run theta (B, K) (rows 4 and 9 on the card), the
    diagonal family with stats or the item encoder (K, B) (rows 3 and 10);
    the code is decoded once an objective where the stats correction, the
    Fisher anchor or the item encoder reads it."""
    for fam, tp in (("chol", False), ("laplace", False),
                    ("laplace-w", False), ("diag", True)):
        model = VIBO(VIBOConfig(num_items=M, ability_dim=K, use_pallas=True,
                                theta_posterior=fam, condition_on="stats"),
                     device="cpu")
        assert model.wants_transposed_theta() is tp
        params = model.init_params(0)
        assert model._decode_if_needed(params, torch.ones(
            (2, M), dtype=torch.int8)) is not None
    plain = VIBO(VIBOConfig(num_items=M, ability_dim=K, use_pallas=True),
                 device="cpu")
    assert plain._decode_if_needed(plain.init_params(0), torch.ones(
        (2, M), dtype=torch.int8)) is None
    # chol at K = 1 is the diagonal family (no Cholesky entries)
    assert VIBO(VIBOConfig(num_items=M, theta_posterior="chol",
                           use_pallas=True),
                device="cpu").wants_transposed_theta()


def test_family_inits_match_jax():
    """The head widths, the laplace c-bias log 0.15 (laplace-w keeps 0)
    and the param trees of every family against JAX's init."""
    for fam in ("diag", "chol", "laplace", "laplace-w"):
        for cond in CONDS:
            kw = dict(num_items=M, ability_dim=K, hidden_dim=H,
                      theta_posterior=fam, condition_on=cond)
            jparams = JVIBO(JConfig(**kw)).init_params(jax.random.key(0))
            params = VIBO(VIBOConfig(**kw), device="cpu").init_params(0)
            jl = jax.tree.leaves(jparams)
            tl = tree_leaves(params)
            assert [tuple(x.shape) for x in tl] == [x.shape for x in jl]
            head_b = params["encoder"][-1]["b"].detach().numpy()
            want = np.asarray(jparams["encoder"][-1]["b"])
            assert (want != 0).any() == (fam == "laplace")
            _close(head_b, want, 1e-6)


def test_generator_forms_draw_what_the_eps_forms_take():
    """tril_reparameterize and sample_items_from (the generator forms)
    are the eps forms on a draw of the generator: same seed, same
    numbers, and tril_reparameterize hands back its eps."""
    rng = np.random.default_rng(50)
    mu, logvar = (torch.from_numpy(_gauss(rng, B, 3)) for _ in range(2))
    off = torch.from_numpy(_gauss(rng, B, 3, scale=0.3))
    z, eps = dist.tril_reparameterize(mu, logvar, off,
                                      torch.Generator().manual_seed(3))
    want = torch.randn(mu.shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(eps, want)
    assert torch.equal(z, dist.tril_reparameterize_eps(want, mu, logvar,
                                                       off))
    model = VIBO(VIBOConfig(num_items=MI, ability_dim=3, irt_model="3pl"),
                 device="cpu")
    post = model.item_dist(model.init_params(0))
    draw = model.sample_items_from(post, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    assert list(draw) == sorted(post)
    for name in sorted(post):
        e = torch.randn(post[name]["mu"].shape, generator=g)
        assert torch.equal(draw[name], dist.reparameterize_eps(
            e, post[name]["mu"], post[name]["logvar"]))
