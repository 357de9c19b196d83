"""The amortized item encoder q(d_j | r_:,j) of the port against the JAX
package: the column statistics (JAX's known-value, masked-cell and
permutation cases, and its values), the encoder's init and output, the
item posterior of the training items (with residuals) and of new items
(cold start), every objective on decoded data and on the int8 code (the
posterior computed once an objective from the data it sees: a minibatch's
columns, or the whole code), the evaluation's full-matrix posterior,
amortized_new_item_eval and the scorer's score / score_items.

Tolerances: 1e-4 of each array's largest magnitude for the objectives and
their gradients, 1e-5 elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu import evaluation as jeval
from vibo_tpu import serve as jserve
from vibo_tpu.data.masking import holdout_split as jholdout
from vibo_tpu.data.masking import split_items as jsplit_items
from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu.models import networks as jnet
from vibo_tpu.ops import objectives as jobj
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu_torch import evaluation
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.data.masking import holdout_split, split_items
from vibo_tpu_torch.models import VIBO, VIBOConfig, networks
from vibo_tpu_torch.ops import objectives
from vibo_tpu_torch.serve import AbilityScorer

from jax_noise_replay import replay_noise

N, M, K, H = 21, 13, 2, 16


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


def _data(seed, n=N, m=M):
    rng = np.random.default_rng(seed)
    resp = (rng.random((n, m)) < 0.6).astype(np.float32)
    mask = (rng.random((n, m)) < 0.8).astype(np.float32)
    mask[2] = 0.0
    return rng, resp, mask


def test_item_stats_person_permutation_invariant():
    rng, resp, mask = _data(0, 40, 12)
    s1 = networks.item_stats(torch.from_numpy(resp), torch.from_numpy(mask))
    perm = rng.permutation(40)
    s2 = networks.item_stats(torch.from_numpy(resp[perm]),
                             torch.from_numpy(mask[perm]))
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-5)
    assert s1.shape == (12, networks.ITEM_STAT_DIM)


def test_item_stats_known_values():
    resp = torch.tensor([[1.0, 0.0], [1.0, 1.0], [0.0, 0.0]])
    s = networks.item_stats(resp, torch.ones((3, 2))).numpy()
    np.testing.assert_allclose(s[:, 0], [2 / 3, 1 / 3], atol=1e-6)
    np.testing.assert_allclose(s[:, 1], [0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(s[:, 4], [1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(s[:, 5], np.log(4.0), atol=1e-6)


def test_item_stats_ignore_masked_cells_and_match_jax():
    _, resp, mask = _data(1, 30, 8)
    corrupted = np.where(mask > 0, resp, 1.0 - resp)
    s1 = networks.item_stats(torch.from_numpy(resp), torch.from_numpy(mask))
    s2 = networks.item_stats(torch.from_numpy(corrupted),
                             torch.from_numpy(mask))
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-6)
    _close(s1, jnet.item_stats(jnp.asarray(resp), jnp.asarray(mask)))


@pytest.mark.parametrize("irt", ["1pl", "2pl", "3pl", "grm", "deep"])
def test_item_encoder_init_and_output_match_jax(irt):
    c = 4 if irt == "grm" else 2
    jenc = jnet.init_item_encoder(jax.random.key(0), irt, K, 3, 8, c)
    g = torch.Generator().manual_seed(0)
    enc = networks.init_item_encoder(irt, K, g, "cpu", 3, 8, c)
    assert [tuple(x.shape) for x in tree_leaves(enc)] == [
        x.shape for x in jax.tree.leaves(jenc)]
    np.testing.assert_array_equal(enc[-1]["b"].numpy(), jenc[-1]["b"])
    jres = jnet.init_item_residual(jax.random.key(1), M, irt, K, 3, c)
    res = networks.init_item_residual(M, irt, K, g, "cpu", 3, c)
    assert [tuple(x.shape) for x in tree_leaves(res)] == [
        x.shape for x in jax.tree.leaves(jres)]
    spec = jnet.item_head_spec(irt, K, 3, c)
    assert spec == networks.item_head_spec(irt, K, 3, c)
    _, resp, mask = _data(2)
    jstats = jnet.item_stats(jnp.asarray(resp), jnp.asarray(mask))
    for residual in (None, jres):
        want = jnet.apply_item_encoder(jenc, jstats, spec, residual)
        got = networks.apply_item_encoder(
            params_from_jax(jax.tree.map(np.asarray, jenc), "cpu"),
            torch.from_numpy(np.asarray(jstats)), spec,
            None if residual is None else params_from_jax(
                jax.tree.map(np.asarray, residual), "cpu"))
        assert sorted(got) == sorted(want)
        for name in want:
            for k in ("mu", "logvar"):
                _close(got[name][k].detach(), want[name][k])


def _models(seed=0, **cfg):
    kw = dict(num_items=M, ability_dim=K, hidden_dim=H, item_encoder=True,
              item_encoder_hidden=8, **cfg)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(seed + 1))
    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    shapes = {name: (M, d) for name, d in model._head_spec.items()}
    return jmodel, jparams, model, params, shapes


def _grads_agree(params, jgrads, tol=1e-4):
    jleaves = jax.tree.leaves(jgrads)
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves)
    for p, g in zip(leaves, jleaves):
        _close(p.grad, g, tol)


def test_item_dist_matches_jax_and_needs_data():
    jmodel, jparams, model, params, _ = _models()
    _, resp, mask = _data(3)
    for new in (False, True):
        want = jmodel.item_dist(jparams, jnp.asarray(resp),
                                jnp.asarray(mask), new_items=new)
        got = model.item_dist(params, torch.from_numpy(resp),
                              torch.from_numpy(mask), new_items=new)
        for name in want:
            for k in ("mu", "logvar"):
                _close(got[name][k].detach(), want[name][k])
    with pytest.raises(ValueError, match="response, mask"):
        model.item_dist(params)
    assert {"item_enc", "item_resid", "encoder"} == set(params)


@pytest.mark.parametrize("cond,family", [
    ("sample", "diag"), ("mean", "diag"), ("stats", "diag"),
    ("stats", "chol"), ("sample", "chol")])
def test_decoded_objectives_match_jax(cond, family):
    """elbo and iwae on a minibatch whose columns the item posterior
    conditions on (as the trainer's minibatch step does)."""
    jmodel, jparams, model, params, shapes = _models(
        condition_on=cond, theta_posterior=family)
    _, resp, mask = _data(4)
    jr, jm = jnp.asarray(resp), jnp.asarray(mask)
    tr, tm = torch.from_numpy(resp), torch.from_numpy(mask)
    key = jax.random.key(5)
    (_, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.elbo(p, key, jr, jm, 0.4, 2), has_aux=True)(jparams)
    _, aux = model.elbo_eps(params, tr, tm, *replay_noise(key, 2, shapes, N,
                                                          K), 0.4)
    aux["elbo"].backward()
    for name in jaux:
        _close(aux[name].detach(), jaux[name], 1e-4)
    _grads_agree(params, jgrads)
    for leaf in tree_leaves(params):
        leaf.grad = None
    jb, jgrads = jax.value_and_grad(
        lambda p: jmodel.iwae(p, key, jr, jm, 3, 0.4))(jparams)
    b = model.iwae_eps(params, tr, tm, *replay_noise(key, 3, shapes, N, K),
                       0.4)
    b.backward()
    _close(b.detach(), jb, 1e-4)
    _grads_agree(params, jgrads)


@pytest.mark.parametrize("cond,family,transposed,dtype,tol", [
    ("sample", "diag", True, "float32", 1e-4),
    ("stats", "diag", True, "float32", 1e-4),
    ("mean", "diag", False, "float32", 1e-4),
    ("stats", "chol", False, "float32", 1e-4),
    ("stats", "diag", True, "bfloat16", 2e-2),
])
def test_packed_objectives_match_jax(cond, family, transposed, dtype, tol):
    """elbo_packed_sums and iwae_packed_terms with the item posterior on
    the whole code (the full-batch step)."""
    jmodel, jparams, model, params, _ = _models(
        condition_on=cond, theta_posterior=family, use_pallas=True,
        compute_dtype=dtype)
    if transposed or family != "diag":     # diag runs either layout
        assert model.wants_transposed_theta() == transposed
    rng, resp, mask = _data(6)
    packed = jpack(resp, mask)
    item_eps = {n: rng.standard_normal((2, M, d)).astype(np.float32)
                for n, d in sorted(model._head_spec.items())}
    shape = (2, K, N) if transposed else (2, N, K)
    theta_eps = rng.standard_normal(shape).astype(np.float32)
    jargs = (jnp.asarray(packed), jax.tree.map(jnp.asarray, item_eps),
             jnp.asarray(theta_eps))
    targs = (torch.from_numpy(packed),
             {k: torch.from_numpy(v) for k, v in item_eps.items()},
             torch.from_numpy(theta_eps))

    def jelbo(p):
        t = jmodel.elbo_packed_sums(p, *jargs, transposed=transposed)
        return jobj.elbo(*t), t

    def jiwae(p):
        t = jmodel.iwae_packed_terms(p, *jargs, transposed=transposed)
        return jobj.iwae_bound(t[0] + 0.3 * t[1]), t

    for jfn, tfn, bound in (
            (jelbo, model.elbo_packed_sums, lambda t: objectives.elbo(*t)),
            (jiwae, model.iwae_packed_terms,
             lambda t: objectives.iwae_bound(t[0] + 0.3 * t[1]))):
        (_, jt), jgrads = jax.value_and_grad(jfn, has_aux=True)(jparams)
        for leaf in tree_leaves(params):
            leaf.grad = None
        t = tfn(params, *targs, transposed=transposed)
        bound(t).backward()
        for got, want in zip(t, jt):
            _close(got.detach(), want, tol)
        _grads_agree(params, jgrads, tol)


@pytest.fixture(scope="module")
def split():
    """A column split of a small 2PL matrix and JAX's params of an item
    encoder model on its training items."""
    rng = np.random.default_rng(9)
    resp = (rng.random((60, 16)) < 0.6).astype(np.float32)
    mask = (rng.random((60, 16)) < 0.9).astype(np.float32)
    jds = jholdout(resp, mask, 0.2, seed=0)
    ds = holdout_split(resp, mask, 0.2, seed=0)
    jtrain, jtest = jsplit_items(jds, 0.25, seed=0)
    train, test = split_items(ds, 0.25, seed=0)
    m = train.shape[1]
    kw = dict(num_items=m, ability_dim=K, hidden_dim=H, item_encoder=True,
              item_encoder_hidden=8)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(2))
    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params, (jtrain, jtest), (train, test)


def test_full_item_dist_and_imputation_match_jax(split):
    jmodel, jparams, model, params, (jtrain, _), (train, _) = split
    want = jeval.full_item_dist(jmodel, jparams, jtrain)
    got = evaluation.full_item_dist(model, params, train)
    for name in want:
        for k in ("mu", "logvar"):
            _close(got[name][k], want[name][k])
    jacc = jeval.imputation_accuracy(jmodel, jparams, jtrain)
    acc = evaluation.imputation_accuracy(model, params, train)
    assert acc == jacc


def test_amortized_new_item_eval_matches_jax(split):
    jmodel, jparams, model, params, (jtrain, jtest), (train, test) = split
    want = jeval.amortized_new_item_eval(jmodel, jparams, jtrain, jtest)
    got = evaluation.amortized_new_item_eval(model, params, train, test)
    for key in ("acc", "base_rate", "num_heldout", "num_new_items"):
        assert got[key] == want[key], key
    assert got["num_new_items"] == test.shape[1] == 4
    free = VIBO(VIBOConfig(num_items=train.shape[1]), device="cpu")
    with pytest.raises(ValueError, match="item_encoder"):
        evaluation.amortized_new_item_eval(free, free.init_params(0), train,
                                           test)


def test_scorer_scores_items_and_students_as_jax(split):
    """score_items (the encoder alone on new columns) and score (the
    item posterior from each padded scoring batch) against JAX's
    scorer."""
    jmodel, jparams, model, params, _, _ = split
    rng = np.random.default_rng(12)
    m = model.cfg.num_items
    resp = (rng.random((19, 5)) < 0.5).astype(np.float32)
    mask = (rng.random((19, 5)) < 0.8).astype(np.float32)
    jsc = jserve.AbilityScorer(jmodel, jparams, pad_multiple=8)
    sc = AbilityScorer(model, params, pad_multiple=8, device="cpu")
    want, got = jsc.score_items(resp, mask), sc.score_items(resp, mask)
    assert sorted(got) == sorted(want) == ["a_mu", "a_sigma", "b_mu",
                                           "b_sigma"]
    for key in want:
        _close(got[key], want[key])
    resp = (rng.random((19, m)) < 0.5).astype(np.float32)
    mask = (rng.random((19, m)) < 0.8).astype(np.float32)
    want, got = jsc.score(resp, mask), sc.score(resp, mask)
    for key in want:
        _close(got[key], want[key])
    free = VIBO(VIBOConfig(num_items=m), device="cpu")
    with pytest.raises(ValueError, match="item_encoder"):
        AbilityScorer(free, free.init_params(0),
                      device="cpu").score_items(resp, mask)
