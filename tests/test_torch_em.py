"""The port's EM baseline (`vibo_tpu_torch.models.em`) against the JAX
package's (`vibo_tpu.models.em`) on the CPU at small shapes: 1PL, 2PL and
3PL at 200 x 20; 2PL at K = 2, 3 and 4 on 5 nodes a dimension; GRM and
GPCM at C = 5.

- the node grids, exactly as numpy's hermegauss gives them;
- one E-step (posterior node weights and the marginal log-lik) at 1e-5
  relative, from the same items;
- one M-step of each form (m_step, _m_step_multi, m_step_3pl,
  m_step_grm) from the same posterior: 1e-5, or 1e-4 where a solve or a
  Hessian enters (_m_step_multi, m_step_3pl, m_step_grm);
- fit_em end to end at 1e-4 with the iterations equal, and response_prob;
- the marginal log-lik rising over iterations, and every guard.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu.data import simulate_irt as jsim
from vibo_tpu.models import em as jem
from vibo_tpu_torch.models import em

N, M, C = 200, 20, 5
BINARY = [("1pl", 1), ("2pl", 1), ("3pl", 1), ("2pl", 2), ("2pl", 3),
          ("2pl", 4)]
POLY = ("grm", "gpcm")
NODES_PER_DIM = 5


def _close(got, want, rtol, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _data(model: str, k: int = 1, seed: int = 0):
    sim = jsim(model, N, M, ability_dim=k, seed=seed, missing_rate=0.2,
               num_categories=C if model in POLY else 2)
    return (np.asarray(sim.response, np.float32),
            np.asarray(sim.mask, np.float32))


def _cfg(model: str, k: int = 1, **kw):
    return dict(irt_model=model, ability_dim=k,
                num_categories=C if model in POLY else 2,
                nodes_per_dim=NODES_PER_DIM if k > 1 else 0, **kw)


def _grid(k: int):
    if k == 1:
        nodes, w = jem.gauss_hermite_nodes(61)
        return nodes, jnp.log(w)
    return jem.gauss_hermite_grid(NODES_PER_DIM, k)


def _items(model: str, k: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    a = (rng.uniform(0.5, 1.5, (M,)) if k == 1
         else rng.normal(0.0, 0.7, (M, k))).astype(np.float32)
    if model in POLY:
        b = rng.normal(0.0, 0.8, (M, C - 1)).astype(np.float32)
    else:
        b = rng.normal(0.0, 1.0, (M,)).astype(np.float32)
    g = (rng.normal(-1.5, 0.3, (M,)).astype(np.float32)
         if model == "3pl" else None)
    return a, b, g


@pytest.mark.parametrize("q,k", [(61, 1), (5, 1), (21, 2), (13, 3),
                                 (9, 4), (5, 4)])
def test_node_grids(q, k):
    if k == 1:
        for got, want in zip(em.gauss_hermite_nodes(q, "cpu"),
                             jem.gauss_hermite_nodes(q)):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(em.gauss_hermite_grid(q, k, "cpu"),
                         jem.gauss_hermite_grid(q, k)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("model,k", BINARY)
def test_e_step(model, k):
    resp, mask = _data(model, k)
    a, b, g = _items(model, k)
    nodes, log_w = _grid(k)
    post_j, ll_j = jem.e_step(jnp.asarray(resp), jnp.asarray(mask), nodes,
                              log_w, jnp.asarray(a), jnp.asarray(b),
                              None if g is None else jnp.asarray(g))
    post, ll = em.e_step(_t(resp), _t(mask), _t(nodes), _t(log_w), _t(a),
                         _t(b), None if g is None else _t(g))
    _close(post, post_j, 1e-5)
    _close(ll, ll_j, 1e-5)
    np.testing.assert_allclose(post.sum(1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("model", POLY)
def test_e_step_grm(model):
    resp, mask = _data(model)
    a, b, _ = _items(model, 1)
    nodes, log_w = _grid(1)
    post_j, ll_j = jem.e_step_grm(jnp.asarray(resp), jnp.asarray(mask),
                                  nodes, log_w, jnp.asarray(a),
                                  jnp.asarray(b), C, irt_model=model)
    post, ll = em.e_step_grm(_t(resp), _t(mask), _t(nodes), _t(log_w),
                             _t(a), _t(b), C, irt_model=model)
    _close(post, post_j, 1e-5)
    _close(ll, ll_j, 1e-5)
    _close(em._categorical_node_logprob(model, _t(nodes), _t(a), _t(b)),
           jem._categorical_node_logprob(model, nodes, jnp.asarray(a),
                                         jnp.asarray(b)), 1e-5)


def _jax_post(model, k, resp, mask, a, b, g):
    nodes, log_w = _grid(k)
    post, _ = jem.e_step(jnp.asarray(resp), jnp.asarray(mask), nodes, log_w,
                         jnp.asarray(a), jnp.asarray(b),
                         None if g is None else jnp.asarray(g))
    return nodes, post


@pytest.mark.parametrize("model,k", BINARY)
def test_m_step(model, k):
    """One M-step of each binary form from JAX's posterior."""
    resp, mask = _data(model, k)
    a, b, g = _items(model, k)
    nodes, post = _jax_post(model, k, resp, mask, a, b, g)
    jargs = (jnp.asarray(resp), jnp.asarray(mask), post, nodes,
             jnp.asarray(a), jnp.asarray(b))
    args = (_t(resp), _t(mask), _t(post), _t(nodes), _t(a), _t(b))
    if model == "3pl":
        want = jem.m_step_3pl(*jargs, jnp.asarray(g), 8, -1.5, 1.0)
        got = em.m_step_3pl(*args, _t(g), 8, -1.5, 1.0)
        tol = 1e-4
    elif k > 1:
        want = jem._m_step_multi(*jargs, 8)
        got = em._m_step_multi(*args, 8)
        tol = 1e-4
    else:
        want = jem.m_step(*jargs, 8, model != "1pl")
        got = em.m_step(*args, 8, model != "1pl")
        tol = 1e-5
    assert len(got) == len(want)
    for x, y in zip(got, want):
        _close(x, y, tol, atol=tol)


@pytest.mark.parametrize("model", POLY)
def test_m_step_grm(model):
    resp, mask = _data(model)
    a, b, _ = _items(model, 1)
    nodes, log_w = _grid(1)
    post, _ = jem.e_step_grm(jnp.asarray(resp), jnp.asarray(mask), nodes,
                             log_w, jnp.asarray(a), jnp.asarray(b), C,
                             irt_model=model)
    n_qjc = jnp.stack([post.T @ (jnp.asarray(mask) * (jnp.asarray(resp)
                                                       == c))
                       for c in range(C)], axis=-1)
    prior = 1.0 if model == "gpcm" else None
    want = jem.m_step_grm(n_qjc, nodes, jnp.asarray(a), jnp.asarray(b), 8,
                          irt_model=model, prior_var=prior)
    got = em.m_step_grm(_t(n_qjc), _t(nodes), _t(a), _t(b), 8,
                        irt_model=model, prior_var=prior)
    for x, y in zip(got, want):
        _close(x, y, 1e-4, atol=1e-4)


@pytest.mark.parametrize("model,k", BINARY + [(f, 1) for f in POLY])
def test_fit_em_matches_jax(model, k):
    """fit_em end to end (each fit stops by the tolerance after 3 to 23
    iterations, most inside a chunk, its params at the chunk's end): every
    output at 1e-4, the iterations equal, and response_prob."""
    resp, mask = _data(model, k)
    cfg = _cfg(model, k, max_iters=30)
    want = jem.fit_em(resp, mask, jem.EMConfig(**cfg))
    got = em.fit_em(resp, mask, em.EMConfig(**cfg), device="cpu")
    assert set(got) == set(want)
    assert got["iterations"] == want["iterations"]
    for key, v in want.items():
        if isinstance(v, np.ndarray):
            scale = max(1.0, float(np.abs(v).max()))
            _close(got[key], v, 1e-4, atol=1e-4 * scale)
        elif isinstance(v, float):
            assert got[key] == pytest.approx(v, rel=1e-5)
        else:
            assert got[key] == v
    _close(em.response_prob(got, device="cpu"), jem.response_prob(want),
           1e-4, atol=1e-4)


@pytest.mark.parametrize("model,k", BINARY + [(f, 1) for f in POLY])
def test_marginal_loglik_rises(model, k):
    """EM's marginal log-lik after 1, 2, ..., 5 iterations never falls
    (slack 1e-6 relative) and ends above the start's."""
    resp, mask = _data(model, k, seed=3)
    lls = [em.fit_em(resp, mask, em.EMConfig(**_cfg(model, k, max_iters=i,
                                                    host_chunk=1, tol=0.0)),
                     device="cpu")["log_marginal"] for i in range(1, 6)]
    assert all(np.isfinite(lls))
    for before, after in zip(lls, lls[1:]):
        assert after >= before - 1e-6 * abs(before)
    assert lls[-1] > lls[0]


def test_host_fetches_one_a_chunk():
    """max_iters 12 in chunks of 5: three chunks, one fetch each, and (as
    in JAX) every iteration of the last chunk counted."""
    resp, mask = _data("2pl")
    cfg = dict(max_iters=12, tol=0.0, host_chunk=5)
    em.reset_stats()
    out = em.fit_em(resp, mask, em.EMConfig(**cfg), device="cpu")
    st = em.stats()
    assert st["host_fetches"] == 3 and len(st["log_liks"]) == 15
    assert out["iterations"] == 15 == jem.fit_em(
        resp, mask, jem.EMConfig(**cfg))["iterations"]


def test_guards():
    resp, mask = _data("2pl")
    for cfg, match in (({"irt_model": "deep"}, "supports"),
                       ({"irt_model": "3pl", "ability_dim": 2}, "2pl-only"),
                       ({"irt_model": "1pl", "ability_dim": 2}, "2pl-only"),
                       ({"ability_dim": 5}, "capped at K=4"),
                       ({"irt_model": "grm", "ability_dim": 2,
                         "num_categories": C}, "K=1 classical"),
                       ({"irt_model": "gpcm", "num_categories": 2},
                        "num_categories >= 3")):
        with pytest.raises(ValueError, match=match):
            jem.fit_em(resp, mask, jem.EMConfig(**cfg))
        with pytest.raises(ValueError, match=match):
            em.fit_em(resp, mask, em.EMConfig(**cfg), device="cpu")
