"""The port's polytomous families (GRM and GPCM) against the JAX package:
the simulators byte for byte; links, likelihood cells and all-category
log-probabilities within 1e-6 (f32, same formulas); the one-pass training
ops (port: plain versions on the CPU; JAX: its Pallas ops in interpret
mode, or its XLA twin for GPCM above 16 categories) in value and every
gradient within 1e-5 relative to each array's largest magnitude (f32 sums
in different orders), under a uniform and a non-uniform cotangent, with a
leading sample axis, and at the extreme points (|theta . a| beyond the
clamp, a collapsing category, every cell in the first or the last
category)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu.data import synthetic as jsyn
from vibo_tpu.ops import likelihood as jlik
from vibo_tpu.ops import links as jlinks
from vibo_tpu.ops import pallas_gpcm as jgpcm
from vibo_tpu.ops import pallas_grm as jgrm
from vibo_tpu.ops.pallas_elbo import pack_responses
from vibo_tpu_torch.data import synthetic
from vibo_tpu_torch.ops import _build, likelihood, links, pallas_gpcm, pallas_grm

FAMILIES = ["grm", "gpcm"]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


def _ops(fam):
    """(JAX op, port op) of a family's one-pass training loglik."""
    name = f"masked_loglik_{fam}_packed_train"
    jmod, tmod = (jgrm, pallas_grm) if fam == "grm" else (jgpcm, pallas_gpcm)
    return getattr(jmod, name), getattr(tmod, name)


def _inputs(b, m, k, c, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((b, k)).astype(np.float32)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b_free = rng.standard_normal((m, c - 1)).astype(np.float32)
    resp = rng.integers(0, c, (b, m)).astype(np.float32)
    mask = (rng.random((b, m)) < 0.8).astype(np.float32)
    return theta, a, b_free, resp, mask, pack_responses(resp, mask)


@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("c,missing", [(3, 0.0), (5, 0.2)])
def test_simulators_byte_equal_to_jax(fam, c, missing):
    got = synthetic.simulate_irt(fam, 37, 23, ability_dim=2, seed=4,
                                 missing_rate=missing, num_categories=c)
    want = jsyn.simulate_irt(fam, 37, 23, ability_dim=2, seed=4,
                             missing_rate=missing, num_categories=c)
    assert got.num_categories == want.num_categories == c
    assert got.irt_model == fam and got.g_hat is None
    for name in ("response", "mask", "theta", "a", "b", "prob"):
        x, y = getattr(got, name), getattr(want, name)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    assert set(np.unique(got.response)) <= set(range(c))


@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("per_sample", [False, True])
def test_links_and_likelihood_match_jax(fam, per_sample):
    """Tables, cells, per-person sums and all-category log-probabilities;
    per_sample: theta and the item draws with a leading axis of 2 (the port
    batches it, JAX is called per sample)."""
    rng = np.random.default_rng(1)
    s, b, m, k, c = 2, 7, 11, 3, 5
    theta = rng.standard_normal((s, b, k)).astype(np.float32)
    a = rng.standard_normal((s, m, k)).astype(np.float32)
    b_free = 2 * rng.standard_normal((s, m, c - 1)).astype(np.float32)
    resp = rng.integers(0, c, (b, m)).astype(np.float32)
    mask = (rng.random((b, m)) < 0.7).astype(np.float32)
    ix = slice(None) if per_sample else 0
    tt, ta, tb = (torch.from_numpy(x[ix]) for x in (theta, a, b_free))
    table = links.categorical_table(fam, tb)
    base = links.grm_base(tt, ta)
    cells = likelihood.categorical_loglik_cells(
        fam, base, table, torch.from_numpy(resp), torch.from_numpy(mask))
    per_person = likelihood.categorical_loglik_per_person(
        fam, base, table, torch.from_numpy(resp), torch.from_numpy(mask))
    logp = likelihood.categorical_logprob_all(fam, base, table)
    for i in range(s if per_sample else 1):
        pick = (lambda x: x[i]) if per_sample else (lambda x: x)
        jt = jlinks.categorical_table(fam, jnp.asarray(b_free[i]))
        jb = jlinks.grm_base(jnp.asarray(theta[i]), jnp.asarray(a[i]))
        _close(pick(table), jt, 1e-6)
        _close(pick(base), jb, 1e-6)
        _close(pick(cells), jlik.categorical_loglik_cells(
            fam, jb, jt, jnp.asarray(resp), jnp.asarray(mask)), 1e-6)
        _close(pick(per_person), jlik.categorical_loglik_per_person(
            fam, jb, jt, jnp.asarray(resp), jnp.asarray(mask)), 1e-6)
        _close(pick(logp), jlik.categorical_logprob_all(fam, jb, jt), 1e-6)
    assert torch.allclose(logp.exp().sum(-1), torch.ones(()), atol=1e-5)
    with pytest.raises(ValueError, match="categorical"):
        links.categorical_table("2pl", tb)


def _value_and_grads(fam, theta, a, b_free, packed, through_table=True):
    """Value and gradients (theta, a, the unconstrained b through the
    family's table, or the op's table itself when not through_table) of
    the op summed over persons, in JAX and the port."""
    jop, top = _ops(fam)
    pk = jnp.asarray(packed)
    jtab = ((lambda bf: jlinks.categorical_table(fam, bf)) if through_table
            else (lambda bf: bf))
    ttab = ((lambda bf: links.categorical_table(fam, bf)) if through_table
            else (lambda bf: bf))
    jfn = lambda t, aa, bf: jop(t, aa, jtab(bf), pk).sum()
    jval, jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        jnp.asarray(theta), jnp.asarray(a), jnp.asarray(b_free))
    ts = [torch.tensor(x, requires_grad=True) for x in (theta, a, b_free)]
    val = top(ts[0], ts[1], ttab(ts[2]), torch.from_numpy(packed)).sum()
    val.backward()
    return (val.detach(), [t.grad for t in ts]), (jval, jgrads)


@pytest.mark.parametrize("fam,shape", [
    ("grm", (45, 130, 4, 5)), ("grm", (9, 20, 1, 3)),
    ("gpcm", (45, 130, 4, 5)), ("gpcm", (9, 20, 1, 3)),
    ("gpcm", (12, 40, 2, 8)),      # the kernel's largest compile-time C
    ("gpcm", (12, 40, 2, 9)),      # the kernel's smallest run-time C
    ("gpcm", (12, 40, 2, 17)),     # JAX: its XLA twin above 16 categories
    ("grm", (23, 70, 12, 5)), ("gpcm", (23, 70, 12, 5)),   # K > 8
])
def test_train_op_value_and_grads(fam, shape):
    theta, a, b_free, _, _, packed = _inputs(*shape)
    (val, grads), (jval, jgrads) = _value_and_grads(fam, theta, a, b_free,
                                                    packed)
    _close(val, jval, 1e-5)
    for got, want in zip(grads, jgrads):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("fam", FAMILIES)
def test_train_op_per_person_and_dtheta_any_cotangent(fam):
    """Per-person values, and dtheta exact for a non-uniform cotangent (the
    item gradients assume a uniform one, the documented contract)."""
    theta, a, b_free, _, _, packed = _inputs(33, 70, 3, 4, seed=1)
    jop, top = _ops(fam)
    kap = links.categorical_table(fam, torch.from_numpy(b_free))
    g = np.random.default_rng(2).random(33).astype(np.float32) + 0.5
    jll, jvjp = jax.vjp(lambda t: jop(t, jnp.asarray(a),
                                      jnp.asarray(kap.numpy()),
                                      jnp.asarray(packed)),
                        jnp.asarray(theta))
    tt = torch.tensor(theta, requires_grad=True)
    ll = top(tt, torch.from_numpy(a), kap, torch.from_numpy(packed))
    (ll * torch.from_numpy(g)).sum().backward()
    _close(ll.detach(), jll, 1e-5)
    _close(tt.grad, jvjp(jnp.asarray(g))[0], 1e-5)


@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("shared", [False, True])
def test_train_op_sample_axis(fam, shared):
    """theta (3, B, K) with per-sample (3, M, ...) or shared items over one
    code, JAX vmapping its op: values and every gradient of the mean over
    samples of the summed loglik."""
    theta, a, b_free, _, _, packed = _inputs(16, 50, 2, 5, seed=3)
    thetas = np.stack([theta, theta + 0.1, theta - 0.2])
    if not shared:
        a = np.stack([a, 1.05 * a, 0.95 * a])
        b_free = np.stack([b_free, b_free + 0.1, b_free - 0.1])
    jop, top = _ops(fam)
    pk = jnp.asarray(packed)

    def jloss(t, aa, bf):
        return jop(t, aa, jlinks.categorical_table(fam, bf), pk).sum(-1).mean()
    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(thetas), jnp.asarray(a), jnp.asarray(b_free))
    ts = [torch.tensor(x, requires_grad=True) for x in (thetas, a, b_free)]
    ll = top(ts[0], ts[1], links.categorical_table(fam, ts[2]),
             torch.from_numpy(packed))
    assert ll.shape == (3, 16)
    val = ll.sum(-1).mean()
    val.backward()
    _close(val.detach(), jval, 1e-5)
    for got, want in zip(ts, jgrads):
        _close(got.grad, want, 1e-5)


def _extreme_cases(c=5, m=128):
    """theta . a = +-40, +-31 (beyond the +-30 clamp) and 0; ordered tables
    whose 2nd and 3rd entries tie (a collapsing GRM category: the -1e-6 gap
    clamp); codes with every category, all category 0, all C - 1."""
    theta = np.array([[40.0], [-40.0], [31.0], [-31.0], [0.0]], np.float32)
    a = np.ones((m, 1), np.float32)
    rng = np.random.default_rng(5)
    kap = np.sort(rng.standard_normal((m, c - 1)).astype(np.float32), -1)
    kap[:, 2] = kap[:, 1]
    codes = {"mixed": pack_responses(
                 rng.integers(0, c, (5, m)).astype(np.float32),
                 np.ones((5, m), np.float32)),
             "first_category": np.ones((5, m), np.int8),
             "last_category": np.full((5, m), c, np.int8)}
    return theta, a, kap, codes


@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("case", ["mixed", "first_category",
                                  "last_category"])
def test_train_op_extreme_points_finite_and_equal_to_jax(fam, case):
    """The op's own inputs (the table, not the unconstrained b: through the
    softplus a collapsed gap's opposite ~1e6 dkappa terms cancel, and f32
    keeps no digit of the difference in either framework)."""
    theta, a, kap, codes = _extreme_cases()
    (val, grads), (jval, jgrads) = _value_and_grads(
        fam, theta, a, kap, codes[case], through_table=False)
    assert np.isfinite(float(val))
    _close(val, jval, 1e-5)
    for got, want in zip(grads, jgrads):
        assert torch.isfinite(got).all()
        _close(got, want, 1e-5)


@pytest.mark.parametrize("fam", FAMILIES)
def test_train_op_checks_inputs_and_launches_nothing_on_cpu(fam):
    _, top = _ops(fam)
    _build.reset_launches()
    theta, a, b_free, _, _, packed = _inputs(5, 9, 2, 4)
    pk = torch.from_numpy(packed)
    kap = links.categorical_table(fam, torch.from_numpy(b_free))
    ll = top(torch.from_numpy(theta), torch.from_numpy(a), kap, pk)
    assert ll.shape == (5,) and torch.isfinite(ll).all()
    assert _build.KERNELS[f"loglik_{fam}_train"].launches == 0
    with pytest.raises(ValueError, match="categories"):
        top(torch.from_numpy(theta), torch.from_numpy(a), kap[:, :1], pk)
    with pytest.raises(ValueError, match="int8"):
        top(torch.from_numpy(theta), torch.from_numpy(a), kap, pk.int())
    with pytest.raises(ValueError, match="do not match"):
        top(torch.from_numpy(theta), torch.from_numpy(a)[:4], kap, pk)


@pytest.mark.parametrize("c", [3, 5, 8, 9])
def test_grm_tables_match_jax(c):
    """The port's `grm_tables` (D and log D a category, the table the GRM
    kernel's prologue computes once a call) against JAX's `_grm_tables` on
    sorted thresholds with one gap collapsing below the -1e-6 clamp and one
    just above it, within 1e-6."""
    rng = np.random.default_rng(c)
    kappa = np.sort(rng.standard_normal((37, c - 1)), -1).astype(np.float32)
    kappa[:, 1] = kappa[:, 0] + 1e-8              # collapses: clamped
    kappa[0, 1] = kappa[0, 0] + 4e-6              # just wider than the clamp
    kappa = np.sort(kappa, -1)
    d, ld = pallas_grm.grm_tables(torch.from_numpy(kappa))
    jd, jld = jgrm._grm_tables(jnp.asarray(kappa))
    assert d.shape == ld.shape == (37, c)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd).T, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld).T, rtol=1e-6,
                               atol=1e-6)
    assert np.isfinite(ld.numpy()).all()
