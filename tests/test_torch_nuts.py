"""The port's NUTS trajectories (`trajectory="nuts"`) and its MLE/MAP
baseline against the JAX package's, at small shapes on the CPU:

- NUTS iterations of `step_with_noise` on JAX's own draws, replayed from
  the keys its `step` and `nuts_draw` split (the momentum, the ridge and
  rotation draws as for fixed trajectories; from k_acc, per depth
  split(key, 4) -> key, k_dir, k_sub, k_take, and within a subtree per
  leaf split(key) -> key, k_take), for the links of
  test_torch_hmc.test_steps_match_jax_on_its_draws at max_tree_depth 4,
  against `programs.chunked`, 5 iterations with warm-up flags (a window
  collected, a metric switch, one iteration past warm-up): positions, the
  accept statistic, the step, dh, U, its gradient and the adaptation state
  at 1e-4; leapfrogs, divergences and each chain's tree depth exactly
  (JAX's depth is the bit length of its leapfrog count: every doubling
  takes at least one leaf);
- the checkpoint slots of every leaf up to 2^max_d against the rule of
  JAX's build_subtree, checked by the subtrees each leaf closes, and
  logaddexp at -inf as JAX's;
- `run_hmc(trajectory="nuts")` against JAX's: the same keys, shapes and
  diagnostics keys, leapfrogs a draw measured;
- a port-only run at the shape of tests/test_nuts.py: NUTS's posterior
  against the port's fixed trajectories;
- the MLE/MAP objective and its gradients (1e-5), `fit_mle` from JAX's
  initial point after 30 Adam steps (1e-4) and `response_prob` (1e-6)
  for the 1pl, 2pl, 3pl, grm and gpcm links.

Each replayed iteration starts from JAX's carry after the one before (the
port's state is compared with it after every iteration): at NUTS's steps
(0.04 at first, then dual averaging's 0.5-1 in whitened units) a chain of
5 iterations amplifies the two sides' f32 order differences past 1e-4 of
a position, one draw from the same state keeps them near 1e-6. At those
steps the first iteration's trees reach depth 4 and later ones turn
before it; one GPCM iteration diverges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hmc import (_close, _params, _programs, _replay_step_noise,
                            _t)
from vibo_tpu.data import holdout_split as jholdout, simulate_irt as jsim
from vibo_tpu.models import hmc as jhmc
from vibo_tpu.models import mle as jmle
from vibo_tpu_torch.models import hmc, mle

MAX_D = 4
NUTS_KW = dict(trajectory="nuts", max_tree_depth=MAX_D, init_step_size=0.04,
               target_accept=0.8)
MLE_MODELS = ("1pl", "2pl", "3pl", "grm", "gpcm")


def _replay_nuts_noise(keys, spec, ridge_moves, kdim, max_d):
    """JAX's draws of `step` with trajectory="nuts" for keys (C, T): the
    port's noise dicts, the uniforms behind JAX's bernoulli directions,
    merge decisions and leaf selections in the fixed-size table."""
    out = _replay_step_noise(keys, spec, ridge_moves, kdim)
    chains, iters = keys.shape
    for i in range(iters):
        dirs, takes, leaves = [], [], []
        for c in range(chains):
            key = jax.random.split(keys[c, i], 4)[1]           # k_acc
            d_row, t_row = [], []
            l_row = np.zeros((1 << max_d) - 1, np.float32)
            for depth in range(max_d):
                key, k_dir, k_sub, k_take = jax.random.split(key, 4)
                u_dir = jax.random.uniform(k_dir)
                # jax.random.bernoulli(k, 0.5) is uniform(k) < 0.5
                assert bool(jax.random.bernoulli(k_dir)) == bool(u_dir < 0.5)
                d_row.append(np.asarray(u_dir))
                t_row.append(np.asarray(jax.random.uniform(k_take)))
                for leaf in range(1 << depth):
                    k_sub, k_leaf = jax.random.split(k_sub)
                    l_row[(1 << depth) - 1 + leaf] = jax.random.uniform(
                        k_leaf)
            dirs.append(d_row)
            takes.append(t_row)
            leaves.append(l_row)
        noise = out[i]
        del noise["jitter"], noise["accept"]
        noise["nuts_dir"] = torch.from_numpy(np.asarray(dirs, np.float32))
        noise["nuts_take"] = torch.from_numpy(np.asarray(takes, np.float32))
        noise["nuts_leaf"] = torch.from_numpy(np.stack(leaves))
    return out


FIELDS = ("pos", "u", "g", "log_eps", "log_eps_bar", "h_bar", "t", "mu",
          "inv_mass", "w_mean", "w_m2", "w_cnt")      # JAX's carry, in order


def _state(carry):
    """JAX's chain carry as the port's state dict."""
    return {k: _t(jax.tree.map(np.asarray, v)) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32))
            for k, v in zip(FIELDS, carry)}


@pytest.mark.parametrize("model", ("2pl", "3pl", "grm", "gpcm", "deep"))
def test_nuts_steps_match_jax_on_its_draws(model):
    prog, jprog, data, jdata, kw, spec = _programs(
        model, ability_dim=1 if model in ("3pl", "gpcm") else 2, **NUTS_KW)
    chains, iters = 2, 5
    adapt = np.array([1, 1, 1, 1, 0], np.float32)
    collect = np.array([1, 1, 1, 1, 0], np.float32)
    switch = np.array([0, 0, 0, 1, 0], np.float32)
    pos = _params(spec, np.random.default_rng(8), (chains,))
    keys = jax.random.split(jax.random.key(7), chains * iters).reshape(
        chains, iters)
    noise = _replay_nuts_noise(keys, spec, kw["ridge_moves"],
                               kw["ability_dim"], MAX_D)
    carry = jprog.init(jax.tree.map(jnp.asarray, pos), jdata)
    depths, divergent = [], []
    for i in range(iters):
        state = _state(carry)
        carry, jout = jprog.chunked(
            carry, keys[:, i:i + 1], jnp.asarray(adapt[i:i + 1]),
            jnp.asarray(collect[i:i + 1]), jnp.asarray(switch[i:i + 1]),
            jdata)
        state, out = prog.step_with_noise(state, noise[i], float(adapt[i]),
                                          float(collect[i]),
                                          float(switch[i]), data)
        jsteps = np.asarray(jout["steps"])[:, 0]
        np.testing.assert_array_equal(out["steps"].numpy(), jsteps)
        np.testing.assert_array_equal(out["divergent"].numpy(),
                                      np.asarray(jout["divergent"])[:, 0])
        np.testing.assert_array_equal(
            out["depth"].numpy(), [int(v).bit_length() for v in jsteps])
        depths.append(out["depth"].numpy())
        divergent.append(out["divergent"].numpy())
        for k in spec:
            _close(out["pos"][k], np.asarray(jout["pos"][k])[:, 0],
                   rtol=1e-4, atol=1e-4)
        for name in ("accept", "eps", "dh"):
            _close(out[name], np.asarray(jout[name])[:, 0], rtol=1e-4,
                   atol=1e-4)
        want = _state(carry)
        for name in FIELDS:
            if name in ("pos", "w_mean", "w_m2"):
                continue
            pairs = (zip(state[name].values(), want[name].values())
                     if name in ("g", "inv_mass")
                     else [(state[name], want[name])])
            for got, exp in pairs:
                _close(got, exp, rtol=1e-4, atol=1e-4)
    depths, divergent = np.asarray(depths), np.asarray(divergent)
    assert (depths == MAX_D).any()
    # a chain that stopped early without diverging turned
    assert ((depths < MAX_D) & (divergent == 0)).any()


@pytest.mark.parametrize("max_d", (1, 4, 7))
def test_leaf_checkpoint_slots(max_d):
    """nuts_leaf_masks against the rule of JAX's build_subtree, leaf by
    leaf up to 2^max_d: an even leaf pushes at slot popcount(i) and checks
    nothing; an odd leaf with t trailing one bits pushes nothing and checks
    exactly the slots that hold the left edges of the t balanced subtrees
    ending at it ([i - 2^h + 1, i], h = 1..t), as the pushes so far left
    them (each slot still holding that left edge)."""
    push, check = hmc.nuts_leaf_masks(max_d)
    assert push.shape == check.shape == (1 << max_d, max_d)
    held = {}                                   # slot -> leaf pushed there
    for i in range(1 << max_d):
        if i % 2 == 0:
            assert np.flatnonzero(push[i]).tolist() == [bin(i).count("1")]
            assert not check[i].any()
            held[bin(i).count("1")] = i
            continue
        assert not push[i].any()
        t = 0
        while (i >> t) & 1:
            t += 1
        edges = [i - (1 << h) + 1 for h in range(1, t + 1)]
        slots = sorted(s for s, leaf in held.items() if leaf in edges)
        assert len(slots) == t
        assert np.flatnonzero(check[i]).tolist() == slots
    # JAX's docstring's examples: leaf 3 closes [2, 3] at slot 1 and [0, 3]
    # at slot 0; leaf 5 [4, 5] at slot 1; leaf 7 slots 2, 1, 0
    if max_d >= 3:
        assert np.flatnonzero(check[3]).tolist() == [0, 1]
        assert np.flatnonzero(check[5]).tolist() == [1]
        assert np.flatnonzero(check[7]).tolist() == [0, 1, 2]


@pytest.mark.parametrize("a,b", [(-np.inf, 0.3), (-np.inf, -np.inf),
                                 (0.3, -np.inf), (-2.0, -np.inf)])
def test_logaddexp_at_minus_inf_matches_jax(a, b):
    """The progressive sampling's weights start at -inf (a subtree's first
    leaf; a divergent leaf's weight): torch.logaddexp there is JAX's."""
    got = torch.logaddexp(torch.tensor(a), torch.tensor(b))
    want = jnp.logaddexp(jnp.float32(a), jnp.float32(b))
    assert float(got) == float(want)


def test_run_hmc_nuts_keys_match_jax():
    sim = jsim("2pl", 30, 8, ability_dim=2, seed=1, missing_rate=0.1)
    ds = jholdout(sim.response, sim.mask, 0.1, seed=0)
    kw = dict(irt_model="2pl", ability_dim=2, num_warmup=40, num_samples=12,
              num_chains=2, map_init_steps=20, scan_chunk=25,
              trajectory="nuts", max_tree_depth=MAX_D)
    hmc.reset_counts()
    got = hmc.run_hmc(ds.response, ds.train_mask, hmc.HMCConfig(**kw),
                      device="cpu")
    counts = hmc.counts()
    want = jhmc.run_hmc(ds.response, ds.train_mask, jhmc.HMCConfig(**kw))
    assert sorted(got) == sorted(want)
    assert sorted(got["diagnostics"]) == sorted(want["diagnostics"])
    assert {k: v.shape for k, v in got["samples"].items()} == \
        {k: v.shape for k, v in want["samples"].items()}
    d = got["diagnostics"]
    assert d["_eps_trace"].shape == want["diagnostics"]["_eps_trace"].shape
    assert d["trajectory"] == "nuts" and d["num_chains"] == 2
    assert sorted(d["rhat"]) == sorted(want["diagnostics"]["rhat"])
    # measured: the draws' mean leapfrogs, within a tree's range (the
    # config's num_leapfrog, 20, is not)
    assert 1.0 <= d["leapfrogs_per_draw"] <= 2 ** MAX_D - 1
    assert 1.0 <= want["diagnostics"]["leapfrogs_per_draw"] <= 2 ** MAX_D - 1
    # every iteration: at least one evaluation a doubling, one sync a
    # doubling, and the refresh after the ridge and rotation moves
    iters = kw["num_warmup"] + kw["num_samples"]
    assert counts["evaluations"] >= 1 + 2 * iters
    assert counts["syncs"] >= iters
    assert 0.0 < got["accept_rate"] <= 1.0
    assert all(np.isfinite(v).all() for v in got["samples"].values())


def _sign_align(x, ref):
    return x if np.corrcoef(x, ref)[0, 1] >= 0 else -x


def test_nuts_matches_fixed_trajectories():
    """The port's NUTS and fixed trajectories sample the same posterior
    (tests/test_nuts.py's shape: 2PL, 64 x 32, 10 % missing): per-person
    posterior means agree to Monte-Carlo error and the spreads match."""
    sim = jsim("2pl", 64, 32, ability_dim=1, seed=0, missing_rate=0.1)
    base = dict(irt_model="2pl", num_warmup=150, num_samples=150,
                num_chains=2, seed=11)
    r_nuts = hmc.run_hmc(sim.response, sim.mask, hmc.HMCConfig(
        trajectory="nuts", max_tree_depth=6, **base), device="cpu")
    r_fix = hmc.run_hmc(sim.response, sim.mask, hmc.HMCConfig(
        trajectory="fixed", **base), device="cpu")
    for r in (r_nuts, r_fix):
        assert r["diagnostics"]["rhat_max"] < 1.1
        assert r["diagnostics"]["divergences"] == 0
    mu_n = r_nuts["samples"]["theta"].mean(0)[:, 0]
    mu_f = r_fix["samples"]["theta"].mean(0)[:, 0]
    mu_n = _sign_align(mu_n, mu_f)
    assert np.corrcoef(mu_n, mu_f)[0, 1] > 0.95
    sd_n = r_nuts["samples"]["theta"].std(0)[:, 0].mean()
    sd_f = r_fix["samples"]["theta"].std(0)[:, 0].mean()
    assert 0.7 < sd_n / sd_f < 1.4


def _mle_setup(model, n=30, m=9, k=2):
    c = 4 if model in ("grm", "gpcm") else 2
    sim = jsim(model, n, m, ability_dim=k, seed=2, missing_rate=0.2,
               num_categories=c)
    return (sim.response.astype(np.float32), sim.mask.astype(np.float32),
            dict(irt_model=model, ability_dim=k, num_categories=c))


@pytest.mark.parametrize("model", MLE_MODELS)
@pytest.mark.parametrize("map_prior", [False, True])
def test_neg_log_posterior_matches_jax(model, map_prior):
    resp, mask, kw = _mle_setup(model)
    jcfg = jmle.MLEConfig(map_prior=map_prior, **kw)
    cfg = mle.MLEConfig(map_prior=map_prior, **kw)
    p = jax.tree.map(np.asarray, jmle.init_point_params(
        jax.random.key(3), *resp.shape, jcfg))
    # off the start, where every gradient is far from 0
    p = {k: v + 0.3 * np.random.default_rng(4).standard_normal(
        v.shape).astype(np.float32) for k, v in p.items()}
    jval, jgrad = jax.value_and_grad(jmle.neg_log_posterior)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(resp), jnp.asarray(mask),
        jcfg)
    tp = {k: v.requires_grad_() for k, v in _t(p).items()}
    val = mle.neg_log_posterior(tp, torch.from_numpy(resp),
                                torch.from_numpy(mask), cfg)
    val.backward()
    _close(val, jval, rtol=1e-5, atol=1e-5)
    assert sorted(tp) == sorted(jgrad)
    for k in tp:
        _close(tp[k].grad, jgrad[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", MLE_MODELS)
def test_fit_mle_matches_jax(model):
    """30 Adam steps from JAX's own initial point (its key's draws), and
    response_prob at the end point."""
    resp, mask, kw = _mle_setup(model)
    jcfg = jmle.MLEConfig(steps=30, seed=5, **kw)
    cfg = mle.MLEConfig(steps=30, seed=5, **kw)
    jparams, jloss = jmle.fit_mle(resp, mask, jcfg)
    start = jax.tree.map(np.asarray, jmle.init_point_params(
        jax.random.key(5), *resp.shape, jcfg))
    params, loss = mle.fit_mle(resp, mask, cfg, params0=start,
                               device="cpu")
    assert sorted(params) == sorted(jparams)
    for k in params:
        _close(params[k], jparams[k], rtol=1e-4, atol=1e-4)
    _close(loss, jloss, rtol=1e-4, atol=1e-4)
    # the port's own start: the same shapes, the loss falls from it
    own, own_loss = mle.fit_mle(resp, mask, cfg, device="cpu")
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in params.items()}
    assert own_loss < float(mle.neg_log_posterior(
        mle.init_point_params(torch.Generator().manual_seed(5),
                              *resp.shape, cfg),
        torch.from_numpy(resp), torch.from_numpy(mask), cfg))
    jprob = jmle.response_prob(jax.tree.map(jnp.asarray, jparams), jcfg)
    prob = mle.response_prob(_t(jax.tree.map(np.asarray, jparams)), cfg)
    assert prob.shape == jprob.shape
    _close(prob, jprob, rtol=1e-6, atol=1e-6)
