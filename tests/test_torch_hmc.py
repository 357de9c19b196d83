"""The port's HMC baseline (fixed trajectories) against the JAX package's,
at small shapes on the CPU:

- `_flatten_spec` for every link;
- the per-person loglik and `make_potential` (value and every gradient,
  with and without ll_ref) for 1pl/2pl/3pl/grm/gpcm/deep, dense and packed
  (the JAX side's Pallas ops in interpret mode; the deep link's in its f32
  mode), and the packed ops' chain axis against separate calls (exactly);
- the whitened value-and-grad, `map_run` and `ll_ref_fn` against JAX's
  chain programs;
- 5 iterations of `step_with_noise` on JAX's own draws, replayed from the
  keys its `step` splits (momentum, jitter, accept, the ridge sweeps'
  fold_in draws, the rotation's Gaussian), against `programs.chunked`,
  with warm-up flags that collect a window and fire a metric switch, and
  a last iteration past warm-up: positions, step-size state and inverse
  mass, and every accept decision;
- split-R-hat, ESS, the chain alignment, `posterior_mean_prob` and the
  latent-space comparisons of `evaluation` on the same numpy inputs;
- the refusals of an invalid trajectory, init mode or deep call, and one
  small `run_hmc` whose output and diagnostics keys are JAX's (NUTS:
  tests/test_torch_nuts.py).

Tolerances: 1e-5 relative and 1e-4 absolute where both sides compute the
same f32 arithmetic in different orders; 1e-4 on the chain states after 5
iterations; accept decisions exactly. The chain programs run at a small
step (init 0.01, target 0.9) and the MAP for 10 Adam steps: a leapfrog at
a step of ~1 in whitened units (init 0.1) amplified the two sides' f32
order differences past 1e-3 within 5 iterations, and Adam's normalization
amplifies them in a near-zero gradient component over tens of steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu import evaluation as jeval
from vibo_tpu.data import holdout_split as jholdout, simulate_irt as jsim
from vibo_tpu.models import hmc as jhmc
from vibo_tpu.models import networks as jnet
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu_torch import evaluation
from vibo_tpu_torch.models import hmc
from vibo_tpu_torch.ops.packing import pack_responses

N, M = 24, 10
D, H = 3, 128                                  # deep: item latent, width
MODELS = ("1pl", "2pl", "3pl", "grm", "gpcm", "deep")
# the deep link at a wider width (the f32 kernel's cluster variant on the
# card; JAX's f32 Pallas potential in interpret mode)
WIDE_DEEP = {"deep_H256": 256}


def _close(got, want, rtol=1e-5, atol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _t(tree):
    """numpy / JAX leaves -> CPU f32 tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _deep_link(h=H):
    return jax.tree.map(np.asarray,
                        jnet.init_deep_link(jax.random.key(3), 2, D, h))


def _setup(model, k=2, seed=0, n=N, m=M):
    """(cfg, resp, mask, deep params or None) for a link at (n, m); a key
    of WIDE_DEEP is the deep link at its width."""
    h = WIDE_DEEP.get(model, H)
    model = "deep" if model in WIDE_DEEP else model
    c = 4 if model in ("grm", "gpcm") else 2
    sim = jsim("nonlinear" if model == "deep" else model, n, m,
               ability_dim=k, seed=seed, missing_rate=0.2,
               num_categories=c)
    deep = _deep_link(h) if model == "deep" else None
    kw = dict(irt_model=model, ability_dim=k, num_categories=c)
    if deep is not None:
        kw.update(deep_latent_dim=D, deep_hidden_dim=h)
    return kw, sim.response.astype(np.float32), sim.mask.astype(np.float32), \
        deep


def _params(spec, rng, lead=()):
    return {k: (0.7 * rng.standard_normal(lead + v)).astype(np.float32)
            for k, v in spec.items()}


@pytest.mark.parametrize("model", MODELS)
def test_flatten_spec_matches_jax(model):
    kw, *_ = _setup(model, k=3)
    assert hmc._flatten_spec(7, 5, hmc.HMCConfig(**kw)) == \
        jhmc._flatten_spec(7, 5, jhmc.HMCConfig(**kw))


@pytest.mark.parametrize("model", MODELS + tuple(WIDE_DEEP))
@pytest.mark.parametrize("packed", [False, True])
def test_potential_matches_jax(model, packed):
    kw, resp, mask, deep = _setup(model)
    cfg, jcfg = hmc.HMCConfig(**kw), jhmc.HMCConfig(**kw)
    spec = hmc._flatten_spec(N, M, cfg)
    rng = np.random.default_rng(5)
    params = _params(spec, rng)
    ll_ref = (rng.standard_normal(N) - 5.0).astype(np.float32)
    pk = jnp.asarray(jpack(resp, mask)) if packed else None
    tpk = torch.from_numpy(pack_responses(resp, mask)) if packed else None
    jper = jhmc._make_loglik_per_person(resp, mask, jcfg, pk, deep)
    per = hmc._make_loglik_per_person(resp, mask, cfg, tpk, deep)
    _close(per(_t(params)), jper(jax.tree.map(jnp.asarray, params)))
    for ref in (None, ll_ref):
        ju = jhmc.make_potential(resp, mask, jcfg, pk,
                                 None if ref is None else jnp.asarray(ref),
                                 deep)
        u = hmc.make_potential(resp, mask, cfg, tpk,
                               None if ref is None else torch.from_numpy(ref),
                               deep)
        jval, jgrad = jax.value_and_grad(ju)(
            jax.tree.map(jnp.asarray, params))
        tp = {k: v.requires_grad_() for k, v in _t(params).items()}
        val = u(tp)
        val.backward()
        _close(val, jval)
        for name in spec:
            _close(tp[name].grad, jgrad[name])


@pytest.mark.parametrize("model", ("1pl", "2pl", "3pl", "grm", "gpcm",
                                   "deep"))
def test_packed_chain_axis_equals_separate_calls(model):
    kw, resp, mask, deep = _setup(model)
    cfg = hmc.HMCConfig(**kw)
    spec = hmc._flatten_spec(N, M, cfg)
    data = {"pk": torch.from_numpy(pack_responses(resp, mask))}
    if deep is not None:
        data["deep"] = _t(deep)
    per = hmc._per_person_fn(cfg, M, True)
    batched = {k: v.requires_grad_() for k, v in _t(_params(
        spec, np.random.default_rng(2), (3,))).items()}
    ll = per(batched, data)
    ll.sum().backward()
    for c in range(3):
        one = {k: v[c].detach().clone().requires_grad_()
               for k, v in batched.items()}
        llc = per(one, data)
        llc.sum().backward()
        assert torch.equal(llc, ll[c])
        for k in spec:
            assert torch.equal(one[k].grad, batched[k].grad[c])


def _programs(model, packed=False, **extra):
    """(port programs, JAX programs, port data, JAX data, cfg kwargs,
    spec) with center, scale and ll_ref set (JAX's ll_ref for both)."""
    kw, resp, mask, deep = _setup(model)
    kw.update(dict(dict(num_warmup=20, num_samples=0, num_leapfrog=3,
                        ridge_moves=2, init_step_size=0.01,
                        target_accept=0.9, map_init_steps=10), **extra))
    cfg = hmc.HMCConfig(use_packed_kernel=packed, **kw)
    jcfg = jhmc._programs_key(jhmc.HMCConfig(**kw), packed)
    prog = hmc._chain_programs(cfg, N, M)
    jprog = jhmc._chain_programs(jcfg, N, M)
    spec = prog.spec
    rng = np.random.default_rng(11)
    center = _params(spec, rng)
    count_r, count_c = mask.sum(1), mask.sum(0)
    scale = {}
    for k, shape in spec.items():
        sd = 1.0 / np.sqrt(1.0 + 0.25 * (count_r if k == "theta"
                                         else count_c))
        scale[k] = np.broadcast_to(sd[:, None] if len(shape) == 2 else sd,
                                   shape).astype(np.float32)
    if packed:
        jbase = {"pk": jnp.asarray(jpack(resp, mask))}
        base = {"pk": torch.from_numpy(pack_responses(resp, mask))}
    else:
        jbase = {"resp": jnp.asarray(resp), "mask": jnp.asarray(mask)}
        base = {"resp": torch.from_numpy(resp), "mask": torch.from_numpy(mask)}
    if deep is not None:
        jbase["deep"] = jax.tree.map(jnp.asarray, deep)
        base["deep"] = _t(deep)
    jc = jax.tree.map(jnp.asarray, center)
    ll_ref = np.asarray(jprog.ll_ref_fn(jc, jbase))
    jdata = dict(jbase, center=jc, scale=jax.tree.map(jnp.asarray, scale),
                 ll_ref=jnp.asarray(ll_ref))
    data = dict(base, center=_t(center), scale=_t(scale), ll_ref=_t(ll_ref))
    return prog, jprog, data, jdata, kw, spec


@pytest.mark.parametrize("model,packed", [
    ("2pl", False), ("2pl", True), ("3pl", True), ("grm", True),
    ("gpcm", False), ("deep", True)])
def test_whitened_vg_and_map_match_jax(model, packed):
    prog, jprog, data, jdata, kw, spec = _programs(model, packed)
    _close(prog.ll_ref_fn(data["center"], data), jdata["ll_ref"])
    x = _params(spec, np.random.default_rng(4))
    ju, jg = jprog.vg(jax.tree.map(jnp.asarray, x), jdata)
    # the port's programs take the chain axis: one chain here
    u, g = prog.vg({k: v[None] for k, v in _t(x).items()}, data)
    _close(u[0], ju)
    for k in spec:
        _close(g[k][0], jg[k])
    p0 = _params(spec, np.random.default_rng(6))
    jmap = jprog.map_run(jax.tree.map(jnp.asarray, p0), jdata)
    tmap = prog.map_run(_t(p0), data)
    for k in spec:
        _close(tmap[k], jmap[k])


def test_find_mode_reaches_jax_mode():
    """_find_mode from its own random start (the port's generator, JAX's
    key) reaches the same joint MAP: the potential's value there within
    1e-5, theta's sign-aligned mode within 1e-2."""
    kw, resp, mask, _ = _setup("2pl", k=1, n=60, m=12)
    cfg = hmc.HMCConfig(map_init_steps=300, **kw)
    spec = hmc._flatten_spec(60, 12, cfg)
    ju = jhmc.make_potential(resp, mask, jhmc.HMCConfig(**kw))
    u = hmc.make_potential(resp, mask, cfg)
    jmode = jhmc._find_mode(ju, spec, jhmc.HMCConfig(map_init_steps=300,
                                                     **kw),
                            jax.random.key(0))
    mode = hmc._find_mode(u, spec, cfg, torch.Generator().manual_seed(0))
    _close(u(mode), ju(jmode), rtol=1e-5, atol=1e-3)
    sign = np.sign((mode["a"].numpy() * np.asarray(jmode["a"])).sum())
    _close(sign * mode["theta"].numpy(), jmode["theta"], rtol=0, atol=1e-2)


def _replay_step_noise(keys, spec, ridge_moves, kdim):
    """JAX's draws of `step` for each chain c and iteration i of keys (C,
    T), as the port's noise dicts (one a iteration, chains stacked): the
    key splits of vibo_tpu/models/hmc.py step()."""
    chains, iters = keys.shape
    names = sorted(spec)
    out = []
    for i in range(iters):
        z = {k: [] for k in names}
        jit, acc, ridge, rot = [], [], [], []
        for c in range(chains):
            k_mom, k_acc, k_jit, k_ridge = jax.random.split(keys[c, i], 4)
            for kk, name in zip(jax.random.split(k_mom, len(spec)), names):
                z[name].append(np.asarray(jax.random.normal(kk,
                                                            spec[name])))
            jit.append(np.asarray(jax.random.uniform(k_jit)))
            acc.append(np.asarray(jax.random.uniform(k_acc)))
            moves = []
            for kk in jax.random.split(k_ridge, ridge_moves):
                moves.append([[np.asarray(draw(jax.random.fold_in(
                    kk, 4 * kd + j))) for j, draw in enumerate(
                        (jax.random.normal, jax.random.uniform,
                         jax.random.normal, jax.random.uniform))]
                    for kd in range(kdim)])
            ridge.append(moves)
            rot.append(np.asarray(jax.random.normal(
                jax.random.fold_in(k_ridge, 131071), (kdim, kdim))))
        out.append({"z": {k: torch.from_numpy(np.stack(v))
                          for k, v in z.items()},
                    "jitter": torch.from_numpy(np.stack(jit)),
                    "accept": torch.from_numpy(np.stack(acc)),
                    "ridge": torch.from_numpy(np.asarray(ridge, np.float32)),
                    "rotation": torch.from_numpy(np.stack(rot))})
    return out


@pytest.mark.parametrize("model", ("2pl", "3pl", "grm", "gpcm", "deep"))
def test_steps_match_jax_on_its_draws(model):
    prog, jprog, data, jdata, kw, spec = _programs(
        model, ability_dim=1 if model in ("3pl", "gpcm") else 2)
    chains, iters = 2, 5
    adapt = np.array([1, 1, 1, 1, 0], np.float32)
    collect = np.array([1, 1, 1, 1, 0], np.float32)
    switch = np.array([0, 0, 0, 1, 0], np.float32)
    pos = _params(spec, np.random.default_rng(8), (chains,))
    keys = jax.random.split(jax.random.key(7), chains * iters).reshape(
        chains, iters)
    carry = jprog.init(jax.tree.map(jnp.asarray, pos), jdata)
    carry, jout = jprog.chunked(carry, keys, jnp.asarray(adapt),
                                jnp.asarray(collect), jnp.asarray(switch),
                                jdata)
    noise = _replay_step_noise(keys, spec, kw["ridge_moves"],
                               kw["ability_dim"])
    state = prog.init(_t(pos), data)
    decisions = []
    for i in range(iters):
        state, out = prog.step_with_noise(state, noise[i], float(adapt[i]),
                                          float(collect[i]),
                                          float(switch[i]), data)
        for k in spec:
            _close(out["pos"][k], np.asarray(jout["pos"][k])[:, i],
                   rtol=1e-4, atol=1e-4)
        ja = np.asarray(jout["accept"])[:, i]
        _close(out["accept"], ja, rtol=1e-4, atol=1e-4)
        _close(out["eps"], np.asarray(jout["eps"])[:, i], rtol=1e-4)
        with np.errstate(divide="ignore"):
            u = noise[i]["accept"].double().log().numpy()
            mine = u < np.log(out["accept"].double().numpy())
            assert (mine == (u < np.log(ja.astype(np.float64)))).all()
        decisions.append(mine)
    (jpos, ju, jg, log_eps, log_eps_bar, h_bar, t, mu, inv_mass, _, _,
     w_cnt) = carry
    for name, want in (("log_eps", log_eps), ("log_eps_bar", log_eps_bar),
                       ("h_bar", h_bar), ("t", t), ("mu", mu),
                       ("w_cnt", w_cnt), ("u", ju)):
        _close(state[name], want, rtol=1e-4, atol=1e-4)
    for k in spec:
        _close(state["inv_mass"][k], inv_mass[k], rtol=1e-4, atol=1e-4)
        _close(state["g"][k], jg[k], rtol=1e-4, atol=1e-4)
    # the switch fired on a window of 4 draws: the metric moved off 1
    assert not torch.equal(state["inv_mass"]["theta"],
                           torch.ones_like(state["inv_mass"]["theta"]))
    decisions = np.asarray(decisions)
    assert decisions.any()


def test_diagnostics_and_alignment_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 40, 5, 2)).astype(np.float32)
    x[1] += 0.3
    np.testing.assert_allclose(hmc.split_rhat(x), jhmc.split_rhat(x),
                               rtol=1e-12)
    np.testing.assert_allclose(hmc.effective_sample_size(x),
                               jhmc.effective_sample_size(x), rtol=1e-12)
    a = rng.standard_normal((2, 6, 9, 3)).astype(np.float32)
    chain = {"a": a, "theta": rng.standard_normal((2, 6, 11, 3)).astype(
        np.float32), "b": rng.standard_normal((2, 6, 9)).astype(np.float32)}
    got, want = hmc._align_chain_signs(chain), jhmc._align_chain_signs(chain)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    one = {"theta": chain["theta"], "b": chain["b"]}
    assert hmc._align_chain_signs(one) is one


def test_latent_comparisons_match_jax():
    rng = np.random.default_rng(1)
    truth = rng.standard_normal((50, 3))
    inferred = truth @ np.linalg.qr(rng.standard_normal((3, 3)))[0] \
        + 0.2 * rng.standard_normal((50, 3))
    sigma = rng.random((50, 3)) + 0.1
    np.testing.assert_allclose(evaluation.procrustes_rotation(inferred, truth),
                               jeval.procrustes_rotation(inferred, truth))
    np.testing.assert_allclose(evaluation.procrustes_align(inferred, truth),
                               jeval.procrustes_align(inferred, truth))
    w = jeval.procrustes_rotation(inferred, truth)
    np.testing.assert_allclose(evaluation.rotate_diag_sigma(sigma, w),
                               jeval.rotate_diag_sigma(sigma, w))
    for kw in ({}, {"align_rotation": True}, {"align_sign": False}):
        assert evaluation.correlation(-inferred, truth, **kw) == \
            jeval.correlation(-inferred, truth, **kw)
    flat = np.zeros((50, 1))
    assert evaluation.correlation(flat, truth[:, :1]) == \
        jeval.correlation(flat, truth[:, :1])


@pytest.mark.parametrize("model", MODELS)
def test_posterior_mean_prob_matches_jax(model):
    kw, _, _, deep = _setup(model)
    spec = hmc._flatten_spec(N, M, hmc.HMCConfig(**kw))
    samples = _params(spec, np.random.default_rng(3), (5,))
    got = hmc.posterior_mean_prob(samples, model, sample_chunk=2,
                                  deep_params=deep, device="cpu")
    want = jhmc.posterior_mean_prob(samples, model, sample_chunk=2,
                                    deep_params=deep)
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got, want, atol=1e-6)


def test_invalid_config_raises():
    sim = jsim("1pl", 8, 4, ability_dim=1, seed=0, missing_rate=0.0)
    for cfg, err, match in (
            (hmc.HMCConfig(trajectory="nuts2"), ValueError, "trajectory"),
            (hmc.HMCConfig(init_mode="zero"), ValueError, "init_mode")):
        with pytest.raises(err, match=match):
            hmc.run_hmc(sim.response, sim.mask, cfg, device="cpu")
    with pytest.raises(ValueError, match="deep_params"):
        hmc.run_hmc(sim.response, sim.mask, hmc.HMCConfig(irt_model="deep"),
                    device="cpu")


def test_packed_deep_potential_raises_at_unsupported_width():
    """An explicit use_packed_kernel=True on the deep link at a width the
    fused op does not take raises, naming H, instead of running dense."""
    link = jax.tree.map(np.asarray,
                        jnet.init_deep_link(jax.random.key(3), 2, D, 64))
    sim = jsim("nonlinear", 8, 4, ability_dim=2, seed=0, missing_rate=0.0)
    cfg = hmc.HMCConfig(irt_model="deep", ability_dim=2,
                        use_packed_kernel=True)
    with pytest.raises(ValueError, match="H = 64"):
        hmc.run_hmc(sim.response, sim.mask, cfg, deep_params=link,
                    device="cpu")


def test_run_hmc_keys_match_jax():
    sim = jsim("2pl", 30, 8, ability_dim=2, seed=1, missing_rate=0.1)
    ds = jholdout(sim.response, sim.mask, 0.1, seed=0)
    kw = dict(irt_model="2pl", ability_dim=2, num_warmup=60, num_samples=12,
              num_leapfrog=4, num_chains=2, map_init_steps=20, scan_chunk=25,
              target_accept=0.65)
    got = hmc.run_hmc(ds.response, ds.train_mask, hmc.HMCConfig(**kw),
                      device="cpu")
    want = jhmc.run_hmc(ds.response, ds.train_mask, jhmc.HMCConfig(**kw))
    assert sorted(got) == sorted(want)
    assert sorted(got["diagnostics"]) == sorted(want["diagnostics"])
    assert {k: v.shape for k, v in got["samples"].items()} == \
        {k: v.shape for k, v in want["samples"].items()}
    d = got["diagnostics"]
    assert d["_eps_trace"].shape == want["diagnostics"]["_eps_trace"].shape
    assert d["leapfrogs_per_draw"] == 4.0 and d["num_chains"] == 2
    assert sorted(d["rhat"]) == sorted(want["diagnostics"]["rhat"])
    assert 0.0 < got["accept_rate"] <= 1.0
    assert all(np.isfinite(v).all() for v in got["samples"].values())
