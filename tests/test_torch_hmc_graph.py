"""The sampler's chunk program (`hmc.Sampler`, JAX's `run_chunk`), its
flags-as-tensors step and NUTS's masked subtrees, at small shapes on the
CPU, where the sampler runs the bodies its CUDA graphs capture on the card:

- `step_with_noise` with the warm-up flags as tensors, applied by
  torch.where, against the branch form it replaced (a copy below: Python
  branches on float flags), bit for bit over a whole warm-up schedule
  (every adapt, collect and switch boundary, then sampling iterations),
  fixed trajectories and NUTS;
- `Sampler.run` over chunks (a shorter last one) against as many calls of
  `step` on a generator of the same seed, bit for bit, for 2PL K = 2, 3PL,
  GRM and the dense deep link: every output and the end state;
- NUTS's masked subtrees (a depth's whole subtree between two host
  checks) against the eager per-leaf loop, bit for bit, on draws whose
  chains stop at different leaves and one of which diverges; the leaves
  the masked form ran and needed, and its host syncs (at most one a
  depth);
- the sampler on JAX's own draws (`_replay_step_noise`, and NUTS's from
  `_replay_nuts_noise`) against `programs.chunked`: positions, accept
  statistic and step within 1e-4 (as tests/test_torch_hmc.py), accept
  decisions, NUTS's leapfrogs, divergences and depths exactly;
- the launch recorder's replay counting (`_build.add_launches`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hmc import (_close, _params, _programs, _replay_step_noise,
                            _t)
from test_torch_nuts import NUTS_KW, _replay_nuts_noise, _state
from vibo_tpu_torch.models import hmc
from vibo_tpu_torch.ops import _build

SMALL = dict(num_warmup=20, num_samples=3, num_leapfrog=3, ridge_moves=2,
             init_step_size=0.05, target_accept=0.8, map_init_steps=10)


def _bits(x):
    """A tensor's bits (NaN and inf compare as themselves)."""
    x = x.detach().contiguous()
    if x.dtype == torch.bool:
        return x
    return x.view(torch.int32 if x.element_size() == 4 else torch.int64)


def _same(a, b, path=""):
    """Dict trees of tensors equal bit for bit -> the paths that differ."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        return [p for k in a for p in _same(a[k], b[k], f"{path}.{k}")]
    return [] if (a.shape == b.shape and a.dtype == b.dtype
                  and torch.equal(_bits(a), _bits(b))) else [path]


def _start(prog, data, seed=3, chains=3):
    """A chain state near the center, the chains apart."""
    pos = _t(_params(prog.spec, np.random.default_rng(seed), (chains,)))
    return prog.init({k: 0.5 * v for k, v in pos.items()}, data)


def _branch_step(prog, state, noise, adapt, collect, switch, data):
    """The branch form `step_with_noise` had before its flags were tensors:
    Python branches on float flags (its adaptation verbatim), the same
    moves."""
    cfg, names = prog.cfg, prog.names
    gamma, t0, kappa = 0.05, 10.0, 0.75
    log10 = np.log(10.0)
    do_mass = cfg.adapt_mass and cfg.num_warmup >= 20
    mom = prog.momentum(state, noise)
    eps = torch.exp(state["log_eps"] if adapt else state["log_eps_bar"])
    if cfg.trajectory == "nuts":
        moved = prog.nuts_draw(state, mom, eps, noise, data)
    else:
        moved = prog.fixed_draw(state, mom, eps, noise, data)
    # the links of its test all have ridges
    pos, u_cur, g_cur = prog.gibbs(moved["pos"], noise, data)
    accept_prob = moved["accept"]
    log_eps, log_eps_bar = state["log_eps"], state["log_eps_bar"]
    h_bar, t, mu = state["h_bar"], state["t"], state["mu"]
    inv_mass = state["inv_mass"]
    w_mean, w_m2, w_cnt = state["w_mean"], state["w_m2"], state["w_cnt"]
    if adapt:
        t = t + adapt
        accept_stat = accept_prob.mean()
        h_bar = ((1.0 - 1.0 / (t + t0)) * h_bar
                 + (cfg.target_accept - accept_stat) / (t + t0))
        log_eps = mu - torch.sqrt(t) / gamma * h_bar
        eta = t ** (-kappa)
        log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
    if do_mass:
        if collect > 0:
            w_cnt_new = w_cnt + 1.0
            w_mean_new = {k: w_mean[k] + (pos[k] - w_mean[k])
                          / hmc._bc(w_cnt_new, pos[k]) for k in names}
            w_m2 = {k: w_m2[k] + (pos[k] - w_mean[k])
                    * (pos[k] - w_mean_new[k]) for k in names}
            w_mean, w_cnt = w_mean_new, w_cnt_new
        if switch > 0:
            denom = torch.clamp(w_cnt - 1.0, min=1.0)
            shrink = w_cnt / (w_cnt + 5.0)

            def new_im(k):
                var = (w_m2[k] / hmc._bc(denom, w_m2[k])).mean(
                    0, keepdim=True)
                sh = hmc._bc(shrink, w_m2[k])
                est = torch.clamp(sh * var + (1.0 - sh), 1e-6, 1e6)
                return torch.where(hmc._bc(w_cnt >= 4.0, w_m2[k]), est,
                                   inv_mass[k])
            inv_mass = {k: new_im(k) for k in names}
            w_cnt = torch.zeros_like(w_cnt)
            w_mean = {k: torch.zeros_like(v) for k, v in w_mean.items()}
            w_m2 = {k: torch.zeros_like(v) for k, v in w_m2.items()}
            mu = log10 + log_eps_bar
            log_eps = log_eps_bar
            h_bar = torch.zeros_like(h_bar)
            t = torch.zeros_like(t)
    state = {"pos": pos, "u": u_cur, "g": g_cur, "log_eps": log_eps,
             "log_eps_bar": log_eps_bar, "h_bar": h_bar, "t": t, "mu": mu,
             "inv_mass": inv_mass, "w_mean": w_mean, "w_m2": w_m2,
             "w_cnt": w_cnt}
    out = {"pos": pos, **{k: moved[k] for k in hmc.OUT_KEYS[1:]}}
    if "depth" in moved:
        out["depth"] = moved["depth"]
    return state, out


@pytest.mark.parametrize("model,extra", [
    ("2pl", {}), ("grm", {}), ("2pl", dict(trajectory="nuts",
                                          max_tree_depth=3))])
def test_tensor_flags_step_matches_branch_form(model, extra):
    prog, _, data, _, kw, _ = _programs(model, **dict(SMALL, **extra))
    cfg = hmc.HMCConfig(**kw)
    adapt_f, collect_f, switch_f = hmc._warmup_schedule(cfg)
    # every boundary: adapt to 20, collect 3-16, switches after 4, 8, 16
    assert switch_f.sum() == 3 and collect_f.any() and not adapt_f[-1]
    gen_a, gen_b = (torch.Generator().manual_seed(4) for _ in range(2))
    chains = 3
    st_a = st_b = _start(prog, data)
    for it in range(len(adapt_f)):
        flags = (float(adapt_f[it]), float(collect_f[it]),
                 float(switch_f[it]))
        st_a, out_a = prog.step_with_noise(
            st_a, prog.draw_noise(gen_a, chains), *map(torch.tensor, flags),
            data)
        st_b, out_b = _branch_step(prog, st_b, prog.draw_noise(gen_b, chains),
                                   *flags, data)
        assert _same(st_a, st_b) == [], it
        assert _same(out_a, out_b) == [], it
    # the metric moved off 1 at the switches
    assert not torch.equal(st_a["inv_mass"]["theta"],
                           torch.ones_like(st_a["inv_mass"]["theta"]))


def _sampler_vs_steps(prog, data, total, chunk, **sampler_kw):
    """Sampler.run over chunks of `chunk` against `total` calls of step on
    generators of one seed -> (the sampler, its end state, the steps'
    end state, joined outputs of both, hmc.counts() of each)."""
    cfg = prog.cfg
    flags = np.stack(hmc._warmup_schedule(cfg))[:, :total]
    state = _start(prog, data)
    gen = torch.Generator().manual_seed(9)
    hmc.reset_counts()
    st, outs = state, []
    with torch.no_grad():
        for it in range(total):
            st, o = prog.step(st, *map(float, flags[:, it]), data, gen)
            outs.append(o)
    eager_counts = hmc.counts()
    keys = hmc.OUT_KEYS[1:] + (("depth",) if cfg.trajectory == "nuts"
                               else ())
    want = {k: torch.stack([o[k] for o in outs], 1) for k in keys}
    want["pos"] = {k: torch.stack([o["pos"][k] for o in outs], 1)
                   for k in prog.names}
    hmc.reset_counts()
    sampler = hmc.Sampler(prog, state, data, torch.Generator().manual_seed(9),
                          flags, chunk, **sampler_kw)
    parts = [sampler.run(min(chunk, total - i))
             for i in range(0, total, chunk)]
    got = {k: torch.from_numpy(np.concatenate([p[k] for p in parts], 1))
           for k in keys}
    got["pos"] = {k: torch.from_numpy(np.concatenate(
        [p["pos"][k] for p in parts], 1)) for k in prog.names}
    return sampler, st, got, want, eager_counts, hmc.counts()


@pytest.mark.parametrize("model,k", [("2pl", 2), ("3pl", 1), ("grm", 1),
                                     ("deep", 2)])
def test_chunk_program_matches_steps(model, k):
    prog, _, data, _, _, _ = _programs(model, ability_dim=k, **SMALL)
    total, chunk = 23, 10
    sampler, st, got, want, eager, graph = _sampler_vs_steps(
        prog, data, total, chunk)
    assert _same(got, want) == []
    assert _same(sampler.state, st) == []
    assert int(sampler.it) == total
    # the same evaluations, no host sync: the counts a graph would replay
    assert graph["evaluations"] == eager["evaluations"] > 0
    assert graph["syncs"] == eager["syncs"] == 0
    assert got["accept"].shape == (3, total)


def _diverging_nuts(max_d=4):
    """A NUTS sampler setting in which chain 0 diverges (a step of 40 in
    whitened units), chain 1 (at 1.0) runs to the deepest tree and chain 2
    (at 1.6) turns inside its subtrees, at different leaves (and diverges
    later)."""
    prog, _, data, _, _, _ = _programs(
        "2pl", **dict(SMALL, trajectory="nuts", max_tree_depth=max_d,
                      num_warmup=0, num_samples=6))
    state = _start(prog, data)
    state["log_eps"] = state["log_eps_bar"] = torch.log(
        torch.tensor([40.0, 1.0, 1.6]))
    return prog, data, state


def test_masked_nuts_matches_per_leaf_loop():
    prog, data, state = _diverging_nuts()
    flags = np.zeros((3, 6), np.float32)
    gen = torch.Generator().manual_seed(2)
    hmc.reset_counts()
    st, outs = state, []
    with torch.no_grad():
        for it in range(6):
            st, o = prog.step(st, 0.0, 0.0, 0.0, data, gen)
            outs.append(o)
    eager = hmc.counts()
    hmc.reset_counts()
    sampler = hmc.Sampler(prog, state, data, torch.Generator().manual_seed(2),
                          flags, 6)
    got = sampler.run(6)
    masked = hmc.counts()
    for k in hmc.OUT_KEYS[1:] + ("depth",):
        want = torch.stack([o[k] for o in outs], 1)
        assert torch.equal(_bits(torch.from_numpy(got[k])), _bits(want)), k
    for k in prog.names:
        want = torch.stack([o["pos"][k] for o in outs], 1)
        assert torch.equal(_bits(torch.from_numpy(got["pos"][k])),
                           _bits(want)), k
    assert _same(sampler.state, st) == []
    # chain 0 diverges, the others stop at different leaves and depths
    assert got["divergent"][0].all() and not got["divergent"][1].any()
    steps = got["steps"][1:]
    whole = (1 << np.arange(1, prog.max_d + 1)) - 1     # full trees
    assert (steps[0] != steps[1]).all() and len(np.unique(steps[1])) > 2
    assert not np.isin(steps[1], whole).all()
    # the masked form runs at least the leaves the loop needed, knows them,
    # and syncs at most once a depth
    assert masked["leaves_needed"] == eager["leaves"] == \
        eager["leaves_needed"]
    assert masked["leaves"] >= eager["leaves"]
    assert masked["syncs"] <= 6 * prog.max_d < eager["syncs"]


@pytest.mark.parametrize("model", ("2pl", "3pl", "grm", "deep"))
def test_chunk_program_matches_jax_on_its_draws(model):
    prog, jprog, data, jdata, kw, spec = _programs(
        model, ability_dim=1 if model == "3pl" else 2)
    chains, iters = 2, 5
    flags = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 0], [0, 0, 0, 1, 0]],
                     np.float32)
    pos = _params(spec, np.random.default_rng(8), (chains,))
    keys = jax.random.split(jax.random.key(7), chains * iters).reshape(
        chains, iters)
    carry = jprog.init(jax.tree.map(jnp.asarray, pos), jdata)
    carry, jout = jprog.chunked(carry, keys, *map(jnp.asarray, flags), jdata)
    noise = iter(_replay_step_noise(keys, spec, kw["ridge_moves"],
                                    kw["ability_dim"]))
    sampler = hmc.Sampler(prog, prog.init(_t(pos), data), data,
                          torch.Generator(), flags, iters,
                          draw=lambda: next(noise))
    got = sampler.run(iters)
    for k in spec:
        _close(got["pos"][k], np.asarray(jout["pos"][k]), rtol=1e-4,
               atol=1e-4)
    _close(got["accept"], np.asarray(jout["accept"]), rtol=1e-4, atol=1e-4)
    _close(got["eps"], np.asarray(jout["eps"]), rtol=1e-4)
    replay = _replay_step_noise(keys, spec, kw["ridge_moves"],
                                kw["ability_dim"])
    with np.errstate(divide="ignore"):
        u = np.log(np.stack([r["accept"].double().numpy() for r in replay],
                            1))
        assert ((u < np.log(got["accept"].astype(np.float64)))
                == (u < np.log(np.asarray(jout["accept"], np.float64)))
                ).all()
    for name, want in zip(("log_eps", "log_eps_bar", "h_bar", "t", "mu"),
                          carry[3:8]):
        _close(sampler.state[name], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model", ("2pl", "grm"))
def test_masked_nuts_matches_jax_on_its_draws(model):
    """Each of 4 iterations from JAX's carry (as tests/test_torch_nuts.py),
    a one-iteration sampler on JAX's draws: positions, accept statistic
    and step within 1e-4, leapfrogs, divergences and depths exactly."""
    prog, jprog, data, jdata, kw, spec = _programs(model, **NUTS_KW)
    chains, iters = 2, 4
    adapt = np.array([1, 1, 1, 0], np.float32)
    collect = np.array([1, 1, 1, 0], np.float32)
    switch = np.zeros(4, np.float32)
    pos = _params(spec, np.random.default_rng(8), (chains,))
    keys = jax.random.split(jax.random.key(7), chains * iters).reshape(
        chains, iters)
    noise = _replay_nuts_noise(keys, spec, kw["ridge_moves"],
                               kw["ability_dim"], NUTS_KW["max_tree_depth"])
    carry = jprog.init(jax.tree.map(jnp.asarray, pos), jdata)
    for i in range(iters):
        state = _state(carry)
        carry, jout = jprog.chunked(
            carry, keys[:, i:i + 1], jnp.asarray(adapt[i:i + 1]),
            jnp.asarray(collect[i:i + 1]), jnp.asarray(switch[i:i + 1]),
            jdata)
        sampler = hmc.Sampler(
            prog, state, data, torch.Generator(),
            np.stack([adapt, collect, switch])[:, i:i + 1], 1,
            draw=lambda i=i: noise[i])
        got = sampler.run(1)
        for k in spec:
            _close(got["pos"][k][:, 0], np.asarray(jout["pos"][k])[:, 0],
                   rtol=1e-4, atol=1e-4)
        _close(got["accept"][:, 0], np.asarray(jout["accept"])[:, 0],
               rtol=1e-4, atol=1e-4)
        _close(got["eps"][:, 0], np.asarray(jout["eps"])[:, 0], rtol=1e-4)
        steps = np.asarray(jout["steps"])[:, 0]
        assert (got["steps"][:, 0] == steps).all()
        assert (got["divergent"][:, 0]
                == np.asarray(jout["divergent"])[:, 0]).all()
        # JAX's depth: the bit length of its leapfrog count
        assert (got["depth"][:, 0]
                == np.floor(np.log2(np.maximum(steps, 1))) + 1).all()


def test_add_launches_counts_a_replay():
    """A recorder's noted launches are added once a replay, by variant."""
    from vibo_tpu_torch.ops import pallas_elbo  # noqa: F401 (registers)
    _build.reset_launches()
    rec = {("loglik_2pl_train", "bk"): 3}
    for _ in range(2):
        _build.add_launches(rec)
    kern = _build.KERNELS["loglik_2pl_train"]
    assert kern.launches == 6 and kern.launches_by == {"bk": 6}
    _build.reset_launches()
    with _build.recording_captures() as outer:
        with _build.recording_captures() as inner:
            assert _build._RECORDERS[-1] is inner
        assert _build._RECORDERS == [outer]
    assert _build._RECORDERS == []


def test_sampler_run_refuses_more_than_a_chunk():
    prog, _, data, _, _, _ = _programs("2pl", **SMALL)
    sampler = hmc.Sampler(prog, _start(prog, data), data, torch.Generator(),
                          np.zeros((3, 4)), 2)
    with pytest.raises(ValueError, match="1 to 2"):
        sampler.run(3)
