"""The port's training steps against the JAX ones, for the 2PL and the 3PL
link, the GRM and GPCM families (C = 5) and the deep link (the one-pass op,
"deep_fused", and the decoded plain link): five packed full-batch steps
(clip by global norm + Adam) on the same params and numpy noise track
`make_optimizer` + `elbo_packed_sums`, and three decoded-data minibatch
steps on JAX's replayed noise track `make_step`, at f32 within 1e-4
(relative to each array's largest magnitude: the frameworks sum in
different orders). `batch_iterator` gives JAX's batches byte for byte.

The deep link's steps start from JAX's params and Adam moments every time
(`_start_from_jax`), and each lands within DEEP_PARAM_TOL of JAX's: Adam
divides each gradient element by its own running RMS, so an element whose
gradient is near zero (a hidden unit active on few pairs) turns a
difference in the gradient's last bits into an update difference of up to
the learning rate, which the relu pattern then carries on, so five free
steps part by a few per cent in a few elements. With the plain link at f32
one step agrees within 1e-4 (measured 2.0e-5); the one-pass op rounds its
products' operands to bf16, where an operand may round the other way in
one framework, so 1e-3 (measured 1.1e-4).

Also held on their own: the clip (optax scales by max/norm only above the
threshold, with no epsilon) and torch.optim.Adam against optax.adam."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vibo_tpu.data.masking import holdout_split as jholdout
from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu.ops import objectives as jobj
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu.train.trainer import make_optimizer as jmake_optimizer
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.models import VIBO, VIBOConfig
from vibo_tpu_torch.ops.packing import packed_on_device
from vibo_tpu_torch.train import Trainer, TrainConfig, make_optimizer
from vibo_tpu_torch.train.trainer import clip_by_global_norm_

from jax_noise_replay import replay_noise

N, M, K, H, STEPS = 40, 24, 2, 16, 5
C = 5                                      # grm/gpcm categories
DL = 4                                     # deep: item latent dim
DEEP_PARAM_TOL = {"deep": 1e-4, "deep_fused": 1e-3}   # module doc


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


POLYTOMOUS = ("grm", "gpcm")


def _item_shapes(irt_model: str, k: int = K) -> dict:
    """{name: (M, D)} of the link's item parameters."""
    if irt_model in POLYTOMOUS:
        return {"a": (M, K), "b": (M, C - 1)}
    if irt_model.startswith("deep"):
        return {"d": (M, DL)}
    return ({"a": (M, k), "b": (M, 1)} if irt_model == "2pl"
            else {"a": (M, k), "b": (M, 1), "g_hat": (M, 1)})


def _data(rng, irt_model: str, n: int):
    """(responses, mask): binary, or categories 0..C-1 for grm/gpcm."""
    resp = (rng.integers(0, C, (n, M)).astype(np.float32)
            if irt_model in POLYTOMOUS
            else (rng.random((n, M)) < 0.5).astype(np.float32))
    return resp, (rng.random((n, M)) < 0.85).astype(np.float32)


def _start_from_jax(params, optimizer, jparams, opt_state) -> None:
    """Copy JAX's params and Adam moments and count into the port's."""
    adam = next(x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))
    with torch.no_grad():
        for p, q, mu, nu in zip(tree_leaves(params), jax.tree.leaves(jparams),
                                jax.tree.leaves(adam.mu),
                                jax.tree.leaves(adam.nu)):
            p.copy_(torch.from_numpy(np.array(q)))
            if int(adam.count) > 0:
                optimizer.state[p] = {
                    "step": torch.tensor(float(adam.count)),
                    "exp_avg": torch.from_numpy(np.array(mu)),
                    "exp_avg_sq": torch.from_numpy(np.array(nu))}


def _config(irt_model: str, k: int = K, **kw) -> dict:
    """"deep_fused": the deep link with deep_fused_kernel (its op's width
    128, item blocks of 10 for the plain link)."""
    if irt_model.startswith("deep"):
        kw.update(item_latent_dim=DL, deep_hidden_dim=128,
                  deep_item_chunk=10,
                  deep_fused_kernel=irt_model == "deep_fused")
        irt_model = "deep"
    return dict(num_items=M, irt_model=irt_model, ability_dim=k,
                hidden_dim=H, compute_dtype="float32",
                num_categories=C if irt_model in POLYTOMOUS else 2, **kw)


@pytest.mark.parametrize("irt_model", ["2pl", "3pl", "grm", "gpcm", "deep",
                                       "deep_fused", "2pl_k1"])
def test_five_steps_track_jax(irt_model):
    # "2pl_k1": the 2PL link at ability_dim 1 (the at-scale pipeline's)
    k = 1 if irt_model == "2pl_k1" else K
    irt_model = irt_model.removesuffix("_k1")
    rng = np.random.default_rng(0)
    resp, mask = _data(rng, irt_model, N)
    kw = _config(irt_model, k, use_pallas=True)
    # lr large enough that Adam moves every param, max_grad_norm small
    # enough that the clip fires
    lr, max_norm = 2e-2, 5.0
    # grm/gpcm and deep run theta as (B, K), the binary links transposed
    transposed = irt_model in ("2pl", "3pl")
    noise = [({n: rng.standard_normal((1,) + shp).astype(np.float32)
               for n, shp in _item_shapes(irt_model, k).items()},
              rng.standard_normal((1, k, N) if transposed else (1, N, k)
                                  ).astype(np.float32))
             for _ in range(STEPS)]

    jmodel = JVIBO(JConfig(**kw))
    assert jmodel.wants_transposed_theta() == transposed
    jparams = jmodel.init_params(jax.random.key(2))
    tx = jmake_optimizer(lr, max_norm)
    opt_state = tx.init(jparams)
    packed_j = jnp.asarray(jpack(resp, mask))
    row_valid = jnp.asarray((mask.sum(-1) > 0).astype(np.float32))

    @jax.jit
    def jstep(p, s, ie, te):
        def loss(p):
            ll, klt, kli = jmodel.elbo_packed_sums(p, packed_j, ie, te,
                                                   row_valid,
                                                   transposed=transposed)
            return -jobj.elbo(ll, klt, kli)
        val, g = jax.value_and_grad(loss)(p)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, -val

    model = VIBO(VIBOConfig(**kw), device="cpu")
    trainer = Trainer(model, TrainConfig(lr=lr, max_grad_norm=max_norm),
                      device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    optimizer = make_optimizer(params, lr)
    packed, rv = packed_on_device(resp, mask, "cpu")

    for ie, te in noise:
        if irt_model in DEEP_PARAM_TOL:
            _start_from_jax(params, optimizer, jparams, opt_state)
        jparams, opt_state, jelbo = jstep(jparams, opt_state,
                                          jax.tree.map(jnp.asarray, ie),
                                          jnp.asarray(te))
        aux = trainer.step_with_noise(
            params, optimizer, packed, rv,
            {k: torch.from_numpy(v) for k, v in ie.items()},
            torch.from_numpy(te))
        _close(aux["elbo"], jelbo, 1e-4)
    for p, q in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        _close(p.detach(), q, DEEP_PARAM_TOL.get(irt_model, 1e-4))


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32) * scale
             for s in [(7, 3), (5,)]]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(got, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_adam_matches_optax():
    rng = np.random.default_rng(2)
    x0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) * 10 ** (i - 3)
             for i in range(6)]
    tx = optax.adam(1e-2)
    xj, state = jnp.asarray(x0), tx.init(jnp.asarray(x0))
    xt = torch.tensor(x0, requires_grad=True)
    opt = torch.optim.Adam([xt], lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, xj)
        xj = optax.apply_updates(xj, upd)
        xt.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj),
                               rtol=1e-6, atol=1e-7)


def test_batch_iterator_byte_equal_to_jax():
    from vibo_tpu.data.masking import batch_iterator as jbatches
    from vibo_tpu_torch.data import batch_iterator
    rng = np.random.default_rng(3)
    ds = jholdout((rng.random((23, 9)) < 0.5).astype(np.float32),
                  (rng.random((23, 9)) < 0.9).astype(np.float32), 0.2,
                  seed=1)
    for seed, epoch in ((0, 0), (5, 3)):
        got = list(batch_iterator(ds, 10, seed, epoch))
        want = list(jbatches(ds, 10, seed, epoch))
        assert len(got) == len(want) == 3
        for (r, m), (jr, jm) in zip(got, want):
            assert r.dtype == jr.dtype and m.dtype == jm.dtype
            assert r.tobytes() == jr.tobytes() and m.tobytes() == jm.tobytes()
        assert not got[-1][1][3:].any()          # zero-padded last batch


@pytest.mark.parametrize("objective,use_pallas,s,irt_model", [
    ("elbo", True, 1, "2pl"), ("iwae", False, 2, "2pl"),
    ("elbo", True, 1, "3pl"), ("iwae", True, 2, "3pl"),
    ("elbo", True, 1, "grm"), ("iwae", True, 2, "grm"),
    ("elbo", True, 1, "gpcm"), ("iwae", True, 3, "gpcm"),
    ("elbo", True, 1, "deep"), ("iwae", True, 2, "deep")])
def test_minibatch_steps_track_jax(objective, use_pallas, s, irt_model):
    """Three decoded-data minibatch steps (item_scale = batch / N) on JAX's
    own noise, replayed from its step keys, track `Trainer.make_step`."""
    from vibo_tpu.train.trainer import (Trainer as JTrainer,
                                        TrainConfig as JTrainConfig)
    from vibo_tpu_torch.data import batch_iterator
    rng = np.random.default_rng(4)
    ds = jholdout(*_data(rng, irt_model, N), 0.1, seed=2,
                  num_categories=C if irt_model in POLYTOMOUS else 2)
    batch = 16
    kw = _config(irt_model, use_pallas=use_pallas)
    lr, max_norm = 2e-2, 5.0
    tcfg = dict(lr=lr, max_grad_norm=max_norm, num_mc_samples=s,
                objective=objective, batch_size=batch)
    jmodel = JVIBO(JConfig(**kw))
    jtrainer = JTrainer(jmodel, JTrainConfig(**tcfg))
    jparams = jmodel.init_params(jax.random.key(6))
    opt_state = jtrainer.optimizer.init(jparams)
    jstep = jtrainer.make_step(batch / N, s)

    model = VIBO(VIBOConfig(**kw), device="cpu")
    trainer = Trainer(model, TrainConfig(**tcfg), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    optimizer = make_optimizer(params, lr)
    names = _item_shapes(irt_model)
    keys = jax.random.split(jax.random.key(9), 3)
    for key, (resp, mask) in zip(keys, batch_iterator(ds, batch, 0, 0)):
        if irt_model in DEEP_PARAM_TOL:
            _start_from_jax(params, optimizer, jparams, opt_state)
        jparams, opt_state, jaux = jstep(jparams, opt_state, key,
                                         jnp.asarray(resp), jnp.asarray(mask))
        item_eps, theta_eps = replay_noise(key, s, names, batch, K)
        aux = trainer.minibatch_step_with_noise(
            params, optimizer, torch.from_numpy(resp),
            torch.from_numpy(mask), item_eps, theta_eps, batch / N)
        _close(aux["elbo"], jaux["elbo"], 1e-4)
    for p, q in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        _close(p.detach(), q, DEEP_PARAM_TOL.get(irt_model, 1e-4))


@pytest.mark.parametrize("objective", ["elbo", "iwae"])
def test_minibatch_step_draws_sample_noise(objective):
    """minibatch_step is minibatch_step_with_noise on sample_noise(batch,
    num_mc_samples) drawn from the same generator: both leave the same
    params."""
    rng = np.random.default_rng(6)
    resp = torch.from_numpy((rng.random((16, M)) < 0.5).astype(np.float32))
    mask = torch.from_numpy((rng.random((16, M)) < 0.8).astype(np.float32))
    model = VIBO(VIBOConfig(num_items=M, ability_dim=K, hidden_dim=H,
                            use_pallas=True), device="cpu")
    trainer = Trainer(model, TrainConfig(objective=objective,
                                         num_mc_samples=2), device="cpu")
    runs = []
    for with_noise in (False, True):
        params = model.init_params(1)
        optimizer = make_optimizer(params, 1e-2)
        gen = torch.Generator()
        gen.manual_seed(7)
        if with_noise:
            item_eps, theta_eps = model.sample_noise(16, 2, generator=gen)
            aux = trainer.minibatch_step_with_noise(
                params, optimizer, resp, mask, item_eps, theta_eps, 0.4)
        else:
            aux = trainer.minibatch_step(params, optimizer, resp, mask, 0.4,
                                         gen)
        runs.append((aux, tree_leaves(params)))
    (aux0, p0), (aux1, p1) = runs
    assert set(aux0) == set(aux1) == {"elbo", "loglik", "kl_theta",
                                      "kl_items"}
    assert all(torch.equal(aux0[k], aux1[k]) for k in aux0)
    assert all(torch.equal(x, y) for x, y in zip(p0, p1))


def test_fit_runs_both_paths_and_checks_options():
    rng = np.random.default_rng(5)
    ds = jholdout((rng.random((30, 12)) < 0.5).astype(np.float32),
                  (rng.random((30, 12)) < 0.9).astype(np.float32), 0.2,
                  seed=0)
    model = VIBO(VIBOConfig(num_items=12, hidden_dim=8, use_pallas=True),
                 device="cpu")
    for extra in ({}, {"batch_size": 8}, {"batch_size": 8,
                                          "objective": "iwae",
                                          "num_mc_samples": 2}):
        res = Trainer(model, TrainConfig(epochs=3, eval_every=2,
                                         log_every=1, **extra),
                      device="cpu").fit(ds)
        assert [h["epoch"] for h in res["history"]
                if h["event"] == "train"] == [0, 1, 2]
        assert np.isfinite(res["final_elbo"]) and res["cells_per_sec"] > 0
        assert res["best"]["epoch"] >= 0
    # full-batch IWAE on the int8 code
    res = Trainer(model, TrainConfig(epochs=3, eval_every=2,
                                     objective="iwae", num_mc_samples=2),
                  device="cpu").fit(ds)
    assert np.isfinite(res["final_elbo"]) and res["best"]["epoch"] >= 0
    # the polytomous families on both paths (graded data, C = 4)
    gds = jholdout(rng.integers(0, 4, (30, 12)).astype(np.float32),
                   (rng.random((30, 12)) < 0.9).astype(np.float32), 0.2,
                   seed=0, num_categories=4)
    for irt in ("grm", "gpcm"):
        gmodel = VIBO(VIBOConfig(num_items=12, hidden_dim=8, irt_model=irt,
                                 num_categories=4, use_pallas=True),
                      device="cpu")
        for extra in ({}, {"batch_size": 8}):
            res = Trainer(gmodel, TrainConfig(epochs=2, eval_every=2,
                                              **extra), device="cpu").fit(gds)
            assert np.isfinite(res["final_elbo"])
            assert 0.0 <= res["best"]["heldout_acc"] <= 1.0
    with pytest.raises(ValueError, match="objective"):
        Trainer(model, TrainConfig(objective="mle"), device="cpu")
