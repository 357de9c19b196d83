"""The packed IWAE step and the fused full-batch epochs (JAX's
`iwae_packed_terms` and `_packed_raw_step` for objective="iwae", and
`make_scan` / `_fit_fused`) against the JAX package, at the small shapes of
test_torch_trainer.py and f32: the IWAE terms and three IWAE steps on the
same numpy noise (S = 3) for every link, the port's fused chunks on JAX's
own noise over two chunks, and fuse_epochs against the per-epoch fit. On
the CPU a chunk runs its steps eagerly, so the two settings of fuse_epochs
must agree bitwise; on the card it is a CUDA graph, which chip_smoke.py
holds against eager steps."""

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
from vibo_tpu.train.trainer import (Trainer as JTrainer,
                                    TrainConfig as JTrainConfig,
                                    make_optimizer as jmake_optimizer)
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.models import VIBO, VIBOConfig
from vibo_tpu_torch.ops import objectives
from vibo_tpu_torch.ops.packing import packed_on_device
from vibo_tpu_torch.train import Trainer, TrainConfig, make_optimizer
from vibo_tpu_torch.train.trainer import AUX_KEYS

from test_torch_trainer import (C, DEEP_PARAM_TOL, K, N, POLYTOMOUS,
                                _close, _config, _data, _item_shapes,
                                _start_from_jax)

S = 3                                      # IWAE samples
LINKS = ["2pl", "3pl", "grm", "gpcm", "deep", "deep_fused"]


def _noise(rng, irt_model: str, transposed: bool):
    """Numpy noise of S samples: ({name: (S, M, D)}, theta (S, K, N) when
    transposed, else (S, N, K))."""
    return ({n: rng.standard_normal((S,) + shp).astype(np.float32)
             for n, shp in _item_shapes(irt_model).items()},
            rng.standard_normal((S, K, N) if transposed else (S, N, K)
                                ).astype(np.float32))


def _torch_noise(noise):
    item, theta = noise
    return ({k: torch.from_numpy(v) for k, v in item.items()},
            torch.from_numpy(theta))


@pytest.mark.parametrize("irt_model,transposed,use_pallas", [
    ("2pl", True, True), ("2pl", False, True), ("2pl", False, False),
    ("3pl", True, True), ("3pl", False, True), ("grm", False, True),
    ("gpcm", False, True), ("deep", False, True),
    ("deep_fused", False, True)])
def test_iwae_packed_terms_match_jax(irt_model, transposed, use_pallas):
    """(local, ratio) of iwae_packed_terms on the same params and noise, in
    both theta layouts of the binary links and on the decoded fallback
    (use_pallas=False); and iwae_packed is their bound on sample_noise."""
    rng = np.random.default_rng(10)
    resp, mask = _data(rng, irt_model, N)
    mask[3] = 0.0                           # a row with no observed cell
    kw = _config(irt_model, use_pallas=use_pallas)
    noise = _noise(rng, irt_model, transposed)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(4))
    packed = jpack(resp, mask)
    row_valid = (mask.sum(-1) > 0).astype(np.float32)
    want = jmodel.iwae_packed_terms(
        jparams, jnp.asarray(packed), jax.tree.map(jnp.asarray, noise[0]),
        jnp.asarray(noise[1]), jnp.asarray(row_valid), transposed=transposed)

    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    pk = torch.from_numpy(packed)
    got = model.iwae_packed_terms(params, pk, *_torch_noise(noise),
                                  torch.from_numpy(row_valid),
                                  transposed=transposed)
    for g, w in zip(got, want):
        assert g.shape == (S,)
        _close(g.detach(), w, 1e-4)

    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    tp = model.wants_transposed_theta()
    eps = model.sample_noise(N, S, transposed=tp, generator=gens[0])
    local, ratio = model.iwae_packed_terms(params, pk, *eps, transposed=tp)
    bound = model.iwae_packed(params, pk, 0.5, S, generator=gens[1])
    assert torch.equal(bound, objectives.iwae_bound(local + 0.5 * ratio))


@pytest.mark.parametrize("irt_model", LINKS)
def test_iwae_steps_track_jax(irt_model):
    """Three packed full-batch IWAE steps (clip + Adam) on the same params
    and noise: the port's step_with_noise(objective="iwae") against JAX's
    iwae_packed_terms + iwae_bound under value_and_grad with optax.

    Every step starts from JAX's params and Adam moments, as the deep
    link's steps do in test_torch_trainer.py, on every link: the
    log-weights are sums over the batch (about -660 here), whose f32
    rounding (~6e-5) moves the sample weights by ~1e-4 and with them the
    gradient (1.1e-4 of its largest element between the frameworks, 2e-7
    at S = 1), and Adam divides each element by its own RMS, so elements
    with small gradients part by up to 5e-3 after three free steps."""
    rng = np.random.default_rng(11)
    resp, mask = _data(rng, irt_model, N)
    kw = _config(irt_model, use_pallas=True)
    lr, max_norm = 2e-2, 5.0
    transposed = irt_model in ("2pl", "3pl")
    noise = [_noise(rng, irt_model, transposed) for _ in range(3)]

    jmodel = JVIBO(JConfig(**kw))
    assert jmodel.wants_transposed_theta() == transposed
    jparams = jmodel.init_params(jax.random.key(5))
    tx = jmake_optimizer(lr, max_norm)
    opt_state = tx.init(jparams)
    packed_j = jnp.asarray(jpack(resp, mask))
    row_valid = jnp.asarray((mask.sum(-1) > 0).astype(np.float32))

    @jax.jit
    def jstep(p, s, ie, te):
        def loss(p):
            local, ratio = jmodel.iwae_packed_terms(
                p, packed_j, ie, te, row_valid, transposed=transposed)
            return -jobj.iwae_bound(local + ratio)
        val, g = jax.value_and_grad(loss)(p)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, -val

    model = VIBO(VIBOConfig(**kw), device="cpu")
    trainer = Trainer(model, TrainConfig(lr=lr, max_grad_norm=max_norm,
                                         objective="iwae",
                                         num_mc_samples=S), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    optimizer = make_optimizer(params, lr)
    packed, rv = packed_on_device(resp, mask, "cpu")
    for ie, te in noise:
        _start_from_jax(params, optimizer, jparams, opt_state)
        jparams, opt_state, jbound = jstep(jparams, opt_state,
                                           jax.tree.map(jnp.asarray, ie),
                                           jnp.asarray(te))
        aux = trainer.step_with_noise(params, optimizer, packed, rv,
                                      *_torch_noise((ie, te)))
        _close(aux["elbo"], jbound, 1e-4)
        assert torch.equal(aux["loglik"], aux["elbo"])
        assert float(aux["kl_theta"]) == float(aux["kl_items"]) == 0.0
    for p, q in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        _close(p.detach(), q, DEEP_PARAM_TOL.get(irt_model, 1e-4))


def _holdout(rng, irt_model: str, n: int = 30):
    return jholdout(*_data(rng, irt_model, n), 0.2, seed=0,
                    num_categories=C if irt_model in POLYTOMOUS else 2)


@pytest.mark.parametrize("objective,irt_model", [
    ("elbo", "2pl"), ("iwae", "2pl"), ("elbo", "grm"), ("iwae", "3pl"),
    ("iwae", "deep_fused")])
def test_fused_fit_equals_per_epoch_fit(objective, irt_model):
    """On the CPU a fused chunk is the per-epoch steps in the same generator
    order: history, final ELBO and params bitwise equal, over chunks of 2,
    2 and 1 epochs (a second chunk length)."""
    ds = _holdout(np.random.default_rng(12), irt_model)
    model = VIBO(VIBOConfig(**_config(irt_model, use_pallas=True)),
                 device="cpu")
    runs = [Trainer(model, TrainConfig(epochs=5, eval_every=2, lr=1e-2,
                                       objective=objective,
                                       num_mc_samples=2,
                                       fuse_epochs=fuse, log_every=1),
                    device="cpu").fit(ds)
            for fuse in (True, False)]
    fused, eager = runs
    # every record but its wall-clock throughput
    assert [{k: v for k, v in h.items() if k != "cells_per_sec"}
            for h in fused["history"]] == [
        {k: v for k, v in h.items() if k != "cells_per_sec"}
        for h in eager["history"]]
    assert [h["epoch"] for h in fused["history"] if h["event"] == "train"
            ] == [0, 1, 2, 3, 4]
    assert [h["epoch"] for h in fused["history"] if h["event"] == "eval"
            ] == [1, 3, 4]
    assert fused["final_elbo"] == eager["final_elbo"]
    assert np.isfinite(fused["final_elbo"])
    assert all(torch.equal(p, q) for p, q in zip(
        tree_leaves(fused["params"]), tree_leaves(eager["params"])))
    assert 0 < fused["warm_train_seconds"] and 0 < fused["train_seconds"]


def test_make_scan_is_the_steps_it_fuses():
    """make_scan's chunk on the CPU: (length, 4) aux in AUX_KEYS order and
    each step's noise, equal to Trainer.step on the same generator."""
    ds = _holdout(np.random.default_rng(13), "2pl")
    model = VIBO(VIBOConfig(**_config("2pl", use_pallas=True)), device="cpu")
    trainer = Trainer(model, TrainConfig(), device="cpu")
    packed, rv = packed_on_device(ds.response, ds.train_mask, "cpu")
    out = []
    for fused in (True, False):
        params = model.init_params(0)
        optimizer = make_optimizer(params, 1e-2)
        gen = torch.Generator().manual_seed(4)
        if fused:
            scan = trainer.make_scan(1.0, 1, 3)
            aux = scan(params, optimizer, packed, rv, gen)
            assert len(scan.noise) == 3
            assert scan.noise[0][1].shape == (1, K, ds.response.shape[0])
        else:
            aux = torch.stack([torch.stack([
                a[k] for k in AUX_KEYS]) for a in (
                    trainer.step(params, optimizer, packed, rv, gen)
                    for _ in range(3))])
        out.append((aux, tree_leaves(params)))
    assert out[0][0].shape == (3, 4)
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(p, q) for p, q in zip(out[0][1], out[1][1]))


def test_fused_chunks_track_jax_fit_fused():
    """The port's fused chunks on JAX's own noise (its key chain replayed
    through its sample_noise) against JAX's _fit_fused: 2 chunks of 2
    epochs from the same params, the per-epoch ELBO within 1e-4, and the
    params after both."""
    ds = _holdout(np.random.default_rng(14), "2pl", N)
    kw = _config("2pl", use_pallas=True)
    tcfg = dict(lr=2e-2, max_grad_norm=5.0, epochs=4, eval_every=2, seed=3)
    jmodel = JVIBO(JConfig(**kw))
    jtrainer = JTrainer(jmodel, JTrainConfig(log_every=1, **tcfg))
    res = jtrainer.fit(ds)
    jelbos = [h["elbo"] for h in res["history"] if h["event"] == "train"]
    assert len(jelbos) == 4

    # fit's key chain: one split for the init, then one a step
    key, k_init = jax.random.split(jax.random.key(tcfg["seed"]))
    jparams, _ = jtrainer.init_state(k_init)
    noise = []
    for _ in range(4):
        key, sub = jax.random.split(key)
        ie, te = jmodel.sample_noise(None, sub, N, 1, transposed=True)
        noise.append(_torch_noise((jax.tree.map(np.asarray, ie),
                                   np.asarray(te))))
    model = VIBO(VIBOConfig(**kw), device="cpu")
    trainer = Trainer(model, TrainConfig(**tcfg), device="cpu")
    replay = iter(noise)
    trainer.packed_noise = lambda packed, s, gen: next(replay)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    optimizer = make_optimizer(params, tcfg["lr"])
    packed, rv = packed_on_device(ds.response, ds.train_mask, "cpu")
    scan = trainer.make_scan(1.0, 1, 2)
    elbos = torch.cat([scan(params, optimizer, packed, rv, None)[:, 0]
                       for _ in range(2)])
    _close(elbos, jelbos, 1e-4)
    for p, q in zip(tree_leaves(params), jax.tree.leaves(res["params"])):
        _close(p.detach(), q, 1e-4)


@pytest.mark.parametrize("fuse", [True, False])
def test_non_finite_elbo_raises_as_in_jax(fuse):
    """fuse_epochs defaults to True in both packages; an infinite learning
    rate makes epoch 1's ELBO non-finite, which both fits name, fused or
    not; check_finite=False trains on."""
    assert TrainConfig().fuse_epochs is JTrainConfig().fuse_epochs is True
    ds = _holdout(np.random.default_rng(15), "2pl")
    kw = _config("2pl", use_pallas=True)
    tcfg = dict(lr=float("inf"), epochs=4, eval_every=2, fuse_epochs=fuse)
    msg = r"non-finite ELBO at epoch 1: loglik="
    with pytest.raises(FloatingPointError, match=msg):
        JTrainer(JVIBO(JConfig(**kw)), JTrainConfig(**tcfg)).fit(ds)
    model = VIBO(VIBOConfig(**kw), device="cpu")
    with pytest.raises(FloatingPointError, match=msg):
        Trainer(model, TrainConfig(**tcfg), device="cpu").fit(ds)
    res = Trainer(model, TrainConfig(check_finite=False, **tcfg),
                  device="cpu").fit(ds)
    assert not np.isfinite(res["final_elbo"])
