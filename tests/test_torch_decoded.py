"""The decoded full batch (TrainConfig.packed=False) and the key-taking
packed ELBO against the JAX package, on one device at the small shapes of
test_torch_trainer.py, f32:
- `VIBO.elbo_packed` (the port: a generator or given noise) against JAX's
  `elbo_packed(params, key, ...)` on JAX's noise replayed from its key
  (tests/jax_noise_replay.py), for every link, within 1e-4;
- fit(packed=False) against JAX's: the port's fused decoded chunks
  (make_scan(decoded=True)) on JAX's params and JAX's noise, replayed from
  fit's key chain, track JAX's fit's per-epoch ELBO within 1e-4 and its
  params within 1e-4 (1e-3 for the deep link and the IWAE bound, whose
  last-bit differences Adam amplifies over free steps), for both
  objectives;
- on the CPU fit(packed=False) is bitwise the same fused or not, and it is
  the minibatch step on the whole data (item_scale 1);
- TrainConfig.packed's rules and errors are JAX's."""

import jax
import numpy as np
import pytest
import torch

from vibo_tpu.data.masking import holdout_split as jholdout
from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu.train.trainer import Trainer as JTrainer, TrainConfig as JTC
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.models import VIBO, VIBOConfig
from vibo_tpu_torch.ops.packing import pack_responses
from vibo_tpu_torch.train import Trainer, TrainConfig, make_optimizer

from jax_noise_replay import replay_noise
from test_torch_trainer import (C, K, N, POLYTOMOUS, _close, _config, _data,
                                _item_shapes)

LINKS = ["2pl", "3pl", "grm", "gpcm", "deep"]


@pytest.mark.parametrize("irt_model", LINKS)
@pytest.mark.parametrize("s", [1, 3])
def test_elbo_packed_matches_jax(irt_model, s):
    rng = np.random.default_rng(20)
    resp, mask = _data(rng, irt_model, N)
    mask[2] = 0.0
    kw = _config(irt_model, use_pallas=irt_model == "2pl")
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(1))
    packed = jpack(resp, mask)
    row_valid = (mask.sum(-1) > 0).astype(np.float32)
    key = jax.random.key(2)
    want, jaux = jmodel.elbo_packed(jparams, key, packed, 0.7, s,
                                    row_valid=row_valid)
    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    noise = replay_noise(key, s, _item_shapes(irt_model), N, K)
    got, aux = model.elbo_packed(params, torch.from_numpy(packed), 0.7, s,
                                 torch.from_numpy(row_valid), noise=noise)
    _close(got.detach(), want, 1e-4)
    for k in ("loglik", "kl_theta", "kl_items"):
        _close(aux[k].detach(), jaux[k], 1e-4)
    # a generator draws sample_noise(B, S) (theta (S, B, K))
    gens = [torch.Generator().manual_seed(4) for _ in range(2)]
    a, _ = model.elbo_packed(params, torch.from_numpy(packed), 0.7, s,
                             generator=gens[0])
    b, _ = model.elbo_packed(params, torch.from_numpy(packed), 0.7, s,
                             noise=model.sample_noise(N, s,
                                                      generator=gens[1]))
    assert torch.equal(a, b)


def _holdout(rng, irt_model, n=N):
    return jholdout(*_data(rng, irt_model, n), 0.2, seed=0,
                    num_categories=C if irt_model in POLYTOMOUS else 2)


@pytest.mark.parametrize("objective,irt_model,s", [
    ("elbo", "2pl", 1), ("iwae", "2pl", 2), ("elbo", "grm", 1),
    ("elbo", "3pl", 2), ("iwae", "deep", 2)])
def test_fit_decoded_tracks_jax(objective, irt_model, s):
    """JAX's fit(packed=False) (its fused chunks of model.elbo / model.iwae
    on (response, mask)) against the port's fused decoded chunks from the
    same params on JAX's noise: two chunks of two epochs."""
    ds = _holdout(np.random.default_rng(21), irt_model)
    kw = _config(irt_model, use_pallas=True)
    tcfg = dict(lr=2e-2, max_grad_norm=5.0, epochs=4, eval_every=2, seed=3,
                objective=objective, num_mc_samples=s, packed=False)
    jmodel = JVIBO(JConfig(**kw))
    jtrainer = JTrainer(jmodel, JTC(log_every=1, **tcfg))
    res = jtrainer.fit(ds)
    jelbos = [h["elbo"] for h in res["history"] if h["event"] == "train"]

    # fit's key chain: one split for the init, then one a step
    key, k_init = jax.random.split(jax.random.key(tcfg["seed"]))
    jparams, _ = jtrainer.init_state(k_init)
    noise = []
    for _ in range(4):
        key, sub = jax.random.split(key)
        noise.append(replay_noise(sub, s, _item_shapes(irt_model), N, K))
    model = VIBO(VIBOConfig(**kw), device="cpu")
    trainer = Trainer(model, TrainConfig(**tcfg), device="cpu")
    replay = iter(noise)
    trainer.decoded_noise = lambda resp, s, gen: next(replay)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    optimizer = make_optimizer(params, tcfg["lr"])
    resp, mask = (torch.from_numpy(x) for x in (ds.response, ds.train_mask))
    scan = trainer.make_scan(1.0, s, 2, decoded=True)
    elbos = torch.cat([scan(params, optimizer, resp, mask, None)[:, 0]
                       for _ in range(2)])
    _close(elbos, jelbos, 1e-4)
    # Adam divides each gradient element by its own RMS: where the
    # frameworks' f32 sums part in the last bits (the deep link's relu
    # pattern, test_torch_trainer.py; the IWAE weights of sums over the
    # batch, test_torch_fused.py) four free steps part by up to ~1e-3
    tol = 1e-3 if irt_model == "deep" or objective == "iwae" else 1e-4
    for p, q in zip(tree_leaves(params), jax.tree.leaves(res["params"])):
        _close(p.detach(), q, tol)


@pytest.mark.parametrize("objective", ["elbo", "iwae"])
def test_fit_decoded_fused_equals_eager_and_minibatch_step(objective):
    """On the CPU the fused decoded chunks are the per-epoch steps: fit
    bitwise equal with fuse_epochs on and off; and an epoch is one
    minibatch_step on the whole data at item_scale 1."""
    ds = _holdout(np.random.default_rng(22), "2pl", 30)
    model = VIBO(VIBOConfig(**_config("2pl", use_pallas=True)),
                 device="cpu")
    runs = [Trainer(model, TrainConfig(epochs=5, eval_every=2, lr=1e-2,
                                       objective=objective, num_mc_samples=2,
                                       packed=False, fuse_epochs=fuse,
                                       log_every=1), device="cpu").fit(ds)
            for fuse in (True, False)]
    strip = [[{k: v for k, v in h.items() if k != "cells_per_sec"}
              for h in r["history"]] for r in runs]
    assert strip[0] == strip[1]
    assert runs[0]["final_elbo"] == runs[1]["final_elbo"]
    assert all(torch.equal(p, q) for p, q in zip(
        tree_leaves(runs[0]["params"]), tree_leaves(runs[1]["params"])))

    trainer = Trainer(model, TrainConfig(objective=objective, lr=1e-2,
                                         num_mc_samples=2), device="cpu")
    params = model.init_params(0)
    optimizer = make_optimizer(params, 1e-2)
    gen = torch.Generator().manual_seed(1)
    resp, mask = (torch.from_numpy(x) for x in (ds.response, ds.train_mask))
    first = trainer.minibatch_step(params, optimizer, resp, mask, 1.0, gen)
    assert runs[1]["history"][0]["elbo"] == float(first["elbo"])
    assert runs[1]["history"][0]["loglik"] == float(first["loglik"])


def test_packed_rules_match_jax():
    """packed=None takes the int8 code on a full batch and the decoded
    minibatches otherwise; packed=True with minibatches raises JAX's
    error; packed=False trains the decoded full batch (a different noise
    layout from the code's transposed theta, so a different trajectory)."""
    ds = _holdout(np.random.default_rng(23), "2pl", 30)
    kw = _config("2pl", use_pallas=True)
    msg = "packed=True requires full-batch training"
    with pytest.raises(ValueError, match=msg):
        JTrainer(JVIBO(JConfig(**kw)), JTC(packed=True, batch_size=8,
                                           epochs=1)).fit(ds)
    model = VIBO(VIBOConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match=msg):
        Trainer(model, TrainConfig(packed=True, batch_size=8, epochs=1),
                device="cpu").fit(ds)
    assert TrainConfig().packed is JTC().packed is None
    fits = {packed: Trainer(model, TrainConfig(epochs=2, eval_every=2,
                                               packed=packed, log_every=1),
                            device="cpu").fit(ds)
            for packed in (None, True, False)}
    assert fits[None]["final_elbo"] == fits[True]["final_elbo"]
    assert fits[False]["final_elbo"] != fits[True]["final_elbo"]
    assert np.isfinite(fits[False]["final_elbo"])
    # the same bound, both ways, on the same params and the same noise
    params = model.init_params(0)
    noise = model.sample_noise(30, 1, generator=torch.Generator()
                               .manual_seed(5))
    resp, mask = (torch.from_numpy(x) for x in (ds.response, ds.train_mask))
    decoded, _ = model.elbo_eps(params, resp, mask, *noise)
    packed, _ = model.elbo_packed(
        params, torch.from_numpy(pack_responses(ds.response, ds.train_mask)),
        noise=noise)
    _close(packed.detach(), decoded.detach(), 1e-5)
