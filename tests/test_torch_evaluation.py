"""The port's IWAE test log-likelihood against the JAX package's:
`evaluation.iwae_loglik` on the same (converted) params and on JAX's own
noise, replayed from the keys it splits per person block (GRM and GPCM at
C = 5 too, and the deep link, its samples in chunks of 2). One case fits in
one block (N <= block_size); the others cut N into zero-padded blocks, so
the padded rows and the per-block item_scale are exercised. f32 encoder;
the bound within 1e-5 relative (f32 sums in different orders), the cell
count exactly."""

import jax
import numpy as np
import pytest
import torch

from vibo_tpu import evaluation as jeval
from vibo_tpu.data import holdout_split as jholdout, simulate_irt as jsim
from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu_torch import evaluation
from vibo_tpu_torch.convert import params_from_jax
from vibo_tpu_torch.models import VIBO, VIBOConfig

from jax_noise_replay import replay_noise

N, M, K, H = 30, 14, 2, 12
DL = 3                                     # deep: item latent dim


@pytest.mark.parametrize("irt_model,block,s,on", [
    ("2pl", 64, 4, "heldout"),
    ("2pl", 16, 12, "heldout"),
    ("1pl", 16, 5, "train"),
    ("3pl", 16, 4, "heldout"),
    ("grm", 16, 4, "heldout"),
    ("gpcm", 64, 5, "train"),
    ("deep", 16, 4, "heldout"),
])
def test_iwae_loglik_matches_jax(irt_model, block, s, on, monkeypatch):
    c = 5 if irt_model in ("grm", "gpcm") else 2
    sim = jsim("nonlinear" if irt_model == "deep" else irt_model, N, M,
               ability_dim=K, seed=2, missing_rate=0.2, num_categories=c)
    ds = jholdout(sim.response, sim.mask, 0.25, seed=1, num_categories=c)
    ds.train_mask[4] = 0.0        # a person with nothing to condition on
    kw = dict(num_items=M, irt_model=irt_model, ability_dim=K,
              hidden_dim=H, use_pallas=True, num_categories=c)
    if irt_model == "deep":
        kw.update(item_latent_dim=DL, deep_hidden_dim=32, deep_item_chunk=8)
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(3))
    key = jax.random.key(11)
    want = jeval.iwae_loglik(jmodel, jparams, key, ds, num_samples=s,
                             block_size=block, on=on)

    shapes = {"1pl": {"b": (M, 1)}, "2pl": {"a": (M, K), "b": (M, 1)},
              "3pl": {"a": (M, K), "b": (M, 1), "g_hat": (M, 1)},
              "grm": {"a": (M, K), "b": (M, c - 1)},
              "gpcm": {"a": (M, K), "b": (M, c - 1)},
              "deep": {"d": (M, DL)}}[irt_model]
    state = {"key": key, "blocks": []}

    def noise(block_index, rows):
        state["key"], sub = jax.random.split(state["key"])
        state["blocks"].append((block_index, rows))
        return replay_noise(sub, s, shapes, rows, K)

    model = VIBO(VIBOConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    if irt_model == "deep":
        # a chunk of 2 samples: the deep link's activation budget at work
        monkeypatch.setattr(evaluation, "_DEEP_CHUNK_BYTES",
                            2 * 4 * block * 8 * 32)
    got = evaluation.iwae_loglik(model, params, ds, num_samples=s,
                                 block_size=block, on=on, noise=noise)
    n_blocks = -(-N // block)
    assert state["blocks"] == [(i, min(N, block)) for i in range(n_blocks)]
    assert got["num_cells"] == want["num_cells"] > 0
    assert got["num_samples"] == s
    assert got["loglik"] < 0
    assert got["loglik"] == pytest.approx(want["loglik"], rel=1e-5)
    assert got["loglik_per_cell"] == pytest.approx(want["loglik_per_cell"],
                                                   rel=1e-5)


def test_iwae_loglik_draws_from_a_generator():
    sim = jsim("2pl", 20, 10, ability_dim=1, seed=0, missing_rate=0.1)
    ds = jholdout(sim.response, sim.mask, 0.3, seed=0)
    model = VIBO(VIBOConfig(num_items=10, hidden_dim=8), device="cpu")
    params = model.init_params(0)
    runs = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(4)
        runs.append(evaluation.iwae_loglik(model, params, ds,
                                           num_samples=6, block_size=8,
                                           generator=gen))
    assert runs[0] == runs[1]
    assert np.isfinite(runs[0]["loglik"]) and runs[0]["loglik"] < 0
    with pytest.raises(ValueError, match="heldout"):
        evaluation.iwae_loglik(model, params, ds, on="test")
