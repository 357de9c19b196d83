"""The port's training step against the JAX one: five packed full-batch
steps (clip by global norm + Adam) on the same params and numpy noise track
`make_optimizer` + `elbo_packed_sums` at f32 within 1e-4 (relative to each
array's largest magnitude: the frameworks sum in different orders).

Also held on their own: the clip (optax scales by max/norm only above the
threshold, with no epsilon) and torch.optim.Adam against optax.adam."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu.ops import objectives as jobj
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu.train.trainer import make_optimizer as jmake_optimizer
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.models import VIBO, VIBOConfig
from vibo_tpu_torch.ops.packing import packed_on_device
from vibo_tpu_torch.train import Trainer, TrainConfig, make_optimizer
from vibo_tpu_torch.train.trainer import clip_by_global_norm_

N, M, K, H, STEPS = 40, 24, 2, 16, 5


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


def test_five_steps_track_jax():
    rng = np.random.default_rng(0)
    resp = (rng.random((N, M)) < 0.5).astype(np.float32)
    mask = (rng.random((N, M)) < 0.85).astype(np.float32)
    kw = dict(num_items=M, irt_model="2pl", ability_dim=K, hidden_dim=H,
              use_pallas=True, compute_dtype="float32")
    # lr large enough that Adam moves every param, max_grad_norm small
    # enough that the clip fires
    lr, max_norm = 2e-2, 5.0
    noise = [({"a": rng.standard_normal((1, M, K)).astype(np.float32),
               "b": rng.standard_normal((1, M, 1)).astype(np.float32)},
              rng.standard_normal((1, K, N)).astype(np.float32))
             for _ in range(STEPS)]

    jmodel = JVIBO(JConfig(**kw))
    assert jmodel.wants_transposed_theta()
    jparams = jmodel.init_params(jax.random.key(2))
    tx = jmake_optimizer(lr, max_norm)
    opt_state = tx.init(jparams)
    packed_j = jnp.asarray(jpack(resp, mask))
    row_valid = jnp.asarray((mask.sum(-1) > 0).astype(np.float32))

    @jax.jit
    def jstep(p, s, ie, te):
        def loss(p):
            ll, klt, kli = jmodel.elbo_packed_sums(p, packed_j, ie, te,
                                                   row_valid, transposed=True)
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
        jparams, opt_state, jelbo = jstep(jparams, opt_state,
                                          jax.tree.map(jnp.asarray, ie),
                                          jnp.asarray(te))
        aux = trainer.step_with_noise(
            params, optimizer, packed, rv,
            {k: torch.from_numpy(v) for k, v in ie.items()},
            torch.from_numpy(te))
        _close(aux["elbo"], jelbo, 1e-4)
    for p, q in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        _close(p.detach(), q, 1e-4)


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
