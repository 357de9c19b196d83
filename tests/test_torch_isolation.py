"""The port stands alone: importing every module of vibo_tpu_torch (the CLI,
the data loaders and the native CSV parser's bindings, the profiler among
them) loads no JAX, optax or vibo_tpu module (and builds nothing); entry
points default to the card and raise where there is none; a kernel wrapper
given CPU tensors runs its plain version and launches nothing."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from vibo_tpu_torch.models import VIBO, VIBOConfig, em, hmc, mle
from vibo_tpu_torch.scripts import run_at_scale
from vibo_tpu_torch.ops import (_build, pallas_deep, pallas_elbo,
                                pallas_encoder, pallas_gpcm, pallas_grm)
from vibo_tpu_torch.serve import AbilityScorer
from vibo_tpu_torch.train import Trainer, TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax_or_reference_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import vibo_tpu_torch
        for info in pkgutil.walk_packages(vibo_tpu_torch.__path__,
                                          "vibo_tpu_torch."):
            importlib.import_module(info.name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "optax")
                     or m == "vibo_tpu" or m.startswith("vibo_tpu."))
        print(len([m for m in sys.modules
                   if m.startswith("vibo_tpu_torch.")]), bad)
        from vibo_tpu_torch.ops import _build
        assert all(k._fn is None for k in _build.KERNELS.values())
        assert "vibo_tpu_torch.models.hmc" in sys.modules
        assert {"vibo_tpu_torch.models.em", "vibo_tpu_torch.train.checkpoint",
                "vibo_tpu_torch.utils.metrics", "vibo_tpu_torch.cli",
                "vibo_tpu_torch.data.loaders", "vibo_tpu_torch.data.native",
                "vibo_tpu_torch.utils.prof",
                "vibo_tpu_torch.utils.hostmem",
                "vibo_tpu_torch.scripts.gen_duolingo_csv",
                "vibo_tpu_torch.scripts.bench_ingest",
                "vibo_tpu_torch.scripts.run_at_scale"} <= set(sys.modules)
        from vibo_tpu_torch.data import native
        assert native._lib is None      # the CSV parser builds on first use
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 20
    assert bad.strip() == "[]"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = VIBOConfig(num_items=4, hidden_dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        VIBO(cfg)
    model = VIBO(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model, TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        AbilityScorer(model, model.init_params(0))
    resp = torch.ones((4, 3)).numpy()
    with pytest.raises(RuntimeError, match="CUDA"):
        hmc.run_hmc(resp, resp, hmc.HMCConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        hmc.posterior_mean_prob({"theta": resp[None, :, :1],
                                 "b": resp[None, 0]}, "1pl")
    with pytest.raises(RuntimeError, match="CUDA"):
        mle.fit_mle(resp, resp, mle.MLEConfig(steps=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        em.fit_em(resp, resp, em.EMConfig(max_iters=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        em.response_prob({"a": resp[0], "b": resp[0],
                          "posterior_node_weights": resp})
    # before it writes or reads a CSV
    with pytest.raises(RuntimeError, match="CUDA"):
        run_at_scale.run(os.path.join(REPO, "no_such_dir", "duolingo.csv"),
                         device=None)
    assert not os.path.exists(os.path.join(REPO, "no_such_dir"))


def test_out_of_scope_config_raises():
    # the deep link is in scope: JAX's defaults, theta (B, K), and the
    # one-pass op only with deep_fused_kernel at a width it supports
    cfg = VIBOConfig(num_items=4, irt_model="deep", deep_fused_kernel=True,
                     use_pallas=True)
    assert (cfg.item_latent_dim, cfg.deep_hidden_dim,
            cfg.deep_item_chunk) == (16, 128, 256)
    model = VIBO(cfg, device="cpu")
    params = model.init_params(0)
    assert not model.wants_transposed_theta()
    assert model._use_packed_kernel(params)
    assert not VIBO(VIBOConfig(num_items=4, irt_model="deep",
                               use_pallas=True), device="cpu"
                    )._use_packed_kernel(params)
    narrow = VIBO(VIBOConfig(num_items=4, irt_model="deep", use_pallas=True,
                             deep_fused_kernel=True, deep_hidden_dim=96),
                  device="cpu")
    assert not narrow._use_packed_kernel(narrow.init_params(0))
    # every family of the JAX config is accepted; an unknown one raises
    for fam in ("chol", "laplace", "laplace-w"):
        VIBOConfig(num_items=4, theta_posterior=fam, condition_on="stats")
    VIBOConfig(num_items=4, item_encoder=True)
    with pytest.raises(ValueError, match="theta_posterior"):
        VIBOConfig(num_items=4, theta_posterior="full")
    # a field the JAX config does not have is refused
    with pytest.raises(TypeError):
        VIBOConfig(num_items=4, deep_kernel=True)


def test_cpu_tensors_take_the_plain_path():
    _build.reset_launches()
    pk = torch.tensor([[0, 1, 2], [2, 2, 0]], dtype=torch.int8)
    w = torch.ones((3, 2), requires_grad=True)
    h = pallas_encoder.packed_first_layer(pk, w, w)
    h.sum().backward()
    theta = torch.zeros((2, 1), requires_grad=True)
    ll = pallas_elbo.masked_loglik_2pl_packed_train_t(
        theta.T, torch.ones((3, 1)), torch.zeros(3), pk)
    ll.backward()
    # 1 wrong + 3 right observed cells at logit 0: 4 * log(1/2)
    assert float(ll.detach()) == pytest.approx(4 * -0.6931471805599453)
    assert h.detach().tolist() == [[3.0, 3.0], [4.0, 4.0]]
    # the deep one-pass op: a zero link scores every observed cell at
    # logit 0 (4 cells, 4 log(1/2)), and its gradients reach the link
    link = {"w_theta": torch.zeros((1, 128), requires_grad=True),
            "w_item": torch.zeros((2, 128)), "b1": torch.zeros(128),
            "layer2": {"w": torch.zeros((128, 128)), "b": torch.zeros(128)},
            "out": {"w": torch.zeros((128, 1)),
                    "b": torch.zeros(1, requires_grad=True)}}
    ll = pallas_deep.masked_loglik_deep_packed_train(
        torch.zeros((2, 1)), torch.zeros((3, 2)), link, pk)
    ll.sum().backward()
    assert float(ll.sum().detach()) == pytest.approx(4 * -0.6931471805599453)
    # sum of m (r - 1/2): 3 right, 1 wrong
    assert float(link["out"]["b"].grad) == pytest.approx(1.0)
    assert all(k.launches == 0 and k._fn is None
               for k in _build.KERNELS.values())
    assert set(_build.KERNELS) == {"first_layer_fwd", "first_layer_bwd",
                                   "first_layer_fwd_f32",
                                   "first_layer_bwd_f32",
                                   "deep_link_train",
                                   "deep_link_f32_train",
                                   "loglik_2pl_train", "loglik_3pl_train",
                                   "loglik_grm_train", "loglik_gpcm_train",
                                   "masked_loglik_2pl_fwd",
                                   "masked_loglik_2pl_bwd",
                                   "masked_loglik_3pl_fwd",
                                   "masked_loglik_3pl_bwd"}


def test_cpu_tensors_take_the_plain_path_general_loglik():
    """The general op, both links and readers, with a sample axis, and the
    3PL one-pass op: plain versions on CPU tensors, no kernel bound or
    launched."""
    _build.reset_launches()
    pk = torch.tensor([[0, 1, 2], [2, 2, 0]], dtype=torch.int8)
    m, r = (pk > 0).float(), (pk == 2).float()
    theta = torch.zeros((2, 2, 1), requires_grad=True)
    a, b = torch.ones((3, 1)), torch.zeros((2, 3), requires_grad=True)
    # a guess logit of -inf-like size: 3PL reduces to 2PL
    g_hat = torch.full((3,), -60.0, requires_grad=True)
    for ll in (pallas_elbo.masked_loglik_2pl(theta, a, b, r, m),
               pallas_elbo.masked_loglik_2pl_packed(theta, a, b, pk),
               pallas_elbo.masked_loglik_3pl(theta, a, b, g_hat, r, m),
               pallas_elbo.masked_loglik_3pl_packed(theta, a, b, g_hat, pk)):
        (ll * torch.tensor([[1.0, 2.0], [0.5, 0.0]])).sum().backward()
        # two and two observed cells at logit 0: 2 * log(1/2) per person
        assert ll.detach().tolist() == [[pytest.approx(-1.3862944)] * 2] * 2
    ll = pallas_elbo.masked_loglik_3pl_packed_train_t(theta[0].T, a, b[0],
                                                      g_hat, pk)
    ll.backward()
    assert float(ll.detach()) == pytest.approx(4 * -0.6931471805599453)
    # the polytomous one-pass ops, C = 3: base 0, GPCM steps 0 (every
    # category 1/3), GRM thresholds 0 and 50 (categories 0 and 1 at 1/2
    # each, the codes 1 and 2)
    for op, kap in ((pallas_gpcm.masked_loglik_gpcm_packed_train,
                     torch.zeros((3, 2))),
                    (pallas_grm.masked_loglik_grm_packed_train,
                     torch.tensor([[0.0, 50.0]] * 3))):
        ll = op(theta, a, kap.requires_grad_(), pk)
        ll.sum().backward()
        assert ll.shape == (2, 2) and torch.isfinite(kap.grad).all()
    assert float(ll[0, 0]) == pytest.approx(2 * -0.6931471805599453)
    assert all(k.launches == 0 and k.launches_by == {} and k._fn is None
               for k in _build.KERNELS.values())
