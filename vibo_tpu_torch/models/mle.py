"""MLE / MAP baseline: point estimates of abilities and item parameters by
full-batch Adam (counterpart of `vibo_tpu.models.mle`, same names).

The objective is VIBO's masked likelihood without posteriors, over every
cell at once; MAP adds the N(0, I) log-prior of every parameter. The
polytomous links' "b" holds the unconstrained table coordinates
(`links.categorical_table`), as in VIBO and HMC. Plain PyTorch on the
device, as JAX's is plain XLA: no kernel. The start is drawn from an
explicit torch.Generator seeded with cfg.seed, or given (`params0`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from vibo_tpu_torch._device import resolve_device
from vibo_tpu_torch.ops import likelihood as lik
from vibo_tpu_torch.ops import links


@dataclasses.dataclass(frozen=True)
class MLEConfig:
    irt_model: str = "2pl"
    ability_dim: int = 1
    num_categories: int = 2     # grm/gpcm only
    map_prior: bool = True      # False => pure MLE
    lr: float = 0.05
    steps: int = 500
    seed: int = 0


def init_point_params(generator: torch.Generator, num_persons: int,
                      num_items: int, cfg: MLEConfig) -> dict:
    """The start: theta and b ~ 0.1 N(0, 1), a ~ N(0, 1) / (2 sqrt(K)),
    3PL g_hat ~ -1.5 + 0.1 N(0, 1), drawn from the generator on its
    device."""
    dev = generator.device

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev)
    k = cfg.ability_dim
    params = {"theta": 0.1 * normal((num_persons, k))}
    params["b"] = 0.1 * normal(
        (num_items, cfg.num_categories - 1)
        if cfg.irt_model in links.CATEGORICAL_MODELS else (num_items,))
    if cfg.irt_model in ("2pl", "3pl", "grm", "gpcm"):
        params["a"] = normal((num_items, k)) / math.sqrt(k) * 0.5
    if cfg.irt_model == "3pl":
        params["g_hat"] = -1.5 + 0.1 * normal((num_items,))
    return params


def neg_log_posterior(params: dict, resp, mask, cfg: MLEConfig):
    """-(masked loglik over every cell + the N(0, I) log-priors when
    cfg.map_prior)."""
    theta = params["theta"]
    if cfg.irt_model in links.CATEGORICAL_MODELS:
        ll = lik.categorical_loglik_cells(
            cfg.irt_model, links.grm_base(theta, params["a"]),
            links.categorical_table(cfg.irt_model, params["b"]),
            resp, mask).sum()
    else:
        if cfg.irt_model == "1pl":
            logits = links.logits_1pl(theta, params["b"])
            g_hat = None
        else:
            logits = links.logits_2pl(theta, params["a"], params["b"])
            g_hat = params.get("g_hat") if cfg.irt_model == "3pl" else None
        ll = lik.masked_loglik_total(logits, resp, mask, g_hat=g_hat)
    if cfg.map_prior:
        for k in sorted(params):
            ll = ll - 0.5 * params[k].square().sum()
    return -ll


def fit_mle(resp, mask, cfg: MLEConfig, params0: dict | None = None,
            device=None) -> tuple:
    """cfg.steps full-batch Adam steps (optax.adam(cfg.lr)'s form) on
    neg_log_posterior from params0 (default: init_point_params from a
    generator seeded with cfg.seed) -> (params {name: tensor}, the
    objective at the last step's start, as JAX's scan reports it).
    resp/mask: (N, M) numpy arrays or tensors; params0 numpy arrays or
    tensors. device: None = the card (no fallback)."""
    from vibo_tpu_torch.train.trainer import make_optimizer
    dev = resolve_device(device)
    resp_t, mask_t = (
        (x if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.array(x, np.float32))).to(dev, torch.float32)
        for x in (resp, mask))
    n, m = resp_t.shape
    if params0 is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        params0 = init_point_params(gen, n, m, cfg)
    params = {k: (v if isinstance(v, torch.Tensor)
                  else torch.from_numpy(np.array(v, np.float32)))
              .to(dev, torch.float32).clone().requires_grad_()
              for k, v in sorted(params0.items())}
    opt = make_optimizer(params, cfg.lr)
    loss = torch.full((), float("nan"), device=dev)
    for _ in range(cfg.steps):
        opt.zero_grad(set_to_none=True)
        loss = neg_log_posterior(params, resp_t, mask_t, cfg)
        loss.backward()
        opt.step()
    return ({k: v.detach() for k, v in params.items()},
            float(loss.detach()) if cfg.steps else float("nan"))


def response_prob(params: dict, cfg: MLEConfig) -> torch.Tensor:
    """(N, M) predicted probabilities from the point estimates (grm/gpcm:
    (N, M, C) category probabilities)."""
    with torch.no_grad():
        item = {k: v for k, v in params.items() if k != "theta"}
        if cfg.irt_model in links.CATEGORICAL_MODELS:
            return torch.exp(lik.categorical_logprob_all(
                cfg.irt_model, links.grm_base(params["theta"], item["a"]),
                links.categorical_table(cfg.irt_model, item["b"])))
        return links.response_prob(cfg.irt_model, params["theta"], item)
