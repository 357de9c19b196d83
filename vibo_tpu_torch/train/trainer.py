"""VIBO training harness (counterpart of `vibo_tpu.train.trainer`, the
full-batch packed path): one step is the int8-code ELBO with exogenous noise,
its backward, clipping by global norm and Adam.

Optimizer parity with the JAX chain `optax.chain(clip_by_global_norm(c),
adam(lr))`:
- clipping scales by c / norm only when norm >= c, with no epsilon
  (`clip_by_global_norm_`); torch.nn.utils.clip_grad_norm_ adds 1e-6 and
  differs;
- torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8) is optax.adam(lr): eps
  is added outside the square root of the bias-corrected second moment and
  both moments are bias-corrected the same way (tests/test_torch_trainer.py
  holds the two against each other).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from vibo_tpu_torch import evaluation
from vibo_tpu_torch._device import resolve_device
from vibo_tpu_torch.convert import tree_leaves
from vibo_tpu_torch.data.masking import Dataset
from vibo_tpu_torch.models.vibo import VIBO
from vibo_tpu_torch.ops import objectives
from vibo_tpu_torch.ops.packing import packed_on_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 5e-3
    epochs: int = 50
    num_mc_samples: int = 1            # S for the training ELBO
    seed: int = 0
    eval_every: int = 10               # epochs between held-out evals
    max_grad_norm: float | None = 10.0
    check_finite: bool = True          # raise on a NaN/Inf ELBO


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g <- (g / norm) * max_norm where
    norm >= max_norm, unchanged otherwise. No host sync. Returns the norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def make_optimizer(params: dict, lr: float) -> torch.optim.Adam:
    """Adam over the param leaves, matching optax.adam(lr) (module doc)."""
    return torch.optim.Adam(tree_leaves(params), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


class Trainer:
    def __init__(self, model: VIBO, cfg: TrainConfig, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, trainer on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg

    def step_with_noise(self, params: dict, optimizer, packed, row_valid,
                        item_eps: dict, theta_eps):
        """One packed full-batch step on given noise; params update in
        place. Returns the aux dict of 0-d tensors (no host sync)."""
        model = self.model
        ll, klt, kli = model.elbo_packed_sums(
            params, packed, item_eps, theta_eps, row_valid,
            transposed=model.wants_transposed_theta())
        bound = objectives.elbo(ll, klt, kli)   # full batch: item_scale 1
        optimizer.zero_grad(set_to_none=True)
        (-bound).backward()
        if self.cfg.max_grad_norm is not None:
            with torch.no_grad():
                clip_by_global_norm_([p.grad for p in tree_leaves(params)],
                                     self.cfg.max_grad_norm)
        optimizer.step()
        return {"elbo": bound.detach(), "loglik": ll.detach(),
                "kl_theta": klt.detach(), "kl_items": kli.detach()}

    def step(self, params: dict, optimizer, packed, row_valid,
             generator: torch.Generator):
        """One packed full-batch step with noise drawn from `generator`."""
        item_eps, theta_eps = self.model.sample_noise(
            packed.shape[0], self.cfg.num_mc_samples,
            transposed=self.model.wants_transposed_theta(),
            generator=generator)
        return self.step_with_noise(params, optimizer, packed, row_valid,
                                    item_eps, theta_eps)

    def fit(self, ds: Dataset) -> dict:
        """Full-batch training on ds.train_mask with held-out imputation
        accuracy every eval_every epochs. Returns params, history, best
        accuracy, final ELBO and throughput."""
        cfg = self.cfg
        n, m = ds.response.shape
        packed, row_valid = packed_on_device(ds.response, ds.train_mask,
                                             self.device)
        params = self.model.init_params(cfg.seed)
        optimizer = make_optimizer(params, cfg.lr)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed + 1)
        history, elbos = [], []
        final_elbo = float("nan")
        best = {"heldout_acc": -1.0, "epoch": -1}
        t_train = 0.0
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            aux = self.step(params, optimizer, packed, row_valid, gen)
            elbos.append(aux["elbo"])
            last = epoch == cfg.epochs - 1
            if (epoch + 1) % cfg.eval_every and not last:
                t_train += time.perf_counter() - t0
                continue
            chunk = torch.stack(elbos).cpu().numpy()   # completion barrier
            t_train += time.perf_counter() - t0
            elbos = []
            if cfg.check_finite and not np.isfinite(chunk).all():
                raise FloatingPointError(
                    f"non-finite ELBO by epoch {epoch}: loglik="
                    f"{float(aux['loglik'])} kl_theta="
                    f"{float(aux['kl_theta'])} kl_items="
                    f"{float(aux['kl_items'])}; check lr/grad-clip")
            final_elbo = float(chunk[-1])
            history.append({"event": "train", "epoch": epoch,
                            "elbo": final_elbo})
            if ds.heldout_mask.sum() > 0:
                ev = evaluation.imputation_accuracy(self.model, params, ds)
                history.append({"event": "eval", "epoch": epoch, **ev})
                if ev["acc"] > best["heldout_acc"]:
                    best = {"heldout_acc": ev["acc"], "epoch": epoch}
        return {"params": params, "optimizer": optimizer,
                "history": history, "best": best, "final_elbo": final_elbo,
                "train_seconds": t_train,
                "cells_per_sec": n * m * cfg.epochs / t_train}
